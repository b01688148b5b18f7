"""The length-bucket choice per call: the self time of the program's
``qoa.bucket`` spans (``parallel/corpus.py``: ``_bucket_model`` and
``_length_buckets`` over a call's device-path files, inside ``qoa.stage``),
per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "bucket")
