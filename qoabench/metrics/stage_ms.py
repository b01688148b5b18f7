"""Host staging per call: the self time of the program's ``qoa.stage``
spans, the host arrays of a call (``parallel/corpus.py``: the file groups,
the bucket choice, ``_stage_transcode``; ``_encode_sharded``'s checks,
``layout_pcm`` and each chunk's cube fill) less the uploads nested in
them, per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "stage")
