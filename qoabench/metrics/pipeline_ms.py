"""Queuing the device work per call: the self time of the program's
``qoa.pipeline`` spans (``parallel/corpus.py``: the transcode handle's
launches; each ``encode_frames_sharded`` of ``_encode_sharded``) less the
uploads nested in them, per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "pipeline")
