"""Parse per call: the self time of the program's ``qoa.parse`` span,
``bitstream.parse_file_arrays`` over a call's streams (``batch_transcode``
and ``batch_decode`` in ``parallel/corpus.py``), per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "parse")
