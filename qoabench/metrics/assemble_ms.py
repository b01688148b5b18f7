"""Assembly per call: the self time of the program's ``qoa.assemble``
spans, the files' bytes from the fetched arrays (``parallel/corpus.py``:
``_assemble_transcode``; ``batch_encode``'s ``assemble_stream_bytes``
loop), per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "assemble")
