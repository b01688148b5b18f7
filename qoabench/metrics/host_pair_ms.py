"""The host pair per call: the self time of the program's ``qoa.host_pair``
spans (``parallel/corpus.py``: the split of a call's files by whether the
device path takes them, and the host decode -> encode of those it does
not), per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "host_pair")
