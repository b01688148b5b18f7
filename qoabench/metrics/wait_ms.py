"""Waiting on the cards per call: the self time of the program's
``qoa.wait`` spans, the synchronize inside each fetch
(``utils/transfer.py::fetch_arrays``), per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "wait")
