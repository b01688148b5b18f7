"""Fetches per call: the self time of the program's ``qoa.fetch`` spans,
pinned staging, the copies back and the copies out of pinned memory
(``utils/transfer.py::fetch_arrays``) less the wait nested in them, per
call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "fetch")
