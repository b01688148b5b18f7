"""Uploads per call: the self time of the program's ``qoa.upload`` spans,
pinning host arrays and queuing their copies to a card
(``utils/transfer.py::put_arrays``), per call, in ms."""

from qoabench.metrics._spans import self_ms
from qoabench.trace import Trace


def read(t: Trace):
    return self_ms(t, "upload")
