"""Copies per call: device time of host-to-device and device-to-host
memcpys (``utils/transfer.py``) over the window, per call, in ms."""

from qoabench.trace import Trace


def read(t: Trace):
    spent = sum(o.end - o.start for o in t.ops if o.kind == "memcpy")
    return spent / len(t.calls) / 1e3 if spent else None
