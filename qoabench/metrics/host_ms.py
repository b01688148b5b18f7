"""Host time per call: the call's wall time less the time any of the
cell's cards was busy inside it, averaged over the window's calls, in ms.
Parse, staging, assembly and the waits around them (``bitstream.py``, the
host side of ``parallel/corpus.py``)."""

from qoabench.trace import Trace, covered, union


def read(t: Trace):
    busy = union([(o.start, o.end) for o in t.ops])
    host = [(e - s) - covered(busy, s, e) for s, e in t.calls]
    return sum(host) / len(host) / 1e3
