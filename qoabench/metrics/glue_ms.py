"""Device glue per call: device time of every kernel and memset that is
not a QOA kernel (the relayout gather, the lens, the packing of
``parallel/corpus.py``), per call, in ms."""

from qoabench.trace import Trace


def read(t: Trace):
    spent = sum(o.end - o.start for o in t.ops if o.kind == "glue")
    return spent / len(t.calls) / 1e3 if spent else None
