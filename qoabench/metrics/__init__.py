"""One reader per per-layer metric, found by the metric's name.

``<name>.py`` reads the metric of that name; a metric ``<base>.<group>``
without a file of its own is read by ``<base>.py``, the group naming the
end-to-end metric it moves.  A reader's ``read(trace)`` takes a
``qoabench.trace.Trace`` and returns the number, or None where the trace
holds nothing for it to read: the metric is then left out of the line.
"""
