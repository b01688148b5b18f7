"""The program's host stage spans, read from ``Trace.host``.

The port marks each host stage of a call as a ``torch.profiler`` span
named ``qoa.<stage>`` (``qoaudio_tpu_torch/utils/timing.py::span``), once
per stage and sub-call; ``qoa.upload`` nests in the stage that queues it,
``qoa.wait`` in ``qoa.fetch``.  A stage's reading is its self time: what
its spans cover less what the ``qoa.*`` spans nested in them cover.  A
trace without such spans (a program that lacks them) reads None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

from qoabench.trace import HostOp, Interval, Trace, union

PREFIX = "qoa."


def _spans(t: Trace) -> List[HostOp]:
    lo, hi = t.window
    return [h for h in t.host if h.name.startswith(PREFIX) and h.end > lo and h.start < hi]


def _covered(merged: Sequence[Interval], starts: Sequence[float], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals (``starts`` their
    starts) cover; visits only those that can meet it."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    out = 0.0
    while i < len(merged) and merged[i][0] < hi:
        out += max(0.0, min(merged[i][1], hi) - max(merged[i][0], lo))
        i += 1
    return out


def self_ms(t: Trace, stage: str) -> Optional[float]:
    """Span ``qoa.<stage>``'s self time per call, in ms: the union of its
    intervals inside the window, less the part that the other ``qoa.*``
    spans nested in them cover, over the window's calls."""
    name = PREFIX + stage
    spans = _spans(t)
    own = union([(h.start, h.end) for h in spans if h.name == name])
    if not own:
        return None
    starts = [s for s, _ in own]

    def nested(h: HostOp) -> bool:
        i = bisect.bisect_right(starts, h.start) - 1
        return i >= 0 and h.end <= own[i][1]

    inner = union([(h.start, h.end) for h in spans if h.name != name and nested(h)])
    inner_starts = [s for s, _ in inner]
    lo, hi = t.window
    spent = 0.0
    for s, e in own:
        s, e = max(s, lo), min(e, hi)
        spent += (e - s) - _covered(inner, inner_starts, s, e)
    return spent / len(t.calls) / 1e3


def unspanned_ms(t: Trace) -> Optional[float]:
    """The part of each call that no ``qoa.*`` span covers, mean over the
    window's calls, in ms."""
    spans = _spans(t)
    if not spans:
        return None
    merged = union([(h.start, h.end) for h in spans])
    starts = [s for s, _ in merged]
    return sum((e - s) - _covered(merged, starts, s, e) for s, e in t.calls) / len(t.calls) / 1e3
