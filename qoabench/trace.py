"""What the traced run hands the per-layer readers: the device operations
and host operations ``torch.profiler`` saw over the window, the calls'
spans, and the work each call carried.  Times are microseconds from the
trace's start, on the trace's own clock.

Kernels are told apart by name: ``qoa_encode`` and ``qoa_decode`` are the
program's QOA kernels (``csrc/qoa_encode.cu``, ``csrc/qoa_decode.cu``);
every other kernel and every memset is device glue; memcpys are copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

CALL_SPAN = "qoabench.call"
ENCODE_KERNEL = "qoa_encode"
DECODE_KERNEL = "qoa_decode"

Interval = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Op:
    device: int
    name: str
    start: float
    end: float

    @property
    def kind(self) -> str:
        if self.name.startswith("Memcpy"):
            return "memcpy"
        if ENCODE_KERNEL in self.name:
            return "encode"
        if DECODE_KERNEL in self.name:
            return "decode"
        return "glue"


@dataclasses.dataclass(frozen=True)
class HostOp:
    name: str
    start: float
    end: float


@dataclasses.dataclass(frozen=True)
class CallWork:
    """The work one call carried, from the shapes the benchmark made."""
    samples: int  # over all channels
    frame_chains: int  # frames x channels
    longest_steps: int  # 20 x windows of the longest chain


@dataclasses.dataclass
class Trace:
    ops: List[Op]
    host: List[HostOp]
    calls: List[Interval]
    work: List[CallWork]
    devices: List[int]
    sm_clock_mhz: float

    @property
    def window(self) -> Interval:
        return (self.calls[0][0], self.calls[-1][1])

    def device_ops(self, device: Optional[int] = None) -> List[Op]:
        return [o for o in self.ops if device is None or o.device == device]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] that the merged intervals leave uncovered."""
    out, t = [], lo
    for s, e in merged:
        if e <= t:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def busy_us(t: Trace, device: Optional[int] = None) -> float:
    lo, hi = t.window
    return covered(union([(o.start, o.end) for o in t.device_ops(device)]), lo, hi)


def from_profiler(prof) -> Tuple[List[Op], List[HostOp], List[Interval]]:
    """Device operations, host operations and the calls' spans of a
    stopped ``torch.profiler.profile``."""
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    ops, host, calls = [], [], []
    for e in results.events():
        s, t = (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            annotation = getattr(e, "is_user_annotation", lambda: False)()
            if not annotation and not name.startswith("qoabench."):
                ops.append(Op(int(e.device_index()), name, s, t))
        elif name == CALL_SPAN:
            calls.append((s, t))
        else:
            host.append(HostOp(name, s, t))
    return ops, host, sorted(calls)


def breakdown(t: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the cell's cards, each named by the host operation that
    covers most of it, where one covers half or more; otherwise the host
    was in Python that the profiler does not see (parse, staging,
    assembly)."""
    by_name: Dict[str, float] = {}
    for o in t.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = t.window
    idle = sorted(gaps(union([(o.start, o.end) for o in t.ops]), lo, hi),
                  key=lambda g: g[0] - g[1])[:top]
    named = []
    for a, b in idle:
        best, over = "", 0.0
        for h in t.host:
            ov = min(b, h.end) - max(a, h.start)
            if ov > over:
                best, over = h.name, ov
        share = round(100 * over / (b - a))
        label = f"{best} ({share}%)" if share >= 50 else (
            f"host Python outside profiled ops (most: {best} {share}%)" if best
            else "host Python outside profiled ops")
        named.append([label, (b - a) / 1e6])
    return {"device_ops": [[n, s / 1e6] for n, s in ops], "idle_gaps": named}
