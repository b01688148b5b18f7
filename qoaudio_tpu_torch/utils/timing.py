"""Timing helpers that know about CUDA's asynchronous launches.

Port of ``qoaudio_tpu/utils/timing.py`` (``Stopwatch``, ``bench_fn``,
``profiler_trace``).  On a CUDA device, a host clock read right after a
launch measures only the enqueue, so the timers synchronise, and device
time comes from CUDA events.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _cuda_devices(where) -> list:
    """The distinct CUDA devices of ``where``: None, one device, or a mesh
    (anything with ``.devices``)."""
    if where is None:
        return []
    devs = getattr(where, "devices", (where,))
    out = []
    for d in devs:
        d = torch.device(d)
        if d.type == "cuda" and d not in out:
            out.append(d)
    return out


class Stopwatch:
    """Wall-clock timer with samples/sec reporting.

    ``device`` is one device or a mesh.  The clock starts and stops after
    a ``torch.cuda.synchronize`` of every CUDA device among them, so
    ``elapsed`` covers their work; with exactly one CUDA device
    ``device_ms`` holds the CUDA-event time between the same points.
    """

    def __init__(self, device=None):
        self.device = device
        self.elapsed = 0.0
        self.device_ms: Optional[float] = None
        self._cuda = _cuda_devices(device)
        self._t0 = None
        self._ev = None

    def __enter__(self):
        for d in self._cuda:
            torch.cuda.synchronize(d)
        if len(self._cuda) == 1:
            stream = torch.cuda.current_stream(self._cuda[0])
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record(stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._ev is not None:
            self._ev[1].record(torch.cuda.current_stream(self._cuda[0]))
        for d in self._cuda:
            torch.cuda.synchronize(d)
        if self._ev is not None:
            self.device_ms = self._ev[0].elapsed_time(self._ev[1])
        self.elapsed = time.perf_counter() - self._t0
        return False

    def msamples_per_sec(self, n_samples: int) -> float:
        return n_samples / self.elapsed / 1e6 if self.elapsed else float("inf")


def time_calls(fn, *args, device=None, warmup: int = 1, iters: int = 5):
    """Time ``iters`` calls of ``fn(*args)`` after ``warmup`` calls; returns
    (seconds of each timed call, last result).  On a CUDA ``device`` each
    call is timed by CUDA events around it (device time of the launches it
    makes, host gaps included); elsewhere by the host clock."""
    result = None
    cuda = _is_cuda(device)
    for _ in range(warmup):
        result = fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            result = fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            result = fn(*args)
            times.append(time.perf_counter() - t0)
    return times, result


def bench_fn(fn, *args, device=None, warmup: int = 1, iters: int = 3):
    """:func:`time_calls`, reduced to (best_seconds, result)."""
    times, result = time_calls(fn, *args, device=device, warmup=warmup, iters=iters)
    return min(times), result


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Optionally wrap a block in a ``torch.profiler`` trace.

    ``None`` or empty: a no-op.  Otherwise CPU activities and, with a CUDA
    device present, CUDA activities are recorded, and a Chrome trace
    (``trace-<pid>.json``) is written into ``log_dir`` when the block
    ends.  Yields the profiler (``key_averages()`` sums by operation), or
    None when off."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}.json"))
