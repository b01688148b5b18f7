"""One run of one cell: set-up, the measured window, the judge, the
metrics.

Set-up makes the pool of files from the seed, the entry's inputs, and one
warm call on the cell's first call; the window then makes calls back to
back, one caller (a closed loop, as a batch job waits for each batch),
from the pool in order, until ``seconds`` have passed.  A call is timed
on the host clock from entry to the bytes returned: the program's entry
points fetch their results, so no device work is left behind.  Once the
window has closed, a sample of the calls drawn from the seed is judged
against the frozen reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from . import generate, judge, roofline
from . import trace as tr
from .spec import Cell, reader


# calls of a window that the judge reads, drawn from the seed
CHECK_CALLS = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Call:
    files: List[int]
    start: float
    end: float
    ok: bool


def _sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def _place(devices):
    if len(devices) == 1:
        return {"device": devices[0]}
    from qoaudio_tpu_torch.parallel import make_mesh
    return {"mesh": make_mesh(devices=devices)}


def _counters() -> Dict[str, int]:
    from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
    from qoaudio_tpu_torch.parallel import corpus
    return {"decode_launches": cuda_decode.launches,
            "masked_encode_launches": cuda_encode.masked_launches,
            "full_encode_launches": cuda_encode.full_launches,
            "host_pair_files": corpus.host_pair_files}


class _Clocks:
    """SM clocks sampled by ``nvidia-smi`` beside the window."""

    def __init__(self, devices):
        self.index = [torch.device(d).index for d in devices if torch.device(d).type == "cuda"]
        self.proc = None
        self.mhz: Optional[float] = None

    def start(self) -> None:
        if self.index:
            with contextlib.suppress(OSError):
                self.proc = subprocess.Popen(
                    ["nvidia-smi", "--query-gpu=index,clocks.sm", "--format=csv,noheader,nounits",
                     "-lms", "500"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> None:
        if self.proc is None:
            return
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = []
        for line in out.splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 2 and parts[0].isdigit() and int(parts[0]) in self.index:
                with contextlib.suppress(ValueError):
                    vals.append(float(parts[1]))
        self.mhz = sum(vals) / len(vals) if vals else None


def card_line(devices) -> str:
    """The cards' names and power limits, for the log."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit,clocks.max.sm",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return " | ".join(r.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def _work(pool: generate.Pool, files) -> tr.CallWork:
    fs = [pool.files[i] for i in files]
    return tr.CallWork(samples=sum(f.samples * f.channels for f in fs),
                       frame_chains=sum(f.frames * f.channels for f in fs),
                       longest_steps=max(20 * -(-f.samples // 20) for f in fs))


def end_to_end(name: str, entry: str, calls: List[Call], pool, window_start: float,
               setup_s: float) -> float:
    """An end-to-end metric by its name: ``setup_s``; ``<entry>_msps``,
    the samples of all files of the calls the window completed over the
    time from the window's start to the end of its last completed call;
    ``<entry>_p<q>_ms``, the q-th percentile of the latency of every call
    of the window, a failed call counting as the whole window.  A name
    ``<metric>.<group>`` is ``<metric>`` for a group of cells whose runs
    spread so differently from the others' that it carries a bound of its
    own."""
    name = name.split(".")[0]
    if name == "setup_s":
        return setup_s
    done = [c for c in calls if c.ok]
    if name == f"{entry}_msps":
        samples = sum(pool.files[i].samples * pool.files[i].channels for c in done for i in c.files)
        return samples / 1e6 / (done[-1].end - window_start)
    m = re.fullmatch(rf"{entry}_p(\d+)_ms", name)
    if m:
        span = calls[-1].end - window_start
        lat = sorted((c.end - c.start) if c.ok else span for c in calls)
        return 1e3 * lat[math.ceil(int(m.group(1)) / 100 * len(lat)) - 1]
    raise KeyError(f"no end-to-end metric {name!r} for entry {entry!r}")


def build_inputs(cell: Cell, seed: int, device, stages=None):
    """The pool, the entry's inputs and each distinct call's files."""
    stages = [] if stages is None else stages
    pool = generate.make_pool(cell.config, cell.traffic, seed)
    pcm = generate.synth(pool, seed, device)
    _sync([device])
    stages.append(("content", time.perf_counter()))
    inputs = cell.entry.prepare(pool, pcm)
    del pcm
    stages.append(("inputs", time.perf_counter()))
    return pool, inputs, pool.units


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, devices: List[str],
             t_start: float) -> dict:
    """One run; returns the result line (the ``checks`` key last)."""
    entry = cell.entry
    dev0 = devices[0]
    stages = [("import", time.perf_counter())]
    pool, inputs, calls_files = build_inputs(cell, seed, dev0, stages)
    place = _place(devices)
    entry.call(inputs, calls_files[0], place)
    _sync(devices)
    stages.append(("warm call", time.perf_counter()))
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start
    marks = [t_start] + [t for _, t in stages]
    log(f"setup: {setup_s:.3f} s (" + ", ".join(
        f"{n} {b - a:.3f}" for (n, _), a, b in zip(stages, marks, marks[1:]))
        + f"); {len(pool.files)} files in {len(calls_files)} distinct calls")

    before = _counters()
    rng = np.random.default_rng([seed, 7])
    kept: List[tuple] = []  # (files, outputs) of the calls the judge reads
    calls: List[Call] = []
    prof = clocks = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        clocks = _Clocks(devices)
        clocks.start()
        prof = profile(activities=acts)
        prof.start()
    window_start = time.perf_counter()
    deadline = window_start + seconds
    k = 0
    while not calls or time.perf_counter() < deadline:
        files = calls_files[k % len(calls_files)]
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(tr.CALL_SPAN):
                out = entry.call(inputs, files, place)
            ok = True
        except Exception:  # a failed call is counted and the loop goes on
            log(traceback.format_exc())
            out, ok = None, False
        t1 = time.perf_counter()
        calls.append(Call(files, t0, t1, ok))
        if ok:
            n_ok = sum(c.ok for c in calls)
            if len(kept) < CHECK_CALLS:
                kept.append((files, out))
            else:
                j = int(rng.integers(0, n_ok))
                if j < CHECK_CALLS:
                    kept[j] = (files, out)
        del out
        k += 1
    _sync(devices)
    if traced:
        prof.stop()
        clocks.stop()
    after = _counters()
    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    moved = {n: after[n] - before[n] for n in after}
    log("counters over the window: " + ", ".join(f"{n} +{v}" for n, v in moved.items()))
    failed = sum(not c.ok for c in calls)
    lat = [1e3 * (c.end - c.start) for c in calls]
    if len(lat) >= 4:
        q = statistics.quantiles(lat, n=4)
        half = len(lat) // 2
        log(f"latency ms: min {min(lat):.1f}, quartiles {q[0]:.1f} {q[1]:.1f} {q[2]:.1f}, "
            f"max {max(lat):.1f}; mean of first half {statistics.mean(lat[:half]):.1f}, "
            f"second half {statistics.mean(lat[half:]):.1f}; gaps between calls "
            f"{1e3 * sum(b.start - a.end for a, b in zip(calls, calls[1:])) / len(calls):.2f} ms a call")
    log(f"window: {len(calls)} calls, {failed} failed, "
        f"{calls[-1].end - window_start:.3f} s; cards: {card_line(cuda) if cuda else 'none'}")

    result = {"correct": False, "attempted": len(calls), "failed": failed}
    metrics: Dict[str, dict] = {}
    if not traced:
        for m in cell.end_to_end:
            v = end_to_end(m["name"], cell.traffic["entry"], calls, pool, window_start, setup_s)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        ops, host, spans = tr.from_profiler(prof)
        del prof
        if len(spans) != len(calls):
            raise RuntimeError(f"trace holds {len(spans)} calls of {len(calls)}")
        lo, hi = spans[0][0], spans[-1][1]
        ops = [o for o in ops if o.end > lo and o.start < hi]
        index = sorted({torch.device(d).index or 0 for d in devices})
        mhz = clocks.mhz or roofline.MAX_SM_CLOCK_MHZ
        log(f"SM clock beside the window: {clocks.mhz} MHz (bound at {mhz} MHz)")
        t = tr.Trace(ops, host, spans, [_work(pool, c.files) for c in calls], index, mhz)
        for m in cell.per_layer:
            v = reader(m["name"]).read(t)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = sum(tr.busy_us(t, d) for d in index) / len(index) / 1e6
        result["breakdown"] = tr.breakdown(t)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(cuda[0]) if cuda else "cpu",
              "count": len(devices), "memory_peak_bytes": int(peak)}
    if traced:
        device["busy_s"] = busy
        device["window_s"] = (hi - lo) / 1e6
    result["metrics"] = metrics
    result["device"] = device

    for d in cuda:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    counts = {"files": 0, "frames": 0, "files_wrong": 0, "frames_wrong": 0, "rounds": 0}
    for files, out in kept:
        x = entry.chains(pool, inputs, files, dev0)
        if x is None:
            raise RuntimeError("judge: the benchmark's own inputs do not parse")
        c = judge.compare([pool.files[i] for i in files], x, out)
        del x
        for n in counts:
            counts[n] = max(counts[n], c.get(n, 0)) if n == "rounds" else counts[n] + c.get(n, 0)
    log(f"judge: {len(kept)} calls, {counts['files']} files, {counts['frames']} frames, "
        f"{counts['rounds']} rounds of carried states, {time.perf_counter() - t_judge:.3f} s")
    checks = {"failed_calls": failed, "files_wrong": counts["files_wrong"],
              "frames_wrong": counts["frames_wrong"]}
    result["correct"] = bool(kept) and all(v == 0 for v in checks.values())
    result["checks"] = {n: {"value": v, "limit": 0} for n, v in checks.items()}
    return result
