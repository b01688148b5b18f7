"""The transcode pipeline's device time, stage by stage, on the card.

    python -m qoaudio_tpu_torch.experiments.transcode_profile [bench] [saturated] [mixed]

The counterpart of ``experiments/tpu_transcode_profile.py``.  The stages of
``corpus._transcode_pipeline`` on the 32-file bench corpus (35.7 Msamples,
6,976 decode chains, 48 encode chains), each between CUDA events on the
pipeline's stream: the decode kernel, the relayout gather
(``_relayout_encode_input``, once per 64-frame chunk), ``_transcode_lens``
(once per masked chunk), the full-window and the masked encode launches,
and the packing (two concatenations and two gathers).  The events are
recorded around the pipeline's own calls while the transcode handle runs,
so the stages are the handle's, not a copy of them; what lies between two
stages (the host issuing the next one) is reported as ``gaps``, and the
stages' sum is held beside the handle's time without events.  Each encode
stage also gives its ns per dependent step (its time over the frames x 256
windows x 20 steps of its launches).  Before any timing every file is
gated against the native decode -> encode pair.  Arguments name the
corpora to profile (default ``bench``): ``saturated`` is the benchmark's
128 x 64-frame corpus (256 encode chains), ``mixed`` the 128 x 64 + 128 x
256-frame corpus of ``bucketed_transcode`` (512 chains).

OUTCOME (NVIDIA H100 80GB HBM3, 700.00 W; one run of this module with
``bench saturated mixed``; ms, medians of 5, calls in parentheses):
                  bench (48 chains)   saturated (256)   mixed (512)
    decode        0.2964 (1)          0.2677 (1)        0.6280 (1)
    relayout      0.4882 (4)          0.5607 (1)        3.8654 (4)
    lens          0.0937 (3)          - (0)             0.4011 (3)
    encode_full   24.0448 (1)         25.0246 (1)       25.2604 (1)
    encode_masked 69.6144 (3)         - (0)             81.5852 (3)
    pack          0.0771              0.1107            0.6993
    gaps          0.0875              0.0328            0.0724
    sum           94.6959             26.0152           112.3298
    handle        94.5654             26.0589           112.4353
    ns per step: full 73.38 / 76.37 / 77.09; masked 70.82 / - / 82.99.
    The two encode kernels are 98.9%, 96.2% and 95.1% of the pipeline; the
    glue (relayout, lens, packing) is 0.7%, 2.6% and 4.4% and grows with
    the bytes it moves (3.87 ms of gathers for 1.34 GB read and written at
    512 chains), the decode kernel 0.3-1.0%.  The stamps cost nothing that
    shows: sum and unstamped handle agree within 0.2%.  The encoder's step
    hardly grows from 48 to 512 chains (one warp a scheduler at most), but
    the masked kernel's grows more (70.8 -> 83.0 ns) than the full one's
    (73.4 -> 77.1).  The decode launch reads 0.27-0.30 ms here against
    0.14-0.16 through its wrapper alone at the bench corpus's shape: the
    first launch of a run also pays for its output's allocation.
"""

from __future__ import annotations

import contextlib
import statistics
import sys
import time

import torch

from .. import bench
from ..ops import cuda_decode, cuda_encode
from ..parallel import corpus
from ..utils.timing import time_calls
from ..utils.transfer import fetch_arrays
from .bucketed_transcode import mixed_spec

# stage -> (module, function) whose calls it times
STAGE_CALLS = {
    "decode": (cuda_decode, "decode_chains_words"),
    "relayout": (corpus, "_relayout_encode_input"),
    "lens": (corpus, "_transcode_lens"),
    "encode_full": (cuda_encode, "encode_frames_full"),
    "encode_masked": (cuda_encode, "encode_frames"),
}
STAGES = (*STAGE_CALLS, "pack")
CORPORA = {"bench": bench.bench_spec, "saturated": bench.saturated_spec, "mixed": mixed_spec}


class _Marks:
    """Time stamps on ``device``'s current stream: CUDA events on a card
    (read after one synchronize), the host clock on the CPU."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stamps = []

    def stamp(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
        else:
            ev = time.perf_counter()
        self.stamps.append(ev)
        return len(self.stamps) - 1

    def seconds(self, i: int, j: int) -> float:
        a, b = self.stamps[i], self.stamps[j]
        return a.elapsed_time(b) / 1e3 if self.device.type == "cuda" else b - a


@contextlib.contextmanager
def _stamped(marks: _Marks, spans: list):
    """Stamp before and after every call of the pipeline's stages; each
    call appends (stage, stamp before, stamp after, dependent steps of an
    encode launch) to ``spans``."""
    saved = {k: getattr(mod, name) for k, (mod, name) in STAGE_CALLS.items()}

    def around(stage, fn):
        def call(*args, **kw):
            i = marks.stamp()
            out = fn(*args, **kw)
            steps = 0
            if stage.startswith("encode"):  # args: state, samples (F, W, 20, N)[, lens]
                steps = args[1].shape[0] * args[1].shape[1] * args[1].shape[2]
            spans.append((stage, i, marks.stamp(), steps))
            return out
        return call

    for k, (mod, name) in STAGE_CALLS.items():
        setattr(mod, name, around(k, saved[k]))
    try:
        yield
    finally:
        for k, (mod, name) in STAGE_CALLS.items():
            setattr(mod, name, saved[k])


def profile_handle(handle, device, iters: int = 5) -> dict:
    """One warm run, then ``iters`` stamped runs of ``handle``: per stage
    the median seconds, and in ``calls`` and ``steps`` its calls and its
    dependent steps per run; ``total`` (first stamp to last), ``gaps``
    (total minus the stages), and ``handle`` (the median of ``iters`` runs
    without stamps)."""
    device = torch.device(device)
    handle()
    runs, calls, steps = [], None, None
    for _ in range(iters):
        marks, spans = _Marks(device), []
        with _stamped(marks, spans):
            first = marks.stamp()
            handle()
            last = marks.stamp()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t = {s: 0.0 for s in STAGES}
        for stage, i, j, _ in spans:
            t[stage] += marks.seconds(i, j)
        t["pack"] = marks.seconds(spans[-1][2], last)  # after the last encode
        t["total"] = marks.seconds(first, last)
        t["gaps"] = t["total"] - sum(t[s] for s in STAGES)
        runs.append(t)
        calls = {s: sum(1 for sp in spans if sp[0] == s) for s in STAGE_CALLS}
        steps = {s: sum(sp[3] for sp in spans if sp[0] == s) for s in STAGE_CALLS}
    out = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    out["calls"], out["steps"] = calls, steps
    out["handle"] = statistics.median(time_calls(handle, device=device, warmup=0,
                                                 iters=iters)[0])
    return out


def profile_streams(streams, device, iters: int = 5) -> dict:
    """Gate ``streams`` against the native pair, then profile their
    transcode handle on ``device``."""
    got, handle = corpus.batch_transcode(streams, device, bucket=False,
                                         return_fused_handle=True)
    for i, s in enumerate(streams):
        if got[i] != bench.native_pair(s):
            bench.parity_failure(f"batch_transcode != native pair (file {i})")
    if handle.assemble(*fetch_arrays(handle())) != got:
        bench.parity_failure("the handle's re-run gives other bytes")
    return profile_handle(handle, device, iters)


def run(device="cuda", spec=None, iters: int = 5) -> dict:
    """Build the corpus ``spec`` (default: the bench corpus), gate it and
    profile its transcode handle on ``device``."""
    spec = bench.bench_spec() if spec is None else spec
    _, pcm, channels, _ = bench.load_pcm()
    streams, total = bench.build_corpus(pcm.reshape(-1, channels), spec)
    out = profile_streams(streams, device, iters)
    out["samples"] = total
    out["chains"] = sum(ch for _, ch, _ in spec)
    return out


def describe(r: dict) -> str:
    """One line: each stage's ms (calls), their sum with the gaps, and the
    handle's time without stamps."""
    def calls(s):
        if s not in r["calls"]:
            return ""
        per_step = f", {r[s] * 1e9 / r['steps'][s]:.2f} ns per step" if r["steps"][s] else ""
        return f" ({r['calls'][s]}{per_step})"

    parts = [f"{s} {r[s] * 1e3:.4f} ms{calls(s)}" for s in STAGES]
    return (", ".join(parts) + f"; gaps {r['gaps'] * 1e3:.4f} ms; sum {r['total'] * 1e3:.4f} "
            f"ms; handle without stamps {r['handle'] * 1e3:.4f} ms")


def main(argv=None) -> int:
    names = list(sys.argv[1:] if argv is None else argv) or ["bench"]
    unknown = [n for n in names if n not in CORPORA]
    if unknown:
        print(f"transcode_profile: unknown corpus {unknown}; one of {sorted(CORPORA)}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("transcode_profile: no CUDA device", file=sys.stderr)
        return 2
    print(bench.device_line("cuda"))
    for name in names:
        r = run(spec=CORPORA[name]())
        print(f"{name} corpus, {r['samples'] / 1e6:.1f} Msamples, {r['chains']} encode chains, "
              f"median of 5 runs: " + describe(r))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
