"""Length-bucketed ``batch_transcode`` against one call, on the card.

    python -m qoaudio_tpu_torch.experiments.bucketed_transcode

The counterpart of ``experiments/tpu_bucketed_transcode.py``.  Corpus: 256
stereo files, 128 x 64 frames and 128 x 256 frames (419.4 Msamples, 512
encode chains, about 0.84 GB of decoded PCM on the card).  One call pads
every chain to the longest file's 256 frames; ``bucket="auto"`` may split
the corpus by length where ``corpus._length_buckets`` finds that it cuts
padded encode work by 1/0.75.  The cost model is the card's
(``corpus._bucket_model``): all chains of one resident wave run at once,
so a corpus under one wave costs its longest chain whatever it pads, and
the model need not cut.  What it chose is printed, with the model's
numbers, and both ways are timed whatever it chose: end to end (median of
``iters`` warm calls) and the device side (the handle's re-run, CUDA
events).  Parity: ``"auto"`` equals ``False`` byte for byte, and four files
equal the native decode -> encode pair.

OUTCOME (NVIDIA H100 80GB HBM3, 700.00 W; one run of this module, medians
of 3):
    the cost model chose ONE CALL: 512 encode chains against an e_mult of
    4,224 (one resident wave) are 1 step of e_mult; one call costs 256
    frames x 4,224 + 4,224 lane-frames of overhead, and no partition comes
    within 0.75 of that: every chain runs at once, so padding costs nothing.
    bucket=False : device pipeline 112.528 ms = 3727.3 Msps; end to end 529.316 ms = 792.4 Msps
    bucket="auto": device pipeline 112.584 ms = 3725.5 Msps; end to end 710.591 ms = 590.3 Msps
    parity: byte for byte identical; 4 files == the native pair.
    "auto" made the same single call, so the two device times agree to
    0.05%; the end-to-end times differ by host noise alone (the same code
    ran twice; 256 files of staging and 4 fetches of up to 84 MB).  The
    model is right not to cut here: 112.5 ms is the longest chain's 256
    frames at 0.44 ms a frame, which no partition shortens.
"""

from __future__ import annotations

import math
import sys

import torch

from .. import bench
from .. import bitstream as bs
from .. import format as fmt
from ..parallel import Mesh, corpus
from ..utils.timing import Stopwatch, time_calls
from .lane_saturated import spot


def mixed_spec(n_each: int = 128, short_frames: int = 64, long_frames: int = 256) -> tuple:
    return ((short_frames * fmt.QOA_FRAME_LEN, 2, 44100),) * n_each + (
        (long_frames * fmt.QOA_FRAME_LEN, 2, 48000),) * n_each


def describe_choice(parsed, device, chunk_frames: int = 64) -> tuple:
    """What ``_length_buckets`` chooses for these files on ``device`` and
    the model's numbers behind it: (segs or None, text)."""
    e_mult, overhead = corpus._bucket_model(Mesh((torch.device(device),)))
    frames = [p.n_frames for p in parsed]
    chans = [p.channels for p in parsed]
    segs = corpus._length_buckets(frames, chans, e_mult, chunk_frames, overhead)
    waves = math.ceil(sum(chans) / e_mult)
    text = (f"cost model: {sum(chans)} encode chains, e_mult {e_mult} (chains that cost as "
            f"one) -> {waves} step(s) of e_mult; one call costs {max(frames)} frames x "
            f"{waves * e_mult} + {overhead:.0f} lane-frames of overhead; ")
    if segs is None:
        text += ("no partition comes within 0.75 of that" + (
            ": every chain runs at once, so padding costs nothing" if waves == 1 else "")
            + " -> one call")
    else:
        text += "buckets: " + "; ".join(
            f"{len(g)} files, {max(frames[i] for i in g)} frames max" for g in segs)
    return segs, text


def run(device="cuda", spec=None, iters: int = 3) -> dict:
    """Gate, then time ``bucket=False`` and ``bucket="auto"`` on ``device``."""
    _, pcm, channels, _ = bench.load_pcm()
    with Stopwatch() as sw:
        streams, total = bench.build_corpus(pcm.reshape(-1, channels),
                                            mixed_spec() if spec is None else spec)
    bench.log(f"corpus: {len(streams)} files, {total / 1e6:.1f} Msamples, "
              f"{sum(len(s) for s in streams) / 1e6:.1f} MB compressed (built in "
              f"{sw.elapsed:.1f} s)")
    segs, text = describe_choice([bs.parse_file_arrays(s) for s in streams], device)
    bench.log(text)
    out = {"samples": total, "buckets": None if segs is None else [len(g) for g in segs],
           "choice": text}
    outs = {}
    for label, bucket in (("single", False), ("auto", "auto")):
        with Stopwatch(device) as sw:
            outs[label], handle = corpus.batch_transcode(streams, device, bucket=bucket,
                                                         return_fused_handle=True)
        bench.log(f"{label}: warm call {sw.elapsed:.3f} s")
        if label == "single":
            for i in spot(len(streams)):
                if outs[label][i] != bench.native_pair(streams[i]):
                    bench.parity_failure(f"batch_transcode != native pair (file {i})")
        elif outs["auto"] != outs["single"]:
            bench.parity_failure("bucket='auto' != bucket=False")
        times = []
        for _ in range(iters):
            with Stopwatch(device) as sw:
                corpus.batch_transcode(streams, device, bucket=bucket)
            times.append(sw.elapsed)
        out[label + "_e2e_msps"] = bench.rate(f"{label}: end to end", times, total)
        times, _ = time_calls(handle, device=device, warmup=1, iters=iters)
        out[label + "_chip_msps"] = bench.rate(f"{label}: device pipeline (handle)",
                                               times, total)
        del handle
    bench.log("parity: bucket='auto' == bucket=False byte for byte; 4 files == native pair")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bucketed_transcode: no CUDA device", file=sys.stderr)
        return 2
    print(bench.device_line("cuda"))
    r = run()
    print(r["choice"])
    for label in ("single", "auto"):
        print(f"{label}: device pipeline {r['samples'] / r[label + '_chip_msps'] / 1e3:.3f} ms "
              f"= {r[label + '_chip_msps']:.1f} Msps; end to end "
              f"{r['samples'] / r[label + '_e2e_msps'] / 1e3:.3f} ms = "
              f"{r[label + '_e2e_msps']:.1f} Msps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
