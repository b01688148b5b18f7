"""Transcode rate at a few encode chains against many, on the card.

    python -m qoaudio_tpu_torch.experiments.lane_saturated

The counterpart of ``experiments/tpu_lane_saturated.py``.  Two corpora in
one process, both built by the benchmark's recipes (``bench.build_corpus``):

* the 32-file bench corpus: 48 encode chains, the frame count pinned by
  the longest file (256 frames), 35.7 Msamples;
* the saturated corpus: 128 stereo files x 64 frames, 256 encode chains of
  one length, 83.9 Msamples.

Each is spot-checked against the native decode -> encode pair (4 files),
then timed: end to end (bytes in -> bytes out, median of 5 warm calls) and
the device side alone (the transcode handle's re-run, CUDA events, median
of 5).  On this card every chain of either corpus is resident at once (one
wave holds 4,224), so a corpus costs its longest chain's steps: the rate
should grow with samples per step, not with any tile's occupancy.

OUTCOME (NVIDIA H100 80GB HBM3, 700.00 W; one run of this module, all
numbers medians of 5):
    bench corpus     (32 files, 48 chains, 256 frames max, 35.7 Msamples):
        device pipeline 94.266 ms = 378.9 Msps; end to end 129.061 ms = 276.7 Msps
    saturated corpus (128 files, 256 chains, 64 frames, 83.9 Msamples):
        device pipeline 26.027 ms = 3223.1 Msps; end to end 186.294 ms = 450.3 Msps
    -> 8.51x the samples per second on the device: 5.3x the chains over a
       quarter of the steps, every chain resident either way, so the rate
       follows samples per serial step (0.368 ms a frame against 0.407).
       End to end only 1.63x: the host's share grows from 35 ms to 160 ms
       (128 files to parse, stage and assemble; the benchmark's saturated
       section read 105.8 ms end to end for the same corpus in another
       process on the same card, so this share moves by tens of ms from run
       to run).
"""

from __future__ import annotations

import sys

import torch

from .. import bench


def spot(n_files: int) -> list:
    """Four files spread over the corpus."""
    return list(range(0, n_files, max(1, n_files // 4)))[:4]


def run(device="cuda", specs=None, iters: int = 5) -> dict:
    """Gate and time each corpus of ``specs`` (label -> spec; default: the
    bench corpus and the saturated corpus) on ``device``; returns label ->
    {"files", "samples", "e2e_msps", "chip_msps"}."""
    if specs is None:
        specs = {"bench corpus": bench.bench_spec(), "saturated corpus": bench.saturated_spec()}
    _, pcm, channels, _ = bench.load_pcm()
    stereo = pcm.reshape(-1, channels)
    corpora = {label: bench.build_corpus(stereo, spec) for label, spec in specs.items()}
    out = {}
    for label, (streams, total) in corpora.items():
        e2e, chip = bench.transcode_rates(label, streams, total, device,
                                          spot(len(streams)), iters)
        out[label] = {"files": len(streams), "samples": total, "e2e_msps": e2e,
                      "chip_msps": chip}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("lane_saturated: no CUDA device", file=sys.stderr)
        return 2
    print(bench.device_line("cuda"))
    res = run()
    for label, r in res.items():
        print(f"{label}: {r['files']} files, {r['samples'] / 1e6:.1f} Msamples: device "
              f"pipeline {r['samples'] / r['chip_msps'] / 1e3:.3f} ms = {r['chip_msps']:.1f} "
              f"Msps; end to end {r['samples'] / r['e2e_msps'] / 1e3:.3f} ms = "
              f"{r['e2e_msps']:.1f} Msps")
    a, b = list(res.values())[:2]
    print(f"the second corpus moves {b['chip_msps'] / a['chip_msps']:.2f}x the first's "
          f"samples per second on the device, {b['e2e_msps'] / a['e2e_msps']:.2f}x end to end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
