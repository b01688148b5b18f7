"""What one more decode launch costs the host, on the card.

    python -m qoaudio_tpu_torch.experiments.decode_calibration

The counterpart of ``experiments/pallas_decode_calibration.py``: the decode
kernel on the fixture's chains tiled to 256 windows x 32,768 chains (the
benchmark's decode section, parity-gated the same way), K launches in a row
with ONE synchronize at the end, for K in {1, 2, 4, 8, 16, 24}.  For each K
three times are taken around the same launches: the host clock until the
last launch call has returned (enqueue), the host clock until the
synchronize has returned (wall), and CUDA events around the K launches
(device).  A line fitted through wall against K gives the cost of one more
launch (slope) and the fixed cost of a timed window (intercept: the
synchronize and the clock reads).  The per-launch host overhead is the
enqueue time per launch: while it stays under the kernel's time the card
never waits for the host, and wall per launch equals device per launch.
It launches the production kernel and adds none.

OUTCOME (NVIDIA H100 80GB HBM3, 700.00 W; one run of this module, medians
of 3 per K):
    K= 1: wall 0.2800 ms, device 0.2714 ms a launch, enqueue 60.56 us a launch
    K= 2: wall 0.5224 ms, device 0.2572 ms a launch, enqueue 67.87 us a launch
    K= 4: wall 0.9060 ms, device 0.2243 ms a launch, enqueue 31.86 us a launch
    K= 8: wall 1.7559 ms, device 0.2179 ms a launch, enqueue 30.62 us a launch
    K=16: wall 3.4654 ms, device 0.2160 ms a launch, enqueue 28.27 us a launch
    K=24: wall 5.1683 ms, device 0.2149 ms a launch, enqueue 24.26 us a launch
    wall = 0.2122 ms x K + 0.0716 ms -> 790.8 Gsamples/s per launch.
    The per-launch host overhead is 24-68 us (the wrapper's checks, the
    output's allocation and the ctypes call), a quarter of the kernel's time
    at most, so the card never waits: wall per launch meets device per
    launch within 1% from K=4 on.  A launch alone reads 0.27 ms by events,
    launches back to back 0.215: the next launch's blocks fill the SMs
    while the last one's tail drains, so a single-launch timing overstates
    the kernel by a quarter.  The fixed cost of a timed window is 72 us.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from .. import bench

KS = (1, 2, 4, 8, 16, 24)


def run(device="cuda", sizes: bench.Sizes = bench.Sizes(), ks=KS, reps: int = 3) -> dict:
    """Per K (median over ``reps``): enqueue, wall and device seconds of
    the bench's decode launch (``sizes.decode_windows`` x
    ``sizes.decode_chains``); and the line through wall against K."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    data = bench.load_pcm()[0]
    launch, total = bench.gated_decode(data, device, sizes)
    for _ in range(2):  # both output buffers the loop alternates between exist
        launch()
    rows = []
    for K in ks:
        enq, wall, dev = [], [], []
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(device)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            o = None
            for _ in range(K):
                o = launch()
            t1 = time.perf_counter()
            if cuda:
                b.record()
                torch.cuda.synchronize(device)
            t2 = time.perf_counter()
            del o
            enq.append(t1 - t0)
            wall.append(t2 - t0)
            dev.append(a.elapsed_time(b) / 1e3 if cuda else t2 - t0)
        rows.append({"K": K, "enqueue_s": statistics.median(enq),
                     "wall_s": statistics.median(wall), "device_s": statistics.median(dev)})
    slope, icept = (np.polyfit([r["K"] for r in rows], [r["wall_s"] for r in rows], 1)
                    if len(rows) > 1 else (rows[0]["wall_s"] / rows[0]["K"], 0.0))
    return {"samples": total, "rows": rows, "slope_s": float(slope), "intercept_s": float(icept)}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_calibration: no CUDA device", file=sys.stderr)
        return 2
    print(bench.device_line("cuda"))
    r = run()
    for row in r["rows"]:
        K = row["K"]
        print(f"K={K:2d}: wall {row['wall_s'] * 1e3:.4f} ms ({row['wall_s'] / K * 1e3:.4f} a "
              f"launch), device {row['device_s'] / K * 1e3:.4f} ms a launch, enqueue "
              f"{row['enqueue_s'] / K * 1e6:.2f} us a launch")
    last = r["rows"][-1]
    print(f"wall = {r['slope_s'] * 1e3:.4f} ms x K + {r['intercept_s'] * 1e3:.4f} ms -> "
          f"{r['samples'] / r['slope_s'] / 1e9:.2f} Gsamples/s per launch; per-launch host "
          f"overhead (enqueue at K={last['K']}) {last['enqueue_s'] / last['K'] * 1e6:.2f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
