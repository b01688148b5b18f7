"""The decode kernel's store-shape probe on the card.

    python -m qoaudio_tpu_torch.experiments.decode_variants

The counterpart of ``experiments/pallas_decode_variants.py::main``: the
fixture's frame x channel chains tiled to W=256 windows x N=32,768 chains
(167.8 M samples; ``v0`` writes 335.5 MB), decoded by each store mode of
``csrc/qoa_decode.cu`` at each block size:

* ``v0``        the production kernel's per-sample int16 stores;
* ``nostore``   the same recurrence with no sample stores — the compute
  ceiling;
* ``storeonly`` the codes stored, no LMS — the store cost;
* ``stack``     a window's 20 samples stored after its last step;
* ``pack32``    sample pairs packed into int32 stores.

Every mode is checked before it is timed: ``v0``, ``stack`` and unpacked
``pack32`` equal the production ``decode_chains_words``, ``nostore``'s
out[0, 0, :] its last sample, ``storeonly`` the codes.  Times are CUDA
events around single launches after 2 warm-up launches: best and median
of 10, in ms and Gsamples/s.  A device that is not CUDA is refused: the
probe times kernels, and the plain versions are held against them by
``chip_smoke.py``.
"""

from __future__ import annotations

import os
import statistics
import sys

import numpy as np
import torch

from .. import bitstream
from ..ops import cuda_decode, layout
from ..ops import decode as plain

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "julien_baker_sprained_ankle.qoa")
WINDOWS, CHAINS = 256, 32768
BLOCK_SIZES = cuda_decode.VARIANT_THREADS  # threads (chains) per block; 64 is production's
WARMUP, ITERS = 2, 10


def tiled_chains(fixture: str = FIXTURE, windows: int = WINDOWS,
                 chains: int = CHAINS):
    """The fixture's chains tiled to ``chains`` columns: (state int32
    (8, N), raw big-endian words int64 (W, N)) as numpy."""
    with open(fixture, "rb") as f:
        pa = bitstream.parse_file_arrays(f.read())
    idx = np.arange(chains) % pa.words_be.shape[1]
    words_be = np.ascontiguousarray(pa.words_be[:windows][:, idx]).view(np.int64)
    state = np.ascontiguousarray(pa.state[:, idx])
    return state, words_be


def check(mode: str, out: torch.Tensor, ref: torch.Tensor, codes: torch.Tensor) -> bool:
    """The probe's checks of one mode's output against the production
    decode ``ref`` and the codes."""
    if mode in ("v0", "stack"):
        return torch.equal(out, ref)
    if mode == "pack32":
        return torch.equal(plain.unpack_pack32(out), ref)
    if mode == "nostore":
        return torch.equal(out[0, 0], ref[-1, -1])
    return torch.equal(out, codes)


def _time(fn) -> list:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def run(device="cuda", windows: int = WINDOWS, chains: int = CHAINS,
        block_sizes=BLOCK_SIZES) -> dict:
    """Check and time every mode at every block size on ``device``;
    returns the results (raises if a check fails)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the probe times CUDA kernels; got device {device}")
    state, words_be = tiled_chains(windows=windows, chains=chains)
    st = torch.from_numpy(state).to(device)
    wb = torch.from_numpy(words_be).to(device)
    ref = cuda_decode.decode_chains_words(st, wb)
    codes = layout.unpack_words(layout.be_to_logical(wb))[1].to(torch.int16)
    samples = windows * 20 * chains
    results = []
    for threads in block_sizes:
        for mode in plain.VARIANT_MODES:
            out = cuda_decode.decode_chains_variant(st, wb, mode, threads)
            if not check(mode, out, ref, codes):
                raise AssertionError(f"{mode} at {threads} threads differs from the decode")
            del out
            ms = _time(lambda: cuda_decode.decode_chains_variant(st, wb, mode, threads))
            best, med = min(ms), statistics.median(ms)
            results.append({"mode": mode, "threads": threads, "best_ms": best,
                            "median_ms": med, "gsps_best": samples / best / 1e6,
                            "gsps_median": samples / med / 1e6, "all_ms": ms})
    return {"device": torch.cuda.get_device_name(device), "windows": windows,
            "chains": chains, "samples": samples, "results": results}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    res = run()
    print(f"{res['device']}: W={res['windows']} x N={res['chains']}, "
          f"{res['samples']} samples per launch")
    for r in res["results"]:
        print(f"threads={r['threads']:3d} {r['mode']:9s}: best {r['best_ms']:.4f} ms "
              f"({r['gsps_best']:.2f} Gsps), median {r['median_ms']:.4f} ms "
              f"({r['gsps_median']:.2f} Gsps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
