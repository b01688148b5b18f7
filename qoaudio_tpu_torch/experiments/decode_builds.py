"""Several builds of the decode kernel side by side on one card.

    python -m qoaudio_tpu_torch.experiments.decode_builds NAME=SOURCE.cu[,FLAG...] ...

Each SOURCE is a decode source with ``csrc/qoa_decode.cu``'s C interface:
this tree's, an older commit's (``git show COMMIT:.../qoa_decode.cu``), or
a copy with the step written another way (FLAGs such as ``-DNAME=1`` pick
among forms one copy holds).  With no argument it takes this tree's
source alone.  Every build is compiled by ``nvcc`` with the port's flags
(all started together) into ``build/decode_builds/``, then:

* ``ptxas -v``: registers and spills of the production kernel (store mode
  ``v0``, 64 threads) and whether any instantiation spills;
* ``cuobjdump -sass``: the production kernel's hottest loop per window
  (instructions, ALU- and FMA-pipe operations) and its dependent path per
  step (``utils/roofline.py``);
* checked: the production decode on a wrap-regime input (random words,
  weights over all of int32) and every store mode at 64 threads on the
  timed input equal the plain versions (``ops/decode.py``);
* timed as the store probe times (``decode_variants``: CUDA events around
  single launches, best and median of 10 after 2 warm-up launches), the
  builds in turns and then in the reverse order: the
  production decode on the fixture's chains tiled to the smoke corpus's
  shape (W=256 x N=7,912), with ``nostore``, ``stack`` and ``pack32`` at
  64 threads beside it, and ``v0``, ``nostore`` and ``storeonly`` at 64
  threads on the store probe's shape (W=256 x N=32,768).

It prints one line per build and round, and the card's name and power
limit first.  A device that is not CUDA is refused.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops import decode as plain
from ..utils import roofline
from . import decode_variants

OUT_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "decode_builds")
MAIN_PATH_CHAINS = 7912  # the smoke corpus's decode chains
PROBE_MODES = ("v0", "nostore", "storeonly")
MAIN_MODES = ("nostore", "stack", "pack32")  # beside the production decode, at its shape
PRODUCTION = "qoa_decode_kernelILi0ELi64E"  # store mode v0, 64 threads
WINDOW_LOAD = r"LDG\.E\.64"  # one per window, plain or through the read-only path


def parse_spec(spec: str) -> tuple:
    """``NAME=SOURCE.cu[,FLAG...]`` -> (name, source, flags)."""
    name, _, rest = spec.partition("=")
    if not rest:
        raise ValueError(f"want NAME=SOURCE.cu[,FLAG...], got {spec!r}")
    source, *flags = rest.split(",")
    return name, source, tuple(flags)


def build_all(specs) -> dict:
    """name -> (library path, ptxas report); one nvcc per build, all
    started together."""
    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise _build.BuildFailed("nvcc not found")
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = {}
    for name, source, flags in specs:
        lib = os.path.join(OUT_DIR, f"{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o", lib, source]
        procs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (lib, cmd, proc) in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise _build.BuildFailed(f"nvcc failed: {' '.join(cmd)}\n{out}\n{err}")
        built[name] = (lib, err)
    return built


def registers(report: str) -> tuple:
    """((registers, spill bytes) of the production kernel, most spill
    bytes of any kernel) from ``ptxas -v``."""
    regs = _build.ptxas_registers(report)
    (prod,) = [v for k, v in regs.items() if PRODUCTION in k]
    return prod, max(spill for _, spill in regs.values())


def sass_counts(lib: str) -> tuple:
    """(``sass_loop``, ``sass_chain``) of the production kernel."""
    cuobjdump = roofline.find_cuobjdump(_build.find_nvcc())
    funcs = roofline.sass_functions(lib, cuobjdump)
    (sass,) = [v for k, v in funcs.items() if PRODUCTION in k]
    return (roofline.sass_loop(sass, WINDOW_LOAD, 1),
            roofline.sass_chain(sass, WINDOW_LOAD, 1, 20))


class Library:
    """One build's C entry points on torch tensors."""

    def __init__(self, path: str):
        self.lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib.qoa_decode_chains_cuda.argtypes = [p, p, i, i, p, p]
        self.lib.qoa_decode_chains_cuda.restype = i
        self.lib.qoa_decode_variant_cuda.argtypes = [p, p, i, i, p, i, i, p]
        self.lib.qoa_decode_variant_cuda.restype = i

    def decode(self, state, words_be, mode=None, threads=64):
        n_win, n_ch = words_be.shape
        _build.require(words_be, "words_be", torch.int64, (n_win, n_ch))
        _build.require(state, "state", torch.int32, (8, n_ch))
        pack = mode == "pack32"
        out = torch.empty((n_win, 10 if pack else 20, n_ch), device=state.device,
                          dtype=torch.int32 if pack else torch.int16)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        if mode is None:
            rc = self.lib.qoa_decode_chains_cuda(words_be.data_ptr(), state.data_ptr(),
                                                 n_win, n_ch, out.data_ptr(), stream)
        else:
            rc = self.lib.qoa_decode_variant_cuda(
                words_be.data_ptr(), state.data_ptr(), n_win, n_ch, out.data_ptr(),
                plain.VARIANT_MODES.index(mode), threads, stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return out


def _time(fn) -> tuple:
    """(best, median) ms of the probe's timing of ``fn``."""
    ms = decode_variants._time(fn)
    return min(ms), statistics.median(ms)


def check(name: str, lib: Library, st, wb, dev) -> None:
    """Raise unless the build equals the plain versions."""
    rng = np.random.default_rng(2026)
    W, N = 64, 4097  # ragged: not a multiple of any block
    wl = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(np.uint64) | (
        rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    state = np.concatenate([rng.integers(-32768, 32768, size=(4, N)),
                            rng.integers(-(1 << 31), 1 << 31, size=(4, N))]).astype(np.int32)
    s = torch.from_numpy(state).to(dev)
    w = torch.from_numpy(wl.byteswap().view(np.int64)).to(dev)
    if not torch.equal(lib.decode(s, w), plain.decode_chains_words(s, w)):
        raise AssertionError(f"{name}: production decode != plain on the wrap-regime input")
    s1, w1 = s[:, :1].contiguous(), w[:1, :1].contiguous()
    if not torch.equal(lib.decode(s1, w1), plain.decode_chains_words(s1, w1)):
        raise AssertionError(f"{name}: production decode != plain at W=1, N=1")
    want = plain.decode_chains_words(st, wb)
    for mode in plain.VARIANT_MODES:
        got = lib.decode(st, wb, mode)
        ref = plain.decode_chains_variant(st, wb, mode) if mode in ("storeonly", "pack32") \
            else want
        ok = torch.equal(got[0, 0], ref[-1, -1]) if mode == "nostore" else torch.equal(got, ref)
        if not ok:
            raise AssertionError(f"{name}: {mode} != plain on the timed input")


def run(specs, device="cuda") -> int:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the builds are CUDA kernels; got device {device}")
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    card = r.stdout.strip().splitlines()[0]
    print(card, flush=True)
    built = build_all(specs)
    libs = {}
    for name, (path, report) in built.items():
        prod, worst = registers(report)
        loop, chain = sass_counts(path)
        print(f"{name}: v0/64 {prod[0]} registers, {prod[1]} spill bytes (most of any "
              f"kernel {worst}); loop per window {loop['instructions_per_window']:.0f} "
              f"instructions, {loop['alu_per_window']:.0f} ALU + {loop['fma_per_window']:.0f} "
              f"FMA ops; dependent path {chain['chain_per_step']:.2f} per step "
              f"({chain['chain']} over {chain['steps']} steps in a block of "
              f"{chain['block_instructions']})", flush=True)
        libs[name] = Library(path)
    inputs = {}
    for label, chains in (("main", MAIN_PATH_CHAINS), ("probe", decode_variants.CHAINS)):
        state, words_be = decode_variants.tiled_chains(chains=chains)
        inputs[label] = (torch.from_numpy(state).to(device),
                         torch.from_numpy(words_be).to(device))
    for name, lib in libs.items():
        check(name, lib, *inputs["main"], device)
        print(f"{name}: == plain (wrap-regime W=64 x N=4,097, W=1 x N=1, every store mode "
              f"on the fixture's chains W=256 x N={MAIN_PATH_CHAINS})", flush=True)
    order = list(libs)
    for rnd, names in enumerate((order, order[::-1])):
        for name in names:
            lib = libs[name]
            st, wb = inputs["main"]
            best, med = _time(lambda: lib.decode(st, wb))
            line = (f"round {rnd} {name}: main path W=256 x N={MAIN_PATH_CHAINS} best "
                    f"{best:.4f} ms median {med:.4f} ms ({best * 1e6 / 5120:.2f} ns per step)")
            for mode in MAIN_MODES:
                best, med = _time(lambda: lib.decode(st, wb, mode))
                line += f", {mode} {best:.4f} / {med:.4f}"
            st, wb = inputs["probe"]
            for mode in PROBE_MODES:
                best, med = _time(lambda: lib.decode(st, wb, mode))
                line += f"; probe {mode} {best:.4f} / {med:.4f}"
            print(f"{line} [{card}]", flush=True)
    return 0


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("decode_builds: no CUDA device", file=sys.stderr)
        return 2
    argv = sys.argv[1:] if argv is None else argv
    specs = [parse_spec(a) for a in argv] or [
        ("tree", os.path.join(_build.CSRC, "qoa_decode.cu"), ())]
    return run(specs)


if __name__ == "__main__":
    sys.exit(main())
