#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU.

    python3 chip_smoke.py

Phases, in order, each printing its result on its own line; any failure
raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from ``qoaudio_tpu_torch/csrc`` (one nvcc per
   source, started together) and time it; each kernel's registers and
   spills (``ptxas -v``; no decode instantiation and no encoder may spill;
   the production decode's registers are printed) and its hottest loop's
   ALU- and FMA-pipe operations per window (``cuobjdump -sass``), from
   which every kernel's bound is computed, each function from its leanest
   build; the production decode's and the encoders' dependent path per
   step (the longest chain of dependent SASS instructions through a
   window's steps, over 20);
3. every kernel against its plain PyTorch version on CUDA tensors, exactly:
   the decoder on adversarial wrap-regime chains (random words, weights
   over all of int32), on a ragged shape (one window, a chain count that
   is no multiple of the block) and on the fixture's chains, each also
   against the native engine; the masked and the full encoder on random
   windows and from a wrap-regime state; the stream assembly kernel on an
   ESC-50 fold's shape (400 mono files of 44 frames), timed beside its
   byte bound;
4. the batched corpus path at real size: a 33-file corpus (the bench's
   32-file recipe plus the fixture) through ``batch_transcode``,
   ``batch_decode`` and ``batch_encode`` on ``cuda``; every file
   byte-equal to the native host engine, every kernel launched, no file on
   the host pair; one assembly launch for the transcode and one for the
   encode; each kernel against its plain version again on the
   inputs the main path gave it (the encoders' first two frames), both
   timed, and the kernel's ns per dependent step; the end-to-end time and
   each entry point's kernel time;
5. the public entry points on ``cuda``: ``decode_all``,
   ``open_and_decode_all``, ``decode_range`` and ``encode_all`` on the
   fixture (the re-encode's SHA-256 is the golden of tests/test_native.py),
   ``QoaDecoder`` with prefetch and in streaming mode across a format
   change, ``QoaEncoder`` frame by frame with its state handed to a second
   encoder and one-shot, ``encode_all_batch`` on the corpus, and the CLI in
   process (``transcode --hbm``, ``transcode``, ``decode``, ``encode``);
   every output equal to the native engine's; every call on the card
   launches exactly the kernels its path needs (counted from 0 around each
   call) and puts no file on the host pair; each call's median wall time
   over 3 calls per side, the sides alternating which runs first, beside
   the native engine's for the same call;
6. the rest of the corpus layer on the card: ``batch_transcode``,
   ``batch_decode`` and ``batch_encode`` on the smoke corpus over
   ``make_mesh()`` (every visible card) and over a mesh that lists
   ``cuda:0`` four times (its device groups run in turn), each byte-equal to the
   native engine with its exact launches and timed (median of 3) beside
   the unsharded call; the transcode handle (``return_fused_handle``):
   its re-run gives the same bytes, and its device-side median beside the
   end-to-end median splits off the host share; length bucketing on a
   mixed corpus past two resident waves of encode chains (one-frame mono
   clips and 64-frame stereo files): the wave size, the buckets chosen,
   ``bucket="auto"`` against ``bucket=False``, both byte-equal to native,
   and the smoke corpus held to one launch under ``"auto"``;
7. the decode kernel's store-shape probe
   (``qoaudio_tpu_torch.experiments.decode_variants``: five store modes x
   three block sizes on the fixture's chains tiled to W=256 x N=32,768),
   every mode checked against the production decode and timed, with its
   bound, then every mode against its plain version on the same inputs;
8. the port's benchmark (``qoaudio_tpu_torch.bench``) at full size in
   process on ``cuda``: every parity gate passed, each section's kernel
   launches (counted from 0 around the run, and per section by the bench)
   equal to what the section needs, and its JSON line holding every metric
   with a positive number;
9. the port's entry module (``qoaudio_tpu_torch.graft_entry``): the
   flagship step once (one masked launch, words and state equal to the
   plain version's), then the six-step dry run on a mesh of 4 shards over
   the cards present;
10. the transcode pipeline's stages on the smoke corpus, each between CUDA
    events (``qoaudio_tpu_torch.experiments.transcode_profile``), on one
    line;
11. one JSON line of entry points, one of the bench's result, one of
    kernels (each with its launches on the main path and in the bench,
    error against its plain version, time, plain time and bound), then
    ``{"ok": true, "device": ...}`` last.

Without a CUDA device it exits 2 and prints no result.  It imports nothing
of jax and nothing of the JAX package ``qoaudio_tpu``: the port carries its
own host tier.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

# the port must run without jax and without the JAX package: importing
# either fails
sys.modules["jax"] = None
sys.modules["qoaudio_tpu"] = None

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")
SEED = 2026
ENCODE_FRAMES_COMPARED = 2  # the plain encoder takes ~2 s per frame on the card
# the golden of tests/test_native.py (tests/test_torch_port_rules.py pins it)
FIXTURE_REENCODE_SHA256 = (
    "e9f87726aef5d602e248dc839ac7de5c570ad869419984f00274cde76f28c19e"
)
STREAM_ENCODE_SPLIT = 100  # frames the first streaming encoder takes
DECODER_READAHEAD = 32  # frames per QoaDecoder batch (prefetch needs > 1)
ENTRY_REPS = 3  # timed calls per side of each phase-5 entry point
MIX_CLIP_SAMPLES = 4410  # phase 6's one-frame mono clips (0.1 s at 44.1 kHz)
MIX_LONG_FILES, MIX_LONG_FRAMES = 32, 64  # and its long stereo files
PRODUCTION_DECODE = "decode<v0,64>"  # store mode v0 at 64 threads, as ptxas_registers names it


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def max_abs_err(got, want) -> float:
    """Largest |got - want| over paired int tensors (0 when exact)."""
    err = 0.0
    for g, w in zip(got, want):
        require(g.shape == w.shape and g.dtype == w.dtype,
                f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        d = (g.double() - w.double()).abs().max().item() if g.numel() else 0.0
        err = max(err, d)
    return err


def function_ops(counts: dict) -> dict:
    """Each function's SASS loop count from its leanest build
    (``roofline.leanest``), keyed by function: "decode" (the decoded
    samples: the production kernel, the probe's ``v0`` and ``stack`` at
    every block size; also under "v0" and "stack"), the probe's other
    modes, and "encode" (the full and the masked encoder)."""
    from qoaudio_tpu_torch.utils import roofline

    def builds(*modes):
        return [c for k, c in counts.items() if isinstance(k, tuple) and k[0] in modes]

    samples = roofline.leanest(builds("v0", "stack"))
    out = {"decode": samples, "v0": samples, "stack": samples,
           "encode": roofline.leanest([counts["full"], counts["masked"]])}
    for mode in ("nostore", "storeonly", "pack32"):
        out[mode] = roofline.leanest(builds(mode))
    return out


def ops_bound(n_bytes, count: dict, per_window_lanes: float, card) -> dict:
    """The bound of ``n_bytes`` moved and ``per_window_lanes`` passes of
    the loop ``count`` (one per window per thread), with the card's rates
    (``utils/roofline.py``)."""
    from qoaudio_tpu_torch.utils import roofline

    alu = count["alu_per_window"] * per_window_lanes
    fma = count["fma_per_window"] * per_window_lanes
    issued = count["instructions_per_window"] * per_window_lanes
    ms, by = roofline.bound_ms(n_bytes, alu, fma, issued, card)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": n_bytes,
            "bound_alu_ops": alu, "bound_fma_ops": fma, "bound_issued": issued}


def decode_bound(W, N, fn_ops, card) -> dict:
    """The bound of one decode launch at W windows x N chains: state and
    words in, samples out; one pass of the loop per window per chain."""
    return ops_bound(32 * N + 8 * W * N + 40 * W * N, fn_ops["decode"], W * N, card)


def encode_bound(masked, F, W, N, windows, fn_ops, card) -> dict:
    """The bound of one encode launch at F frames x W windows x N chains,
    ``windows`` of which hold samples: state in and out, samples,
    snapshots, words (and the masked lens); per window 16 candidate lanes
    per chain."""
    n_bytes = 64 * N + 40 * F * W * N + 32 * F * N + 8 * F * W * N
    if masked:
        n_bytes += 4 * F * W * N
    return ops_bound(n_bytes, fn_ops["encode"], 16 * windows, card)


def kernel_bound(key, args, fn_ops, card) -> dict:
    """The bound of one call of kernel ``key`` on ``args`` (its CUDA
    inputs): bytes each input read once and each output written once, and
    operations from the function's leanest SASS loop (the masked encoder:
    over the windows with samples)."""
    if key == "decode":
        return decode_bound(*args[1].shape, fn_ops, card)
    if key == "assemble":
        return assemble_bound(args[2], card)
    if key == "gather":
        return gather_bound(args[1], args[2], args[3], card)
    F, W, _, N = args[1].shape
    windows = int((args[2] > 0).sum()) if key == "masked" else F * W * N
    return encode_bound(key == "masked", F, W, N, windows, fn_ops, card)


def assemble_bound(table, card) -> dict:
    """The bound of one assembly launch over the files of ``table`` (its
    int64 tensor): each slice word (8 B) and LMS value (4 B) read once,
    each output byte written once; the byte swap and the headers are a
    few operations a word, far from binding."""
    from qoaudio_tpu_torch.ops import assemble
    from qoaudio_tpu_torch.utils import roofline

    t = table.cpu().numpy()
    C, T = t[assemble.CHANNELS], t[assemble.SAMPLES]
    n_bytes = int((8 * -(-T // 20) * C + 4 * 8 * t[assemble.FRAMES] * C).sum()
                  + assemble.stream_bytes(C, T).sum())
    ms, by = roofline.bound_ms(n_bytes, 0, 0, 0, card)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": n_bytes,
            "bound_alu_ops": 0, "bound_fma_ops": 0, "bound_issued": 0}


def gather_bound(table, W, N, card) -> dict:
    """The bound of one gather launch of ``N`` chains into ``W`` rows over
    the files of ``table`` (its int64 tensor): each slice word of their
    frames (8 B) and each chain's two LMS words read once, each output
    word (W x N of 8 B) and state value (8 x N of 4 B) written once."""
    from qoaudio_tpu_torch.ops import gather
    from qoaudio_tpu_torch.utils import roofline

    t = table.cpu().numpy()
    slices = ((t[gather.FRAMES_FULL] * t[gather.WINDOWS] + t[gather.TAIL_WINDOWS])
              * t[gather.CHANNELS]).sum()
    n_bytes = int(8 * slices + 16 * N + 8 * W * N + 32 * N)
    ms, by = roofline.bound_ms(n_bytes, 0, 0, 0, card)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": n_bytes,
            "bound_alu_ops": 0, "bound_fma_ops": 0, "bound_issued": 0}


def variant_bound(mode, W, N, fn_ops, card) -> dict:
    """The bound of one probe launch in store mode ``mode`` at W x N: the
    words (and, with the LMS, the state) in; the mode's output out (only
    out[0, 0, :] for nostore); operations from the mode's leanest build."""
    n_bytes = 8 * W * N + (0 if mode == "storeonly" else 32 * N)
    n_bytes += 2 * N if mode == "nostore" else 40 * W * N
    return ops_bound(n_bytes, fn_ops[mode], W * N, card)


def ptxas_registers(report: str) -> dict:
    """kernel (short name) -> (registers, spill bytes) from ``ptxas -v``."""
    from qoaudio_tpu_torch.ops import _build

    return {short_kernel_name(k): v for k, v in _build.ptxas_registers(report).items()}


def short_kernel_name(mangled: str) -> str:
    from qoaudio_tpu_torch.ops.decode import VARIANT_MODES

    m = re.search(r"qoa_decode_kernelILi(\d)ELi(\d+)E", mangled)
    if m:
        return f"decode<{VARIANT_MODES[int(m.group(1))]},{m.group(2)}>"
    m = re.search(r"qoa_encode_kernelILb(\d)E", mangled)
    if m:
        return "encode<masked>" if m.group(1) == "1" else "encode<full>"
    if "qoa_assemble_kernel" in mangled:
        return "assemble"
    if "qoa_gather_kernel" in mangled:
        return "gather"
    return mangled


def sass_ops(lib_path: str, nvcc: str) -> dict:
    """Operations per window of each kernel's hottest loop: the decode's
    (store mode, block size) instantiations, the encoders' "full" and
    "masked"."""
    from qoaudio_tpu_torch.ops.cuda_decode import VARIANT_THREADS
    from qoaudio_tpu_torch.ops.decode import VARIANT_MODES
    from qoaudio_tpu_torch.utils import roofline

    funcs = sass_of(lib_path, nvcc)

    def loop(pattern, load, per_window):
        return roofline.sass_loop(one_function(funcs, pattern), load, per_window)

    counts = {(mode, t): loop(decode_function(i, t), DECODE_WINDOW_LOAD, 1)
              for i, mode in enumerate(VARIANT_MODES) for t in VARIANT_THREADS}
    for key, pattern in ENCODE_FUNCTIONS.items():
        counts[key] = loop(pattern, r"LDG\.E\.U16", 20)
    return counts


# the encoders' mangled-name patterns in the SASS
ENCODE_FUNCTIONS = {"full": "qoa_encode_kernelILb0E", "masked": "qoa_encode_kernelILb1E"}
# the decoder's one load per window: the word, plain or through the
# read-only path (LDG.E.64.CONSTANT)
DECODE_WINDOW_LOAD = r"LDG\.E\.64"


def decode_function(mode_index: int, threads: int) -> str:
    """The mangled-name pattern of one decode instantiation."""
    return f"qoa_decode_kernelILi{mode_index}ELi{threads}E"


def sass_of(lib_path: str, nvcc) -> dict:
    """Mangled kernel name -> SASS of the library at ``lib_path``."""
    from qoaudio_tpu_torch.utils import roofline

    cuobjdump = roofline.find_cuobjdump(nvcc)
    require(cuobjdump is not None, "cuobjdump not found beside nvcc or on PATH")
    return roofline.sass_functions(lib_path, cuobjdump)


def one_function(funcs: dict, pattern: str) -> str:
    names = [k for k in funcs if pattern in k]
    require(len(names) == 1, f"{pattern}: SASS functions {names}")
    return funcs[names[0]]


def dependent_paths(lib_path: str, nvcc) -> dict:
    """The dependent path per step of the production decode ("decode":
    store mode ``v0`` at 64 threads) and of each encoder ("full",
    "masked"): the longest chain of dependent SASS instructions in the
    hottest loop's largest straight-line block (a window's unrolled
    steps; the encoders' full-window steps), over the 20 steps of a
    window (``roofline.sass_chain``)."""
    from qoaudio_tpu_torch.utils import roofline

    funcs = sass_of(lib_path, nvcc)
    paths = {"decode": roofline.sass_chain(one_function(funcs, decode_function(0, 64)),
                                           DECODE_WINDOW_LOAD, 1, 20)}
    for key, pattern in ENCODE_FUNCTIONS.items():
        paths[key] = roofline.sass_chain(one_function(funcs, pattern), r"LDG\.E\.U16", 20, 20)
    return paths


def describe_paths(paths: dict) -> str:
    return "dependent path per step (SASS): " + ", ".join(
        f"{k} {c['chain_per_step']:.2f} instructions ({c['chain']} over {c['steps']} steps "
        f"in a straight-line block of {c['block_instructions']})" for k, c in paths.items())


def print_paths(lib_path: str) -> int:
    """Phase 2's dependent-path count for any built library, e.g. an
    older commit's, to set beside this one's:

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.print_paths(sys.argv[1]))' LIB

    Needs ``cuobjdump`` (beside nvcc), no card."""
    from qoaudio_tpu_torch.ops import _build

    say(f"{lib_path}: {describe_paths(dependent_paths(lib_path, _build.find_nvcc()))}")
    return 0


def kernel_wrappers() -> dict:
    """(module, wrapper attribute, plain version) of each kernel."""
    from qoaudio_tpu_torch.ops import assemble as plain_assemble
    from qoaudio_tpu_torch.ops import cuda_assemble, cuda_decode, cuda_encode, cuda_gather
    from qoaudio_tpu_torch.ops import decode as plain_decode
    from qoaudio_tpu_torch.ops import encode as plain_encode
    from qoaudio_tpu_torch.ops import gather as plain_gather

    return {
        "decode": (cuda_decode, "decode_chains_words", plain_decode.decode_chains_words),
        "masked": (cuda_encode, "encode_frames", plain_encode.encode_frames),
        "full": (cuda_encode, "encode_frames_full", plain_encode.encode_frames_full),
        "assemble": (cuda_assemble, "assemble_streams", plain_assemble.assemble_streams),
        "gather": (cuda_gather, "gather_chains", plain_gather.gather_chains),
    }


@contextlib.contextmanager
def wrapped(make):
    """Route every kernel wrapper call through ``make(key, wrapper)``."""
    wrappers = kernel_wrappers()
    saved = {k: getattr(mod, attr) for k, (mod, attr, _) in wrappers.items()}
    for k, (mod, attr, _) in wrappers.items():
        setattr(mod, attr, make(k, saved[k]))
    try:
        yield
    finally:
        for k, (mod, attr, _) in wrappers.items():
            setattr(mod, attr, saved[k])


def balanced_groups(parsed, k: int):
    """The corpus layer's partition of files over ``k`` devices (on every
    batched path), worked out here apart from it: files longest chain first (then
    samples x channels, then input order), each to the device with the
    least encode work so far (the first such device on a tie); each group
    in input order."""
    work = [int(p.samples_per_frame.sum()) * p.channels for p in parsed]
    load, groups = [0] * k, [[] for _ in range(k)]
    for i in sorted(range(len(parsed)), key=lambda i: (-parsed[i].n_frames, -work[i], i)):
        g = load.index(min(load))
        groups[g].append(i)
        load[g] += work[i]
    return [sorted(g) for g in groups]


def smoke_corpus(fixture: bytes):
    """The 33-file smoke corpus (the bench's 32-file recipe,
    ``bench.bench_spec``, plus the fixture) and
    the native engine's answers: (fixture PCM, files, streams, decodes,
    decode -> encode pairs, encodes)."""
    from qoaudio_tpu_torch import bench, codec, types

    QoaDesc = types.QoaDesc
    fix_dec = codec.decode_all(fixture, backend="native")
    files = bench.build_files(fix_dec.samples.reshape(-1, fix_dec.num_channels),
                              bench.bench_spec())
    files.append((fix_dec.samples, QoaDesc(fix_dec.num_channels, fix_dec.sample_rate,
                                           fix_dec.samples_per_channel)))
    streams = [codec.encode_all(p, d, backend="native") for p, d in files[:-1]]
    streams.append(fixture)
    want_dec = [codec.decode_all(s, backend="native") for s in streams]
    want_tc = [
        codec.encode_all(o.samples, QoaDesc(o.num_channels, o.sample_rate,
                                             o.samples_per_channel), backend="native")
        for o in want_dec
    ]
    want_enc = [codec.encode_all(p, d, backend="native") for p, d in files]
    return fix_dec, files, streams, want_dec, want_tc, want_enc


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2

    from qoaudio_tpu_torch import bitstream, codec, native, types
    from qoaudio_tpu_torch.ops import _build, cuda_assemble, cuda_decode, cuda_encode, cuda_gather
    from qoaudio_tpu_torch.ops import assemble as plain_assemble
    from qoaudio_tpu_torch.ops import gather as plain_gather
    from qoaudio_tpu_torch.ops.decode import VARIANT_MODES
    from qoaudio_tpu_torch.parallel import corpus
    from qoaudio_tpu_torch.utils import roofline
    from qoaudio_tpu_torch.utils.timing import Stopwatch, bench_fn

    dev = torch.device("cuda")
    kernels = {
        "decode": {"name": "qoa_decode_chains", "route": "cuda",
                   "source": "qoaudio_tpu_torch/csrc/qoa_decode.cu",
                   "replaces": "qoaudio_tpu/ops/pallas_decode.py:114"},
        "masked": {"name": "qoa_encode_frames", "route": "cuda",
                   "source": "qoaudio_tpu_torch/csrc/qoa_encode.cu",
                   "replaces": "qoaudio_tpu/ops/pallas_encode.py:264"},
        "full": {"name": "qoa_encode_frames_full", "route": "cuda",
                 "source": "qoaudio_tpu_torch/csrc/qoa_encode.cu",
                 "replaces": "qoaudio_tpu/ops/pallas_encode.py:324"},
        "assemble": {"name": "qoa_assemble_streams", "route": "cuda",
                     "source": "qoaudio_tpu_torch/csrc/qoa_assemble.cu",
                     "replaces": "host assembly (bitstream.assemble_stream_bytes)"},
        "gather": {"name": "qoa_gather_chains", "route": "cuda",
                   "source": "qoaudio_tpu_torch/csrc/qoa_gather.cu",
                   "replaces": "host chain gather (bitstream.parse_file_arrays)"},
    }
    for k in kernels.values():
        k["library_ms"] = None  # no one PyTorch call computes QOA decode, encode or streams
    wrappers = kernel_wrappers()
    max_err = {k: 0.0 for k in kernels}

    def compare(key, *args, what: str):
        """Kernel == plain version exactly on these CUDA inputs."""
        mod, attr, plain = wrappers[key]
        got, want = getattr(mod, attr)(*args), plain(*args)
        if key in ("decode", "assemble"):
            got, want = (got,), (want,)
        err = max_abs_err(got, want)
        max_err[key] = max(max_err[key], err)
        require(err == 0, f"{key} kernel != plain on {what} (max err {err})")
        # int64 words differ below a double's precision too
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"{key} kernel != plain on {what}")
        return got

    # ---- phase 1: the card and the toolchain ----
    card = gpu_line()
    say(card)
    tag = f"[{card}]"
    say(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    nvcc = _build.find_nvcc()
    require(nvcc is not None, "nvcc not found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    say(f"phase 1: nvcc {nvcc}: {ver[-2] if len(ver) > 1 else ver[-1]}")
    require(native.available(), "native host engine unavailable (no g++?)")
    say("phase 1: native host engine available (byte reference)")

    # ---- phase 2: build ----
    with Stopwatch() as sw:
        _build.library()
    nvcc_s = _build.build_seconds if _build.build_seconds is not None else 0.0
    say(f"phase 2: kernels built and loaded in {sw.elapsed:.3f} s (nvcc {nvcc_s:.3f} s)")
    if _build.ptxas_report is None:
        say("phase 2: ptxas register check skipped: the library was built by an "
            "earlier process (no ptxas report in this one)")
    else:
        regs = ptxas_registers(_build.ptxas_report)
        # + 2 encoders + the assembly + the gather
        want = len(VARIANT_MODES) * len(cuda_decode.VARIANT_THREADS) + 4
        require(len(regs) == want, f"ptxas reported {sorted(regs)}")
        say("phase 2: ptxas registers (spill bytes): " + ", ".join(
            f"{k} {r} ({sp})" for k, (r, sp) in sorted(regs.items())))
        for name, (_, spill) in regs.items():  # every decode instantiation, every other kernel
            require(spill == 0, f"{name} spills {spill} bytes")
        kernels["decode"]["registers"] = regs[PRODUCTION_DECODE][0]
        say("phase 2: no kernel spills; the production decode "
            f"({PRODUCTION_DECODE}) {regs[PRODUCTION_DECODE][0]} registers, " + ", ".join(
                f"{name} {regs[name][0]}"
                for name in ("encode<masked>", "encode<full>", "assemble", "gather")))
    lib_path = _build.build()
    paths = dependent_paths(lib_path, nvcc)
    for key, c in paths.items():
        kernels[key]["chain_per_step"] = c["chain_per_step"]
    say("phase 2: " + describe_paths(paths))
    counts = sass_ops(lib_path, nvcc)
    card_peaks = roofline.card(dev)
    say("phase 2: SASS hottest loop per window, ALU + FMA operations (instructions): "
        + ", ".join(f"{k if isinstance(k, str) else '%s/%d' % k} {c['alu_per_window']:.0f} "
                    f"+ {c['fma_per_window']:.0f} ({c['instructions_per_window']:.0f})"
                    for k, c in counts.items())
        + f"; per pipe {card_peaks.pipe_ops_per_s:.4e}/s, issue "
        f"{card_peaks.issue_ops_per_s:.4e}/s ({card_peaks.sms} SMs x "
        f"{roofline.PIPE_OPS_PER_SM_PER_CLOCK} or {roofline.ISSUE_OPS_PER_SM_PER_CLOCK} x "
        f"{card_peaks.clock_mhz:.0f} MHz), memory {roofline.HBM_BYTES_PER_S:.3e} B/s")
    fn_ops = function_ops(counts)
    say("phase 2: each function's leanest build, ALU + FMA per window (instructions): "
        + ", ".join(f"{k} {c['alu_per_window']:.0f} + {c['fma_per_window']:.0f} "
                    f"({c['instructions_per_window']:.0f})" for k, c in fn_ops.items()))

    # ---- phase 3: each kernel against its plain version ----
    rng = np.random.default_rng(SEED)

    # decoder, adversarial chains in the wrap regime: random words over
    # every sf, history over int16 and weights over all of int32, so the
    # prediction dot and the weight update wrap at every step; then a
    # ragged shape: one window, chains no multiple of the block
    for W, N, what in ((256, 4096, "wrap-regime chains"), (1, 4097, "ragged wrap-regime chains")):
        wl = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(np.uint64) | (
            rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
        st = np.concatenate([rng.integers(-32768, 32768, size=(4, N)),
                             rng.integers(-(1 << 31), 1 << 31, size=(4, N))]).astype(np.int32)
        got = compare("decode", torch.from_numpy(st).to(dev),
                      torch.from_numpy(wl.byteswap().view(np.int64)).to(dev), what=what)
        require(np.array_equal(got[0].cpu().numpy(), native.decode_chains(wl.byteswap(), st)),
                f"decode kernel != native engine on {what}")
        say(f"phase 3: decode kernel == plain == native, {what} (weights over all of "
            f"int32) W={W} N={N}")

    with open(FIXTURE, "rb") as f:
        fixture = f.read()
    pa = bitstream.parse_file_arrays(fixture)
    require(pa is not None, "fixture rejected by the arithmetic parser")
    got = compare("decode", torch.from_numpy(np.ascontiguousarray(pa.state)).to(dev),
                  torch.from_numpy(np.ascontiguousarray(pa.words_be).view(np.int64)).to(dev),
                  what="fixture chains")
    require(np.array_equal(got[0].cpu().numpy(), native.decode_chains(pa.words_be, pa.state)),
            "decode kernel != native engine on fixture chains")
    say(f"phase 3: decode kernel == plain == native, fixture chains "
        f"W={pa.words_be.shape[0]} N={pa.words_be.shape[1]}")

    F, W, N = 2, 16, 256  # encoders, random windows with random lengths
    x = rng.integers(-32768, 32768, size=(F, W, 20, N)).astype(np.int16)
    lens = rng.integers(0, 21, size=(F, W, N)).astype(np.int32)
    x = np.where(np.arange(20)[None, None, :, None] < lens[:, :, None, :], x, 0
                 ).astype(np.int16)
    carry = rng.integers(-65536, 65536, size=(8, N)).astype(np.int32)
    x_d, l_d, c_d = (torch.from_numpy(a).to(dev) for a in (x, lens, carry))
    compare("masked", c_d, x_d, l_d, what="random windows")
    say(f"phase 3: masked encode kernel == plain, random windows and lengths "
        f"F={F} W={W} N={N}")
    xf = torch.from_numpy(
        rng.integers(-32768, 32768, size=(F, W, 20, N)).astype(np.int16)).to(dev)
    got = compare("full", c_d, xf, what="random full windows")
    l20 = torch.full((F, W, N), 20, dtype=torch.int32, device=dev)
    err = max_abs_err(got, cuda_encode.encode_frames(c_d, xf, l20))
    max_err["full"] = max(max_err["full"], err)
    require(err == 0, f"full encode kernel != masked kernel at lens=20 (max err {err})")
    say(f"phase 3: full encode kernel == plain == masked kernel at lens=20, "
        f"F={F} W={W} N={N}")
    # the wrap regime: weights over all of int32 and history over int16 make
    # the prediction dot, qoa_div (sf 0 and 1) and the weight update wrap
    wrap_state = np.concatenate([rng.integers(-32768, 32768, size=(4, N)),
                                 rng.integers(-(1 << 31), 1 << 31, size=(4, N))])
    ws_d = torch.from_numpy(wrap_state.astype(np.int32)).to(dev)
    compare("masked", ws_d, x_d, l_d, what="wrap-regime state")
    compare("full", ws_d, xf, what="wrap-regime state")
    say(f"phase 3: masked and full encode kernels == plain from a wrap-regime state, "
        f"F={F} W={W} N={N}")

    # the stream assembly at an ESC-50 fold's shape: 400 mono files of
    # 220,500 samples (44 frames); snapshots over all of int32, so the
    # weights truncate
    F, W, N = 44, 256, 400
    table, n_bytes, n_frames = plain_assemble.file_table(
        [1] * N, [44100] * N, [220_500] * N, np.arange(N))
    fold = (torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(F, 8, N)
                                          ).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, size=(F, W, N),
                                          dtype=np.int64)).to(dev),
            torch.from_numpy(table).to(dev), n_bytes, n_frames)
    compare("assemble", *fold, what="an ESC-50 fold's shape")
    k_s = bench_fn(cuda_assemble.assemble_streams, *fold, device=dev, warmup=2, iters=20)[0]
    b = assemble_bound(fold[2], card_peaks)
    kernels["assemble"]["fold_ms"] = k_s * 1e3
    kernels["assemble"]["fold_bound_ms"] = b["bound_ms"]
    say(f"phase 3: assembly kernel == plain at an ESC-50 fold's shape ({N} files x {F} "
        f"frames, {n_bytes} B out): kernel {k_s * 1e3:.4f} ms (best of 20), bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_bytes']} B at "
        f"{roofline.HBM_BYTES_PER_S:.3e} B/s), {100 * b['bound_ms'] / (k_s * 1e3):.1f}% "
        f"of the bound {tag}")
    del fold

    # the chain gather at an ESC-50 fold's shape: 400 mono 5-s streams
    # (eight distinct clips), staged as batch_transcode stages them
    clips = [codec.encode_all(rng.integers(-3000, 3000, size=220_500).astype(np.int16),
                              types.QoaDesc(1, 44100, 220_500), backend="native")
             for _ in range(8)]
    fold_streams = [clips[i % 8] for i in range(400)]
    geos = [bitstream.parse_file_geometry(s) for s in fold_streams]
    buf, gtable, n_chains = corpus._stage_streams(fold_streams, geos, pin=True)
    fold = (buf.to(dev), torch.from_numpy(gtable).to(dev), 256, n_chains)
    got = compare("gather", *fold, what="an ESC-50 fold's streams")
    h_words, h_state, _ = corpus._stage_decode(
        [bitstream.parse_file_arrays(s) for s in fold_streams])
    require(np.array_equal(got[0].cpu().numpy(), h_words)
            and np.array_equal(got[1].cpu().numpy(), h_state),
            "gather kernel != the host gather (parse_file_arrays) on a fold")
    k_s = bench_fn(cuda_gather.gather_chains, *fold, device=dev, warmup=2, iters=20)[0]
    p_s = bench_fn(plain_gather.gather_chains, *fold, device=dev, warmup=1, iters=3)[0]
    b = gather_bound(fold[1], 256, n_chains, card_peaks)
    kernels["gather"]["fold_ms"] = k_s * 1e3
    kernels["gather"]["fold_bound_ms"] = b["bound_ms"]
    say(f"phase 3: gather kernel == plain == host gather at an ESC-50 fold's shape (400 "
        f"files, {n_chains} chains x 256 windows, {buf.numel() * 8} B of streams): kernel "
        f"{k_s * 1e3:.4f} ms (best of 20), plain {p_s * 1e3:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_bytes']} B at {roofline.HBM_BYTES_PER_S:.3e} "
        f"B/s), {100 * b['bound_ms'] / (k_s * 1e3):.1f}% of the bound {tag}")
    del fold, buf

    # ---- phase 4: the main path at real size ----
    fix_dec, files, streams, want_dec, want_tc, want_enc = smoke_corpus(fixture)
    total = sum(d.samples * d.channels for _, d in files)
    dec_chains = sum(-(-d.samples // 5120) * d.channels for _, d in files)
    enc_chains = sum(d.channels for _, d in files)
    say(f"phase 4: corpus {len(streams)} files, {total} samples, "
        f"{dec_chains} decode chains, {enc_chains} encode chains, "
        f"{sum(len(s) for s in streams)} bytes compressed")

    # the counted run; each kernel's first inputs are kept for the
    # comparison below
    captured = {}

    def capture(key, fn):
        def run(*args):
            if key not in captured:
                captured[key] = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                      for a in args)
            return fn(*args)
        return run

    cuda_decode.launches = 0
    cuda_encode.masked_launches = 0
    cuda_encode.full_launches = 0
    cuda_assemble.launches = 0
    cuda_gather.launches = 0
    corpus.host_pair_files = 0
    with wrapped(capture):
        with Stopwatch(dev) as sw:
            got_tc = corpus.batch_transcode(streams, dev)
        t_first = sw.elapsed
        got_dec = corpus.batch_decode(streams, dev)
        got_enc = corpus.batch_encode(files, dev)
        torch.cuda.synchronize()
    counts = {
        "decode": cuda_decode.launches,
        "masked": cuda_encode.masked_launches,
        "full": cuda_encode.full_launches,
        "assemble": cuda_assemble.launches,
        "gather": cuda_gather.launches,
    }
    host_pairs = corpus.host_pair_files
    say(f"phase 4: launches decode={counts['decode']} masked={counts['masked']} "
        f"full={counts['full']} assemble={counts['assemble']} gather={counts['gather']}, "
        f"host_pair_files={host_pairs}")
    for key, n in counts.items():
        require(n > 0, f"kernel {key} never launched on the main path")
        kernels[key]["launches"] = n
    require(host_pairs == 0, f"{host_pairs} files took the host pair")
    require(counts["assemble"] == 2, "one assembly launch a call (transcode, encode)")
    require(counts["gather"] == 1, "one gather launch a call (transcode)")

    bad = [i for i, (g, w) in enumerate(zip(got_tc, want_tc)) if g != w]
    require(not bad, f"batch_transcode != native pair for files {bad}")
    bad = [i for i, (g, w) in enumerate(zip(got_dec, want_dec))
           if not (g.num_channels == w.num_channels and g.sample_rate == w.sample_rate
                   and np.array_equal(g.samples, w.samples))]
    require(not bad, f"batch_decode != native decode for files {bad}")
    bad = [i for i, (g, w) in enumerate(zip(got_enc, want_enc)) if g != w]
    require(not bad, f"batch_encode != native encode for files {bad}")
    for o, (_, d) in zip(got_dec, files):
        require(o.samples.shape == (d.samples * d.channels,) and o.samples.dtype == np.int16,
                "decoded PCM has the wrong shape or type")
    say(f"phase 4: all {len(streams)} files byte-equal to the native host engine "
        f"under batch_transcode, batch_decode and batch_encode")

    # each kernel against its plain version on the main path's own inputs
    # (the encoders' first frames only: the plain encoder is slow), timed
    require(set(captured) == set(kernels), f"inputs captured only for {sorted(captured)}")
    for key, args in captured.items():
        if key in ("masked", "full"):  # state (8, N) stays; samples and lens lose frames
            args = tuple(a if a.dim() == 2 else a[:ENCODE_FRAMES_COMPARED].contiguous()
                         for a in args)
        compare(key, *args, what="main-path inputs")
        mod, attr, plain = wrappers[key]
        k_s = bench_fn(getattr(mod, attr), *args, device=dev, warmup=2, iters=10)[0]
        p_s = bench_fn(plain, *args, device=dev, warmup=0, iters=1)[0]
        shape = (f"{args[2]}x{args[3]}" if key == "gather"
                 else "x".join(str(n) for n in args[1].shape))
        kernels[key].update(ms=k_s * 1e3, plain_ms=p_s * 1e3, timed_shape=shape,
                            **kernel_bound(key, args, fn_ops, card_peaks))
        k = kernels[key]
        per_step = ""
        if key not in ("assemble", "gather"):  # no serial chain in these
            # the serial chain: W x 20 dependent steps (decode), F x W x 20 (encode)
            steps = 20 * (args[1].shape[0] if key == "decode"
                          else args[1].shape[0] * args[1].shape[1])
            k["ns_per_step"] = k_s * 1e9 / steps
            per_step = f", {k['ns_per_step']:.2f} ns per dependent step"
        say(f"phase 4: {key} kernel == plain on main-path inputs {shape}: "
            f"kernel {k_s * 1e3:.4f} ms, plain {p_s * 1e3:.2f} ms, bound "
            f"{k['bound_ms']:.4f} ms ({k['bound_by']}: {k['bound_bytes']} B, "
            f"{k['bound_alu_ops']:.4e} ALU + {k['bound_fma_ops']:.4e} FMA ops of "
            f"{k['bound_issued']:.4e} issued){per_step} {tag}")
    for key in kernels:
        kernels[key]["max_abs_err"] = max_err[key]

    # end-to-end time of batch_transcode (bytes in -> bytes out)
    times = []
    for _ in range(3):
        with Stopwatch(dev) as sw:
            corpus.batch_transcode(streams, dev)
        times.append(sw.elapsed)
    med = statistics.median(times)
    say(f"phase 4: batch_transcode e2e first {t_first:.4f} s, then "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s; median {med:.4f} s = {total / med / 1e6:.2f} Msamples/s {tag}")

    # device time of each kernel inside one more run of each entry point,
    # by CUDA events around every launch; the rest of each call's wall
    # time is host work and copies
    main_path_ms = {k: 0.0 for k in kernels}
    for name, call in (("batch_transcode", lambda: corpus.batch_transcode(streams, dev)),
                       ("batch_decode", lambda: corpus.batch_decode(streams, dev)),
                       ("batch_encode", lambda: corpus.batch_encode(files, dev))):
        wall_ms, spent = kernel_ms(call, dev)
        say(f"phase 4: {name} with kernel events: wall {wall_ms:.3f} ms; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in spent.items())
            + f"; outside the kernels {wall_ms - sum(spent.values()):.3f} ms {tag}")
        for k, v in spent.items():
            main_path_ms[k] += v
    for key, ms in main_path_ms.items():
        kernels[key]["main_path_ms"] = ms

    # ---- phase 5: the public entry points on the card ----
    entry_points = phase5(dev, tag, fixture, fix_dec, files, streams, want_tc, want_enc)

    # ---- phase 6: mesh, handle and length bucketing ----
    phase6(dev, tag, fix_dec, files, streams, want_tc, want_dec, want_enc)

    # ---- phase 7: the decode kernel's store-shape probe ----
    kernels["variants"] = phase7(dev, tag, fn_ops, card_peaks)
    # the probe's v0 at 64 threads is the production kernel
    kernels["variants"]["chain_per_step"] = kernels["decode"]["chain_per_step"]

    # ---- phase 8: the port's benchmark ----
    bench_result, bench_launches = phase_bench(dev, card, streams[:-1], fn_ops, card_peaks)
    for key in kernels:  # the probe's count is read too: the bench launches it no time
        kernels[key]["bench_launches"] = bench_launches[key]

    # ---- phase 9: the flagship step and the dry run ----
    phase_entry(dev)

    # ---- phase 10: the transcode pipeline stage by stage ----
    phase_profile(dev, tag, streams)

    # ---- phase 11: results ----
    say(json.dumps({"entry_points": entry_points}))
    say(json.dumps({"bench": bench_result}))
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "timed_shape",
             "fold_ms", "fold_bound_ms",
             "main_path_ms", "ns_per_step", "chain_per_step", "registers", "bench_launches",
             "modes")
    say(json.dumps({"kernels": [{k: v[k] for k in order if k in v}
                                for v in kernels.values()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_bench(dev, card, bench_streams, fn_ops, card_peaks):
    """The port's benchmark at full size on ``dev``, in process: a failed
    parity gate raises out of it.  The launches of the whole run (counted
    from 0 just before it, read just after) and of each section (the
    bench's own per-section counts) must equal what the sections need;
    the JSON line must hold every metric with a positive number.
    Each kernel's time per launch at the bench's shape is set beside its
    bound.  ``bench_streams``: the 32 streams of the bench corpus.
    Returns (the line's object, the launches counted per kernel, the
    probe's among them)."""
    from qoaudio_tpu_torch import bench, bitstream
    from qoaudio_tpu_torch.ops import cuda_assemble, cuda_decode, cuda_gather

    sizes = bench.Sizes()
    calls = 2 * sizes.iters + 2  # warm, timed end to end; the handle: warm, timed
    frames = [spc // 5120 for spc, _, _ in sizes.saturated_spec]
    full = sum(1 for f0 in range(0, max(frames), 64) if min(f0 + 64, max(frames)) <= min(frames))
    windows = (sizes.iters + 1) * sizes.chain_launches + 2  # timed windows, two gates
    want = {
        # the gate's launch, then the warm and the timed windows
        "decode": {"decode": (sizes.iters + 1) * sizes.decode_launches + 1, "masked": 0,
                   "full": 0},
        "transcode": {k: v * calls for k, v in transcode_launches(
            [[bitstream.parse_file_arrays(s) for s in bench_streams]]).items()
            if k != "host_pair_files"},
        "encode": {"decode": 0, "masked": windows, "full": windows},
        "saturated": {"decode": calls, "masked": (-(-max(frames) // 64) - full) * calls,
                      "full": full * calls},
    }
    reset_launch_counts()
    cuda_decode.variant_launches = 0
    assembled, gathered = cuda_assemble.launches, cuda_gather.launches
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(dev)
    seen = launch_counts()
    assembled = cuda_assemble.launches - assembled
    gathered = cuda_gather.launches - gathered
    seen_variants = cuda_decode.variant_launches
    require(rc == 0, f"bench.main returned {rc}")
    lines = out.getvalue().strip().splitlines()
    require(len(lines) == 1, f"the bench printed {len(lines)} lines on stdout")
    result = json.loads(lines[0])
    require(result["launches"] == want,
            f"bench launches per section {result['launches']}, expected {want}")
    total = {k: sum(sec[k] for sec in want.values()) for k in ("decode", "masked", "full")}
    require(seen == {**total, "host_pair_files": 0},
            f"bench launches {seen}, expected {total} and no host-pair file")
    require(seen_variants == 0, f"the bench launched the store probe {seen_variants} times")
    for k in total:
        require(seen[k] > 0, f"kernel {k} never launched by the bench")
    require(result["metric"] == "encode_msamples_per_sec_per_chip"
            and result["unit"] == "Msamples/s", f"bench headline is {result['metric']!r}")
    require(result["device"] == card, f"bench device {result['device']!r}, the card is {card!r}")
    for key in ("value", "vs_baseline", "decode_e2e_msps", "decode_stream_msps",
                "decode_mono_e2e_msps", "encode_single_file_e2e_msps", "decode_batched_msps",
                "transcode_hbm_msps", "transcode_hbm_vs_baseline", "transcode_chip_msps",
                "encode_masked_msps", "transcode_saturated_msps",
                "transcode_saturated_chip_msps", "decode_vs_baseline"):
        require(isinstance(result.get(key), (int, float)) and result[key] > 0,
                f"bench metric {key} is {result.get(key)!r}")
    say(f"phase 8: bench passed every parity gate; launches per section {result['launches']}; "
        f"headline {result['value']} Msamples/s (full encode, {sizes.n_chains} chains x "
        f"{sizes.frames} frames), masked {result['encode_masked_msps']}, decode "
        f"{result['decode_batched_msps']}, transcode e2e {result['transcode_hbm_msps']} "
        f"(device side {result['transcode_chip_msps']}), saturated "
        f"{result['transcode_saturated_msps']} ({result['transcode_saturated_chip_msps']}) "
        f"[{card}]")
    # each kernel at the bench's shape beside its bound (ms per launch from
    # the line's median rates)
    W = 256
    samples = sizes.frames * 5120 * sizes.n_chains
    shapes = [("decode", f"{sizes.decode_windows}x{sizes.decode_chains}",
               sizes.decode_windows * 20 * sizes.decode_chains / result["decode_batched_msps"] / 1e3,
               sizes.decode_windows * 20,
               decode_bound(sizes.decode_windows, sizes.decode_chains, fn_ops, card_peaks))]
    for key, metric in (("full", "value"), ("masked", "encode_masked_msps")):
        shapes.append((key, f"{sizes.frames}x{W}x20x{sizes.n_chains}",
                       samples / result[metric] / 1e3, sizes.frames * W * 20,
                       encode_bound(key == "masked", sizes.frames, W, sizes.n_chains,
                                    sizes.frames * W * sizes.n_chains, fn_ops, card_peaks)))
    for key, shape, ms, steps, b in shapes:
        say(f"phase 8: bench {key} kernel at {shape}: {ms:.4f} ms a launch (median), "
            f"{ms * 1e6 / steps:.2f} ns per dependent step, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), {ms / b['bound_ms']:.1f}x [{card}]")
    # the bounds of the encode launches the transcode experiments time
    # (experiments.transcode_profile prints their times): 64-frame chunks
    for N in (48, 256, 512):
        bounds = [encode_bound(m, 64, W, N, 64 * W * N, fn_ops, card_peaks) for m in (False, True)]
        say(f"phase 8: bound of one 64x{W}x20x{N} encode launch: full "
            f"{bounds[0]['bound_ms']:.4f} ms, masked {bounds[1]['bound_ms']:.4f} ms "
            f"({bounds[0]['bound_by']})")
    return result, {**{k: seen[k] for k in total}, "variants": seen_variants,
                    "assemble": assembled, "gather": gathered}


def phase_entry(dev):
    """The flagship step once on ``dev`` (one masked launch, equal to the
    plain version on the same arguments), then the dry run on 4 shards
    over the cards present, all six steps."""
    import torch

    from qoaudio_tpu_torch import graft_entry
    from qoaudio_tpu_torch.ops import encode as plain_encode
    from qoaudio_tpu_torch.parallel import Mesh

    fn, args = graft_entry.entry(dev)
    reset_launch_counts()
    words, state = fn(*args)
    torch.cuda.synchronize()
    want_counts = {"decode": 0, "masked": 1, "full": 0, "host_pair_files": 0}
    require(launch_counts() == want_counts,
            f"entry: launches {launch_counts()}, expected {want_counts}")
    p_state, _, p_words = plain_encode.encode_frames(*args)
    err = max_abs_err([words, state], [p_words, p_state])
    require(err == 0, f"entry: kernel != plain version (max err {err})")
    say(f"phase 9: entry() on {words.device}: words {tuple(words.shape)}, state "
        f"{tuple(state.shape)} == the plain version, one masked launch")
    n = 4
    want_counts = dryrun_launches(n, Mesh((dev,) * n))
    reset_launch_counts()
    graft_entry.dryrun_multichip(n)
    seen = launch_counts()
    require(seen == want_counts, f"dry run: launches {seen}, expected {want_counts}")
    say(f"phase 9: dryrun_multichip({n}) passed all six steps; launches {seen}, as its "
        "inputs need")


def dryrun_launches(n: int, mesh) -> dict:
    """Exact launches of ``graft_entry.dryrun_multichip`` over ``mesh`` (of
    ``n`` shards), worked out from its inputs: steps 1-2 launch once per
    shard (one frame, partial windows: the masked encoder); steps 3-4, step
    5 and step 6's two mesh calls once per non-empty device group of the
    longest-chain-first partition, step 6's one-device call once, and its
    handle once more; a call whose corpus the cost model cuts makes these
    launches per bucket."""
    from qoaudio_tpu_torch import bitstream, codec, graft_entry
    from qoaudio_tpu_torch.parallel import Mesh

    def parse(files):
        return [bitstream.parse_file_arrays(codec.encode_all(p, d, backend="native"))
                for p, d in files]

    def transcode(parsed, m, bucket):
        segs = graft_entry._buckets(m, parsed) if bucket else None
        groups = []
        for seg in segs or [range(len(parsed))]:
            sub = [parsed[i] for i in seg]
            groups += [[sub[j] for j in g] for g in balanced_groups(sub, m.size)]
        return transcode_launches(groups)

    _, files, mixed = graft_entry.dryrun_inputs(n)
    small, mix = parse(files), parse(mixed)
    one = Mesh(mesh.devices[:1])
    groups = sum(1 for g in balanced_groups(small, mesh.size) if g)
    calls = [{"decode": n, "masked": n},  # steps 2 and 1
             {"decode": groups, "masked": groups},  # steps 4 and 3
             transcode(small, mesh, True),  # step 5
             transcode(mix, mesh, False), transcode(mix, mesh, True),
             transcode(mix, one, True), transcode(mix, one, True)]  # the call, the handle
    return {k: sum(c.get(k, 0) for c in calls)
            for k in ("decode", "masked", "full", "host_pair_files")}


def phase_profile(dev, tag, streams):
    """The transcode pipeline's stages on the smoke corpus, between CUDA
    events; every launch of the handle lies inside a stage."""
    from qoaudio_tpu_torch import bitstream
    from qoaudio_tpu_torch.experiments import transcode_profile

    iters = 5
    reset_launch_counts()
    r = transcode_profile.profile_streams(streams, dev, iters)
    counted = launch_counts()
    want = transcode_launches([[bitstream.parse_file_arrays(s) for s in streams]])
    seen = {"decode": r["calls"]["decode"], "masked": r["calls"]["encode_masked"],
            "full": r["calls"]["encode_full"], "host_pair_files": 0}
    require(seen == want, f"profile: stage calls {r['calls']}, the handle launches {want}")
    # the gated call and the handle's re-run; one warm run, ``iters`` with
    # stamps and ``iters`` without
    runs = 2 + 1 + 2 * iters
    require(counted == {k: v * runs for k, v in want.items()},
            f"profile: launches {counted}, expected {runs} runs of {want}")
    for stage in transcode_profile.STAGES:
        require(r[stage] > 0, f"profile: stage {stage} took {r[stage]} s")
    say(f"phase 10: transcode stages, smoke corpus, median of {iters}; {runs} runs of the "
        f"handle, launches {counted}: "
        f"{transcode_profile.describe(r)} {tag}")


def phase7(dev, tag, fn_ops, card) -> dict:
    """The store-shape probe on ``dev``: the experiment's own run (each
    mode checked against the production decode, then timed) with the
    variant launches counted from 0 around it, each mode's bound, then
    every mode against its plain version on the same inputs (those
    launches are not counted).  Returns the probe's kernel entry."""
    import torch

    from qoaudio_tpu_torch.experiments import decode_variants
    from qoaudio_tpu_torch.ops import cuda_decode
    from qoaudio_tpu_torch.ops import decode as plain
    from qoaudio_tpu_torch.utils.timing import bench_fn

    cuda_decode.variant_launches = 0
    res = decode_variants.run(dev)
    torch.cuda.synchronize()
    launches = cuda_decode.variant_launches
    W, N = res["windows"], res["chains"]
    modes = plain.VARIANT_MODES
    want = len(decode_variants.BLOCK_SIZES) * len(modes) * (
        1 + decode_variants.WARMUP + decode_variants.ITERS)
    require(launches == want, f"probe launches {launches}, expected {want}")
    say(f"phase 7: probe {W} windows x {N} chains ({res['samples']} samples per launch), "
        f"every mode == the production decode at every block size; variant launches {launches}")
    for r in res["results"]:
        r.update(variant_bound(r["mode"], W, N, fn_ops, card))
        say(f"phase 7: threads={r['threads']:3d} {r['mode']:9s} best {r['best_ms']:.4f} ms "
            f"({r['gsps_best']:.2f} Gsamples/s), median {r['median_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) {tag}")

    state, words_be = decode_variants.tiled_chains(windows=W, chains=N)
    st = torch.from_numpy(state).to(dev)
    wb = torch.from_numpy(words_be).to(dev)
    err, plain_ms = 0.0, {}
    for mode in modes:  # kernel (production block) against plain, exactly
        got = cuda_decode.decode_chains_variant(st, wb, mode)
        p_s, want_out = bench_fn(plain.decode_chains_variant, st, wb, mode, device=dev,
                                 warmup=0, iters=1)
        plain_ms[mode] = p_s * 1e3
        if mode == "nostore":
            got, want_out = got[0, 0], want_out[0, 0]
        e = max_abs_err([got], [want_out])
        require(e == 0, f"probe {mode} kernel != plain (max err {e})")
        err = max(err, e)
        del got, want_out
    say(f"phase 7: every mode's kernel == its plain version on the probe's inputs (nostore "
        f"on out[0, 0, :]); plain " + ", ".join(f"{m} {t:.2f} ms" for m, t in plain_ms.items())
        + f" {tag}")
    v0 = next(r for r in res["results"] if r["mode"] == "v0" and r["threads"] == 64)
    torch.cuda.empty_cache()
    return {"name": "qoa_decode_variant", "route": "cuda",
            "source": "qoaudio_tpu_torch/csrc/qoa_decode.cu",
            "replaces": "experiments/pallas_decode_variants.py:132",
            "launches": launches, "max_abs_err": err, "ms": v0["best_ms"],
            "plain_ms": plain_ms["v0"], "bound_ms": v0["bound_ms"],
            "bound_by": v0["bound_by"], "library_ms": None, "timed_shape": f"{W}x{N}",
            "ns_per_step": v0["best_ms"] * 1e6 / (W * 20),
            "modes": [{k: r[k] for k in ("mode", "threads", "best_ms", "median_ms",
                                         "gsps_best", "bound_ms", "bound_by")}
                      | ({"plain_ms": plain_ms[r["mode"]]} if r["threads"] == 64 else {})
                      for r in res["results"]]}


def phase5(dev, tag, fixture, fix_dec, files, streams, want_tc, want_enc):
    """Every public entry point on ``dev``, each output held against the
    native engine's for the same call; returns the entry-point times."""
    from qoaudio_tpu_torch import (QoaDecoder, QoaDesc, QoaEncoder, cli,
                                   decode_all, decode_range, encode_all,
                                   encode_all_batch, open_and_decode_all)
    from qoaudio_tpu_torch.format import QOA_SLICES_PER_FRAME, qoa_frame_size
    from qoaudio_tpu_torch.utils.timing import Stopwatch
    from qoaudio_tpu_torch.utils.wav import read_wav

    T = dict(backend="torch", device=dev)
    N = dict(backend="native")
    fix_desc = QoaDesc(fix_dec.num_channels, fix_dec.sample_rate,
                       fix_dec.samples_per_channel)
    pcm = fix_dec.samples
    C, n = fix_desc.channels, fix_desc.samples
    results = []

    def same_pcm(a, b):
        return (a.num_channels, a.sample_rate) == (b.num_channels, b.sample_rate) \
            and np.array_equal(a.samples, b.samples)

    def entry(name, torch_call, native_call, launches, same=lambda a, b: a == b):
        """Run both sides ENTRY_REPS times, alternating which goes first.
        Every torch call must make exactly ``launches`` (kernel -> count;
        the others 0) with no file on the host pair, counted from 0 just
        before the call and read just after it."""
        want_counts = {"decode": 0, "masked": 0, "full": 0, "host_pair_files": 0,
                       **launches}
        t_ms, n_ms = [], []
        for rep in range(ENTRY_REPS):
            for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
                if side == 0:
                    reset_launch_counts()
                    with Stopwatch(dev) as sw:
                        got = torch_call()
                    seen = launch_counts()
                    require(seen == want_counts,
                            f"{name}: launches {seen}, expected {want_counts}")
                    t_ms.append(sw.elapsed * 1e3)
                else:
                    with Stopwatch() as sn:
                        want = native_call()
                    n_ms.append(sn.elapsed * 1e3)
            require(same(got, want), f"{name}: torch output != native output")
        if max(t_ms) < min(n_ms):
            faster = "torch"
        elif max(n_ms) < min(t_ms):
            faster = "native"
        else:
            faster = "unresolved"  # the two sides' ranges overlap
        t_med, n_med = statistics.median(t_ms), statistics.median(n_ms)
        results.append({"name": name, "ms": t_med, "native_ms": n_med,
                        "ms_all": t_ms, "native_ms_all": n_ms, "faster": faster,
                        "launches": {k: want_counts[k] for k in ("decode", "masked", "full")}})
        for k in total:
            total[k] += want_counts[k]
        say(f"phase 5: {name} == native, launches {launches}: torch median "
            f"{t_med:.3f} ms ({', '.join(f'{t:.3f}' for t in t_ms)}), native median "
            f"{n_med:.3f} ms ({', '.join(f'{t:.3f}' for t in n_ms)}), faster: "
            f"{faster} {tag}")
        return got

    # launches of the chunked encoder (64 frames per launch) over F frames
    # when the leading f_full frames of every chain are full
    def chunked(F, f_full, chunk=64):
        full = sum(1 for f0 in range(0, F, chunk) if min(f0 + chunk, F) <= f_full)
        return {"full": full, "masked": -(-F // chunk) - full}

    n_frames = -(-n // 5120)
    fix_enc = chunked(n_frames, n // 5120)
    corpus_enc = chunked(max(-(-d.samples // 5120) for _, d in files),
                         min(d.samples // 5120 for _, d in files))
    corpus_tc = {"decode": 1, **corpus_enc}
    total = {"decode": 0, "masked": 0, "full": 0}

    one_decode = {"decode": 1}
    entry("decode_all", lambda: decode_all(fixture, **T),
          lambda: decode_all(fixture, **N), one_decode, same_pcm)
    entry("open_and_decode_all", lambda: open_and_decode_all(FIXTURE, **T),
          lambda: open_and_decode_all(FIXTURE, **N), one_decode, same_pcm)
    for lo, hi in ((5000, 12000), (n - 3100, n + 10)):  # a frame edge, the tail
        entry(f"decode_range[{lo}:{hi}]", lambda: decode_range(fixture, lo, hi, **T),
              lambda: decode_range(fixture, lo, hi, **N), one_decode, same_pcm)
    enc = entry("encode_all", lambda: encode_all(pcm, fix_desc, **T),
                lambda: encode_all(pcm, fix_desc, **N), fix_enc)
    require(enc == want_enc[-1], "encode_all != native encode")
    require(hashlib.sha256(enc).hexdigest() == FIXTURE_REENCODE_SHA256,
            "fixture re-encode differs from the golden")

    def stream_decode(**kw):
        dec = QoaDecoder.open(FIXTURE, readahead=DECODER_READAHEAD, **kw)
        try:
            out = dec.decode_pending()
            require(dec.prefetch_hits > 0 or kw["backend"] != "torch",
                    "QoaDecoder never prefetched")
            return out
        finally:
            dec.into_inner().close()

    entry("QoaDecoder.open+decode_pending", lambda: stream_decode(**T),
          lambda: stream_decode(**N), {"decode": -(-n_frames // DECODER_READAHEAD)},
          lambda a, b: np.array_equal(a, b))

    fsize = qoa_frame_size(C, QOA_SLICES_PER_FRAME)
    other = encode_all(pcm.reshape(-1, C)[:3000, 0].copy(), QoaDesc(1, 22050, 3000), **N)

    def network_stream(**kw):
        dec = QoaDecoder.new_streaming(**kw)
        a = dec.decode_frame(fixture[8 : 8 + 2 * fsize])  # two stereo frames
        b = dec.decode_frame(other[8:])  # then mono at another rate
        return a, b, dec.current_frame_header()

    got = entry("QoaDecoder.new_streaming (format change)",
                lambda: network_stream(**T), lambda: network_stream(**N),
                {"decode": 2},  # one per decode_frame call
                lambda a, b: all(np.array_equal(x, y) for x, y in zip(a[:2], b[:2]))
                and a[2] == b[2])
    require(np.array_equal(got[0], pcm[: 2 * 5120 * C]), "streamed frames != fixture PCM")

    def stream_encode(**kw):
        e1 = QoaEncoder(fix_desc, **kw)
        out = io.BytesIO()
        e1.write_header(out)
        split = STREAM_ENCODE_SPLIT * 5120
        for off in range(0, split, 5120):
            e1.encode_frame(pcm[C * off : C * (off + 5120)], out)
        e2 = QoaEncoder(fix_desc, **kw)  # resumes from e1's state
        e2.set_state(e1.get_state())
        for off in range(split, n, 5120):
            e2.encode_frame(pcm[C * off : C * min(n, off + 5120)], out)
        return out.getvalue()

    got = entry(f"QoaEncoder.encode_frame x{n_frames} (state handed over)",
                lambda: stream_encode(**T), lambda: stream_encode(**N),
                {"full": n // 5120, "masked": n_frames - n // 5120})
    require(got == want_enc[-1], "streamed encode != native encode")
    results[-1]["ms_per_frame"] = results[-1]["ms"] / n_frames
    results[-1]["native_ms_per_frame"] = results[-1]["native_ms"] / n_frames
    say(f"phase 5: streaming encode {results[-1]['ms_per_frame']:.4f} ms/frame "
        f"on torch, {results[-1]['native_ms_per_frame']:.4f} ms/frame native {tag}")
    entry("QoaEncoder.encode", lambda: QoaEncoder(fix_desc, **T).encode(pcm),
          lambda: QoaEncoder(fix_desc, **N).encode(pcm), fix_enc)

    got = entry(f"encode_all_batch ({len(files)} files)", lambda: encode_all_batch(files, **T),
                lambda: encode_all_batch(files, **N), corpus_enc)
    require(got == want_enc, "encode_all_batch != native encode")

    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i, s in enumerate(streams):
            paths.append(os.path.join(tmp, f"in{i:02d}.qoa"))
            with open(paths[-1], "wb") as f:
                f.write(s)

        def run_cli(argv, out_dir=None):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            require(rc == 0, f"cli {' '.join(argv[:4])} ... exited {rc}")
            if out_dir is None:
                return None
            outs = []
            for p in paths:
                with open(os.path.join(out_dir, os.path.basename(p)), "rb") as f:
                    outs.append(f.read())
            return outs

        def d(name):
            return os.path.join(tmp, name)

        def cli_transcode(global_opts, *opts):
            out_dir = tempfile.mkdtemp(dir=tmp)  # a fresh one for every call
            return run_cli([*global_opts, "transcode", *paths, *opts,
                            "--out-dir", out_dir], out_dir)

        on_card, native_cli = ["--device", str(dev)], ["--backend", "native"]
        got = entry(f"cli transcode --hbm ({len(paths)} files)",
                    lambda: cli_transcode(on_card, "--hbm"),
                    lambda: cli_transcode(native_cli), corpus_tc)
        require(got == want_tc, "cli transcode --hbm != native pair")
        got = entry(f"cli transcode ({len(paths)} files)",
                    lambda: cli_transcode(on_card),
                    lambda: cli_transcode(native_cli), corpus_tc)
        require(got == want_tc, "cli transcode != native pair")

        def cli_decode(backend, wav):
            run_cli(["--backend", backend, "--device", str(dev), "decode", FIXTURE, wav])
            return read_wav(wav)[0]

        got = entry("cli decode", lambda: cli_decode("torch", d("t.wav")),
                    lambda: cli_decode("native", d("n.wav")), one_decode,
                    lambda a, b: np.array_equal(a, b))
        require(np.array_equal(got, pcm), "cli decode != fixture PCM")

        def cli_encode(backend, out):
            run_cli(["--backend", backend, "--device", str(dev), "encode", d("t.wav"), out])
            with open(out, "rb") as f:
                return f.read()

        got = entry("cli encode", lambda: cli_encode("torch", d("t.qoa")),
                    lambda: cli_encode("native", d("n.qoa")), fix_enc)
        require(hashlib.sha256(got).hexdigest() == FIXTURE_REENCODE_SHA256,
                "cli encode differs from the golden")

    say(f"phase 5: launches per pass over the entry points decode={total['decode']} "
        f"masked={total['masked']} full={total['full']}, host_pair_files=0")
    for key, k in total.items():
        require(k > 0, f"kernel {key} never launched by the entry points")
    return results


def kernel_ms(call, dev):
    """(wall ms, device ms of each kernel) of one ``call()`` on ``dev``,
    the kernels timed by CUDA events around every launch."""
    import torch

    from qoaudio_tpu_torch.utils.timing import Stopwatch

    spent = {"decode": 0.0, "masked": 0.0, "full": 0.0, "assemble": 0.0, "gather": 0.0}

    def timed(key, fn):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            b.synchronize()
            spent[key] += a.elapsed_time(b)
            return out
        return run

    with wrapped(timed), Stopwatch(dev) as sw:
        call()
    return sw.elapsed * 1e3, spent


def launch_counts() -> dict:
    """Kernel launches and host-pair files counted since the last reset."""
    from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
    from qoaudio_tpu_torch.parallel import corpus

    return {"decode": cuda_decode.launches, "masked": cuda_encode.masked_launches,
            "full": cuda_encode.full_launches, "host_pair_files": corpus.host_pair_files}


def reset_launch_counts() -> None:
    from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
    from qoaudio_tpu_torch.parallel import corpus

    cuda_decode.launches = 0
    cuda_encode.masked_launches = 0
    cuda_encode.full_launches = 0
    corpus.host_pair_files = 0


def encode_launches(groups, chunk=64) -> dict:
    """Exact launches of a batch_encode whose device groups hold files of
    these (frames, samples a channel): each non-empty group's chunked
    encode, its leading all-full chunks on the full-window kernel."""
    want = {"decode": 0, "masked": 0, "full": 0, "host_pair_files": 0}
    for g in groups:
        if g:
            F = max(f for f, _ in g)
            f_full = min(n for _, n in g) // 5120
            full = sum(1 for f0 in range(0, F, chunk) if min(f0 + chunk, F) <= f_full)
            want["full"] += full
            want["masked"] += -(-F // chunk) - full
    return want


def transcode_launches(parsed_groups, chunk=64) -> dict:
    """Exact launches of a transcode whose device groups hold these parsed
    files: one decode each, then its chunked encode."""
    want = encode_launches([[(p.n_frames, int(p.samples_per_frame.sum())) for p in g]
                            for g in parsed_groups], chunk)
    want["decode"] = sum(1 for g in parsed_groups if g)
    return want


def median_time(call, where, reps=3):
    """(median, all) seconds of ``reps`` calls, each synchronised on
    ``where`` (a device or a mesh) before and after."""
    from qoaudio_tpu_torch.utils.timing import Stopwatch

    times = []
    for _ in range(reps):
        with Stopwatch(where) as sw:
            call()
        times.append(sw.elapsed)
    return statistics.median(times), times


def fmt_times(med, times) -> str:
    return f"median {med:.4f} s ({', '.join(f'{t:.4f}' for t in times)})"


def mesh_phase(dev, tag, files, streams, want_tc, want_dec, want_enc):
    """``batch_transcode``, ``batch_decode`` and ``batch_encode`` on the
    smoke corpus on ``dev``, over ``make_mesh()`` (every visible card) and
    over ``cuda:0`` listed four times: each byte-equal to native, with
    the launches of the files' longest-chain-first partition, and timed."""
    from qoaudio_tpu_torch import bitstream
    from qoaudio_tpu_torch.parallel import Mesh, corpus, make_mesh

    def same_dec(got):
        return all((g.num_channels, g.sample_rate) == (w.num_channels, w.sample_rate)
                   and np.array_equal(g.samples, w.samples) for g, w in zip(got, want_dec))

    parsed = [bitstream.parse_file_arrays(s) for s in streams]
    placements = [("unsharded", dict(device=dev)),
                  ("make_mesh()", dict(mesh=make_mesh())),
                  ("cuda:0 x4", dict(mesh=make_mesh(devices=("cuda:0",) * 4)))]
    unsharded = {}
    for label, where in placements:
        m = where.get("mesh", Mesh((dev,)))
        idx_groups = balanced_groups(parsed, m.size)
        require(all(idx_groups) or len(parsed) < m.size,
                f"{label}: a device holds no file: {idx_groups}")
        for what, frames, work in (
                ("parsed streams", [p.n_frames for p in parsed],
                 [int(p.samples_per_frame.sum()) * p.channels for p in parsed]),
                ("PCM", [-(-d.samples // 5120) for _, d in files],
                 [d.samples * d.channels for _, d in files])):
            require(corpus._file_groups(frames, work, m.size) == idx_groups,
                    f"{label}: the corpus layer's groups of the {what} differ from the "
                    f"longest-chain-first balance {[len(g) for g in idx_groups]}")
        groups = [[parsed[i] for i in g] for g in idx_groups]
        n_groups = sum(1 for g in idx_groups if g)
        cases = (
            ("batch_transcode", lambda: corpus.batch_transcode(streams, **where),
             lambda got: got == want_tc, transcode_launches(groups)),
            ("batch_decode", lambda: corpus.batch_decode(streams, **where), same_dec,
             {"decode": n_groups, "masked": 0, "full": 0, "host_pair_files": 0}),
            ("batch_encode", lambda: corpus.batch_encode(files, **where),
             lambda got: got == want_enc,
             encode_launches([[(-(-files[i][1].samples // 5120), files[i][1].samples)
                               for i in g] for g in idx_groups])),
        )
        for name, call, ok, want_counts in cases:
            reset_launch_counts()
            got = call()
            seen = launch_counts()
            require(seen == want_counts,
                    f"{name} over {label}: launches {seen}, expected {want_counts}")
            require(ok(got), f"{name} over {label} != native")
            med, times = median_time(call, m)
            if label == "unsharded":
                unsharded[name] = med
            say(f"phase 6: {name} over {label} ({m.size} device(s) on "
                f"{', '.join(sorted({str(d) for d in m.devices}))}; files per group "
                f"{[len(g) for g in groups]}) == native, launches "
                f"{ {k: v for k, v in seen.items() if k != 'host_pair_files'} }: "
                f"{fmt_times(med, times)}; unsharded median {unsharded[name]:.4f} s {tag}")


def mesh_cards() -> int:
    """The mesh part of phase 6 alone, for a host with several cards:

        python3 -c 'import sys, chip_smoke; sys.exit(chip_smoke.mesh_cards())'

    ``make_mesh()`` then spans every card, so this drives what exists only
    across cards: per-card launches, fetches and waits over several
    devices, and each card's group of whole files.  Exits 2 with no CUDA
    device."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    from qoaudio_tpu_torch.ops import _build

    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = r.stdout.strip().splitlines()
    for line in cards:
        say(line)
    require(torch.cuda.device_count() == len(cards), "nvidia-smi and torch count differ")
    _build.library()
    with open(FIXTURE, "rb") as f:
        _, files, streams, want_dec, want_tc, want_enc = smoke_corpus(f.read())
    mesh_phase(torch.device("cuda:0"), f"[{len(cards)} x {cards[0]}]", files, streams,
               want_tc, want_dec, want_enc)
    say(f"mesh_cards: passed on {len(cards)} card(s)")
    return 0


def phase6(dev, tag, fix_dec, files, streams, want_tc, want_dec, want_enc):
    """The corpus layer's mesh, handle and bucketing on ``dev``."""
    import torch

    from qoaudio_tpu_torch import bitstream, codec, types
    from qoaudio_tpu_torch.ops import cuda_encode
    from qoaudio_tpu_torch.parallel import Mesh, corpus
    from qoaudio_tpu_torch.utils.timing import Stopwatch
    from qoaudio_tpu_torch.utils.transfer import fetch_arrays

    mesh_phase(dev, tag, files, streams, want_tc, want_dec, want_enc)
    parsed = [bitstream.parse_file_arrays(s) for s in streams]

    # -- the handle: the device side of the end-to-end path alone --
    reset_launch_counts()
    outs, handle = corpus.batch_transcode(streams, dev, return_fused_handle=True)
    require(outs == want_tc, "batch_transcode(return_fused_handle=True) != native")
    require(isinstance(handle, corpus.TranscodeFusedHandle), f"handle is {type(handle)}")
    reset_launch_counts()
    packed = handle()
    require(handle.assemble(*fetch_arrays(packed)) == want_tc,
            "the handle's re-run gives other bytes")
    require(launch_counts() == transcode_launches([parsed]),
            f"handle(): launches {launch_counts()}")
    e2e, hdl = [], []
    for rep in range(3):
        for side in ((0, 1) if rep % 2 == 0 else (1, 0)):
            with Stopwatch(dev) as sw:
                if side == 0:
                    corpus.batch_transcode(streams, dev)
                else:
                    handle()
            (e2e if side == 0 else hdl).append(sw.elapsed)
    e_med, h_med = statistics.median(e2e), statistics.median(hdl)
    say(f"phase 6: batch_transcode e2e {fmt_times(e_med, e2e)}; handle() (device side) "
        f"{fmt_times(h_med, hdl)}; e2e - handle = {(e_med - h_med) * 1e3:.3f} ms host share {tag}")
    del handle, packed

    # -- length bucketing past two resident waves --
    blocks, sms, per_block = cuda_encode.occupancy(dev)
    wave = cuda_encode.chains_per_wave(dev)
    require(wave > 0, "no resident encode chains")
    say(f"phase 6: encoder wave: {blocks} resident blocks per SM x {sms} SMs x "
        f"{per_block} chains per block = {wave} chains {tag}")
    e_mult, overhead = corpus._bucket_model(Mesh((dev,)))
    require(corpus._length_buckets([p.n_frames for p in parsed],
                                   [p.channels for p in parsed], e_mult, 64, overhead) is None,
            "the smoke corpus buckets on the card")
    reset_launch_counts()
    corpus.batch_transcode(streams, dev)
    require(launch_counts() == transcode_launches([parsed]),
            f"the smoke corpus under bucket='auto': launches {launch_counts()}")
    say(f"phase 6: smoke corpus under bucket='auto': one call, launches {launch_counts()}")

    # what one more sub-call costs, in frames of one full wave
    one = codec.encode_all(fix_dec.samples[: 2 * 4410], types.QoaDesc(2, 44100, 4410),
                           backend="native")
    sub_med, _ = median_time(lambda: corpus.batch_transcode([one], dev), dev, reps=5)
    rng = np.random.default_rng(SEED + 6)
    xw = torch.from_numpy(rng.integers(-20000, 20000, size=(1, 256, 20, wave)
                                       ).astype(np.int16)).to(dev)
    lw = torch.full((1, 256, wave), 20, dtype=torch.int32, device=dev)
    sw0 = torch.from_numpy(codec.initial_encoder_state(0, wave)).to(dev)
    frame_med, _ = median_time(lambda: cuda_encode.encode_frames(sw0, xw, lw), dev, reps=5)
    del xw, lw, sw0
    say(f"phase 6: one more sub-call (a one-file transcode) {sub_med * 1e3:.3f} ms; one frame "
        f"of a full wave {frame_med * 1e3:.3f} ms; ratio {sub_med / frame_med:.2f} wave-frames "
        f"(the model uses {corpus._CUDA_BUCKET_OVERHEAD_WAVES}) {tag}")

    left = fix_dec.samples.reshape(-1, fix_dec.num_channels)
    n_src = left.shape[0]
    mix = []
    for i in range(2 * wave):  # one-frame mono clips
        idx = (i * 7919 + np.arange(MIX_CLIP_SAMPLES)) % n_src
        mix.append((np.ascontiguousarray(left[idx, 0]),
                    types.QoaDesc(1, 44100, MIX_CLIP_SAMPLES)))
    for i in range(MIX_LONG_FILES):  # long stereo files
        idx = (i * 104729 + np.arange(MIX_LONG_FRAMES * 5120)) % n_src
        mix.append((np.ascontiguousarray(left[idx]).reshape(-1),
                    types.QoaDesc(2, 44100, MIX_LONG_FRAMES * 5120)))
    with Stopwatch() as sw:
        mix_streams = [codec.encode_all(p, d, backend="native") for p, d in mix]
        want_mix = []  # the native decode -> encode pair of each stream
        for s in mix_streams:
            o = codec.decode_all(s, backend="native")
            want_mix.append(codec.encode_all(o.samples, types.QoaDesc(
                o.num_channels, o.sample_rate, o.samples_per_channel), backend="native"))
    mix_parsed = [bitstream.parse_file_arrays(s) for s in mix_streams]
    chains = sum(p.channels for p in mix_parsed)
    segs = corpus._length_buckets([p.n_frames for p in mix_parsed],
                                  [p.channels for p in mix_parsed], e_mult, 64, overhead)
    require(segs is not None and len(segs) > 1, "the multi-wave corpus does not bucket")
    say(f"phase 6: mixed corpus {len(mix)} files ({2 * wave} one-frame mono clips, "
        f"{MIX_LONG_FILES} {MIX_LONG_FRAMES}-frame stereo files), {chains} encode chains "
        f"= {chains / wave:.3f} waves (built in {sw.elapsed:.1f} s); buckets chosen: "
        + "; ".join(f"{len(g)} files, {sum(mix_parsed[i].channels for i in g)} chains, "
                    f"{max(mix_parsed[i].n_frames for i in g)} frames max" for g in segs))
    runs = {}
    for label, bucket, want_counts in (
            ("auto", "auto", transcode_launches([[mix_parsed[i] for i in g] for g in segs])),
            ("False", False, transcode_launches([mix_parsed]))):
        reset_launch_counts()
        got = corpus.batch_transcode(mix_streams, dev, bucket=bucket)
        torch.cuda.synchronize()
        require(launch_counts() == want_counts,
                f"bucket={label}: launches {launch_counts()}, expected {want_counts}")
        bad = [i for i, (g, w) in enumerate(zip(got, want_mix)) if g != w]
        require(not bad, f"bucket={label} != native for {len(bad)} files, first {bad[:5]}")
        runs[label] = (bucket, launch_counts())
    t = {"auto": [], "False": []}
    for rep in range(3):
        for label in (("auto", "False") if rep % 2 == 0 else ("False", "auto")):
            with Stopwatch(dev) as sw:
                corpus.batch_transcode(mix_streams, dev, bucket=runs[label][0])
            t[label].append(sw.elapsed)
    # the device side alone: each call's handle re-run (a composite one
    # for "auto", which re-runs every bucket)
    handles = {label: corpus.batch_transcode(mix_streams, dev, bucket=runs[label][0],
                                             return_fused_handle=True)[1]
               for label in ("auto", "False")}
    d = {"auto": [], "False": []}
    for rep in range(3):
        for label in (("auto", "False") if rep % 2 == 0 else ("False", "auto")):
            with Stopwatch(dev) as sw:
                handles[label]()
            d[label].append(sw.elapsed)
    for label in ("auto", "False"):
        launched = {k: v for k, v in runs[label][1].items() if k != "host_pair_files"}
        say(f"phase 6: mixed corpus bucket={label} == native, launches {launched}: e2e "
            f"{fmt_times(statistics.median(t[label]), t[label])}; handle (device side) "
            f"{fmt_times(statistics.median(d[label]), d[label])} {tag}")
    for label in ("auto", "False"):  # one more handle run, kernels timed by events
        wall_ms, spent = kernel_ms(handles[label], dev)
        say(f"phase 6: mixed corpus bucket={label} handle with kernel events: wall "
            f"{wall_ms:.3f} ms; " + ", ".join(f"{k} {v:.3f} ms" for k, v in spent.items())
            + f"; outside the kernels (relayout, lens, packing) "
            f"{wall_ms - sum(spent.values()):.3f} ms {tag}")
    del handles
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
