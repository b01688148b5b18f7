#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's batched corpus path once on one GPU.

    python3 chip_smoke.py

Phases, in order, each printing its result on its own line; any failure
raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build the CUDA kernels from ``qoaudio_tpu_torch/csrc`` and time it;
3. every kernel against its plain PyTorch version on CUDA tensors, exactly:
   the decoder on adversarial wrap-regime chains and on the fixture's
   chains, the masked and the full encoder on random windows;
4. the main path at real size: a 33-file corpus (the bench's 32-file
   recipe plus the fixture) through ``batch_transcode``, ``batch_decode``
   and ``batch_encode`` on ``cuda``; every file byte-equal to the native
   host engine, every kernel launched, no file on the host pair; each
   kernel against its plain version again on the inputs the main path
   gave it (the encoders' first two frames), both timed; the end-to-end
   time and each entry point's kernel time;
5. one JSON line of kernels, then ``{"ok": true, "device": ...}`` last.

Without a CUDA device it exits 2 and prints no result.  It never imports
jax: the port and the host tier it re-exports do not need it.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.modules["jax"] = None  # the port must run without jax; importing it fails

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")
SEED = 2026
ENCODE_FRAMES_COMPARED = 2  # the plain encoder takes ~2 s per frame on the card


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


def bench_corpus(pcm: np.ndarray, channels: int, QoaDesc):
    """The bench's 32-file corpus recipe (bench.py:377-391): 64/128/256
    frames, 2/1 channels, 44.1/22.05/48 kHz, real PCM tiled from the
    fixture."""
    stereo = pcm.reshape(-1, channels)
    n_src = stereo.shape[0]
    files, pos = [], 0
    for i in range(32):
        spc = (64, 128, 256)[i % 3] * 5120
        ch = (2, 1, 2, 1)[i % 4]
        rate = (44100, 22050, 48000)[i % 3]
        idx = (pos + np.arange(spc)) % n_src
        blk = stereo[idx][:, :ch]  # mono files take the left channel
        files.append((np.ascontiguousarray(blk).reshape(-1), QoaDesc(ch, rate, spc)))
        pos = (pos + spc + 9973) % n_src
    return files


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2

    from qoaudio_tpu_torch import bitstream, codec, native, types
    from qoaudio_tpu_torch.ops import _build, cuda_decode, cuda_encode
    from qoaudio_tpu_torch.ops import decode as plain_decode
    from qoaudio_tpu_torch.ops import encode as plain_encode
    from qoaudio_tpu_torch.parallel import corpus
    from qoaudio_tpu_torch.utils.timing import Stopwatch, bench_fn

    QoaDesc = types.QoaDesc
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
    }
    # (module, wrapper attribute, plain version) of each kernel
    wrappers = {
        "decode": (cuda_decode, "decode_chains_words", plain_decode.decode_chains_words),
        "masked": (cuda_encode, "encode_frames", plain_encode.encode_frames),
        "full": (cuda_encode, "encode_frames_full", plain_encode.encode_frames_full),
    }
    max_err = {k: 0.0 for k in kernels}

    def compare(key, *args, what: str):
        """Kernel == plain version exactly on these CUDA inputs."""
        mod, attr, plain = wrappers[key]
        got, want = getattr(mod, attr)(*args), plain(*args)
        if key == "decode":
            got, want = (got,), (want,)
        err = max_abs_err(got, want)
        max_err[key] = max(max_err[key], err)
        require(err == 0, f"{key} kernel != plain on {what} (max err {err})")
        return got

    @contextlib.contextmanager
    def wrapped(make):
        """Route every wrapper call through ``make(key, wrapper)``."""
        saved = {k: getattr(mod, attr) for k, (mod, attr, _) in wrappers.items()}
        for k, (mod, attr, _) in wrappers.items():
            setattr(mod, attr, make(k, saved[k]))
        try:
            yield
        finally:
            for k, (mod, attr, _) in wrappers.items():
                setattr(mod, attr, saved[k])

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

    # ---- phase 3: each kernel against its plain version ----
    rng = np.random.default_rng(SEED)

    N, W = 4096, 256  # decoder, adversarial wrap-regime chains
    wl = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(np.uint64) | (
        rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    st = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
    got = compare("decode", torch.from_numpy(st).to(dev),
                  torch.from_numpy(wl.byteswap().view(np.int64)).to(dev),
                  what="wrap-regime chains")
    require(np.array_equal(got[0].cpu().numpy(), native.decode_chains(wl.byteswap(), st)),
            "decode kernel != native engine on wrap-regime chains")
    say(f"phase 3: decode kernel == plain == native, wrap-regime chains W={W} N={N}")

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

    # ---- phase 4: the main path at real size ----
    fix_dec = codec.decode_all(fixture, backend="native")
    files = bench_corpus(fix_dec.samples, fix_dec.num_channels, QoaDesc)
    files.append((fix_dec.samples, QoaDesc(fix_dec.num_channels, fix_dec.sample_rate,
                                           fix_dec.samples_per_channel)))
    streams = [codec.encode_all(p, d, backend="native") for p, d in files[:-1]]
    streams.append(fixture)
    total = sum(d.samples * d.channels for _, d in files)
    dec_chains = sum(-(-d.samples // 5120) * d.channels for _, d in files)
    enc_chains = sum(d.channels for _, d in files)
    say(f"phase 4: corpus {len(streams)} files, {total} samples, "
        f"{dec_chains} decode chains, {enc_chains} encode chains, "
        f"{sum(len(s) for s in streams)} bytes compressed")

    want_dec = [codec.decode_all(s, backend="native") for s in streams]
    want_tc = [
        codec.encode_all(o.samples, QoaDesc(o.num_channels, o.sample_rate,
                                             o.samples_per_channel), backend="native")
        for o in want_dec
    ]
    want_enc = [codec.encode_all(p, d, backend="native") for p, d in files]

    # the counted run; each kernel's first inputs are kept for the
    # comparison below
    captured = {}

    def capture(key, fn):
        def run(*args):
            if key not in captured:
                captured[key] = tuple(a.clone() for a in args)
            return fn(*args)
        return run

    cuda_decode.launches = 0
    cuda_encode.masked_launches = 0
    cuda_encode.full_launches = 0
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
    }
    host_pairs = corpus.host_pair_files
    say(f"phase 4: launches decode={counts['decode']} masked={counts['masked']} "
        f"full={counts['full']}, host_pair_files={host_pairs}")
    for key, n in counts.items():
        require(n > 0, f"kernel {key} never launched on the main path")
        kernels[key]["launches"] = n
    require(host_pairs == 0, f"{host_pairs} files took the host pair")

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
        if key != "decode":  # state (8, N) stays; samples and lens lose frames
            args = tuple(a if a.dim() == 2 else a[:ENCODE_FRAMES_COMPARED].contiguous()
                         for a in args)
        compare(key, *args, what="main-path inputs")
        mod, attr, plain = wrappers[key]
        k_s = bench_fn(getattr(mod, attr), *args, device=dev, warmup=2, iters=10)[0]
        p_s = bench_fn(plain, *args, device=dev, warmup=0, iters=1)[0]
        shape = "x".join(str(n) for n in args[1].shape)
        kernels[key].update(ms=k_s * 1e3, plain_ms=p_s * 1e3, timed_shape=shape)
        say(f"phase 4: {key} kernel == plain on main-path inputs {shape}: "
            f"kernel {k_s * 1e3:.4f} ms, plain {p_s * 1e3:.2f} ms {tag}")
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
    spent = {k: 0.0 for k in kernels}

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

    main_path_ms = {k: 0.0 for k in kernels}
    with wrapped(timed):
        for name, call in (("batch_transcode", lambda: corpus.batch_transcode(streams, dev)),
                           ("batch_decode", lambda: corpus.batch_decode(streams, dev)),
                           ("batch_encode", lambda: corpus.batch_encode(files, dev))):
            spent.update({k: 0.0 for k in spent})
            with Stopwatch(dev) as sw:
                call()
            wall_ms = sw.elapsed * 1e3
            say(f"phase 4: {name} with kernel events: wall {wall_ms:.3f} ms; "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in spent.items())
                + f"; outside the kernels {wall_ms - sum(spent.values()):.3f} ms {tag}")
            for k, v in spent.items():
                main_path_ms[k] += v
    for key, ms in main_path_ms.items():
        kernels[key]["main_path_ms"] = ms

    # ---- phase 5: results ----
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "timed_shape", "main_path_ms")
    say(json.dumps({"kernels": [{k: v[k] for k in order} for v in kernels.values()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
