"""The port's benchmark: bit-exact QOA transcode throughput on one card.

    python -m qoaudio_tpu_torch.bench

The counterpart of the JAX tier's ``bench.py``, in one process.  Logs go to
stderr; stdout carries one JSON line in ``bench.py``'s shape: ``metric``
(``encode_msamples_per_sec_per_chip``), ``value``, ``unit``,
``vs_baseline``, every section's extras, ``decode_vs_baseline``, and also
``device`` (the card's name and power limit as ``nvidia-smi`` prints them)
and ``launches`` (the kernel launches each device section made).

Sections, in order:

* **host** — the native engine end to end on the fixture, through the
  port's own ``native/``, ``codec`` and ``streaming``: one-shot decode, the
  decode's stage attribution (a log line), streaming decode, mono decode
  and single-file encode;
* **decode** — the fixture's chains tiled to 256 windows x 32,768 chains,
  the decode kernel, checked against ``native.decode_chains`` on the first
  256 chains (cut on the device) before it is timed, 8 launches back to
  back per timed window;
* **transcode** — the 32-file corpus (mixed lengths, channels and rates,
  PCM tiled from the fixture) through ``batch_transcode``: every file
  byte-equal to the native decode -> encode pair, then bytes in to bytes
  out, then the device side alone through the transcode handle;
* **encode**, the headline — the fixture's first 16 frames repeated to
  2,048 chains (only ``channels`` chains are distinct), the LMS state
  carried from launch to launch on the device.  Before timing, the full
  and the masked kernel equal the plain encoder on the first 2 frames of
  all chains; over all frames every chain equals the distinct chain it
  repeats, and those equal the native engine's encode of the same PCM.
  The headline is the full-window kernel's rate; ``encode_masked_msps``
  is the masked kernel's on the same input with every length 20;
* **saturated** — 128 stereo files x 64 frames (256 encode chains) through
  ``batch_transcode``, four files spot-checked against the native pair.

A parity failure exits non-zero and prints no JSON line.  Device times are
CUDA events around calls in this process (``utils/timing.py``), host times
the host clock around calls that end in a synchronize: after one warm
call, at least 5 timed ones, median and best both logged, the median in
the JSON line.  ``RUST_*_MSPS`` are the Rust reference crate's rates on an
Apple M-series CPU, kept as the constants ``vs_baseline`` divides by; they
were not measured on the machine this runs on.

Set ``QOA_BENCH_TRACE=<dir>`` to wrap the device sections in a
``torch.profiler`` trace (``utils/timing.py::profiler_trace``): the Chrome
trace lands in ``<dir>`` and the top device operations in the log.
``main()`` runs on ``cuda`` and raises without a card; ``main("cpu")`` runs
the kernels' plain versions, which only a test at a small size wants.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import bitstream as bs
from . import codec, native
from . import format as fmt
from .ops import cuda_decode, cuda_encode
from .ops import encode as plain_encode
from .parallel import corpus
from .streaming import QoaDecoder
from .types import QoaDesc
from .utils.timing import Stopwatch, profiler_trace, time_calls
from .utils.transfer import fetch_arrays, put_arrays

FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures", "julien_baker_sprained_ankle.qoa",
)
# the Rust reference crate on an Apple M-series CPU: what vs_baseline divides by
RUST_ENCODE_MSPS = 41.3
RUST_DECODE_MSPS = 191.5
RUST_TRANSCODE_MSPS = 1.0 / (1.0 / RUST_DECODE_MSPS + 1.0 / RUST_ENCODE_MSPS)

N_CHAINS = 2048  # the headline's encode chains (1,024 stereo streams)
BENCH_FRAMES = 16  # frames per chain of the headline's working set


def bench_spec(n_files: int = 32) -> tuple:
    """The transcode section's corpus, as (samples per channel, channels,
    rate) per file: 64, 128 or 256 frames; stereo or mono; three rates."""
    return tuple(((64, 128, 256)[i % 3] * fmt.QOA_FRAME_LEN, (2, 1, 2, 1)[i % 4],
                  (44100, 22050, 48000)[i % 3]) for i in range(n_files))


def saturated_spec(n_files: int = 128, frames: int = 64) -> tuple:
    """The saturated section's corpus: stereo files of one length."""
    return tuple((frames * fmt.QOA_FRAME_LEN, 2, (44100, 48000)[i % 2])
                 for i in range(n_files))


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every section's size, and the only place a size is written: the
    section functions take one of these (the defaults are the benchmark's;
    a test passes a small one)."""

    n_chains: int = N_CHAINS
    frames: int = BENCH_FRAMES
    plain_frames: int = 2  # frames the plain encoder is run on (~2 s each on a card)
    chain_launches: int = 4  # encode launches per timed window, state carried
    decode_windows: int = 256
    decode_chains: int = 32768
    parity_chains: int = 256
    decode_launches: int = 8  # decode launches per timed window
    transcode_spec: tuple = bench_spec()
    saturated_spec: tuple = saturated_spec()
    spot_files: tuple = (0, 42, 85, 127)
    host_iters: int = 10
    iters: int = 5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parity_failure(what: str):
    raise SystemExit(f"PARITY FAILURE: {what}")


def rate(name: str, times, total: int) -> float:
    """Log median and best of ``times`` (seconds per ``total`` samples);
    returns the median's Msamples/s."""
    med, best = statistics.median(times), min(times)
    log(f"{name}: median {med * 1e3:.4f} ms = {total / med / 1e6:.1f} Msps, best "
        f"{best * 1e3:.4f} ms = {total / best / 1e6:.1f} Msps ({len(times)} timed calls)")
    return total / med / 1e6


def device_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them; a
    device that is no card by its name."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[device.index or 0]


def launch_counts() -> dict:
    return {"decode": cuda_decode.launches, "masked": cuda_encode.masked_launches,
            "full": cuda_encode.full_launches}


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def load_pcm(path: str = FIXTURE):
    """(stream bytes, interleaved PCM, channels, samples per channel) of
    the fixture."""
    with open(path, "rb") as f:
        data = f.read()
    out = codec.decode_all(data, backend="native")
    return data, out.samples, out.num_channels, out.samples_per_channel


def tiled_chains(data: bytes, windows: int, chains: int):
    """The stream's frame x channel chains tiled to ``chains`` columns, its
    first ``windows`` windows: (state int32 (8, N), raw big-endian words
    int64 (W, N)) as numpy."""
    pa = bs.parse_file_arrays(data)
    idx = np.arange(chains) % pa.words_be.shape[1]
    words_be = np.ascontiguousarray(pa.words_be[:windows][:, idx]).view(np.int64)
    return np.ascontiguousarray(pa.state[:, idx]), words_be


def build_files(stereo: np.ndarray, spec):
    """``spec`` (samples per channel, channels, rate) per file -> the files
    as (interleaved PCM, QoaDesc), PCM tiled from ``stereo`` (T, C); a file
    with fewer channels takes the leading ones."""
    n_src = stereo.shape[0]
    files, pos = [], 0
    for spc, ch, sample_rate in spec:
        idx = (pos + np.arange(spc)) % n_src
        blk = stereo[idx][:, :ch]
        files.append((np.ascontiguousarray(blk).reshape(-1), QoaDesc(ch, sample_rate, spc)))
        pos = (pos + spc + 9973) % n_src
    return files


def build_corpus(stereo: np.ndarray, spec):
    """:func:`build_files`, encoded by the native engine: (streams, total
    samples)."""
    files = build_files(stereo, spec)
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    return streams, sum(d.samples * d.channels for _, d in files)


def native_pair(stream: bytes) -> bytes:
    """The native engine's decode -> encode of one stream."""
    out = codec.decode_all(stream, backend="native")
    return codec.encode_all(
        out.samples, QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        backend="native")


def encode_inputs(pcm, channels: int, spc: int, n_chains: int, frames: int):
    """The headline's inputs as numpy: the first ``frames`` frames of the
    PCM in the encoder's layout, each channel repeated ``n_chains //
    channels`` times along the chain axis (chain n repeats channel n //
    reps), lens, and the encoder's initial state."""
    x, lens, F = codec.layout_pcm(pcm, channels, spc)
    F_use = min(frames, F)
    reps = max(n_chains // channels, 1)
    N = reps * channels
    xp = np.repeat(x[:F_use], reps, axis=3)
    lp = np.repeat(lens[:F_use, :, None].astype(np.int32), N, axis=2)
    return xp, lp, codec.initial_encoder_state(0, N)


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

def bench_host_paths(data, pcm, channels, spc, sizes: Sizes = Sizes()) -> dict:
    """End-to-end host-path numbers on the native engine."""
    out = {}
    total = len(pcm)
    iters = sizes.host_iters

    def timed(fn):
        return time_calls(fn, warmup=1, iters=iters)[0]

    out["decode_e2e_msps"] = round(rate(
        f"host decode end-to-end (Rust {RUST_DECODE_MSPS})",
        timed(lambda: codec.decode_all(data, backend="native")), total), 1)

    # one-shot attribution of the decode path, best of 3 per stage
    t = {k: float("inf") for k in ("parse", "kernel", "interleave", "fused", "raw")}

    def stage(key, fn):
        with Stopwatch() as sw:
            r = fn()
        t[key] = min(t[key], sw.elapsed)
        return r

    fused = native.has_fused_interleaved()
    for _ in range(3):
        pa = stage("parse", lambda: bs.parse_file_arrays(data))
        dec = stage("kernel", lambda: native.decode_chains(pa.words_be, pa.state))
        stage("interleave", lambda: native.interleave_trim(
            dec, pa.n_frames, pa.channels, int(pa.samples_per_frame.sum())))
        if fused and pa.channels == 2:
            stage("fused", lambda: native.decode_interleaved_stereo(pa.words_be, pa.state))
            geo = bs.parse_file_geometry(data)
            if geo is not None:
                stage("raw", lambda: native.decode_interleaved_stereo_raw(
                    data, fmt.QOA_HEADER_SIZE, geo.F_full, geo.frame_bytes, geo.W0))
    names = {"fused": "fused kernel+interleave", "raw": "raw-bytes kernel"}
    log("decode attribution: " + ", ".join(
        f"{names.get(k, k)} {v * 1e3:.1f} ms" for k, v in t.items() if v < float("inf")))

    times = []
    for _ in range(iters + 1):  # the first is the warm call
        dec = QoaDecoder(data, backend="native")
        with Stopwatch() as sw:
            n = len(dec.decode_pending())
        if n != total:
            parity_failure(f"streaming decode gave {n} samples of {total}")
        times.append(sw.elapsed)
    out["decode_stream_msps"] = round(rate("host streaming decode", times[1:], total), 1)

    # mono decode (the raw mono kernel path): the left channel re-encoded
    # mono, decoded one-shot; the reference crate benchmarks stereo only
    if channels == 2 and fused:
        mono_pcm = np.ascontiguousarray(pcm.reshape(-1, 2)[:, 0])
        mono = codec.encode_all(mono_pcm, QoaDesc(1, 44100, spc), backend="native")
        out["decode_mono_e2e_msps"] = round(rate(
            "host mono decode end-to-end",
            timed(lambda: codec.decode_all(mono, backend="native")), spc), 1)

    desc = QoaDesc(channels, 44100, spc)
    out["encode_single_file_e2e_msps"] = round(rate(
        f"host single-file encode end-to-end (Rust {RUST_ENCODE_MSPS})",
        timed(lambda: codec.encode_all(pcm, desc, backend="native")), total), 1)
    return out


def gated_decode(data, device, sizes: Sizes = Sizes()):
    """The decode section's launch: the fixture's chains tiled across the
    chain axis and put on ``device``, checked against
    ``native.decode_chains`` on the first ``sizes.parity_chains`` chains
    (the comparison slice is cut on the device).  Returns (launch, samples
    per launch); ``launch()`` decodes once and returns the device tensor."""
    chains = sizes.decode_chains
    state, words_be = tiled_chains(data, sizes.decode_windows, chains)
    n_win = words_be.shape[0]
    st_d, wb_d = put_arrays([state, words_be], device)

    def launch():
        return cuda_decode.decode_chains_words(st_d, wb_d)

    pa = bs.parse_file_arrays(data)
    k = min(sizes.parity_chains, chains, pa.words_be.shape[1])
    (got,) = fetch_arrays([launch()[:, :, :k].contiguous()])
    want = native.decode_chains(np.ascontiguousarray(pa.words_be[:n_win, :k]),
                                np.ascontiguousarray(pa.state[:, :k]))
    if not np.array_equal(got, want):
        parity_failure("device decode != native engine on the fixture's chains")
    log(f"parity gate: device decode bit-exact vs native engine ({k} chains)")
    return launch, n_win * fmt.QOA_SLICE_LEN * chains


def bench_decode(data, device, sizes: Sizes = Sizes()) -> dict:
    """Batched device-resident decode: ``sizes.decode_launches`` launches
    back to back per timed window, as a pipeline sends them (a launch alone
    reads a quarter longer: the next one's blocks fill the card while its
    tail drains, ``experiments/decode_calibration.py``)."""
    launch, total = gated_decode(data, device, sizes)
    chains, launches = sizes.decode_chains, sizes.decode_launches

    def window():
        out = None
        for _ in range(launches):
            out = launch()
        return out

    times, _ = time_calls(window, device=device, warmup=1, iters=sizes.iters)
    msps = rate(f"batched decode, {total // chains // fmt.QOA_SLICE_LEN} windows x "
                f"{chains} chains, {launches} launches a window",
                [t / launches for t in times], total)
    return {"decode_batched_msps": round(msps, 1)}


def transcode_rates(label, streams, total, device, gate_files, iters):
    """The shared body of the transcode sections: one warm call whose
    output feeds the gate (files ``gate_files`` against the native pair),
    ``iters`` end-to-end calls, then the handle's device side alone.
    Returns (e2e Msps, device-side Msps)."""
    log(f"{label} corpus: {len(streams)} files, {total / 1e6:.1f} Msamples, "
        f"{sum(len(s) for s in streams) / 1e6:.1f} MB compressed")
    with Stopwatch(device) as sw:
        got, handle = corpus.batch_transcode(streams, device, return_fused_handle=True)
    log(f"{label} warm call (build + staging): {sw.elapsed:.3f} s")
    for i in gate_files:
        if got[i] != native_pair(streams[i]):
            parity_failure(f"{label} batch_transcode != native decode->encode pair (file {i})")
    log(f"parity gate: {label} batch_transcode byte-identical to the native pair "
        f"({len(gate_files)} files)")
    times = []
    for _ in range(iters):
        with Stopwatch(device) as sw:
            corpus.batch_transcode(streams, device)
        times.append(sw.elapsed)
    e2e = rate(f"{label}: end to end (Rust pair {RUST_TRANSCODE_MSPS:.1f})", times, total)
    # the device side of the same pipeline (decode -> relayout -> encode ->
    # assembly), re-run through the handle with no host staging or fetch
    times, _ = time_calls(handle, device=device, warmup=1, iters=iters)
    return e2e, rate(f"{label}: device pipeline (handle)", times, total)


def bench_transcode_hbm(pcm, channels, device, sizes: Sizes = Sizes()) -> dict:
    """Batched multi-file transcode with the PCM device-resident between
    the decode and encode kernels, every file gated against the native
    pair; end to end (bytes in -> bytes out, host parse and stream
    assembly included) and the device side alone."""
    streams, total = build_corpus(np.asarray(pcm).reshape(-1, channels), sizes.transcode_spec)
    e2e, chip = transcode_rates("transcode", streams, total, device,
                                 range(len(streams)), sizes.iters)
    return {"transcode_hbm_msps": round(e2e, 1),
            "transcode_hbm_vs_baseline": round(e2e / RUST_TRANSCODE_MSPS, 2),
            "transcode_chip_msps": round(chip, 1)}


def bench_transcode_saturated(pcm, channels, device, sizes: Sizes = Sizes()) -> dict:
    """Transcode of many equal-length files: every encode chain real and
    the frame count tight.  Parity is spot-checked (the full gate runs in
    the transcode section)."""
    if channels != 2:
        raise ValueError("the saturated section needs a stereo fixture")
    streams, total = build_corpus(np.asarray(pcm).reshape(-1, channels), sizes.saturated_spec)
    e2e, chip = transcode_rates("saturated", streams, total, device, sizes.spot_files,
                                 sizes.iters)
    return {"transcode_saturated_msps": round(e2e, 1),
            "transcode_saturated_chip_msps": round(chip, 1)}


def _equal(got, want) -> bool:
    return all(g.shape == w.shape and torch.equal(g, w) for g, w in zip(got, want))


def bench_encode(pcm, channels, spc, device, sizes: Sizes = Sizes()) -> dict:
    """The headline: the encode kernels on ``sizes.n_chains`` chains x
    ``sizes.frames`` frames of real music, the state carried from launch to
    launch."""
    x_np, l_np, s_np = encode_inputs(pcm, channels, spc, sizes.n_chains, sizes.frames)
    chain_launches = sizes.chain_launches
    F, W, _, N = x_np.shape
    if not (l_np == fmt.QOA_SLICE_LEN).all():
        raise ValueError("the headline needs full frames")
    reps = N // channels
    x, lens, state0 = put_arrays([x_np, l_np, s_np], device)
    log(f"encode working set: {F} frames x {N} chains ({reps} x {channels} distinct), "
        f"{x.numel() * 2 / 1e6:.1f} MB of samples on {device}")

    # gate 1: both kernels against the plain encoder, first frames, all chains
    P = min(sizes.plain_frames, F)
    xs, ls = x[:P].contiguous(), lens[:P].contiguous()
    with Stopwatch(device) as sw:
        want = plain_encode.encode_frames_full(state0, xs)
    log(f"plain encoder on {P} frames x {N} chains: {sw.elapsed:.2f} s")
    if not _equal(cuda_encode.encode_frames_full(state0, xs), want):
        parity_failure("full encode kernel != plain encoder")
    if not _equal(cuda_encode.encode_frames(state0, xs, ls), want):
        parity_failure("masked encode kernel != plain encoder")
    # gate 2: all frames; every chain equals the distinct chain it repeats,
    # and the distinct chains the native engine's encode of the same PCM
    n_win = F * W
    nat_state = np.ascontiguousarray(codec.initial_encoder_state(channels))
    nat_words, nat_snaps = native.encode_file(
        np.asarray(pcm).reshape(-1, channels)[: F * fmt.QOA_FRAME_LEN],
        np.full(n_win, fmt.QOA_SLICE_LEN, np.int32), n_win, W, nat_state)
    for label, out in (("full", cuda_encode.encode_frames_full(state0, x)),
                       ("masked", cuda_encode.encode_frames(state0, x, lens))):
        for name, t, native_want in zip(
                ("end state", "snaps", "words"), out,
                (nat_state, nat_snaps, nat_words.view(np.int64).reshape(F, W, channels))):
            t = t.reshape(*t.shape[:-1], channels, reps)
            if not bool((t == t[..., :1]).all()):
                parity_failure(f"{label} encode kernel: repeated chains differ ({name})")
            (distinct,) = fetch_arrays([t[..., 0].contiguous()])
            if not np.array_equal(distinct, native_want):
                parity_failure(f"{label} encode kernel != native engine ({name})")
    log(f"parity gate: full and masked encode kernels == plain encoder ({P} frames) "
        f"and == native engine on the distinct chains ({F} frames)")

    total = F * fmt.QOA_FRAME_LEN * N
    steps = F * W * fmt.QOA_SLICE_LEN

    def window(fn, *rest):
        # the kernel's end state fed back as a device tensor, no host copy
        st = state0
        for _ in range(chain_launches):
            st = fn(st, x, *rest)[0]
        return st

    out = {}
    for key, label, args in (("_headline", "full", (cuda_encode.encode_frames_full,)),
                             ("encode_masked_msps", "masked",
                              (cuda_encode.encode_frames, lens))):
        times, _ = time_calls(window, *args, device=device, warmup=1, iters=sizes.iters)
        per = [t / chain_launches for t in times]
        out[key] = round(rate(f"{label} encode kernel, {N} chains x {F} frames", per, total), 1)
        log(f"  = {statistics.median(per) * 1e9 / steps:.2f} ns per dependent step "
            f"({steps} steps a launch, {chain_launches} launches a window)")
    return out


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

DEVICE_SECTIONS = ("decode", "transcode", "encode", "saturated")


def run(device, sizes: Sizes = Sizes()) -> dict:
    """Every section on ``device``; returns the JSON line's object."""
    device = torch.device(device)
    if not native.available():
        raise RuntimeError("the native host engine is unavailable (no g++?): "
                           "every parity gate compares with it")
    data, pcm, channels, spc = load_pcm()
    extra = bench_host_paths(data, pcm, channels, spc, sizes)
    bodies = {
        "decode": lambda: bench_decode(data, device, sizes),
        "transcode": lambda: bench_transcode_hbm(pcm, channels, device, sizes),
        "encode": lambda: bench_encode(pcm, channels, spc, device, sizes),
        "saturated": lambda: bench_transcode_saturated(pcm, channels, device, sizes),
    }
    launches = {}
    with profiler_trace(os.environ.get("QOA_BENCH_TRACE")) as prof:
        for name in DEVICE_SECTIONS:
            log(f"--- device section '{name}' on {device} ---")
            before = launch_counts()
            extra.update(bodies[name]())
            launches[name] = {k: v - before[k] for k, v in launch_counts().items()}
            log(f"section '{name}': kernel launches {launches[name]}")
    if prof is not None:
        by = "cuda_time_total" if device.type == "cuda" else "cpu_time_total"
        log(prof.key_averages().table(sort_by=by, row_limit=16))
    headline = extra.pop("_headline")
    return {
        "metric": "encode_msamples_per_sec_per_chip",
        "value": headline,
        "unit": "Msamples/s",
        "vs_baseline": round(headline / RUST_ENCODE_MSPS, 2),
        **extra,
        "decode_vs_baseline": round(extra["decode_e2e_msps"] / RUST_DECODE_MSPS, 2),
        "device": device_line(device),
        "launches": launches,
    }


def main(device="cuda", sizes: Sizes = Sizes()) -> int:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; the benchmark does not fall to the CPU")
    print(json.dumps(run(device, sizes)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
