"""Native host-runtime engine: build-on-demand C++ kernels via ctypes.

A copy of ``qoaudio_tpu/native/__init__.py``, with its own copy of
``qoa_kernels.cpp`` (the code is the original's; tests/test_torch_host.py
pins it), built into ``qoaudio_tpu_torch/native/qoa_kernels.so``.

The port's CUDA kernels (ops/) own the batched device path; this module
owns the host/IO path (streaming objects, one-shot single-file
transcode) where host<->device transfer latency dominates.  See
qoa_kernels.cpp for the kernel design notes.

The shared library is compiled on first use with the local toolchain
(g++ -O3 -march=native) and cached next to the source.  ``available()``
returns False if no compiler or the build fails: that is the host tier's
own contract (its callers take the numpy backend, or ``"torch"`` on a
device the caller names), not a fallback of any device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "qoa_kernels.cpp")
_LIB_PATH = os.path.join(_HERE, "qoa_kernels.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_allocator_tuned = False

_SLICE_LEN = 20


def tune_allocator() -> None:
    """Keep large numpy buffers on the heap instead of per-call mmap.

    glibc serves >=128 KB allocations via mmap and unmaps them on free, so
    every one-shot decode/encode call pays soft page faults re-touching its
    ~10-20 MB of staging/output buffers.  Raising M_MMAP_THRESHOLD once
    per process lets the heap recycle those buffers fault-free — measured
    1.16-1.59x on the host-tier e2e paths (decode_all 9.7 -> 6.1 ms at the
    fixture, measured for ``qoaudio_tpu``'s host tier).  The heap is never
    trimmed either: a corpus call's per-file arrays and output bytes run
    to GBs, and each call that freed them back to the kernel would fault
    them all in again on the next.  Process-global by nature, so: applied
    only when the native engine is loaded or a batched corpus call runs,
    ``QOA_NO_MALLOPT=1`` opts out, and non-glibc platforms skip silently.
    """
    global _allocator_tuned
    if _allocator_tuned or os.environ.get("QOA_NO_MALLOPT"):
        return
    _allocator_tuned = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(-3, 1 << 26)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, -1)  # M_TRIM_THRESHOLD: never trim
    except (OSError, AttributeError):
        pass


def _build(force: bool = False) -> Optional[str]:
    """Compile the kernels; returns the .so path or None.

    The object is written to a process-unique temp name and os.replace'd
    into place, so concurrent builds (parallel test runners, a
    subprocess racing its parent) each produce a whole .so and the
    atomic rename wins/loses cleanly — never a torn file.
    """
    if not os.path.exists(_SRC):
        return None
    if (
        not force
        and os.path.exists(_LIB_PATH)
        and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)
    ):
        return _LIB_PATH
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        # -mprefer-vector-width=512: GCC otherwise splits the 512-bit
        # vector-extension ops into ymm pairs on AVX-512 targets (measured
        # ~5-12% slower encode); harmless where unsupported (second try)
        for flags in (
            ["-O3", "-march=native", "-mprefer-vector-width=512"],
            ["-O3", "-march=native"],
            ["-O2"],
        ):
            cmd = [
                "g++", *flags, "-fno-strict-aliasing", "-shared", "-fPIC",
                "-o", tmp, _SRC,
            ]
            try:
                r = subprocess.run(cmd, capture_output=True, timeout=120)
            except (OSError, subprocess.TimeoutExpired):
                return None
            if r.returncode == 0:
                os.replace(tmp, _LIB_PATH)
                return _LIB_PATH
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        tune_allocator()
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # a stale/torn .so from an older interrupted build: rebuild once
            path = _build(force=True)
            try:
                lib = ctypes.CDLL(path) if path else None
            except OSError:
                lib = None
            if lib is None:
                _build_failed = True
                return None
        i64 = ctypes.c_int64
        p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        def _bind(lib):
            lib.qoa_gather_frames.argtypes = [
                p_u8, i64, i64, i64, i64, i64, i64, i64, p_u64, p_i32,
            ]
            lib.qoa_gather_frames.restype = None
            lib.qoa_decode_chains.argtypes = [p_u64, p_i32, i64, i64, p_i16]
            lib.qoa_decode_chains.restype = None
            lib.qoa_interleave.argtypes = [p_i16, i64, i64, i64, i64, p_i16]
            lib.qoa_interleave.restype = None
            lib.qoa_decode_interleaved_stereo.argtypes = [
                p_u64, p_i32, i64, i64, p_i16,
            ]
            lib.qoa_decode_interleaved_stereo.restype = None
            lib.qoa_decode_interleaved_mono.argtypes = [
                p_u64, p_i32, i64, i64, p_i16,
            ]
            lib.qoa_decode_interleaved_mono.restype = None
            lib.qoa_decode_interleaved_stereo_raw.argtypes = [
                p_u8, i64, i64, i64, i64, p_i16,
            ]
            lib.qoa_decode_interleaved_stereo_raw.restype = None
            lib.qoa_decode_interleaved_mono_raw.argtypes = [
                p_u8, i64, i64, i64, i64, p_i16,
            ]
            lib.qoa_decode_interleaved_mono_raw.restype = None
            lib.qoa_has_fused_interleaved.argtypes = []
            lib.qoa_has_fused_interleaved.restype = i64
            lib.qoa_encode_windows.argtypes = [
                p_i16, p_i32, i64, i64, p_i32, p_u64,
            ]
            lib.qoa_encode_windows.restype = None
            lib.qoa_encode_file.argtypes = [
                p_i16, p_i32, i64, i64, i64, p_i32, p_u64, p_i32,
            ]
            lib.qoa_encode_file.restype = None
            lib.qoa_encode_fallbacks.argtypes = []
            lib.qoa_encode_fallbacks.restype = i64

        try:
            _bind(lib)
        except AttributeError:
            # a stale .so from an older package version (reinstalls can
            # leave one behind with a NEWER mtime than the fresh source):
            # force one rebuild, then degrade gracefully — available()
            # promises False rather than raising
            path = _build(force=True)
            try:
                lib = ctypes.CDLL(path) if path else None
                if lib is not None:
                    _bind(lib)
            except (OSError, AttributeError):
                lib = None
            if lib is None:
                _build_failed = True
                return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def gather_frames(
    data: bytes, offset: int, F_full: int, frame_bytes: int, C: int,
    W0: int, W: int, N: int
):
    """Gather a uniform fixed-mode stream's full frames into chain arrays.

    Returns (words_be (W, N) raw big-endian u64, state (8, N) int32); the
    padding columns/rows (tail frame, short windows) are zeroed for the
    caller to fill.
    """
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    words_be = np.zeros((W, N), dtype=np.uint64)
    state = np.zeros((8, N), dtype=np.int32)
    lib.qoa_gather_frames(
        buf, offset, F_full, frame_bytes, C, W0, W, N, words_be, state
    )
    return words_be, state


def decode_chains(words_be: np.ndarray, state: np.ndarray) -> np.ndarray:
    """Decode N chains -> (W, 20, N) int16 (untrimmed).

    words_be: (W, N) uint64, raw BIG-ENDIAN slice words (zero padding ok).
    state:    (8, N) int32 frame-start LMS.
    """
    lib = _load()
    W, N = words_be.shape
    words_be = np.ascontiguousarray(words_be, dtype=np.uint64)
    state = np.ascontiguousarray(state, dtype=np.int32)
    out = np.empty((W, _SLICE_LEN, N), dtype=np.int16)
    lib.qoa_decode_chains(words_be, state, W, N, out)
    return out


def has_fused_interleaved() -> bool:
    """True when the build tier fuses decode+interleave (AVX-512)."""
    lib = _load()
    return lib is not None and bool(lib.qoa_has_fused_interleaved())


def decode_interleaved(
    words_be: np.ndarray,
    state: np.ndarray,
    C: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fused decode + interleave for C in (1, 2): (F*W*20, C) int16.

    Dispatches to the stereo or mono kernel; identical contract to
    :func:`decode_interleaved_stereo` with F = N // C untrimmed frames at
    a uniform W*20 row stride.
    """
    if C == 2:
        return decode_interleaved_stereo(words_be, state, out=out)
    if C != 1:
        raise ValueError("fused interleave supports C in (1, 2)")
    lib = _load()
    W, N = words_be.shape
    words_be = np.ascontiguousarray(words_be, dtype=np.uint64)
    state = np.ascontiguousarray(state, dtype=np.int32)
    need = N * W * _SLICE_LEN
    if out is None:
        out = np.empty((need, 1), dtype=np.int16)
    elif (
        out.shape != (need, 1)
        or out.dtype != np.int16
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous int16 of shape ({need}, 1)"
        )
    lib.qoa_decode_interleaved_mono(words_be, state, W, N, out)
    return out


def decode_interleaved_stereo(
    words_be: np.ndarray, state: np.ndarray, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """Fused decode + interleave of N = 2F stereo chains.

    Returns (F*W*20, 2) int16 — frame f's FULL untrimmed samples at rows
    f*W*20..(f+1)*W*20, byte-identical to
    ``interleave_trim(decode_chains(words_be, state), F, 2, F*W*20)`` but
    without the (W, 20, N) intermediate's DRAM round trip (1.9-2.2x at
    typical file shapes).  Callers slice each frame's valid samples.

    ``out``: optional destination, exactly (F*W*20, 2) C-contiguous int16
    (e.g. a view into a larger drain buffer) — skips the allocation AND
    the consumer's copy-out.
    """
    lib = _load()
    W, N = words_be.shape
    words_be = np.ascontiguousarray(words_be, dtype=np.uint64)
    state = np.ascontiguousarray(state, dtype=np.int32)
    need = (N // 2) * W * _SLICE_LEN
    if out is None:
        out = np.empty((need, 2), dtype=np.int16)
    elif (
        out.shape != (need, 2)
        or out.dtype != np.int16
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous int16 of shape ({need}, 2)"
        )
    lib.qoa_decode_interleaved_stereo(words_be, state, W, N, out)
    return out


def decode_interleaved_stereo_raw(
    data,
    offset: int,
    F_full: int,
    frame_bytes: int,
    W: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fused decode of F_full UNIFORM full stereo frames from raw bytes.

    Reads slice words and LMS straight from the frame-major file bytes
    (zero staging, zero parse gather — 1.44-1.54x the parse+kernel
    pipeline at typical shapes).  The caller must have validated the
    uniform geometry (identical frame header words; frame_bytes ==
    qoa_frame_size(2, W)); the short tail frame is decoded separately
    via :func:`decode_interleaved`.

    Returns (F_full*W*20, 2) int16 full untrimmed frames (``out`` may be
    a view into a larger drain buffer, exactly that shape).
    """
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    need = F_full * W * _SLICE_LEN
    if out is None:
        out = np.empty((need, 2), dtype=np.int16)
    elif (
        out.shape != (need, 2)
        or out.dtype != np.int16
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous int16 of shape ({need}, 2)"
        )
    if offset + F_full * frame_bytes > buf.size:
        raise ValueError("frame range exceeds the data buffer")
    lib.qoa_decode_interleaved_stereo_raw(
        buf, offset, F_full, frame_bytes, W, out
    )
    return out


def decode_interleaved_mono_raw(
    data,
    offset: int,
    F_full: int,
    frame_bytes: int,
    W: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Mono sibling of :func:`decode_interleaved_stereo_raw`.

    Returns (F_full*W*20, 1) int16 full untrimmed frames decoded straight
    from the frame-major file bytes (two windows per 128-bit load round).
    """
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    need = F_full * W * _SLICE_LEN
    if out is None:
        out = np.empty((need, 1), dtype=np.int16)
    elif (
        out.shape != (need, 1)
        or out.dtype != np.int16
        or not out.flags["C_CONTIGUOUS"]
    ):
        raise ValueError(
            f"out must be C-contiguous int16 of shape ({need}, 1)"
        )
    if offset + F_full * frame_bytes > buf.size:
        raise ValueError("frame range exceeds the data buffer")
    lib.qoa_decode_interleaved_mono_raw(
        buf, offset, F_full, frame_bytes, W, out
    )
    return out


def decode_interleaved_raw(
    data,
    offset: int,
    F_full: int,
    frame_bytes: int,
    W: int,
    C: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Raw-bytes fused decode for C in (1, 2): (F_full*W*20, C) int16."""
    if C == 2:
        return decode_interleaved_stereo_raw(
            data, offset, F_full, frame_bytes, W, out=out
        )
    if C != 1:
        raise ValueError("raw fused decode supports C in (1, 2)")
    return decode_interleaved_mono_raw(
        data, offset, F_full, frame_bytes, W, out=out
    )


def interleave_trim(decoded: np.ndarray, F: int, C: int, total: int) -> np.ndarray:
    """(W, 20, F*C) chain layout -> (total, C) interleaved trimmed PCM.

    ``total`` is the valid samples per channel; every frame must be full
    except possibly the last (the fixed-mode layout).
    """
    lib = _load()
    W = decoded.shape[0]
    decoded = np.ascontiguousarray(decoded, dtype=np.int16)
    out = np.empty((total, C), dtype=np.int16)
    lib.qoa_interleave(decoded, W, F, C, total, out)
    return out


def encode_windows(
    pcm: np.ndarray, lens: np.ndarray, W: int, state: np.ndarray
) -> np.ndarray:
    """Encode W windows of C channels; mutates ``state`` (8, C) in place.

    pcm: (T, C) int16 interleaved samples — read IN PLACE, no staging copy
         ((W*20, C) row-major is the interleaved layout); windows only read
         up to lens[w] samples, so a short final window needs no padding.
    lens: (W,) int32 valid samples per window (1..20).
    Returns (W, C) uint64 slice words (native endianness).
    """
    lib = _load()
    C = pcm.shape[1]
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    assert state.flags["C_CONTIGUOUS"] and state.dtype == np.int32
    words = np.zeros((W, C), dtype=np.uint64)
    lib.qoa_encode_windows(pcm, lens, W, C, state, words)
    return words


def encode_file(
    pcm: np.ndarray, lens: np.ndarray, W: int, interval: int, state: np.ndarray
):
    """Encode a whole fixed-mode file's windows in one native call.

    Returns (words (W, C) uint64, snaps (ceil(W/interval), 8, C) int32 —
    the carried LMS at each frame start).  Mutates ``state`` in place.
    """
    lib = _load()
    C = pcm.shape[1]
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    assert state.flags["C_CONTIGUOUS"] and state.dtype == np.int32
    words = np.zeros((W, C), dtype=np.uint64)
    n_snaps = -(-W // interval)
    snaps = np.empty((n_snaps, 8, C), dtype=np.int32)
    lib.qoa_encode_file(pcm, lens, W, C, interval, state, words, snaps)
    return words, snaps


def encode_fallbacks() -> int:
    """Monotone count of pairwise-encoder fallback events (wrap-risk
    re-evaluations, fast16 resolutions, scalar straggler walks).

    The delta across an ``encode_windows`` call measures the extra work
    the pairwise C==2 path does over the straggler-free mono16 path —
    the signal ``codec.encode_all_batch`` uses to decide whether pairing
    two mono files keeps paying (experiments/cpp_encode_dual_mono.py).
    Returns 0 when the engine is unavailable (callers treat the delta as
    "no fallbacks", which matches: no native engine, no pairing)."""
    lib = _load()
    return int(lib.qoa_encode_fallbacks()) if lib is not None else 0
