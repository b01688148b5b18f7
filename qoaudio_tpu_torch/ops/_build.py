"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The first call of a kernel wrapper compiles every ``csrc/*.cu`` with
``nvcc`` for ``sm_90a`` (one ``nvcc`` per source, all started together,
then one link) into one shared library with a plain C interface, written
to ``build/qoaudio_tpu_torch/`` beside the package and named by a hash of
the sources and flags (so an edited source never loads a stale library),
then loads it with ``ctypes``.  ``ptxas_report`` keeps what ``ptxas -v``
said of each kernel (registers, spills) in this process's build.
Pointers and the stream pass as ``c_void_p``; each C entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.

There is no fallback: if ``nvcc`` is missing or the build fails, this
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "qoaudio_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
ptxas_report: Optional[str] = None  # ptxas -v output of this process's build


class BuildFailed(RuntimeError):
    """nvcc is missing, or it refused the kernel sources."""


def find_nvcc() -> Optional[str]:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default install path; None when none exists."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(_DEFAULT_NVCC)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _lib_path(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libqoa_cuda_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/*.cu`` (or reuse the library built from the same
    sources); returns the library's path.  Raises BuildFailed."""
    global build_seconds, ptxas_report
    srcs = sources()
    if not srcs:
        raise BuildFailed(f"no CUDA sources under {CSRC}")
    path = _lib_path(srcs)
    if os.path.exists(path):
        return path
    nvcc = find_nvcc()
    if nvcc is None:
        raise BuildFailed(
            "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
            f"{_DEFAULT_NVCC}); the CUDA kernels cannot be built"
        )
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    procs = []
    t0 = time.perf_counter()
    try:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)]
        for c in cmds:
            procs.append(subprocess.Popen(c, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
        report = []
        for cmd, proc in zip(cmds, procs):
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise BuildFailed(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
                )
            report.append(err)
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise BuildFailed(
                f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n"
                f"{r.stdout}\n{r.stderr}"
            )
        os.replace(tmp, path)
    finally:
        for proc in procs:  # a failed build stops the other compiles
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in (tmp, *objs):
            if os.path.exists(f):
                os.unlink(f)
    build_seconds = time.perf_counter() - t0
    ptxas_report = "".join(report)
    return path


def ptxas_registers(report: str) -> dict:
    """Mangled kernel name -> (registers, spill bytes) from ``ptxas -v``."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qoa_decode_chains_cuda.argtypes = [p, p, i, i, p, p]
    lib.qoa_decode_chains_cuda.restype = i
    lib.qoa_decode_variant_cuda.argtypes = [p, p, i, i, p, i, i, p]
    lib.qoa_decode_variant_cuda.restype = i
    lib.qoa_encode_frames_cuda.argtypes = [p, p, p, i, i, i, p, p, p, p]
    lib.qoa_encode_frames_cuda.restype = i
    lib.qoa_encode_frames_full_cuda.argtypes = [p, p, i, i, i, p, p, p, p]
    lib.qoa_encode_frames_full_cuda.restype = i
    lib.qoa_assemble_cuda.argtypes = [p, p, i, ll, p, i, ll, p, p]
    lib.qoa_assemble_cuda.restype = i
    lib.qoa_gather_cuda.argtypes = [p, p, i, i, ll, p, p, p]
    lib.qoa_gather_cuda.restype = i
    ip = ctypes.POINTER(i)
    lib.qoa_encode_occupancy.argtypes = [ip, ip, ip]
    lib.qoa_encode_occupancy.restype = i
    lib.qoa_cuda_error_string.argtypes = [i]
    lib.qoa_cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _bind(lib)
            _lib = lib
    return _lib


def kernel_device(*tensors):
    """None when every tensor lies on the CPU (the wrapper then runs the
    plain version); the CUDA device when every tensor lies on one CUDA
    device.  Raises for anything else — nothing falls back."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"kernel inputs must all lie on the CPU or on one CUDA device, "
            f"got {sorted(str(d) for d in devices)}"
        )
    return next(iter(devices))


def require(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` has the dtype, shape and contiguity a kernel
    takes."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().qoa_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
