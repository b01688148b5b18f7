"""The devices a corpus call runs on, and the chain-sharded kernels.

Port of ``qoaudio_tpu/parallel/mesh.py``.  A :class:`Mesh` lists the
devices of a call (:func:`make_mesh`).  The corpus layer
(``parallel/corpus.py``) gives each of them whole files, so a file's
chains always lie on one device; it uses nothing else of this module.  As
with JAX's single-controller mesh, one process drives every device: the
kernel wrappers launch on the tensors' own device and its current stream
without waiting, so one thread issues every device's launches back to back
and the devices run concurrently.

A ``Mesh`` may list a device more than once: its work then runs in turn on
that device's stream (``("cpu",) * 4`` stands in for a 4-device mesh in
the tests, ``("cuda:0",) * 4`` splits the work on one card).  On a CPU
device the kernels' plain versions run, on a CUDA device the kernels, and
nothing moves from one to the other.

The rest are the counterparts of the JAX package's mesh functions, which
the entry module's dry run (``graft_entry.py``, steps 1-2) and the tests
hold against them: :func:`shard_chain_arrays` splits the chain axis into
one contiguous part per device, :func:`encode_frames_sharded` and
:func:`decode_chains_sharded` run each part on its device, and
:func:`gather_chains` joins the outputs on the host.  The codec's chains
are independent, so none needs a collective.  There is no 128-lane
padding, ``pick_tile`` or ``subs``/``wblk`` here: the CUDA kernels take
any chain count.  ``encode_frames_sharded`` and ``decode_chains_sharded``
stand for both of JAX's pairs, the XLA functions (``mesh.py:50, :63``) and
the Pallas ``shard_map`` ones (``:71, :99``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import cuda_decode, cuda_encode
from ..utils.transfer import fetch_arrays, put_arrays


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a call, in order."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A mesh over ``devices``, or over every CUDA device (the first
    ``n_devices`` of them).  Raises when no device is given and there is
    no CUDA device: a mesh never falls to the CPU."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=... (e.g. ('cpu',) * 4)"
            )
        devices = [f"cuda:{i}" for i in range(n)][:n_devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in devs}) != 1 or devs[0].type not in ("cpu", "cuda"):
        raise ValueError(
            f"make_mesh: devices must all be CPU or all CUDA, got {[str(d) for d in devs]}"
        )
    return Mesh(devs)


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_chain_arrays(mesh: Mesh, *arrays) -> tuple:
    """Split each host array's last (chain) axis into ``mesh.size`` equal
    contiguous parts and put part k on device k.  The chain count must be
    a multiple of the mesh size (pad first).  Returns one list of
    per-device tensors per array."""
    out = []
    for a in arrays:
        n = a.shape[-1]
        if n % mesh.size:
            raise ValueError(f"chain axis {n} is not a multiple of the mesh size {mesh.size}")
        k = n // mesh.size
        out.append([put_arrays([a[..., i * k : (i + 1) * k]], d)[0]
                    for i, d in enumerate(mesh.devices)])
    return tuple(out)


def _shards(mesh: Mesh, a):
    """A list of per-device tensors as it is; a host array sharded."""
    return list(a) if isinstance(a, (list, tuple)) else shard_chain_arrays(mesh, a)[0]


def encode_frames_sharded(mesh: Mesh, state, samples, lens):
    """Run the encoder on every shard of the chain axis, each on its device.

    state (8, N), samples (F, W, 20, N) and lens (F, W, N) are host arrays
    (sharded here) or lists of per-device tensors; ``lens=None`` means every
    window is full and takes the full-window kernel.  Returns the per-shard
    (states, snaps, words) as three lists of device tensors; a shard with no
    chains launches nothing.
    """
    states = _shards(mesh, state)
    xs = _shards(mesh, samples)
    ls = [None] * mesh.size if lens is None else _shards(mesh, lens)
    out_s, out_sn, out_w = [], [], []
    for st, x, ln in zip(states, xs, ls):
        F, W, _, n = x.shape
        if n == 0:
            res = (st, x.new_zeros((F, 8, 0), dtype=torch.int32),
                   x.new_zeros((F, W, 0), dtype=torch.int64))
        elif ln is None:
            res = cuda_encode.encode_frames_full(st, x)
        else:
            res = cuda_encode.encode_frames(st, x, ln)
        out_s.append(res[0])
        out_sn.append(res[1])
        out_w.append(res[2])
    return out_s, out_sn, out_w


def decode_chains_sharded(mesh: Mesh, state, words_be) -> list:
    """Run the decoder on every shard of the chain axis, each on its device.

    state int32 (8, N) and words_be int64 (W, N) raw big-endian words, as
    host arrays or lists of per-device tensors.  Returns the per-shard
    int16 (W, 20, N_k) device tensors; a shard with no chains launches
    nothing."""
    out = []
    for st, w in zip(_shards(mesh, state), _shards(mesh, words_be)):
        if w.shape[1] == 0:
            out.append(w.new_zeros((w.shape[0], 20, 0), dtype=torch.int16))
        else:
            out.append(cuda_decode.decode_chains_words(st, w))
    return out


def gather_chains(parts: Sequence[torch.Tensor]) -> np.ndarray:
    """Per-shard tensors -> one host array, concatenated along the chain
    (last) axis; one wait covers every device."""
    return np.concatenate(fetch_arrays(parts), axis=-1)
