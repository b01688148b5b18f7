"""Entry points of the port for a harness: the flagship step as a callable,
and a multi-device dry run.

    python -m qoaudio_tpu_torch.graft_entry

The counterpart of the JAX tier's ``__graft_entry__.py``.  :func:`entry`
hands out the flagship compute step (the bit-exact encoder on 16 chains x 1
frame) with example arguments; :func:`dryrun_multichip` runs the sharded
train of compute on a small input over a mesh and holds every output
against the scalar oracle (``reference.py``) or the ``"numpy"`` backend.
The dry run is in process: one torch process drives any list of devices
(``parallel/mesh.py``), so it needs no child with its own device count.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from . import bitstream as bs
from . import codec
from . import format as fmt
from . import reference as ref
from .ops import cuda_encode
from .parallel import corpus
from .parallel import mesh as pmesh
from .types import QoaDesc
from .utils.transfer import fetch_arrays, put_arrays


class DryRunFailure(RuntimeError):
    """A step of the dry run gave another result than the oracle."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise DryRunFailure(msg)


def entry(device="cuda"):
    """(fn, example_args) for the flagship compute step on ``device``.

    The flagship kernel is the bit-exact QOA encoder: all 16 scalefactor
    candidates per window, the LMS chained across the windows.  The
    arguments are (state, samples, lens): 16 chains x 1 frame of seeded
    int16 samples, every length 20, the encoder's initial state;
    ``fn(*args)`` returns (words int64 (F, W, N) logical, new state) from
    the masked encode wrapper — the kernel on a CUDA device, the plain
    version on the CPU.
    """
    N, F = 16, 1  # chains (files x channels), frames
    rng = np.random.default_rng(0)
    samples = rng.integers(-30000, 30000, (F, 256, 20, N)).astype(np.int16)
    lens = np.full((F, 256, N), 20, np.int32)
    args = put_arrays([codec.initial_encoder_state(0, N), samples, lens], device)

    def fn(state, samples, lens):
        new_state, _, words = cuda_encode.encode_frames(state, samples, lens)
        return words, new_state

    return fn, tuple(args)


def _dryrun_mesh(n_devices: int, devices) -> pmesh.Mesh:
    if devices is not None:
        return pmesh.make_mesh(devices=devices)
    cards = pmesh.make_mesh().devices  # raises with no card
    return pmesh.Mesh(tuple(cards[i % len(cards)] for i in range(n_devices)))


def _on_mesh(mesh, parts, what: str) -> None:
    """Each shard's output lives on the device the mesh gave that shard."""
    for k, (t, d) in enumerate(zip(parts, mesh.devices)):
        _require(t.device == d, f"{what}: shard {k} lives on {t.device}, the mesh gave {d}")


def _oracle_chain(x_chain, n_windows: int):
    """The scalar oracle on one chain from the encoder's initial state:
    (slice words, the decoder's reconstruction of them)."""
    lms = ref.Lms.encoder_init()
    words, recon = [], []
    for w in range(n_windows):
        word, _, lms2 = ref.encode_slice_py([int(v) for v in x_chain[w]], lms)
        words.append(word)
        dec = ref.Lms(list(lms.history), list(lms.weights))
        sf = word >> 60
        for i in range(fmt.QOA_SLICE_LEN):
            dq = ref._DEQUANT[sf][(word >> (57 - 3 * i)) & 7]
            r = ref._clamp_i16(dec.predict() + dq)
            recon.append(r)
            dec.update(r, dq)
        lms = lms2
    return words, recon


def _step_sharded_encode(mesh, x, lens, state):
    """Step 1: ``encode_frames_sharded``; every word equals the oracle's."""
    states, snaps, words = pmesh.encode_frames_sharded(mesh, state, x, lens)
    for parts, what in ((states, "state"), (snaps, "snaps"), (words, "words")):
        _on_mesh(mesh, parts, f"step 1, sharded encode {what}")
    words = pmesh.gather_chains(words).view(np.uint64)  # (1, W, N)
    snaps = pmesh.gather_chains(snaps)
    W, N = words.shape[1:]
    oracle = [_oracle_chain(x[0, :, :, n], W) for n in range(N)]
    for n in range(N):
        for w in range(W):
            _require(int(words[0, w, n]) == oracle[n][0][w],
                     f"step 1: chain {n} window {w}: sharded word "
                     f"{int(words[0, w, n]):#x} != oracle {oracle[n][0][w]:#x}")
    print(f"sharded encode: words {tuple(words.shape)} over {mesh.size} shards; "
          f"bit-exact vs scalar oracle: {N} chains x {W} windows")
    return words, snaps, oracle


def _step_sharded_decode(mesh, words, snaps, oracle):
    """Step 2: ``decode_chains_sharded`` of step 1's words, checked against
    the oracle's reconstruction."""
    words_be = np.ascontiguousarray(words[0]).byteswap().view(np.int64)  # (W, N) raw BE
    out = pmesh.decode_chains_sharded(mesh, np.ascontiguousarray(snaps[0]), words_be)
    _on_mesh(mesh, out, "step 2, sharded decode")
    out = pmesh.gather_chains(out)  # (W, 20, N)
    for n in range(out.shape[2]):
        got = out[:, :, n].reshape(-1)
        _require([int(v) for v in got] == oracle[n][1],
                 f"step 2: chain {n}: sharded decode != the oracle's reconstruction")
    print(f"sharded decode bit-exact vs scalar oracle: {out.shape[2]} chains x "
          f"{out.shape[0] * fmt.QOA_SLICE_LEN} samples")


def _numpy_pair(data: bytes) -> bytes:
    out = codec.decode_all(data, backend="numpy")
    return codec.encode_all(
        out.samples, QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel),
        backend="numpy")


def _step_batch_encode(mesh, files):
    """Step 3: the corpus layer's ``batch_encode`` under the mesh (chain
    padding to the mesh multiple, per-file window layout, byte
    reassembly); streams equal the oracle's single-file encodes."""
    streams = corpus.batch_encode(files, mesh=mesh)
    for (pcm, d), data in zip(files, streams):
        _require(data == codec.encode_all(pcm, d, backend="numpy"),
                 f"step 3: corpus stream ({d.channels} ch, {d.samples} spc) diverges "
                 "from the scalar oracle")
    print(f"corpus batch_encode sharded: {len(files)} files byte-identical to "
          "single-file oracle encodes")
    return streams


def _step_batch_decode(mesh, files, streams):
    """Step 4: ``batch_decode`` of step 3's streams under the mesh."""
    outs = corpus.batch_decode(streams, mesh=mesh)
    for (_, d), data, o in zip(files, streams, outs):
        want = codec.decode_all(data, backend="numpy")
        _require((o.num_channels, o.sample_rate) == (d.channels, d.sample_rate)
                 and np.array_equal(o.samples, want.samples),
                 f"step 4: sharded batch_decode diverges ({d.channels} ch, {d.samples} spc)")
    print(f"corpus batch_decode sharded: {len(streams)} files bit-exact vs the "
          "scalar-path decode")


def _step_batch_transcode(mesh, streams):
    """Step 5: the device-resident ``batch_transcode`` under the mesh;
    bytes equal the host decode -> encode pair."""
    got = corpus.batch_transcode(streams, mesh=mesh)
    for i, (data, g) in enumerate(zip(streams, got)):
        _require(g == _numpy_pair(data),
                 f"step 5: sharded batch_transcode diverges from the host pair (file {i})")
    print(f"corpus batch_transcode sharded: {len(streams)} files byte-identical to "
          "the host decode->encode pair")


def mixed_corpus(mesh_size: int, rng):
    """Step 6's files: 4 x ``mesh_size`` one-frame clips (mono and stereo,
    a few windows each) and one two-frame mono file."""
    files = []
    for i in range(4 * mesh_size):
        n, ch = 60 + 13 * i, 1 + i % 2
        files.append((rng.integers(-25000, 25000, n * ch).astype(np.int16),
                      QoaDesc(ch, (44100, 22050)[i % 2], n)))
    n = fmt.QOA_FRAME_LEN + 37
    files.append((rng.integers(-25000, 25000, n).astype(np.int16), QoaDesc(1, 48000, n)))
    return files


def _buckets(mesh, parsed, chunk_frames: int = 64):
    e_mult, overhead = corpus._bucket_model(mesh)
    return corpus._length_buckets([p.n_frames for p in parsed], [p.channels for p in parsed],
                                  e_mult, chunk_frames, overhead)


def _step_bucketed_transcode(mesh, files):
    """Step 6: a mixed-length corpus through ``batch_transcode`` with
    ``bucket="auto"``: under the mesh, and on the mesh's first device with
    the transcode handle, whose re-run gives the bytes of ``bucket=False``
    (the mesh path hands out no handle).  The partition the cost model
    chose is printed; whether or not it cuts this small corpus, the same
    bytes are required."""
    streams = [codec.encode_all(p, d, backend="numpy") for p, d in files]
    want = [_numpy_pair(s) for s in streams]
    parsed = [bs.parse_file_arrays(s) for s in streams]
    one = pmesh.Mesh(mesh.devices[:1])
    for label, m in ((f"the {mesh.size}-shard mesh", mesh), (f"{one.devices[0]} alone", one)):
        segs = _buckets(m, parsed)
        print(f"bucketed transcode on {label}: "
              + ("one call (the cost model does not cut)" if segs is None else
                 "; ".join(f"{len(g)} files, {max(parsed[i].n_frames for i in g)} "
                           "frames max" for g in segs)))
    single = corpus.batch_transcode(streams, mesh=mesh, bucket=False)
    auto = corpus.batch_transcode(streams, mesh=mesh, bucket="auto")
    segs = _buckets(one, parsed)
    got, handle = corpus.batch_transcode(streams, one.devices[0], bucket="auto",
                                         return_fused_handle=True)
    _require(single == want, "step 6: bucket=False under the mesh diverges from the host pair")
    _require(auto == single, "step 6: bucket='auto' under the mesh != bucket=False")
    _require(got == single, "step 6: bucket='auto' with the handle != bucket=False")
    # the handle's re-run: every bucket's pipeline again, each assembled
    groups = [list(range(len(streams)))] if segs is None else segs
    handles = handle.handles if segs is not None else [handle]
    _require(len(handles) == len(groups), "step 6: one handle per bucket expected")
    rerun = [None] * len(streams)
    for h, g in zip(handles, groups):
        for i, data in zip(g, h.assemble(*fetch_arrays(h()))):
            rerun[i] = data
    _require(rerun == single, "step 6: the handle's re-run != bucket=False")
    print(f"corpus batch_transcode bucketed: {len(streams)} files, 'auto' == False == the "
          f"handle's re-run ({len(handles)} bucket(s)) == the host pair")


def dryrun_inputs(n: int):
    """The dry run's seeded inputs for an ``n``-device mesh: (samples
    (1, 2, 20, 2n) int16 for steps 1-2, the three-file corpus of steps 3-5,
    the mixed-length corpus of step 6); the corpora as (pcm, desc) pairs."""
    rng = np.random.default_rng(1)
    # N chains sharded over the mesh, 1 frame, 2 slice windows
    x = rng.integers(-25000, 25000, (1, 2, 20, 2 * n)).astype(np.int16)
    # a tiny multi-file corpus, mixed channel counts and lengths
    files = []
    for spc, ch in ((45, 2), (60, 1), (25, 3)):
        pcm = rng.integers(-25000, 25000, spc * ch).astype(np.int16)
        files.append((pcm, QoaDesc(ch, 44100, spc)))
    return x, files, mixed_corpus(n, rng)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Validate the full sharded train of compute on an ``n_devices`` mesh.

    The mesh is ``make_mesh(devices=devices)`` where ``devices`` is given
    (``("cpu",) * 4`` in the tests), else every card present, repeated up
    to ``n_devices`` (shards of one card run in turn on its stream); with
    no card and no ``devices`` it raises.  Six steps on deliberately tiny
    inputs, each bit-exact against the scalar oracle or the ``"numpy"``
    backend; raises :class:`DryRunFailure` at the first difference.
    """
    mesh = _dryrun_mesh(n_devices, devices)
    n = mesh.size
    x, files, mixed = dryrun_inputs(n)
    N = x.shape[3]
    lens = np.full(x.shape[:2] + (N,), 20, np.int32)
    words, snaps, oracle = _step_sharded_encode(
        mesh, x, lens, codec.initial_encoder_state(0, N))
    _step_sharded_decode(mesh, words, snaps, oracle)
    streams = _step_batch_encode(mesh, files)
    _step_batch_decode(mesh, files, streams)
    _step_batch_transcode(mesh, streams)
    _step_bucketed_transcode(mesh, mixed)
    print(f"dryrun_multichip OK: {n}-device mesh "
          f"({', '.join(sorted({str(d) for d in mesh.devices}))}), {N} chains sharded, "
          "encode+decode+corpus(enc/dec/transcode/bucketed) executed, bit-exact")


def main() -> int:
    fn, args = entry()
    words, state = fn(*args)
    torch.cuda.synchronize()
    print(f"entry: words {tuple(words.shape)} {words.dtype}, state {tuple(state.shape)} "
          f"on {words.device}")
    dryrun_multichip(8)
    return 0


if __name__ == "__main__":
    sys.exit(main())
