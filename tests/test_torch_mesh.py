"""The port's mesh (``qoaudio_tpu_torch/parallel/mesh.py``) and the corpus
layer's ``mesh=`` on the CPU.

A mesh that lists the CPU device k times stands in for k devices: each
shard (the mesh functions) or device group of whole files (the corpus
layer) runs the kernels' plain versions in turn.  Everything must equal the
unsharded port, the JAX package's mesh functions on its single-device CPU
client (``qoaudio_tpu.parallel.mesh.make_mesh()``) and the native engine.
The corpus is one-frame clips (the plain encoder costs ~1 s per full
frame): 5 files, 7 chains, so every device of a 3- or 4-device mesh
holds whole files and no file's channels straddle two devices.
"""

import numpy as np
import pytest
import torch

from qoaudio_tpu import codec, native
from qoaudio_tpu.parallel import corpus as jax_corpus
from qoaudio_tpu.parallel import mesh as jax_mesh
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
from qoaudio_tpu_torch.ops import decode as plain_decode
from qoaudio_tpu_torch.ops import encode as plain_encode
from qoaudio_tpu_torch.parallel import corpus, mesh
from qoaudio_tpu_torch.utils import transfer

from conftest import make_noise, make_sine


def _files():
    return [
        (make_noise(300, 1, seed=1), QoaDesc(1, 44100, 300)),
        (make_noise(450, 2, seed=2, amplitude=9000), QoaDesc(2, 22050, 450)),
        (make_sine(700, 1, freq=880.0), QoaDesc(1, 48000, 700)),
        (make_noise(120, 2, seed=3), QoaDesc(2, 44100, 120)),
        (make_sine(61, 1, freq=220.0), QoaDesc(1, 8000, 61)),
    ]


def _native_pair(stream):
    out = codec.decode_all(stream, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return codec.encode_all(out.samples, desc, backend="native")


@pytest.fixture(scope="module")
def clips():
    """Files, their native streams, and every reference output: the
    unsharded port and the JAX package on a mesh of its CPU client."""
    if not native.available():
        pytest.skip("native engine unavailable")
    files = _files()
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    jm = jax_mesh.make_mesh()
    ref = {
        "encode": corpus.batch_encode(files, "cpu"),
        "decode": corpus.batch_decode(streams, "cpu"),
        "transcode": corpus.batch_transcode(streams, "cpu"),
        "jax_encode": jax_corpus.batch_encode(files, mesh=jm),
        "jax_decode": jax_corpus.batch_decode(streams, mesh=jm),
        "jax_transcode": jax_corpus.batch_transcode(streams, mesh=jm),
    }
    return files, streams, ref


@pytest.fixture
def counted(monkeypatch):
    """Count the three wrappers' calls (CPU calls launch nothing)."""
    calls = {"decode": 0, "masked": 0, "full": 0}
    for mod, name, key in ((cuda_decode, "decode_chains_words", "decode"),
                           (cuda_encode, "encode_frames", "masked"),
                           (cuda_encode, "encode_frames_full", "full")):
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(mod, name, run)
    return calls


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(2)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_make_mesh_of_cpu_devices(k):
    m = mesh.make_mesh(devices=("cpu",) * k)
    assert m.size == k and m.devices == (torch.device("cpu"),) * k
    assert mesh.make_mesh(devices=["cpu"] * k) == m


def test_make_mesh_refuses_mixed_or_no_devices():
    with pytest.raises(ValueError):
        mesh.make_mesh(devices=())
    with pytest.raises(ValueError, match="must all be CPU or all CUDA"):
        mesh.make_mesh(devices=("cpu", "meta"))


def _encode_inputs(F, W, N, seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 21, size=(F, W, N)).astype(np.int32)
    x = rng.integers(-32768, 32768, size=(F, W, 20, N))
    x = np.where(np.arange(20)[None, None, :, None] < lens[:, :, None, :], x, 0)
    state = rng.integers(-40000, 40000, size=(8, N)).astype(np.int32)
    return state, x.astype(np.int16), lens


@pytest.mark.parametrize("k", [2, 4])
def test_encode_frames_sharded_matches_unsharded_and_jax(k):
    m = mesh.make_mesh(devices=("cpu",) * k)
    state, x, lens = _encode_inputs(2, 6, 8, seed=10 + k)
    want = plain_encode.encode_frames(*(torch.from_numpy(a) for a in (state, x, lens)))
    got = mesh.encode_frames_sharded(m, state, x, lens)
    assert all(len(parts) == k for parts in got)
    for g, w in zip(got, want):
        assert np.array_equal(mesh.gather_chains(g), w.numpy())

    js, jsn, jhi, jlo = jax_mesh.encode_frames_sharded(
        jax_mesh.make_mesh(), state, x.astype(np.int32), lens)
    words = (np.asarray(jhi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        jlo).astype(np.uint64)
    assert np.array_equal(mesh.gather_chains(got[0]), np.asarray(js))
    assert np.array_equal(mesh.gather_chains(got[1]), np.asarray(jsn))
    assert np.array_equal(mesh.gather_chains(got[2]).view(np.uint64), words)

    # lens=None: every window full, the full-window path on every shard
    xf = np.random.default_rng(k).integers(-32768, 32768, size=x.shape).astype(np.int16)
    want = plain_encode.encode_frames_full(torch.from_numpy(state), torch.from_numpy(xf))
    got = mesh.encode_frames_sharded(m, state, xf, None)
    for g, w in zip(got, want):
        assert np.array_equal(mesh.gather_chains(g), w.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_decode_chains_sharded_matches_unsharded_and_jax(k):
    m = mesh.make_mesh(devices=("cpu",) * k)
    rng = np.random.default_rng(20 + k)
    W, N = 5, 8
    logical = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(np.uint64) | (
        rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    words_be = logical.byteswap()
    state = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
    parts = mesh.decode_chains_sharded(m, state, words_be.view(np.int64))
    assert len(parts) == k
    got = mesh.gather_chains(parts)
    want = plain_decode.decode_chains_words(
        torch.from_numpy(state), torch.from_numpy(words_be.view(np.int64))).numpy()
    assert np.array_equal(got, want)
    sf, codes = jax_corpus._code_planes(words_be)
    jgot = jax_mesh.decode_chains_sharded(jax_mesh.make_mesh(), state, sf, codes)
    assert np.array_equal(got, np.asarray(jgot))
    assert np.array_equal(got, native.decode_chains(words_be, state))


def _same_pcm(a, b):
    return (a.num_channels, a.sample_rate) == (b.num_channels, b.sample_rate) and \
        np.array_equal(a.samples, b.samples)


@pytest.mark.parametrize("k", [1, 3, 4])
def test_batch_paths_under_mesh(clips, counted, k, tmp_path):
    files, streams, ref = clips
    m = mesh.make_mesh(devices=("cpu",) * k)
    corpus.host_pair_files = 0

    enc = corpus.batch_encode(files, mesh=m)
    assert enc == ref["encode"] == ref["jax_encode"] == streams
    assert counted == {"decode": 0, "masked": k, "full": 0}  # one chunk per device group

    dec = corpus.batch_decode(streams, mesh=m)
    assert counted["decode"] == k
    for g, u, j, s in zip(dec, ref["decode"], ref["jax_decode"], streams):
        assert g.samples.dtype == np.int16
        assert _same_pcm(g, u) and _same_pcm(g, j)
        assert _same_pcm(g, codec.decode_all(s, backend="native"))

    counted.update(decode=0, masked=0)
    tc = corpus.batch_transcode(streams, mesh=m)
    assert tc == ref["transcode"] == ref["jax_transcode"]
    assert tc == [_native_pair(s) for s in streams]
    # one decode and one encode chunk per device group (5 files over k)
    assert counted == {"decode": k, "masked": k, "full": 0}
    assert corpus.host_pair_files == 0

    paths = []
    for i, s in enumerate(streams):
        paths.append(tmp_path / f"c{i}.qoa")
        paths[-1].write_bytes(s)
    rep = corpus.transcode_corpus([str(p) for p in paths], mesh=m,
                                  out_dir=str(tmp_path / "out"))
    assert rep.ok and all(r["exact"] for r in rep.results)
    for p, want in zip(paths, ref["encode"]):
        assert (tmp_path / "out" / p.name).read_bytes() == want


def test_more_devices_than_files(counted):
    if not native.available():
        pytest.skip("native engine unavailable")
    files = _files()[3:]  # 2 files, 3 chains
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    m = mesh.make_mesh(devices=("cpu",) * 4)
    assert corpus.batch_transcode(streams, mesh=m) == [_native_pair(s) for s in streams]
    # two device groups hold a file; the other two launch nothing
    assert counted == {"decode": 2, "masked": 2, "full": 0}
    assert corpus.batch_encode(files, mesh=m) == streams  # two devices hold a file
    for g, s in zip(corpus.batch_decode(streams, mesh=m), streams):
        assert _same_pcm(g, codec.decode_all(s, backend="native"))


# (name, devices, [(samples a channel, channels)], chunk_frames)
SHARD_EDGES = [
    # 5 chains over 2 devices: an equal chain split would cut the stereo file
    ("stereo_split", 2, [(300, 1), (450, 1), (700, 2), (90, 1)], 64),
    # one file over 4 devices: three of them hold nothing
    ("more_shards_than_files", 4, [(120, 2)], 64),
    ("more_shards_than_chains", 5, [(300, 1), (450, 2)], 64),
    # an 8-channel file whole on one of three devices, frame by frame
    ("eight_channels_split", 3, [(5120 + 31, 8), (61, 1)], 1),
]


@pytest.mark.parametrize("name, k, shapes, chunk", SHARD_EDGES, ids=[e[0] for e in SHARD_EDGES])
def test_batch_encode_shard_edges(name, k, shapes, chunk):
    """Each device group holds whole files, every file in one group; its
    flat buffer holds its files' PCM back to back, each chain reads its
    own channel there and ends on a zero; the bytes are the native
    engine's and the one-device port's."""
    if not native.available():
        pytest.skip("native engine unavailable")
    from qoaudio_tpu_torch.types import QoaDesc as TDesc

    pcms = [make_noise(n, c, seed=90 + i) for i, (n, c) in enumerate(shapes)]
    files = [(p, TDesc(c, 44100, n)) for p, (n, c) in zip(pcms, shapes)]
    want = [codec.encode_all(p, QoaDesc(c, 44100, n), backend="native")
            for p, (n, c) in zip(pcms, shapes)]
    m = mesh.make_mesh(devices=("cpu",) * k)
    assert corpus.batch_encode(files, mesh=m, chunk_frames=chunk) == want
    assert corpus.batch_encode(files, "cpu", chunk_frames=chunk) == want

    groups = corpus._file_groups([-(-n // 5120) for n, _ in shapes],
                                 [n * c for n, c in shapes], k)
    assert len(groups) == k
    assert sorted(i for g in groups for i in g) == list(range(len(files)))
    assert sum(1 for g in groups if g) == min(k, len(files))
    for g in groups:
        if not g:
            continue
        flat, vec = corpus._stage_encode_pcm([files[i] for i in g], "cpu")
        flat = flat.numpy()
        assert flat.size == sum(n * c + c for n, c in (shapes[i] for i in g))
        channels = [pcms[i].reshape(shapes[i])[:, c] for i in g for c in range(shapes[i][1])]
        assert vec.shape == (3, len(channels))
        for j, want_ch in enumerate(channels):
            base, stride, samples = (int(v) for v in vec[:, j])
            assert np.array_equal(flat[base : base + samples * stride : stride], want_ch)
            assert flat[base + samples * stride] == 0  # where the chain's samples end


def test_multi_frame_file_carries_state_per_shard():
    """A two-frame file on a 3-device mesh: full first frame, masked tail,
    with chunk_frames=1 so the LMS carries across launches on each device."""
    if not native.available():
        pytest.skip("native engine unavailable")
    files = [_files()[0], (make_noise(5120 + 31, 2, seed=7), QoaDesc(2, 44100, 5120 + 31))]
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    m = mesh.make_mesh(devices=("cpu",) * 3)
    assert corpus.batch_encode(files, chunk_frames=1, mesh=m) == streams


def test_device_and_mesh_are_exclusive(tmp_path):
    m = mesh.make_mesh(devices=("cpu",) * 2)
    path = str(tmp_path / "x.qoa")
    for call in (lambda **kw: corpus.batch_encode([], **kw),
                 lambda **kw: corpus.batch_decode([], **kw),
                 lambda **kw: corpus.batch_transcode([], **kw),
                 lambda **kw: corpus.transcode_corpus([path], **kw)):
        with pytest.raises(ValueError, match="exactly one of device= and mesh="):
            call(device="cpu", mesh=m)
        with pytest.raises(ValueError, match="exactly one of device= and mesh="):
            call()
    assert corpus.batch_transcode([], mesh=m) == []


def test_shard_fetch_and_gather_round_trip():
    m = mesh.make_mesh(devices=("cpu",) * 3)
    rng = np.random.default_rng(4)
    a = rng.integers(-(1 << 62), 1 << 62, size=(4, 5, 9))
    b = rng.integers(-32768, 32768, size=(2, 9)).astype(np.int16)
    sa, sb = mesh.shard_chain_arrays(m, a, b)
    assert [t.shape[-1] for t in sa] == [3, 3, 3]
    assert all(t.device.type == "cpu" for t in sa + sb)
    for parts, want in ((sa, a), (sb, b)):
        back = transfer.fetch_arrays(parts)
        for i, part in enumerate(back):
            assert np.array_equal(part, want[..., 3 * i : 3 * i + 3])
        got = mesh.gather_chains(parts)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        mesh.shard_chain_arrays(m, np.zeros((2, 7)))
    assert mesh.round_up(7, 3) == 9 and mesh.round_up(9, 3) == 9


def test_stopwatch_over_a_mesh():
    from qoaudio_tpu_torch.utils.timing import Stopwatch

    m = mesh.make_mesh(devices=("cpu",) * 2)
    with Stopwatch(m) as sw:
        corpus.batch_decode([], mesh=m)
    assert sw.elapsed > 0 and sw.device_ms is None
