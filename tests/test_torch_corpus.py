"""The port's corpus layer against the JAX package and the native host pair.

``qoaudio_tpu_torch.parallel.batch_*`` with ``device="cpu"`` (the kernels'
plain versions) must give the same bytes as ``qoaudio_tpu.parallel``'s
functions (JAX on the CPU) and as the native engine, on a tiny corpus:
a one-frame 300-sample mono clip, a 5,197-sample stereo clip over two
frames, and a one-frame 2,000-sample mono clip.
"""

import io

import numpy as np
import pytest

from qoaudio_tpu import codec
from qoaudio_tpu import format as fmt
from qoaudio_tpu import native
from qoaudio_tpu.parallel import corpus as jax_corpus
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch.parallel import corpus

from conftest import make_noise, make_sine


def _files():
    rng = np.random.default_rng(41)
    stereo = make_sine(5197, 2, freq=330.0, rate=48000).astype(np.int32)
    stereo = stereo + rng.integers(-400, 400, size=stereo.shape)
    return [
        (make_noise(300, 1, seed=42, amplitude=12000), QoaDesc(1, 44100, 300)),
        (np.clip(stereo, -32768, 32767).astype(np.int16), QoaDesc(2, 48000, 5197)),
        (make_sine(2000, 1, freq=880.0, rate=22050), QoaDesc(1, 22050, 2000)),
    ]


@pytest.fixture(scope="module")
def tiny_corpus():
    if not native.available():
        pytest.skip("native engine unavailable")
    files = _files()
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    return files, streams


def _native_pair(stream):
    out = codec.decode_all(stream, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return codec.encode_all(out.samples, desc, backend="native")


def test_batch_transcode_matches_jax_and_native(tiny_corpus):
    _, streams = tiny_corpus
    corpus.host_pair_files = 0
    got = corpus.batch_transcode(streams, "cpu")
    assert corpus.host_pair_files == 0
    assert got == jax_corpus.batch_transcode(streams)
    assert got == [_native_pair(s) for s in streams]


def test_batch_decode_matches_jax_and_native(tiny_corpus):
    _, streams = tiny_corpus
    corpus.host_pair_files = 0
    got = corpus.batch_decode(streams, "cpu")
    assert corpus.host_pair_files == 0
    jax_out = jax_corpus.batch_decode(streams)
    for g, j, s in zip(got, jax_out, streams):
        want = codec.decode_all(s, backend="native")
        assert (g.num_channels, g.sample_rate) == (want.num_channels, want.sample_rate)
        assert g.samples.dtype == np.int16
        assert np.array_equal(g.samples, j.samples)
        assert np.array_equal(g.samples, want.samples)


def test_batch_encode_matches_jax_and_native(tiny_corpus):
    files, streams = tiny_corpus
    got = corpus.batch_encode(files, "cpu")
    assert got == jax_corpus.batch_encode(files)
    assert got == streams


def test_batch_encode_full_chunks_and_tails():
    """Leading all-full chunks take the full-window path, later chunks the
    masked one; files ending mid-chunk stay bit-exact."""
    if not native.available():
        pytest.skip("native engine unavailable")
    files = [
        (make_noise(5120 * 2 + 17, 1, seed=51), QoaDesc(1, 44100, 5120 * 2 + 17)),
        (make_noise(5120 * 1 + 40, 2, seed=52), QoaDesc(2, 22050, 5120 + 40)),
    ]
    got = corpus.batch_encode(files, "cpu", chunk_frames=1)
    assert got == [codec.encode_all(p, d, backend="native") for p, d in files]


@pytest.mark.parametrize("devices, eight, groups", [
    (1, False, 1),  # one device assembles every file
    (2, False, 2),  # 4 chains over 2 devices: the stereo file whole on one of them
    (4, False, 3),  # 3 files over 4 devices: one device holds none and launches nothing
    (8, True, 4),  # 4 files over 8 devices: the 8-channel file whole on one of them
])
def test_batch_encode_assembles_straddling_files_on_the_host(devices, eight, groups,
                                                             monkeypatch):
    """On a mesh every device takes whole files, so no file's channels
    straddle two devices and none is assembled on the host: each non-empty
    device group assembles all of its files in one launch, over exactly
    its files' chains.  The bytes are the native engine's on every mesh."""
    from qoaudio_tpu_torch.ops import cuda_assemble
    from qoaudio_tpu_torch.parallel import make_mesh

    if not native.available():
        pytest.skip("native engine unavailable")
    shapes = [(300, 1), (410, 2), (200, 1)] + ([(100, 8)] if eight else [])
    files = [(make_noise(n, c, seed=90 + i, amplitude=15000), QoaDesc(c, 44100, n))
             for i, (n, c) in enumerate(shapes)]
    where = (dict(device="cpu") if devices == 1
             else dict(mesh=make_mesh(devices=("cpu",) * devices)))
    launched = []  # (chains, files) of each assembly
    real = cuda_assemble.assemble_streams

    def count(snaps, words, table, *rest):
        launched.append((words.shape[2], table.shape[1]))
        return real(snaps, words, table, *rest)

    monkeypatch.setattr(cuda_assemble, "assemble_streams", count)
    got = corpus.batch_encode(files, **where)
    assert got == [codec.encode_all(p, d, backend="native") for p, d in files]
    assert len(launched) == groups
    assert sum(n for n, _ in launched) == sum(c for _, c in shapes)
    assert sum(k for _, k in launched) == len(files)


def _as_is(pcm, desc):
    return pcm, desc


def _strided(pcm, desc):
    """Every other element of a buffer twice the size: no contiguous input."""
    wide = np.zeros(2 * pcm.size, np.int16)
    wide[::2] = pcm
    return wide[::2], desc


def _fortran(pcm, desc):
    """(T, C) in column-major order: channel-major memory, interleaved logic."""
    return np.asfortranarray(pcm.reshape(desc.samples, desc.channels)), desc


# (name, [(samples a channel, channels)], input transform, chunk_frames)
RELAYOUT_EDGES = [
    # mono, stereo and 8-channel over two frames, ragged last windows
    ("channels", [(5120 + 77, 8), (1234, 2), (6001, 1)], _as_is, 64),
    # all sub-frame: W_use < 256, a clip shorter than a window, ragged tails
    ("sub_frame", [(300, 1), (41, 2), (19, 1), (260, 8)], _as_is, 64),
    # int32 and float64 input, whose int16 cast the encoder applies
    ("int32", [(2_000, 2), (777, 1)], lambda p, d: (p.astype(np.int32), d), 64),
    ("float64", [(1_500, 1), (333, 2)], lambda p, d: (p.astype(np.float64), d), 64),
    # inputs in no contiguous interleaved layout
    ("strided", [(900, 2), (420, 8)], _strided, 64),
    ("fortran", [(5120 + 1, 2), (64, 8)], _fortran, 64),
    # one frame a launch across three frames: full chunks, then masked ones
    ("chunk1", [(5120 * 2 + 50, 1), (5120 * 3, 2)], _as_is, 1),
    ("chunk1_ragged", [(5120 * 2 + 9, 2), (5120 + 3, 8), (700, 1)], _as_is, 1),
]


@pytest.mark.parametrize("name, shapes, form, chunk", RELAYOUT_EDGES,
                         ids=[e[0] for e in RELAYOUT_EDGES])
def test_batch_encode_relayout_edges(name, shapes, form, chunk):
    """The on-device relayout over the corpora it has edges for: the bytes
    of the JAX package's batch_encode and of the native engine."""
    if not native.available():
        pytest.skip("native engine unavailable")
    pcms = [make_noise(n, c, seed=300 + i, amplitude=20000)
            for i, (n, c) in enumerate(shapes)]
    descs = [QoaDesc(c, 44100, n) for n, c in shapes]
    files = [form(p, d) for p, d in zip(pcms, descs)]
    got = corpus.batch_encode(files, "cpu", chunk_frames=chunk)
    assert got == [codec.encode_all(p, d, backend="native") for p, d in zip(pcms, descs)]
    assert got == jax_corpus.batch_encode(files, chunk_frames=chunk)


def _group_cube(files, f0, f1):
    """Frames f0 <= f < f1 of ``files``' chain-minor encoder input and lens,
    filled from ``layout_pcm``: the host cube the device gather replaces."""
    from qoaudio_tpu_torch import codec as tcodec

    N = sum(d.channels for _, d in files)
    cx = np.zeros((f1 - f0, fmt.QOA_SLICES_PER_FRAME, fmt.QOA_SLICE_LEN, N), np.int16)
    cl = np.zeros((f1 - f0, fmt.QOA_SLICES_PER_FRAME, N), np.int32)
    off = 0
    for pcm, d in files:
        xf, lf, F = tcodec.layout_pcm(pcm, d.channels, d.samples)
        n = min(F, f1) - f0
        if n > 0:
            cx[:n, :, :, off : off + d.channels] = xf[f0 : f0 + n]
            cl[:n, :, off : off + d.channels] = lf[f0 : f0 + n, :, None]
        off += d.channels
    return cx, cl


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("f0, f1", [(0, 3), (1, 3), (2, 3)])
def test_encode_input_equals_the_host_cube(k, f0, f1):
    """One chunk's device-built input and lens, device group by device
    group over ``k`` devices, equal the chain-minor cube and lens filled
    from ``layout_pcm`` for that group's files, element for element,
    zeros included."""
    import torch

    from qoaudio_tpu_torch.types import QoaDesc as TDesc

    # 13 chains; over 3 devices each group holds whole files of 2 to 8 chains
    shapes = [(5120 * 2 + 133, 2), (5120 + 1, 1), (61, 8), (5120 * 3, 2)]
    files = [(make_noise(n, c, seed=i), TDesc(c, 44100, n)) for i, (n, c) in enumerate(shapes)]
    W = fmt.QOA_SLICES_PER_FRAME
    groups = corpus._file_groups([-(-n // fmt.QOA_FRAME_LEN) for n, _ in shapes],
                                 [n * c for n, c in shapes], k)
    assert sorted(i for g in groups for i in g) == list(range(len(files)))
    assert sum(1 for g in groups if g) == k
    for g in groups:
        sub = [files[i] for i in g]
        flat, vec = corpus._stage_encode_pcm(sub, "cpu")
        v = torch.from_numpy(vec)
        x = corpus._encode_input(flat, v, f0, f1, W)
        lens = corpus._transcode_lens(v[2], f0, f1, W)
        cx, cl = _group_cube(sub, f0, f1)
        assert x.dtype == torch.int16 and np.array_equal(x.numpy(), cx)
        assert lens.dtype == torch.int32 and np.array_equal(lens.numpy(), cl)


def test_encode_input_builds_its_index_a_few_frames_at_a_time(monkeypatch):
    """With room for one frame's index a gather, the chunk's input is the
    same as with room for all of it."""
    import torch

    from qoaudio_tpu_torch.types import QoaDesc as TDesc

    files = [(make_noise(5120 * 3 + 11, 2, seed=5), TDesc(2, 44100, 5120 * 3 + 11)),
             (make_noise(700, 1, seed=6), TDesc(1, 44100, 700))]
    flat, vec = corpus._stage_encode_pcm(files, "cpu")
    v = torch.from_numpy(vec)
    whole = corpus._encode_input(flat, v, 0, 4, fmt.QOA_SLICES_PER_FRAME)
    assert np.array_equal(whole.numpy(), _group_cube(files, 0, 4)[0])
    monkeypatch.setattr(corpus, "_GATHER_ELEMENTS", 1)
    assert torch.equal(corpus._encode_input(flat, v, 0, 4, fmt.QOA_SLICES_PER_FRAME), whole)


def test_batch_transcode_chunks_carry_state_and_use_full_path(monkeypatch):
    """chunk_frames=1: the LMS carries across launches on the device, the
    leading all-full frames take the full-window path, the tail frame the
    masked one."""
    if not native.available():
        pytest.skip("native engine unavailable")
    from qoaudio_tpu_torch.ops import cuda_encode

    calls = []
    for name in ("encode_frames", "encode_frames_full"):
        fn = getattr(cuda_encode, name)
        monkeypatch.setattr(
            cuda_encode, name,
            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a),
        )
    files = [
        (make_noise(5120 * 2 + 100, 2, seed=71), QoaDesc(2, 44100, 5120 * 2 + 100)),
        (make_sine(5120 * 2, 1, freq=523.0), QoaDesc(1, 44100, 5120 * 2)),
    ]
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    got = corpus.batch_transcode(streams, "cpu", chunk_frames=1)
    assert calls == ["encode_frames_full", "encode_frames_full", "encode_frames"]
    assert got == [_native_pair(s) for s in streams]


def _nonstandard_stream():
    """Valid QOA with uniform 2560-sample frames: not the standard framing
    the device relayout assumes."""
    from qoaudio_tpu.streaming import QoaEncoder

    pcm = make_noise(2560 * 2, 1, seed=64)
    enc = QoaEncoder(QoaDesc(1, 44100, 2560 * 2))
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 2, 2560):
        enc.encode_frame(pcm[off : off + 2560], buf)
    return buf.getvalue()


def test_ineligible_streams_take_host_pair_and_are_counted(tiny_corpus):
    _, streams = tiny_corpus
    streaming_mode = fmt.pack_file_header(0) + streams[2][8:]  # parser rejects
    mixed = [streams[0], _nonstandard_stream(), streaming_mode]
    corpus.host_pair_files = 0
    got = corpus.batch_transcode(mixed, "cpu")
    assert corpus.host_pair_files == 2
    assert got == [_native_pair(s) for s in mixed]

    corpus.host_pair_files = 0
    dec = corpus.batch_decode(mixed, "cpu")
    assert corpus.host_pair_files == 1  # only the parser reject
    for g, s in zip(dec, mixed):
        assert np.array_equal(g.samples, codec.decode_all(s).samples)


def test_empty_and_invalid_inputs():
    from qoaudio_tpu_torch import errors, types

    assert corpus.batch_transcode([], "cpu") == []
    assert corpus.batch_decode([], "cpu") == []
    assert corpus.batch_encode([], "cpu") == []
    with pytest.raises(errors.InvalidSamples):
        corpus.batch_encode([(np.zeros(5, np.int16), types.QoaDesc(1, 44100, 6))], "cpu")


def test_transcode_corpus_report(tiny_corpus, tmp_path):
    _, streams = tiny_corpus
    paths = []
    for i, s in enumerate(streams):
        p = tmp_path / f"clip{i}.qoa"
        p.write_bytes(s)
        paths.append(str(p))
    rep = corpus.transcode_corpus(paths, "cpu", out_dir=str(tmp_path / "out"))
    assert rep.ok and len(rep.results) == 3
    assert rep.total_samples == sum(len(codec.decode_all(s).samples) for s in streams)
    for p, s in zip(paths, streams):
        name = tmp_path / "out" / p.rsplit("/", 1)[1]
        assert name.read_bytes() == _native_pair(s)
    assert rep.lines()[-1].startswith("corpus: 3 files")
