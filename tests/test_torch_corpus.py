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
