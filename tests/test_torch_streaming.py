"""The port's ``QoaDecoder`` / ``QoaEncoder`` against the JAX package.

``backend="torch", device="cpu"`` (the kernels' plain versions) must give
the same items, samples, bytes, LMS state and ``prev_scalefactor`` as
``qoaudio_tpu.streaming`` with ``backend="jax"`` (JAX on the CPU) and as
the native engine.  Every comparison is exact; frame headers and errors,
which are each package's own classes, compare by their fields and names.
Encodes stay at one or two frames: the plain encoder takes about a second
per full frame on the CPU.
"""

import io
import threading

import numpy as np
import pytest

from qoaudio_tpu import codec as jax_codec
from qoaudio_tpu import format as fmt
from qoaudio_tpu import streaming as jax_streaming
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch import QoaDecoder, QoaEncoder, errors, native, types
from qoaudio_tpu_torch.ops import cuda_decode

from conftest import make_noise
from test_torch_codec import frames_stream, port_desc, spy_kernels

TORCH = dict(backend="torch", device="cpu")


def _items(dec):
    """Every item of a decoder, then the error that ended it (or None).
    A frame header becomes the tuple of its fields."""
    got = []
    try:
        for item in dec:
            got.append(item if isinstance(item, int) else (
                item.num_channels, item.sample_rate, item.num_samples_per_channel))
    except Exception as e:  # the typed error is part of the item sequence
        return got, type(e)
    return got, None


def _spliced_format_change():
    a = jax_codec.encode_all(make_noise(40, 1, seed=1), QoaDesc(1, 44100, 40))
    b = jax_codec.encode_all(make_noise(40, 2, seed=2), QoaDesc(2, 44100, 40))
    return fmt.pack_file_header(80) + a[8:] + b[8:]


ITEM_CASES = {
    "ragged": lambda: frames_stream([400, 300, 500], seed=21),
    "truncated": lambda: frames_stream([400, 300, 500], channels=2, seed=22)[:-13],
    "format-change": _spliced_format_change,
}


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_decoder_items_match_jax(case):
    data = ITEM_CASES[case]()
    got, err = _items(QoaDecoder(data, readahead=2, **TORCH))
    want, want_err = _items(jax_streaming.QoaDecoder(data, backend="jax", readahead=2))
    assert getattr(err, "__name__", None) == getattr(want_err, "__name__", None)
    assert got == want
    assert err is {"ragged": None, "truncated": errors.IoError,
                   "format-change": errors.IncompatibleFrame}[case]


@pytest.mark.parametrize("source", ["fixed", "streaming"])
def test_decoder_decode_pending_matches_jax(source, monkeypatch):
    # mirrors tests/test_streaming.py::test_jax_backend_streaming_decoder
    n = 5120 * 2 + 777  # two full frames + a short, non-window-aligned tail
    pcm = make_noise(n, 2, seed=91)
    data = jax_codec.encode_all(pcm, QoaDesc(2, 44100, n))
    want = jax_codec.decode_all(data, backend="jax").samples
    calls = spy_kernels(monkeypatch)
    if source == "fixed":
        dec = QoaDecoder(data, readahead=2, **TORCH)
        assert np.array_equal(dec.decode_pending(), want)
        assert [c[1] for c in calls] == [(256, 4), (39, 2)]  # 2 + 1 frames
        return
    qoa = QoaDecoder.new_streaming(**TORCH)
    jq = jax_streaming.QoaDecoder.new_streaming(backend="jax")
    assert np.array_equal(qoa.decode_frame(data[8:]), want)
    assert np.array_equal(jq.decode_frame(data[8:]), want)
    # format change: different channel count and rate mid-stream
    d2 = jax_codec.encode_all(make_noise(300, 1, seed=92), QoaDesc(1, 22050, 300))
    got2 = qoa.decode_frame(d2[8:])
    assert np.array_equal(got2, jq.decode_frame(d2[8:]))
    assert np.array_equal(got2, jax_codec.decode_all(d2).samples)
    assert qoa.current_frame_header() == types.FrameHeader(1, 22050, 300)


def test_decoder_prefetch_worker_thread(tmp_path, monkeypatch):
    """A file source with readahead > 1 decodes the next batch on the
    prefetch worker thread: the kernel wrapper is called from there."""
    data = frames_stream([400] * 11, channels=2, seed=31)
    p = tmp_path / "many.qoa"
    p.write_bytes(data)
    threads = []
    fn = cuda_decode.decode_chains_words

    def run(*args):
        threads.append(threading.current_thread().name)
        return fn(*args)

    monkeypatch.setattr(cuda_decode, "decode_chains_words", run)
    dec = QoaDecoder.open(str(p), readahead=4, **TORCH)
    assert dec._prefetch_enabled
    got = dec.decode_pending()
    assert np.array_equal(got, jax_codec.decode_all(data, backend="jax").samples)
    assert dec.prefetch_hits >= 1
    assert any(t.startswith("qoa-prefetch") for t in threads)
    dec.into_inner().close()


def test_decoder_backend_names():
    data = frames_stream([400], seed=41)
    with pytest.raises(ValueError, match="unknown backend"):
        QoaDecoder(data, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="needs a device"):
        QoaDecoder(data, backend="torch")
    with pytest.raises(ValueError, match="needs a device"):
        QoaDecoder.new_streaming(backend="torch")
    auto = QoaDecoder(data)  # native, else numpy: the parent's choice
    assert auto._backend == ("native" if native.available() else "numpy")
    assert auto.device is None
    assert np.array_equal(auto.decode_pending(), jax_codec.decode_all(data).samples)


def test_encoder_frames_equal_oneshot_jax_and_native(monkeypatch):
    """frame-at-a-time == one ``encode`` call == the JAX package == native,
    with the same final LMS state and prev_scalefactor; ``encode`` makes at
    most ceil(F/64) + 1 kernel calls."""
    n = fmt.QOA_FRAME_LEN + 300
    pcm = make_noise(n, 1, seed=51, amplitude=30000)  # loud: sf 15, word < 0
    desc = QoaDesc(1, 44100, n)
    calls = spy_kernels(monkeypatch)
    one = QoaEncoder(port_desc(desc), **TORCH)
    oneshot = one.encode(pcm)
    assert 1 <= len(calls) <= -(-2 // 64) + 1
    del calls[:]

    enc = QoaEncoder(port_desc(desc), **TORCH)
    out = io.BytesIO()
    enc.write_header(out)
    assert enc.encode_frame(pcm[: fmt.QOA_FRAME_LEN], out) == fmt.QOA_FRAME_LEN
    assert enc.encode_frame(pcm[fmt.QOA_FRAME_LEN :], out) == 300
    # a full frame on the full-window kernel, a short one on the masked
    # kernel over only its 15 windows
    assert calls == [("encode_frames_full", (1, 256, 20, 1)),
                     ("encode_frames", (1, 15, 20, 1))]
    assert out.getvalue() == oneshot

    want = jax_codec.encode_all(pcm, desc, backend="jax")
    assert oneshot == want
    ref = jax_streaming.QoaEncoder(desc)
    assert ref.encode(pcm) == want
    for e in (one, enc):
        assert np.array_equal(e._state, ref._state)
        assert e.prev_scalefactor == ref.prev_scalefactor
    assert ref.prev_scalefactor == [15]  # the top bit of the word is set


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_encoder_state_handover_with_jax(direction):
    """``get_state`` of one encoder, ``set_state`` into the other: the
    continuation bytes equal the first encoder's own continuation."""
    n = 900
    pcm = make_noise(n, 2, seed=61)
    desc = QoaDesc(2, 48000, n)
    jax_enc = jax_streaming.QoaEncoder(desc, backend="jax")
    torch_enc = QoaEncoder(port_desc(desc), **TORCH)
    first, second = (jax_enc, torch_enc) if direction == "jax-to-torch" else (
        torch_enc, jax_enc)
    head = first.encode_frame_bytes(pcm[: 2 * 400])
    second.set_state(first.get_state())
    got = second.encode_frame_bytes(pcm[2 * 400 :])
    assert got == first.encode_frame_bytes(pcm[2 * 400 :])
    assert second.get_state()["prev_scalefactor"] == first.get_state()["prev_scalefactor"]
    assert np.array_equal(second.get_state()["history"], first.get_state()["history"])
    whole = jax_streaming.QoaEncoder(desc, backend="jax")
    assert whole.encode_frame_bytes(pcm[:800]) + whole.encode_frame_bytes(pcm[800:]) == head + got


def test_encoder_validation_before_device_work(monkeypatch):
    enc = QoaEncoder(types.QoaDesc(2, 44100, 10000), **TORCH)
    calls = spy_kernels(monkeypatch)
    out = io.BytesIO()
    with pytest.raises(errors.InvalidSamples):
        enc.encode_frame(np.empty(0, np.int16), out)
    with pytest.raises(errors.InvalidSamples):
        enc.encode_frame(np.zeros(3, np.int16), out)  # not a multiple of 2
    with pytest.raises(errors.InvalidSamples):
        enc.encode_frame(np.zeros(2 * (fmt.QOA_FRAME_LEN + 1), np.int16), out)
    with pytest.raises(errors.InvalidSamples):
        enc.encode(np.zeros(10, np.int16))
    assert not calls and out.getvalue() == b""


def test_encoder_backend_names(monkeypatch):
    desc = types.QoaDesc(1, 44100, 100)
    with pytest.raises(ValueError, match="unknown backend"):
        QoaEncoder(desc, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="needs a device"):
        QoaEncoder(desc, backend="torch")
    pcm = make_noise(100, 1, seed=71)
    want = jax_codec.encode_all(pcm, QoaDesc(1, 44100, 100), backend="numpy")
    if native.available():
        auto = QoaEncoder(desc)
        assert auto._backend == "native" and auto.encode(pcm) == want
    assert QoaEncoder(desc, backend="numpy").encode(pcm) == want
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="no device"):
        QoaEncoder(desc)  # never an ImportError
    enc = QoaEncoder(desc, device="cpu")
    assert enc._backend == "torch" and enc.encode(pcm) == want
