"""The port's one-shot codec against the JAX package.

``qoaudio_tpu_torch.codec`` with ``backend="torch", device="cpu"`` (the
kernels' plain versions) must give the same int16 samples and the same
bytes as ``qoaudio_tpu.codec`` with ``backend="jax"`` (JAX on the CPU),
and as the native engine or the numpy oracle.  Every comparison is exact.
The JAX package's calls take its own types and raise its own errors; the
port's take and raise the port's.
Streams stay at one to three frames: the plain encoder takes about a
second per full frame on the CPU.
"""

import io

import numpy as np
import pytest

from qoaudio_tpu import codec as jax_codec
from qoaudio_tpu import errors as jax_errors
from qoaudio_tpu import format as fmt
from qoaudio_tpu.errors import (
    InvalidChannels,
    InvalidSampleRate,
    InvalidSamples,
)
from qoaudio_tpu.streaming import QoaEncoder as JaxEncoder
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch import codec, errors, native, types
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode

from conftest import make_noise, make_sine

TORCH = dict(backend="torch", device="cpu")


def port_desc(desc):
    """The port's QoaDesc with the fields of the JAX package's."""
    return types.QoaDesc(desc.channels, desc.sample_rate, desc.samples)


def frames_stream(lens, channels=1, rate=44100, seed=0, total=None):
    """A QOA stream whose frame i holds ``lens[i]`` samples per channel
    (interior frames may be short), written frame by frame.  ``total=0``
    makes it a streaming-mode stream."""
    n = sum(lens)
    pcm = make_noise(n, channels, seed=seed, amplitude=20000)
    enc = JaxEncoder(QoaDesc(channels, rate, n))
    buf = io.BytesIO()
    buf.write(fmt.pack_file_header(n if total is None else total))
    pos = 0
    for ln in lens:
        enc.encode_frame(pcm[pos * channels : (pos + ln) * channels], buf)
        pos += ln
    return buf.getvalue()


def spy(monkeypatch, module, name, calls):
    """Record each call of a kernel wrapper as (name, samples/words shape)."""
    fn = getattr(module, name)

    def run(*args):
        calls.append((name, tuple(args[1].shape)))
        return fn(*args)

    monkeypatch.setattr(module, name, run)


def spy_kernels(monkeypatch):
    calls = []
    spy(monkeypatch, cuda_decode, "decode_chains_words", calls)
    spy(monkeypatch, cuda_encode, "encode_frames", calls)
    spy(monkeypatch, cuda_encode, "encode_frames_full", calls)
    return calls


DECODE_CASES = {
    # fixed mode, uniform standard frames + a short non-aligned tail
    "uniform": lambda: frames_stream([5120, 5120, 777], channels=2, seed=1),
    # partial interior frames: the general frame walk
    "ragged": lambda: frames_stream([400, 300, 500], seed=2),
    # uniform frames whose length is no multiple of 20
    "non-aligned": lambda: frames_stream([2570, 2570, 2570], seed=3),
    "streaming-mode": lambda: frames_stream([5120, 1000], channels=2, seed=4,
                                            total=0),
    "one-short-frame": lambda: frames_stream([555], channels=3, seed=5),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_all_matches_jax_and_native(case, monkeypatch):
    data = DECODE_CASES[case]()
    calls = spy_kernels(monkeypatch)
    got = codec.decode_all(data, **TORCH)
    assert [c[0] for c in calls] == ["decode_chains_words"]  # one launch
    want = jax_codec.decode_all(data, backend="jax")
    assert (got.num_channels, got.sample_rate) == (want.num_channels, want.sample_rate)
    assert got.samples.dtype == np.int16
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.samples, jax_codec.decode_all(data, backend="numpy").samples)


@pytest.mark.parametrize("mode", ["fixed", "streaming"])
def test_decode_all_format_change_raises_incompatible(mode):
    a = jax_codec.encode_all(make_sine(40, 1), QoaDesc(1, 44100, 40))
    b = jax_codec.encode_all(make_sine(40, 2), QoaDesc(2, 44100, 40))
    data = fmt.pack_file_header(80 if mode == "fixed" else 0) + a[8:] + b[8:]
    with pytest.raises(jax_errors.IncompatibleFrame):
        jax_codec.decode_all(data, backend="jax")
    with pytest.raises(errors.IncompatibleFrame):
        codec.decode_all(data, **TORCH)


def test_decode_all_header_only_and_truncated():
    with pytest.raises(jax_errors.NoSamples):
        jax_codec.decode_all(fmt.pack_file_header(10), backend="jax")
    with pytest.raises(errors.NoSamples):
        codec.decode_all(fmt.pack_file_header(10), **TORCH)
    cut = frames_stream([400, 400], seed=6)[:-13]
    with pytest.raises(jax_errors.IoError):
        jax_codec.decode_all(cut, backend="jax")
    with pytest.raises(errors.IoError):
        codec.decode_all(cut, **TORCH)


@pytest.mark.parametrize(
    "start, end",
    [(5000, 5300), (0, 10), (10000, 99999), (20, 20), (11017, 11017)],
)
def test_decode_range_matches_jax_and_native(start, end):
    data = DECODE_CASES["uniform"]()
    got = codec.decode_range(data, start, end, **TORCH)
    want = jax_codec.decode_range(data, start, end, backend="jax")
    assert got.num_channels == want.num_channels == 2
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.samples, jax_codec.decode_range(data, start, end).samples)
    with pytest.raises(ValueError):
        codec.decode_range(data, 10, 5, **TORCH)


def test_open_and_decode_all(tmp_path):
    data = DECODE_CASES["ragged"]()
    p = tmp_path / "r.qoa"
    p.write_bytes(data)
    got = codec.open_and_decode_all(str(p), **TORCH)
    assert np.array_equal(got.samples, jax_codec.open_and_decode_all(str(p), backend="jax").samples)


@pytest.mark.parametrize(
    "n, channels, kernels",
    [
        (700, 2, ["encode_frames"]),  # one short frame, 35 windows
        (5120, 1, ["encode_frames_full"]),  # one full frame
        (5120 + 300, 1, ["encode_frames"]),  # the chunk ends in a short frame
    ],
)
def test_encode_all_matches_jax_and_oracle(n, channels, kernels, monkeypatch):
    pcm = make_noise(n, channels, seed=n, amplitude=26000)
    desc = QoaDesc(channels, 44100, n)
    calls = spy_kernels(monkeypatch)
    got = codec.encode_all(pcm, port_desc(desc), **TORCH)
    assert [c[0] for c in calls] == kernels
    if n < fmt.QOA_FRAME_LEN:
        assert calls[0][1] == (1, -(-n // 20), 20, channels)  # only its windows
    assert got == jax_codec.encode_all(pcm, desc, backend="jax")
    if n <= 700:
        assert got == jax_codec.encode_all(pcm, desc, backend="numpy")
    assert got == jax_codec.encode_all(pcm, desc)


@pytest.mark.parametrize(
    "desc, err",
    [
        (QoaDesc(-2, 44100, -20), InvalidChannels),
        (QoaDesc(0, 44100, 20), InvalidChannels),
        (QoaDesc(9, 44100, 20), InvalidChannels),
        (QoaDesc(2, -44100, 20), InvalidSampleRate),
        (QoaDesc(2, 0, 20), InvalidSampleRate),
        (QoaDesc(2, 1 << 32, 20), InvalidSampleRate),
        (QoaDesc(2, 44100, 0), InvalidSamples),
        (QoaDesc(2, 44100, -20), InvalidSamples),
        (QoaDesc(2, 44100, 21), InvalidSamples),  # 40 values are not 2 x 21
    ],
)
def test_encode_all_invalid_desc(desc, err, monkeypatch):
    pcm = np.zeros(40, np.int16)
    calls = spy_kernels(monkeypatch)
    port_err = getattr(errors, err.__name__)
    for backend in ("torch", "numpy", "auto"):
        with pytest.raises(port_err):
            codec.encode_all(pcm, port_desc(desc), backend=backend, device="cpu")
        with pytest.raises(port_err):
            codec.encode_all_batch([(pcm, port_desc(desc))], backend=backend,
                                   device="cpu")
    with pytest.raises(err):
        jax_codec.encode_all(pcm, desc, backend="jax")
    assert not calls  # validated before any device work


def test_encode_all_batch_matches_jax_and_native_pairing(monkeypatch):
    files = [
        (make_noise(300, 1, seed=11), QoaDesc(1, 44100, 300)),
        (make_sine(450, 1, freq=660.0), QoaDesc(1, 22050, 450)),
        (make_noise(700, 2, seed=12), QoaDesc(2, 48000, 700)),
    ]
    calls = spy_kernels(monkeypatch)
    got = codec.encode_all_batch([(x, port_desc(d)) for x, d in files], **TORCH)
    assert [c[0] for c in calls] == ["encode_frames"]  # one launch, 4 chains
    assert calls[0][1][-1] == 4
    assert got == jax_codec.encode_all_batch(files, backend="jax")
    assert got == jax_codec.encode_all_batch(files)  # native: mono files paired
    assert codec.encode_all_batch([], **TORCH) == []


@pytest.mark.parametrize(
    "call",
    ["decode_all", "decode_range", "encode_all", "encode_all_batch",
     "open_and_decode_all"],
)
def test_backend_names_and_devices(call, tmp_path, monkeypatch):
    pcm = make_sine(100, 1)
    desc = QoaDesc(1, 44100, 100)
    data = jax_codec.encode_all(pcm, desc)
    p = tmp_path / "s.qoa"
    p.write_bytes(data)
    pdesc = port_desc(desc)
    run = {
        "decode_all": lambda **kw: codec.decode_all(data, **kw).samples,
        "decode_range": lambda **kw: codec.decode_range(data, 5, 50, **kw).samples,
        "encode_all": lambda **kw: codec.encode_all(pcm, pdesc, **kw),
        "encode_all_batch": lambda **kw: codec.encode_all_batch([(pcm, pdesc)], **kw)[0],
        "open_and_decode_all": lambda **kw: codec.open_and_decode_all(str(p), **kw).samples,
    }[call]
    want = run(backend="numpy")
    with pytest.raises(ValueError, match="unknown backend"):
        run(backend="jax", device="cpu")
    with pytest.raises(ValueError, match="needs a device"):
        run(backend="torch")
    if native.available():
        assert np.array_equal(run(backend="native"), want)
        assert np.array_equal(run(), want)  # auto: native
    calls = spy_kernels(monkeypatch)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="no device"):
        run()  # auto, no native engine, no device: never an ImportError
    assert not calls
    assert np.array_equal(run(device="cpu"), want)  # auto falls to torch
    assert calls
    with pytest.raises(RuntimeError, match="native engine unavailable"):
        run(backend="native")


def test_torch_on_a_missing_card_raises(monkeypatch):
    """A CUDA device that is not there raises; nothing runs elsewhere."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = jax_codec.encode_all(make_sine(100, 1), QoaDesc(1, 44100, 100))
    for host_path in ("_decode_all_native", "_decode_numpy", "_encode_all_native",
                      "encode_all_py"):  # the host tier
        monkeypatch.setattr(codec, host_path, None)
    with pytest.raises(RuntimeError):
        codec.decode_all(data, backend="torch", device="cuda")
    with pytest.raises(RuntimeError):
        codec.encode_all(make_sine(100, 1), types.QoaDesc(1, 44100, 100),
                         backend="torch", device="cuda")
