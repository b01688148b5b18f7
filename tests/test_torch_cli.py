"""The port's CLI (``python -m qoaudio_tpu_torch``) against the JAX package.

Each command runs in process with ``--device cpu`` (the kernels' plain
versions) and must write the same bytes and samples as the JAX package's
``backend="jax"`` and the native engine.  Also: the two CLI faults the
port keeps out (an output directory that is a regular file, two inputs
mapped to one output), and a missing CUDA device failing with a non-zero
exit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from qoaudio_tpu import codec as jax_codec
from qoaudio_tpu import format as fmt
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu.utils.wav import read_wav, write_wav
from qoaudio_tpu_torch import cli

from conftest import make_noise, make_sine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH = ["--backend", "torch", "--device", "cpu"]


def _jax_pair(data: bytes) -> bytes:
    out = jax_codec.decode_all(data, backend="jax")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return jax_codec.encode_all(out.samples, desc, backend="jax")


@pytest.fixture
def wav_file(tmp_path):
    pcm = make_sine(5000, 2)
    p = tmp_path / "in.wav"
    write_wav(p, pcm, 2, 44100)
    return p, pcm


def test_cli_encode_decode(tmp_path, wav_file, capsys):
    wav_in, pcm = wav_file
    qoa = tmp_path / "out.qoa"
    wav_out = tmp_path / "out.wav"
    assert cli.main(TORCH + ["encode", str(wav_in), str(qoa)]) == 0
    assert "compression" in capsys.readouterr().out
    want = jax_codec.encode_all(pcm, QoaDesc(2, 44100, 5000), backend="jax")
    assert qoa.read_bytes() == want

    assert cli.main(TORCH + ["decode", str(qoa), str(wav_out)]) == 0
    got, ch, rate = read_wav(wav_out)
    assert (ch, rate) == (2, 44100)
    assert np.array_equal(got, jax_codec.decode_all(want, backend="jax").samples)


@pytest.mark.parametrize("sink", ["wav", "raw"])
def test_cli_play(tmp_path, sink, capfdbinary):
    pcm = make_noise(700, 2, seed=3)
    data = jax_codec.encode_all(pcm, QoaDesc(2, 44100, 700))
    qoa = tmp_path / "p.qoa"
    qoa.write_bytes(data)
    out_wav = tmp_path / "rendered.wav"
    argv = TORCH + ["play", str(qoa), "--sink", sink, "--output", str(out_wav)]
    assert cli.main(argv) == 0
    want = jax_codec.decode_all(data, backend="jax").samples
    if sink == "wav":
        got, ch, rate = read_wav(out_wav)
        assert (ch, rate) == (2, 44100)
    else:
        got = np.frombuffer(capfdbinary.readouterr().out, "<i2")
    assert np.array_equal(got, want)


def test_cli_info(tmp_path, capsys):
    p = tmp_path / "x.qoa"
    p.write_bytes(jax_codec.encode_all(make_sine(6000, 2), QoaDesc(2, 44100, 6000)))
    assert cli.main(["info", str(p)]) == 0
    out = capsys.readouterr().out
    assert "fixed mode, 2 frames" in out
    assert "channels 2" in out and "6000 samples/ch" in out


def _two_inputs(tmp_path):
    srcs = []
    for i, (n, ch, rate) in enumerate([(300, 1, 44100), (700, 2, 22050)]):
        p = tmp_path / f"in{i}.qoa"
        p.write_bytes(jax_codec.encode_all(make_noise(n, ch, seed=i + 5),
                                           QoaDesc(ch, rate, n)))
        srcs.append(p)
    return srcs


@pytest.mark.parametrize(
    "global_flags, flags, says",
    [
        (TORCH, [], "backend=torch"),  # file by file on the torch backend
        (["--device", "cpu"], ["--hbm"], "device transcode: 2 files"),
        (["--device", "cpu"], [], "corpus: 2 files"),  # transcode_corpus
    ],
    ids=["explicit-backend", "hbm", "corpus"],
)
def test_cli_transcode(tmp_path, capsys, global_flags, flags, says):
    srcs = _two_inputs(tmp_path)
    out_dir = tmp_path / "out"
    argv = global_flags + ["transcode", *map(str, srcs), "--out-dir", str(out_dir)] + flags
    assert cli.main(argv) == 0
    assert says in capsys.readouterr().out
    for p in srcs:
        got = (out_dir / p.name).read_bytes()
        data = p.read_bytes()
        assert got == _jax_pair(data)
        want = jax_codec.decode_all(data)  # native
        assert got == jax_codec.encode_all(
            want.samples, QoaDesc(want.num_channels, want.sample_rate,
                                  want.samples_per_channel))


def test_cli_transcode_hbm_ignores_backend(tmp_path, capsys):
    srcs = _two_inputs(tmp_path)
    argv = ["--backend", "numpy", "--device", "cpu", "transcode",
            *map(str, srcs), "--hbm"]
    assert cli.main(argv) == 0
    assert "--backend is ignored" in capsys.readouterr().err


@pytest.mark.parametrize("command", ["encode", "transcode"])
def test_cli_output_dir_is_a_regular_file(tmp_path, capsys, command):
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, make_sine(100, 1), 1, 44100)
    write_wav(b, make_sine(120, 1), 1, 44100)
    taken = tmp_path / "taken"
    taken.write_bytes(b"not a directory")
    if command == "encode":
        argv = TORCH + ["encode", str(a), str(b), str(taken)]
    else:
        argv = TORCH + ["transcode", *map(str, _two_inputs(tmp_path)),
                        "--out-dir", str(taken)]
    assert cli.main(argv) == 1
    assert "exists and is not a directory" in capsys.readouterr().err
    assert taken.read_bytes() == b"not a directory"


@pytest.mark.parametrize("command", ["encode", "transcode"])
def test_cli_two_inputs_one_output_name(tmp_path, capsys, command):
    for d in ("x", "y"):
        (tmp_path / d).mkdir()
        write_wav(tmp_path / d / "a.wav", make_sine(100, 1), 1, 44100)
        (tmp_path / d / "a.qoa").write_bytes(
            jax_codec.encode_all(make_sine(100, 1), QoaDesc(1, 44100, 100)))
    out_dir = tmp_path / "out"
    ext = ".wav" if command == "encode" else ".qoa"
    inputs = [str(tmp_path / d / ("a" + ext)) for d in ("x", "y")]
    if command == "encode":
        argv = TORCH + ["encode", *inputs, str(out_dir)]
    else:
        argv = TORCH + ["transcode", *inputs, "--out-dir", str(out_dir)]
    assert cli.main(argv) == 1
    assert "would both be written to" in capsys.readouterr().err
    assert not (out_dir / "a.qoa").exists()


def test_cli_missing_card_fails(tmp_path, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tmp_path / "s.qoa"
    p.write_bytes(jax_codec.encode_all(make_sine(100, 1), QoaDesc(1, 44100, 100)))
    for argv in (
        ["--backend", "torch", "decode", str(p), str(tmp_path / "o.wav")],
        ["transcode", str(p), "--hbm"],  # the device paths default to cuda
        ["transcode", str(p)],
    ):
        assert cli.main(argv) == 1
        assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "o.wav").exists()
    with pytest.raises(SystemExit):
        cli.main(["--backend", "jax", "info", str(p)])


def test_python_dash_m_runs_the_cli(tmp_path):
    p = tmp_path / "s.qoa"
    p.write_bytes(fmt.pack_file_header(0)
                  + jax_codec.encode_all(make_sine(100, 1), QoaDesc(1, 44100, 100))[8:])
    r = subprocess.run(
        [sys.executable, "-m", "qoaudio_tpu_torch", "info", str(p)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert "streaming mode, 1 frames" in r.stdout
