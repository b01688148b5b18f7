"""The port's host tier against the JAX package's, copy by copy.

``qoaudio_tpu_torch`` carries its own ``format``, ``bitstream``,
``native`` (with its own ``qoa_kernels.cpp``), ``reference`` and
``utils/wav`` (tests/test_torch_port_rules.py checks that it imports none
of ``qoaudio_tpu``).  Each copy must give what its original gives: parsed
fields on the fixture and on random fixed-mode and streaming-mode streams,
the native engine's bytes (and the fixture re-encode golden of
tests/test_native.py), the scalar oracle's bytes and samples, WAV files;
and every table, in ``format.py``, in ``native/qoa_kernels.cpp`` and in the
CUDA sources, equals ``qoaudio_tpu/format.py``'s.  All exact.
"""

import dataclasses
import hashlib
import io
import os
import re

import numpy as np
import pytest

from qoaudio_tpu import bitstream as jax_bs
from qoaudio_tpu import codec as jax_codec
from qoaudio_tpu import format as jax_fmt
from qoaudio_tpu import native as jax_native
from qoaudio_tpu import reference as jax_ref
from qoaudio_tpu.streaming import QoaEncoder as JaxEncoder
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu.utils import wav as jax_wav
from qoaudio_tpu_torch import bitstream, codec, native, reference, types
from qoaudio_tpu_torch import format as fmt
from qoaudio_tpu_torch.ops import _build
from qoaudio_tpu_torch.utils import wav

from conftest import make_noise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")


def _stream(kind, seed):
    """A random stream of the given kind, written by the JAX package."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 4))
    if kind == "fixed":
        n = int(rng.integers(300, 2 * 5120 + 700))
        return jax_codec.encode_all(make_noise(n, C, seed=seed, amplitude=20000),
                                    QoaDesc(C, 44100, n), backend="numpy")
    # streaming mode: header total 0, ragged frames
    lens = [int(v) for v in rng.integers(20, 900, size=3)]
    pcm = make_noise(sum(lens), C, seed=seed, amplitude=20000)
    enc = JaxEncoder(QoaDesc(C, 22050, sum(lens)), backend="numpy")
    buf = io.BytesIO()
    buf.write(jax_fmt.pack_file_header(0))
    pos = 0
    for ln in lens:
        enc.encode_frame(pcm[pos * C : (pos + ln) * C], buf)
        pos += ln
    return buf.getvalue()


STREAMS = {
    "fixture": lambda: open(FIXTURE, "rb").read(),
    **{f"fixed-{s}": (lambda s=s: _stream("fixed", s)) for s in (1, 2, 3)},
    **{f"streaming-{s}": (lambda s=s: _stream("streaming", s)) for s in (4, 5)},
}


def _fields(obj):
    """A parse result as plain data (arrays as bytes) for comparison across
    the two packages' classes."""
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, np.ndarray):
        return (obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (list, tuple)):
        return [_fields(x) for x in obj]
    return obj


@pytest.mark.parametrize("case", sorted(STREAMS))
@pytest.mark.parametrize("parse", ["parse_file", "parse_file_arrays", "parse_file_geometry"])
def test_parse_matches_jax(case, parse):
    data = STREAMS[case]()
    got = getattr(bitstream, parse)(data)
    want = getattr(jax_bs, parse)(data)
    assert _fields(got) == _fields(want)
    if parse == "parse_file_arrays" and case.startswith("streaming"):
        assert got is None  # streaming mode takes the general frame walk
    if parse == "parse_file" and got.frames:
        assert _fields(bitstream.stack_frames(got.frames)) == _fields(
            jax_bs.stack_frames(want.frames))


@pytest.fixture(scope="module")
def engines():
    if not (native.available() and jax_native.available()):
        pytest.skip("native engine unavailable (no g++)")
    assert native._LIB_PATH != jax_native._LIB_PATH  # the port's own build
    return native, jax_native


@pytest.mark.parametrize("call", ["decode_chains", "decode_interleaved",
                                  "encode_file", "encode_windows", "interleave_trim"])
def test_native_engine_matches_jax(engines, call):
    if call.startswith("decode") or call == "interleave_trim":
        pa = bitstream.parse_file_arrays(STREAMS["fixture"]())
        words, state = pa.words_be[:, :64].copy(), pa.state[:, :64].copy()
        if call == "decode_interleaved":
            args = lambda: (words, state, 2)  # noqa: E731
        elif call == "decode_chains":
            args = lambda: (words, state)  # noqa: E731
        else:
            dec = jax_native.decode_chains(words, state)
            args = lambda: (dec, 32, 2, 32 * words.shape[0] * 20 - 77)  # noqa: E731
    else:
        C, W = 2, 512
        x = make_noise(W * 20, C, seed=6, amplitude=30000).reshape(-1, C)
        lens = np.full(W, 20, np.int32)
        lens[-1] = 7
        lens[-3:-1] = 0
        if call == "encode_file":
            args = lambda: (x, lens, W, 256, jax_codec.initial_encoder_state(C))  # noqa: E731
        else:
            args = lambda: (x, lens, W, jax_codec.initial_encoder_state(C))  # noqa: E731
    got, want = getattr(native, call)(*args()), getattr(jax_native, call)(*args())
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_native_fixture_reencode_golden(engines):
    """The port's native engine re-encodes the fixture to the golden of
    tests/test_native.py, through the port's codec."""
    with open(os.path.join(ROOT, "tests", "test_native.py")) as f:
        golden = re.search(r'FIXTURE_REENCODE_SHA256\s*=\s*\(\s*"([0-9a-f]{64})"',
                           f.read()).group(1)
    dec = codec.decode_all(STREAMS["fixture"](), backend="native")
    enc = codec.encode_all(dec.samples, types.QoaDesc(dec.num_channels, dec.sample_rate,
                                                      dec.samples_per_channel),
                           backend="native")
    assert hashlib.sha256(enc).hexdigest() == golden


@pytest.mark.parametrize("n, channels", [(333, 1), (5120 + 41, 2), (700, 3)])
def test_reference_matches_jax(n, channels):
    pcm = make_noise(n, channels, seed=n, amplitude=31000)
    got = reference.encode_all_py(pcm, channels, 44100, n)
    assert got == jax_ref.encode_all_py(pcm, channels, 44100, n)
    batch = bitstream.stack_frames(bitstream.parse_file(got).frames)
    want = jax_ref.decode_batch_np(jax_bs.stack_frames(jax_bs.parse_file(got).frames))
    assert np.array_equal(reference.decode_batch_np(batch), want)


@pytest.mark.parametrize("channels", [1, 2, 5])
def test_wav_round_trip_with_jax(channels, tmp_path):
    pcm = make_noise(999, channels, seed=channels)
    wav.write_wav(tmp_path / "a.wav", pcm, channels, 32000)
    jax_wav.write_wav(tmp_path / "b.wav", pcm, channels, 32000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for reader in (wav.read_wav, jax_wav.read_wav):
        back, c, rate = reader(tmp_path / "a.wav")
        assert (c, rate) == (channels, 32000) and np.array_equal(back, pcm)


def _module_tables(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, (int, tuple, np.ndarray))}


def _c_int_arrays(path):
    """name -> integer list of every braced integer array in a C++/CUDA
    source (``= { ... }`` initialisers)."""
    with open(path) as f:
        src = re.sub(r"//[^\n]*", "", f.read())
    out = {}
    for name, body in re.findall(r"\b(k\w+)\s*(?:\[\w*\])?\s*=\s*\{([^}]*)\}", src):
        try:
            out[name] = [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]
        except ValueError:
            continue  # not a plain integer table (shifted or computed values)
    return out


TABLE_SOURCES = ["format.py", "native/qoa_kernels.cpp",
                 *[os.path.relpath(p, os.path.join(ROOT, "qoaudio_tpu_torch"))
                   for p in _build.sources()]]


@pytest.mark.parametrize("source", TABLE_SOURCES)
def test_tables_match_jax_format(source):
    sf = [int(v) for v in jax_fmt.QOA_SCALEFACTOR_TAB]
    recip = [int(v) for v in jax_fmt.QOA_RECIPROCAL_TAB]
    quant = [int(v) for v in jax_fmt.QOA_QUANT_TAB]
    if source == "format.py":
        got, want = _module_tables(fmt), _module_tables(jax_fmt)
        assert set(got) == set(want)
        for k in want:
            assert type(got[k]) is type(want[k]), k
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            else:
                assert got[k] == want[k], k
        return
    tables = _c_int_arrays(os.path.join(ROOT, "qoaudio_tpu_torch", source))
    if source in (os.path.join("csrc", "qoa_assemble.cu"), os.path.join("csrc", "qoa_gather.cu")):
        assert tables == {}  # they move bits and quantise nothing: no table
        return
    want = {"kScalefactorTab": sf, "kSfTab": sf, "kReciprocalTab": recip,
            "kRecipTab": recip, "kRecipV": recip, "kQuantLo": quant[:16],
            "kQuantHi": [quant[16]] + [0] * 15}
    if source.endswith(".cpp"):  # also holds lane-shuffle constants
        tables = {k: v for k, v in tables.items() if k in want}
    assert tables and set(tables) <= set(want), sorted(tables)
    for name, vals in tables.items():
        assert vals == want[name], f"{source}: {name}"
    if source.endswith(".cpp"):
        assert {"kSfTab", "kRecipTab", "kRecipV", "kQuantLo", "kQuantHi"} <= set(tables)
    else:
        assert "kScalefactorTab" in tables


def test_native_source_is_the_jax_packages_code():
    """The port's ``qoa_kernels.cpp`` is the JAX package's: the same code,
    comments aside."""
    def code(path):
        with open(path) as f:
            src = f.read()
        src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
        return [ln.split("//")[0].rstrip() for ln in src.splitlines()]

    assert code(os.path.join(ROOT, "qoaudio_tpu_torch", "native", "qoa_kernels.cpp")) == \
        code(os.path.join(ROOT, "qoaudio_tpu", "native", "qoa_kernels.cpp"))
