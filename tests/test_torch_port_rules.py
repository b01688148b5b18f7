"""Rules the PyTorch port keeps, checked on the CPU.

* no module of ``qoaudio_tpu_torch``, and not ``chip_smoke.py``, imports
  jax or the JAX package ``qoaudio_tpu``: with both blocked every module
  imports and the entry points run on the CPU with the JAX package's
  outputs, and no source holds an import of ``qoaudio_tpu``; with the
  native engine gone too, the codec and the corpus layer's host pair run on
  the given device or raise ValueError; its ``codec`` is its own module;
* the ``__constant__`` tables of the CUDA sources are the format's tables;
* the word/state layout conversions round-trip;
* without nvcc the kernel build raises, and a wrapper given a tensor that
  is neither on the CPU nor on a CUDA device raises — nothing falls back;
* the transfer and timing helpers are bit-exact / sane on the CPU.
"""

import ast
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from qoaudio_tpu import format as fmt
from qoaudio_tpu_torch.ops import _build, cuda_decode, cuda_encode, cuda_gather
from qoaudio_tpu_torch.ops import layout
from qoaudio_tpu_torch.utils import timing, transfer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


BLOCK_JAX = "import sys\nsys.modules['jax'] = None\nsys.modules['qoaudio_tpu'] = None\n"
NO_JAX_LOADED = (
    "bad = [k for k, v in sys.modules.items() if v is not None and\n"
    "       (k.split('.')[0] in ('jax', 'qoaudio_tpu'))]\n"
    "assert not bad, bad\n"
)


def test_no_module_imports_jax(tmp_path):
    """With jax and ``qoaudio_tpu`` blocked, every module of the port
    imports, and a codec call, a ``QoaDecoder``/``QoaEncoder`` round trip,
    ``batch_transcode`` and the CLI's ``info`` and ``transcode`` run on the
    CPU with the JAX package's outputs."""
    import contextlib
    import io

    from qoaudio_tpu import cli as jax_cli
    from qoaudio_tpu import codec as jax_codec
    from qoaudio_tpu.types import QoaDesc

    pcm = np.random.default_rng(7).integers(-20000, 20000, 2 * 300).astype(np.int16)
    data = jax_codec.encode_all(pcm, QoaDesc(2, 44100, 300), backend="numpy")
    src = tmp_path / "s.qoa"
    src.write_bytes(data)
    np.save(tmp_path / "pcm.npy", pcm)
    dec = jax_codec.decode_all(data, backend="numpy")
    pair = jax_codec.encode_all(dec.samples, QoaDesc(2, 44100, 300), backend="numpy")
    info = io.StringIO()
    with contextlib.redirect_stdout(info):
        assert jax_cli.main(["info", str(src)]) == 0
    code = BLOCK_JAX + (
        "import contextlib, importlib, io, pkgutil\n"
        "import numpy as np\n"
        "import qoaudio_tpu_torch as qt\n"
        "from qoaudio_tpu_torch import cli\n"
        "from qoaudio_tpu_torch.parallel import corpus\n"
        "names = [m.name for m in pkgutil.walk_packages(qt.__path__, 'qoaudio_tpu_torch.')\n"
        "         if m.module_finder.find_spec(m.name).origin.endswith('.py')]  # not the .so\n"
        "for n in names: importlib.import_module(n)\n"
        f"tmp = {str(tmp_path)!r}\n"
        "data = open(tmp + '/s.qoa', 'rb').read()\n"
        "pcm = np.load(tmp + '/pcm.npy')\n"
        "T = dict(backend='torch', device='cpu')\n"
        "np.save(tmp + '/decoded.npy', qt.decode_all(data, **T).samples)\n"
        "enc = qt.QoaEncoder(qt.QoaDesc(2, 44100, 300), **T).encode(pcm)\n"
        "open(tmp + '/encoded.qoa', 'wb').write(enc)\n"
        "np.save(tmp + '/redecoded.npy', qt.QoaDecoder(enc, **T).decode_pending())\n"
        "open(tmp + '/pair.qoa', 'wb').write(corpus.batch_transcode([data], 'cpu')[0])\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    assert cli.main(['--device', 'cpu', 'info', tmp + '/s.qoa']) == 0\n"
        "    assert cli.main(['--device', 'cpu', 'transcode', '--hbm', tmp + '/s.qoa',\n"
        "                     '--out-dir', tmp + '/out']) == 0\n"
        "open(tmp + '/info.txt', 'w').write(out.getvalue())\n"
        + NO_JAX_LOADED + "print(' '.join(names))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    names = set(r.stdout.split())
    assert len(names) >= 20  # every module was imported
    assert {"qoaudio_tpu_torch.parallel.mesh", "qoaudio_tpu_torch.native",
            "qoaudio_tpu_torch.reference", "qoaudio_tpu_torch.utils.wav"} <= names
    assert np.array_equal(np.load(tmp_path / "decoded.npy"), dec.samples)
    assert (tmp_path / "encoded.qoa").read_bytes() == data
    assert np.array_equal(np.load(tmp_path / "redecoded.npy"), dec.samples)
    assert (tmp_path / "pair.qoa").read_bytes() == pair
    assert (tmp_path / "out" / "s.qoa").read_bytes() == pair
    assert (tmp_path / "info.txt").read_text().startswith(info.getvalue())


_JAX_IMPORT = re.compile(
    r"\bfrom\s+qoaudio_tpu(\.[\w.]+)?\s+import\b|\bimport\s+qoaudio_tpu(?![\w])"
    r"|\bimport_module\(\s*['\"]qoaudio_tpu(?![\w])"
)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "qoaudio_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_the_jax_package(path):
    """No import of ``qoaudio_tpu`` (only ``qoaudio_tpu_torch``) in the
    port's code, lazily or not, nor in a string it runs as code."""
    with open(path) as f:
        src = f.read()
    bad = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if a.name.split(".")[0] == "qoaudio_tpu"]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module.split(".")[0] == "qoaudio_tpu":
                bad.append(node.module)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            bad += [m.group(0) for m in _JAX_IMPORT.finditer(node.value)]
    assert not bad, bad


def _constant_tables():
    tables = {}
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        for name, body in re.findall(
            r"__constant__\s+\w+\s+(\w+)\s*\[\d*\]\s*=\s*\{([^}]*)\}", src
        ):
            vals = [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]
            tables.setdefault(name, []).append((os.path.basename(path), vals))
    return tables


def test_cuda_constant_tables_match_format():
    tables = _constant_tables()
    want = {
        "kScalefactorTab": [int(v) for v in fmt.QOA_SCALEFACTOR_TAB],
        "kReciprocalTab": [int(v) for v in fmt.QOA_RECIPROCAL_TAB],
    }
    assert set(tables) == set(want)
    assert {src for src, _ in tables["kScalefactorTab"]} == {
        "qoa_decode.cu", "qoa_encode.cu"
    }
    for name, copies in tables.items():
        for src, vals in copies:
            assert vals == want[name], f"{src}: {name}"


def test_cuda_test_goldens_are_test_native_goldens():
    """tests/test_torch_cuda.py carries a copy of the SHA-256 goldens (it
    runs without conftest, on a machine with no jax); pin the copy."""
    import test_torch_cuda

    with open(os.path.join(ROOT, "tests", "test_native.py")) as f:
        src = f.read()
    for name in ("REAL_FIXTURE_SHA256", "FIXTURE_REENCODE_SHA256"):
        m = re.search(name + r'\s*=\s*\(\s*"([0-9a-f]{64})"', src)
        assert m and getattr(test_torch_cuda, name) == m.group(1)


def test_layout_round_trips():
    rng = np.random.default_rng(5)
    logical = rng.integers(0, 1 << 63, size=(7, 11), dtype=np.int64).astype(
        np.uint64
    ) | (rng.integers(0, 2, size=(7, 11), dtype=np.uint64) << np.uint64(63))
    w = torch.from_numpy(logical.view(np.int64))

    hi, lo = layout.halves_from_words(w)
    assert np.array_equal(hi.numpy(), (logical >> np.uint64(32)).astype(np.int64))
    assert np.array_equal(lo.numpy(), (logical & np.uint64(0xFFFFFFFF)).astype(np.int64))
    assert torch.equal(layout.words_from_halves(hi, lo), w)
    # the JAX kernels' u32 halves, as numpy hands them over
    hi32 = torch.from_numpy((logical >> np.uint64(32)).astype(np.uint32))
    lo32 = torch.from_numpy((logical & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert torch.equal(layout.words_from_halves(hi32, lo32), w)

    be = layout.logical_to_be(w)
    assert np.array_equal(be.numpy(), logical.byteswap().view(np.int64))
    assert torch.equal(layout.be_to_logical(be), w)

    sf, codes = layout.unpack_words(w)
    assert np.array_equal(sf.numpy(), (logical >> np.uint64(60)).astype(np.int32))
    for k in range(20):
        want = ((logical >> np.uint64(57 - 3 * k)) & np.uint64(7)).astype(np.int32)
        assert np.array_equal(codes[:, k].numpy(), want)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(_build.BuildFailed, match="nvcc not found"):
        _build.library()
    assert _build._lib is None
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    meta = torch.empty((8, 4), dtype=torch.int32, device="meta")
    words = torch.empty((2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_decode.decode_chains_words(meta, words)
    x = torch.empty((1, 2, 20, 4), dtype=torch.int16, device="meta")
    lens = torch.empty((1, 2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_encode.encode_frames(meta, x, lens)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_encode.encode_frames_full(meta, x)
    table = torch.empty((7, 1), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_gather.gather_chains(words.view(-1), table, 2, 4)
    # mixed CPU and non-CPU inputs are refused too
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_decode.decode_chains_words(torch.zeros((8, 4), dtype=torch.int32), words)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        cuda_gather.gather_chains(torch.zeros(8, dtype=torch.int64), table, 2, 4)


def test_require_checks_dtype_shape_contiguity():
    t = torch.zeros((8, 4), dtype=torch.int32)
    _build.require(t, "state", torch.int32, (8, 4))
    with pytest.raises(ValueError, match="state"):
        _build.require(t, "state", torch.int64, (8, 4))
    with pytest.raises(ValueError, match="state"):
        _build.require(t, "state", torch.int32, (8, 5))
    with pytest.raises(ValueError, match="contiguous"):
        _build.require(t.t().contiguous().t(), "state", torch.int32, (8, 4))


def test_transfer_round_trip_on_cpu():
    rng = np.random.default_rng(1)
    arrays = [
        rng.integers(-(1 << 62), 1 << 62, size=(5, 3)),
        rng.integers(-32768, 32768, size=(4, 20, 3)).astype(np.int16),
    ]
    ts = transfer.put_arrays(arrays, "cpu")
    assert all(t.device.type == "cpu" for t in ts)
    back = transfer.fetch_arrays(ts)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    (back1,) = transfer.fetch_arrays([transfer.put_array(arrays[1], "cpu")])
    assert np.array_equal(back1, arrays[1])


def test_timing_helpers_on_cpu():
    with timing.Stopwatch("cpu") as sw:
        sum(range(1000))
    assert sw.elapsed > 0 and sw.device_ms is None
    assert sw.msamples_per_sec(10**6) > 0
    best, result = timing.bench_fn(lambda a: a + 1, 41, device="cpu", iters=2)
    assert result == 42 and best >= 0


def test_time_calls_on_cpu():
    seen = []
    times, result = timing.time_calls(lambda a: seen.append(a) or a * 2, 21, device="cpu",
                                      warmup=2, iters=3)
    assert result == 42 and len(times) == 3 and len(seen) == 5
    assert all(t >= 0 for t in times)


def test_profiler_trace_off_is_a_no_op(tmp_path):
    for off in (None, ""):
        with timing.profiler_trace(off) as prof:
            assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_profiler_trace_leaves_a_chrome_trace(tmp_path):
    import json

    log_dir = tmp_path / "traces" / "run"  # made on demand
    with timing.profiler_trace(str(log_dir)) as prof:
        torch.ones(64).sum()
    (trace,) = list(log_dir.iterdir())
    assert trace.name.startswith("trace-") and trace.suffix == ".json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("sum" in e.get("name", "") for e in events)
    assert any("sum" in e.key for e in prof.key_averages())
    # a block that raises still writes its trace
    with pytest.raises(ZeroDivisionError):
        with timing.profiler_trace(str(tmp_path / "failed")):
            1 / 0
    assert len(list((tmp_path / "failed").iterdir())) == 1


def test_codec_is_the_ports_own():
    import qoaudio_tpu
    import qoaudio_tpu_torch

    assert qoaudio_tpu_torch.codec is not qoaudio_tpu.codec
    assert qoaudio_tpu_torch.codec.__name__ == "qoaudio_tpu_torch.codec"
    assert qoaudio_tpu_torch.decode_all is qoaudio_tpu_torch.codec.decode_all


def test_top_level_surface_covers_the_jax_packages():
    """Every public name of ``qoaudio_tpu`` is a public name of the port,
    the format constants are equal, and ``qoa_frame_size`` agrees."""
    import qoaudio_tpu
    import qoaudio_tpu_torch

    missing = [n for n in qoaudio_tpu.__all__ if n not in qoaudio_tpu_torch.__all__]
    assert not missing, missing
    for name in qoaudio_tpu_torch.__all__:
        assert hasattr(qoaudio_tpu_torch, name), name
    constants = [n for n in qoaudio_tpu.__all__ if n.isupper()]
    assert len(constants) == 8
    for name in constants:
        assert getattr(qoaudio_tpu_torch, name) == getattr(qoaudio_tpu, name), name
    for channels in (1, 2, 8):
        for slices in (1, 17, 256):
            assert qoaudio_tpu_torch.qoa_frame_size(channels, slices) == \
                qoaudio_tpu.qoa_frame_size(channels, slices)
    assert qoaudio_tpu_torch.__version__ == qoaudio_tpu.__version__


def test_codec_without_jax_or_native_engine(tmp_path):
    """With jax blocked and no native engine, the port's codec runs on the
    given device, or raises ValueError when none is given — never
    ImportError."""
    from qoaudio_tpu import codec as jax_codec
    from qoaudio_tpu.types import QoaDesc

    pcm = np.random.default_rng(9).integers(-9000, 9000, 600).astype(np.int16)
    data = jax_codec.encode_all(pcm, QoaDesc(2, 44100, 300), backend="numpy")
    src = tmp_path / "s.qoa"
    src.write_bytes(data)
    np.save(tmp_path / "pcm.npy", pcm)
    np.save(tmp_path / "want.npy", jax_codec.decode_all(data, backend="numpy").samples)
    code = BLOCK_JAX + (
        "import numpy as np\n"
        "from qoaudio_tpu_torch import native\n"
        "native.available = lambda: False\n"
        "import qoaudio_tpu_torch as qt\n"
        f"data = open({str(src)!r}, 'rb').read()\n"
        f"pcm = np.load({str(tmp_path / 'pcm.npy')!r})\n"
        "desc = qt.QoaDesc(2, 44100, 300)\n"
        f"want = np.load({str(tmp_path / 'want.npy')!r})\n"
        "assert np.array_equal(qt.decode_all(data, device='cpu').samples, want)\n"
        "assert qt.encode_all(pcm, desc, device='cpu') == data\n"
        "calls = [lambda: qt.decode_all(data), lambda: qt.encode_all(pcm, desc),\n"
        "         lambda: qt.QoaEncoder(desc), lambda: qt.decode_range(data, 0, 9),\n"
        "         lambda: qt.encode_all_batch([(pcm, desc)])]\n"
        "for call in calls:\n"
        "    try:\n"
        "        call()\n"
        "    except ValueError:\n"
        "        continue\n"
        "    raise AssertionError('no ValueError')\n"
        + NO_JAX_LOADED + "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_corpus_host_pair_without_jax_or_native_engine(tmp_path):
    """With jax blocked and no native engine, streams the device path does
    not take (a streaming-mode stream the parser rejects, and 2,560-sample
    frames) go through the port's own codec on the call's device: no
    ImportError, and every output equals the numpy backend's."""
    import io

    from qoaudio_tpu import codec as jax_codec
    from qoaudio_tpu.streaming import QoaEncoder
    from qoaudio_tpu.types import QoaDesc

    rng = np.random.default_rng(11)
    pcm = rng.integers(-9000, 9000, 2 * 700).astype(np.int16)
    plain = jax_codec.encode_all(pcm, QoaDesc(2, 44100, 700), backend="numpy")
    mono = rng.integers(-9000, 9000, 2560 * 2).astype(np.int16)
    enc = QoaEncoder(QoaDesc(1, 22050, 2560 * 2), backend="numpy")
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 2, 2560):
        enc.encode_frame(mono[off : off + 2560], buf)
    streams = [fmt.pack_file_header(0) + plain[8:], buf.getvalue(), plain]
    paths = []
    for i, data in enumerate(streams):
        paths.append(str(tmp_path / f"s{i}.qoa"))
        with open(paths[-1], "wb") as f:
            f.write(data)
        d = jax_codec.decode_all(data, backend="numpy")
        np.save(tmp_path / f"dec{i}.npy", d.samples)
        (tmp_path / f"want{i}.qoa").write_bytes(jax_codec.encode_all(
            d.samples, QoaDesc(d.num_channels, d.sample_rate, d.samples_per_channel),
            backend="numpy"))
    code = BLOCK_JAX + (
        "import numpy as np\n"
        "from qoaudio_tpu_torch import native\n"
        "native.available = lambda: False\n"
        "from qoaudio_tpu_torch.parallel import corpus\n"
        f"paths = {paths!r}\n"
        f"tmp = {str(tmp_path)!r}\n"
        "streams = [open(p, 'rb').read() for p in paths]\n"
        "dec = [np.load(f'{tmp}/dec{i}.npy') for i in range(len(paths))]\n"
        "want = [open(f'{tmp}/want{i}.qoa', 'rb').read() for i in range(len(paths))]\n"
        "got = corpus.batch_decode(streams, 'cpu')\n"
        "assert corpus.host_pair_files == 1\n"
        "for g, w in zip(got, dec):\n"
        "    assert np.array_equal(g.samples, w)\n"
        "assert corpus.batch_transcode(streams, 'cpu') == want\n"
        "assert corpus.host_pair_files == 3\n"
        f"rep = corpus.transcode_corpus(paths, 'cpu', out_dir={str(tmp_path / 'out')!r})\n"
        "assert rep.ok and all(r['exact'] for r in rep.results)\n"
        "for p, w in zip(paths, want):\n"
        f"    assert open(p.replace({str(tmp_path)!r}, {str(tmp_path / 'out')!r}), 'rb').read() == w\n"
        + NO_JAX_LOADED + "print('ok')\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_golden_is_test_native_golden():
    """chip_smoke.py carries a copy of the fixture re-encode golden (it
    imports nothing from the tests); pin the copy."""
    import test_torch_cuda

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    m = re.search(r'FIXTURE_REENCODE_SHA256\s*=\s*\(\s*"([0-9a-f]{64})"', src)
    assert m and m.group(1) == test_torch_cuda.FIXTURE_REENCODE_SHA256
