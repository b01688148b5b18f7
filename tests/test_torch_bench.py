"""The port's benchmark (qoaudio_tpu_torch.bench) at a small size on the CPU.

On the CPU every kernel wrapper runs its plain PyTorch version, so the
bench's parity gates here hold the plain versions against the native
engine; the kernels take the same gates on the card (chip_smoke.py, the
``cuda`` tests).  The JSON line must carry the metric keys of the JAX
tier's ``bench.py`` (read from its source), a corrupted wrapper must end
the run without a JSON line, and the headline's inputs go through
``qoaudio_tpu.ops.encode.encode_frames`` too, exactly.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qoaudio_tpu import native
from qoaudio_tpu.ops.encode import encode_frames as jax_encode_frames
from qoaudio_tpu_torch import bench
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on tiny tensors: one intra-op thread is
    faster than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# one-frame clips keep the plain encoder to a few windows (the chunked path
# over several frames is held by tests/test_torch_corpus.py)
SMALL = bench.Sizes(
    n_chains=4, frames=1, plain_frames=1, chain_launches=1,
    decode_windows=2, decode_chains=8, parity_chains=4, decode_launches=2,
    transcode_spec=((300, 2, 44100), (120, 1, 22050), (200, 2, 48000)),
    saturated_spec=((400, 2, 44100), (400, 2, 48000), (400, 2, 44100)),
    spot_files=(0, 2), host_iters=2, iters=1,
)


def _jax_bench_keys():
    """The metric keys the JAX tier's bench.py puts on its JSON line: the
    dict it prints, every ``emit``/``_emit`` keyword and every
    ``out[...]`` of the host section; minus the slope-fit bookkeeping
    (``*_rejected``, ``*_floor*``), the internal ``_headline`` and the XLA
    kernel's rate, which has no counterpart."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") in ("emit", "_emit"):
            keys |= {k.arg for k in node.keywords}
        elif isinstance(node, ast.FunctionDef) and node.name == "main":
            for d in ast.walk(node):
                if isinstance(d, ast.Dict):
                    keys |= {k.value for k in d.keys if isinstance(k, ast.Constant)}
        elif (isinstance(node, ast.Subscript) and getattr(node.value, "id", "") == "out"
              and isinstance(node.slice, ast.Constant) and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return {k for k in keys if "rejected" not in k and "floor" not in k
            and k not in ("_headline", "encode_xla_msps")}


def test_jax_bench_keys_are_read_from_its_source():
    keys = _jax_bench_keys()
    assert {"metric", "value", "unit", "vs_baseline", "decode_vs_baseline",
            "decode_e2e_msps", "decode_stream_msps", "decode_mono_e2e_msps",
            "encode_single_file_e2e_msps", "decode_batched_msps", "transcode_hbm_msps",
            "transcode_hbm_vs_baseline", "transcode_chip_msps", "transcode_saturated_msps",
            "transcode_saturated_chip_msps"} == keys


def test_bench_small_on_cpu_prints_the_json_line(capsys):
    """Every section's parity gate passes on the plain versions, and
    stdout is one JSON line with bench.py's keys."""
    assert bench.main("cpu", SMALL) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert _jax_bench_keys() | {"encode_masked_msps", "device", "launches"} == set(res)
    assert res["metric"] == "encode_msamples_per_sec_per_chip"
    assert res["unit"] == "Msamples/s" and res["device"] == "cpu"
    for k, v in res.items():
        if k not in ("metric", "unit", "device", "launches"):
            assert isinstance(v, (int, float)) and v >= 0, k
    for k in ("decode_e2e_msps", "decode_stream_msps", "decode_mono_e2e_msps",
              "encode_single_file_e2e_msps", "decode_vs_baseline"):
        assert res[k] > 0, k  # the host section runs at full size
    assert res["decode_vs_baseline"] == round(res["decode_e2e_msps"] / bench.RUST_DECODE_MSPS, 2)
    # CPU tensors launch nothing
    assert set(res["launches"]) == set(bench.DEVICE_SECTIONS)
    assert all(v == 0 for sec in res["launches"].values() for v in sec.values())
    assert cap.err.count("parity gate:") == 4
    assert "decode attribution: parse" in cap.err


def _flip(out):
    """``out`` with the lowest bit of its last tensor's first element
    flipped (words for the encoders, samples for the decoder)."""
    outs = list(out) if isinstance(out, tuple) else [out]
    bad = outs[-1].clone()
    bad.view(-1)[0] ^= 1
    outs[-1] = bad
    return tuple(outs) if isinstance(out, tuple) else bad


@pytest.mark.parametrize("mod, name", [
    (cuda_decode, "decode_chains_words"),
    (cuda_encode, "encode_frames"),
    (cuda_encode, "encode_frames_full"),
])
def test_corrupted_kernel_output_ends_the_bench_without_a_line(monkeypatch, capsys, mod, name):
    fn = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a: _flip(fn(*a)))
    with pytest.raises(SystemExit) as e:
        bench.main("cpu", SMALL)
    assert e.value.code not in (0, None) and "PARITY FAILURE" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_main_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()


def test_headline_inputs_encode_as_in_the_jax_package():
    """The encode section's small input through the port's wrapper and
    through ``qoaudio_tpu.ops.encode.encode_frames``: state, snaps and
    words equal, and chain n repeats channel n // reps."""
    _, pcm, channels, spc = bench.load_pcm()
    x, lens, state = bench.encode_inputs(pcm, channels, spc, SMALL.n_chains, SMALL.frames)
    assert x.shape == (1, 256, 20, 4) and lens.shape == (1, 256, 4) and (lens == 20).all()
    assert np.array_equal(x[..., 0], x[..., 1]) and np.array_equal(x[..., 2], x[..., 3])
    assert np.array_equal(x[0, :, :, ::2].reshape(5120, 2), pcm.reshape(-1, 2)[:5120])
    got = cuda_encode.encode_frames_full(torch.from_numpy(state), torch.from_numpy(x))
    j_state, j_snaps, hi, lo = jax_encode_frames(
        jnp.asarray(state), jnp.asarray(x), jnp.asarray(lens))
    j_words = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(
        np.uint64)
    for g, w in zip(got, (np.asarray(j_state), np.asarray(j_snaps), j_words.view(np.int64))):
        assert np.array_equal(g.numpy(), w)
    masked = cuda_encode.encode_frames(torch.from_numpy(state), torch.from_numpy(x),
                                       torch.from_numpy(lens))
    assert all(torch.equal(a, b) for a, b in zip(got, masked))


def test_corpus_recipes_are_the_jax_benchs():
    """``bench_spec`` / ``saturated_spec`` are the recipes of bench.py and
    experiments/tpu_lane_saturated.py, and ``build_corpus`` gives that
    experiment's streams for the same spec."""
    spec = bench.bench_spec()
    assert len(spec) == 32 and spec[:4] == (
        (64 * 5120, 2, 44100), (128 * 5120, 1, 22050), (256 * 5120, 2, 48000),
        (64 * 5120, 1, 44100))
    assert sum(spc * ch for spc, ch, _ in spec) == 35_717_120
    assert sum(ch for _, ch, _ in spec) == 48
    sat = bench.saturated_spec()
    assert len(sat) == 128 and set(sat) == {(64 * 5120, 2, 44100), (64 * 5120, 2, 48000)}
    assert sum(spc * ch for spc, ch, _ in sat) == 83_886_080
    path = os.path.join(ROOT, "experiments", "tpu_lane_saturated.py")
    mod_spec = importlib.util.spec_from_file_location("tpu_lane_saturated", path)
    jax_exp = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(jax_exp)
    _, pcm, channels, _ = bench.load_pcm()
    stereo = pcm.reshape(-1, channels)
    small = [(700, 2, 44100), (5120 + 9, 1, 22050), (333, 2, 48000), (41, 1, 44100)]
    want, want_total = jax_exp.build_corpus(stereo, small)
    got, total = bench.build_corpus(stereo, small)
    assert got == want and total == want_total


def test_tiled_chains_is_the_probes():
    from qoaudio_tpu_torch.experiments import decode_variants

    with open(bench.FIXTURE, "rb") as f:
        data = f.read()
    st, wb = bench.tiled_chains(data, 3, 1000)
    st2, wb2 = decode_variants.tiled_chains(windows=3, chains=1000)
    assert st.shape == (8, 1000) and wb.shape == (3, 1000) and wb.dtype == np.int64
    assert np.array_equal(st, st2) and np.array_equal(wb, wb2)
    assert np.array_equal(wb[:, 936:], wb[:, :64])  # the fixture's 936 chains, tiled
