"""A run end to end on the CPU at a tiny size: the result line, discovery
by name, the import rule, the control and the faults ``correct`` must
catch."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from qoabench import control, guard, harness, spec

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _tiny():
    with open(os.path.join(HERE, "tests", "data", "tiny-clips.json")) as f:
        return json.load(f)


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _cell(entry="transcode", devices=1, config=None):
    b = _bench()
    group = "encode" if entry == "encode" else "transcode"
    traffic = {"entry": entry, "pool_units": 2}
    e2e = [m for m in b["end_to_end"] if m["name"] in ("setup_s", f"{entry}_msps", f"{entry}_p95_ms")]
    layers = [m for m in b["per_layer"] if m["name"].endswith("." + group)]
    return spec.Cell("tiny", devices, config or _tiny(), traffic, e2e, layers)


@pytest.mark.parametrize("entry", ["transcode", "encode"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(entry, traced):
    cell = _cell(entry)
    r = harness.run_cell(cell, 2**31 + 17, 0.0, traced, ["cpu"], 0.0)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())
    json.dumps(r)
    names = set(r["metrics"])
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert len(r["breakdown"]["device_ops"]) <= 10 and len(r["breakdown"]["idle_gaps"]) <= 10
        assert names <= {m["name"] for m in cell.per_layer}
        assert f"host_ms.{entry}" in names  # no device ops on the CPU: idle and host only
    else:
        assert names == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "qoabench.run", "--workload", "esc50-transcode",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax.numpy", "jaxlib", "flax.linen", "qoaudio_tpu.codec", "qoaudio_tpu_torch",
             "qoaudio_tpu_torch.codec", "jaxtyping", "qoabench"]
    assert guard.forbidden_modules(names) == ["flax", "jax", "jaxlib", "qoaudio_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import json, sys; from qoabench import guard, harness; "
            "from qoabench.tests.test_qoabench_run import _cell; "
            "r = harness.run_cell(_cell(), 3, 0.0, False, ['cpu'], 0.0); "
            "assert r['correct']; print(json.dumps(guard.forbidden_modules())); "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0].startswith('qoaudio'))))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr[-2000:]
    bad, loaded = (json.loads(l) for l in p.stdout.splitlines()[-2:])
    assert bad == []
    assert "qoaudio_tpu_torch" in loaded and "qoaudio_tpu" not in loaded


def test_run_refuses_a_process_that_loaded_jax(monkeypatch, capsys):
    from qoabench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(harness, "run_cell", lambda *a: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", type(sys)("jax"))
    assert run.main(["--workload", "esc50-transcode", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A new configuration, mix and metric are files and lines: nothing
    that is there changes."""
    tree = tmp_path / "qoabench"
    shutil.copytree(HERE, tree, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tree / "configs" / "tiny.json").write_text(json.dumps(_tiny()))
    (tree / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"entry": "encode", "pool_units": 2}))
    (tree / "metrics" / "calls_seen.py").write_text("def read(t):\n    return float(len(t.calls))\n")
    bench = _bench()
    bench["configs"].append({"name": "tiny", "source": "x", "file": "qoabench/configs/tiny.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-encode", "config": "tiny", "traffic": "tiny-mix",
                               "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "encode_msps")["workloads"].append("tiny-encode")
    bench["per_layer"].append({"name": "calls_seen.encode", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "x", "moves": "encode_msps",
                               "workloads": ["tiny-encode"]})
    monkeypatch.setattr(spec, "HERE", str(tree))
    monkeypatch.setattr(spec, "ROOT", str(tmp_path))
    cell = spec.load("tiny-encode", bench)
    assert cell.config["name"] == "tiny-clips" and cell.traffic["entry"] == "encode"
    assert [m["name"] for m in cell.end_to_end] == ["encode_msps", "setup_s"]
    assert "calls_seen.encode" in [m["name"] for m in cell.per_layer]
    r = harness.run_cell(cell, 5, 0.0, True, ["cpu"], 0.0)
    assert r["correct"] and r["metrics"]["calls_seen.encode"]["value"] == r["attempted"]
    # a metric <base>.<group> falls back to <base>.py
    assert spec.reader("host_ms.anything").__name__.endswith("host_ms")


def test_control_fails_where_the_program_passes():
    cfg = dict(_tiny(), files=[[1, 44100, 4900, 4], [1, 44100, 5100, 4]])
    cell = _cell("encode", config=cfg)
    cell.traffic["pool_units"] = 1
    r = control.readings(cell, 3, "cpu")
    assert r["program"]["files_wrong"] == 0 and r["program"]["frames_wrong"] == 0
    assert r["control"]["files_wrong"] > 0 and r["control"]["frames_wrong"] > 0


def _state_unchanged(monkeypatch):
    from qoaudio_tpu_torch.ops import encode as plain
    real = plain._encode_window
    monkeypatch.setattr(plain, "_encode_window",
                        lambda carry, *a: (carry, real(carry, *a)[1]))


def _half_batch(monkeypatch):
    from qoaudio_tpu_torch import parallel
    real = parallel.batch_transcode

    def half(streams, **kw):
        got = real(list(streams[: (len(streams) + 1) // 2]), **kw)
        return (got * 2)[: len(streams)]
    monkeypatch.setattr(parallel, "batch_transcode", half)


def _no_exchange(monkeypatch):
    from qoaudio_tpu_torch.parallel import corpus
    real = corpus.fetch_arrays
    monkeypatch.setattr(corpus, "fetch_arrays",
                        lambda ts: [a if i < 2 else np.zeros_like(a) for i, a in enumerate(real(ts))])


def _altered_word(monkeypatch):
    from qoaudio_tpu_torch.ops import cuda_encode
    real = cuda_encode.encode_frames

    def flip(*a):
        state, snaps, words = real(*a)
        words = words.clone()
        words[0, 0, 0] ^= 1 << 40
        return state, snaps, words
    monkeypatch.setattr(cuda_encode, "encode_frames", flip)


@pytest.mark.parametrize("fault,devices", [(_state_unchanged, 1), (_half_batch, 1),
                                           (_no_exchange, 4), (_altered_word, 1)])
def test_faults_come_out_not_correct(fault, devices, monkeypatch):
    # a mesh call holds four units' files, so every card gets some
    cfg = dict(_tiny(), files=[g[:3] + [g[3] * devices] for g in _tiny()["files"]])
    cell = _cell("transcode", devices=devices, config=cfg)
    sound = harness.run_cell(cell, 11, 0.0, False, ["cpu"] * devices, 0.0)
    assert sound["correct"]
    fault(monkeypatch)
    r = harness.run_cell(cell, 11, 0.0, False, ["cpu"] * devices, 0.0)
    assert r["correct"] is False
    assert r["checks"]["files_wrong"]["value"] > 0
