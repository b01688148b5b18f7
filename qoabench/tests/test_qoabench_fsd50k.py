"""The ``fsd50k-transcode`` cell: FSD50K's eval set in one call.

The configuration must hold the set's documented count, total, range,
rate and channels as the stated duration rule gives them; the cell must
load exactly its metrics; the two readers of the corpus layer's
``qoa.bucket`` and ``qoa.host_pair`` spans read self time, and nothing
where a program lacks the spans.  On a CUDA card (skips without one):

    python -m pytest -m cuda qoabench/tests/test_qoabench_fsd50k.py
"""

import json
import os
import re
import statistics
import subprocess
import sys

import pytest
import torch

from qoabench import generate, spec
from qoabench import trace as tr
from qoabench.spec import reader

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "fsd50k-transcode"
RATE = 44_100
N_CLIPS = 10_231


def _config():
    with open(os.path.join(HERE, "configs", "fsd50k-eval.json")) as f:
        return json.load(f)


def _tail(f: generate.File) -> int:
    return f.samples - (f.frames - 1) * 5120


def test_configuration_holds_the_set_as_the_rule_gives_it():
    cfg = _config()
    assert cfg["reduced"] == [] and cfg["name"] == "fsd50k-eval" and cfg["unit"] == "set"
    files = generate.unit_shapes(cfg)
    samples = [f.samples for f in files]
    assert len(cfg["files"]) == len(files) == N_CLIPS
    assert all(g[0] == 1 and g[1] == RATE and g[3] == 1 for g in cfg["files"])
    assert len(set(samples)) == N_CLIPS
    assert sum(samples) == 4_429_406_446 and round(sum(samples) / RATE / 3600, 3) == 27.9
    assert sum(f.frames for f in files) == 870_242
    assert (min(samples), max(samples)) == (13_536, 1_322_841)
    assert round(statistics.median(samples) / RATE, 2) == 7.21
    assert sum(5101 <= _tail(f) <= 5119 for f in files) == 37
    assert min(f.frames for f in files) == 3 and max(f.frames for f in files) == 259
    # the stated rule, clip by clip
    rule = [round(0.3 * 100 ** (((i + 0.5) / N_CLIPS) ** 0.534549) * RATE) for i in range(N_CLIPS)]
    assert samples == rule
    assert len(cfg["assumed"]) == 3


def test_the_pool_is_one_unit_the_whole_set():
    with open(os.path.join(HERE, "traffic", "set-transcode.json")) as f:
        traffic = json.load(f)
    assert traffic["entry"] == "transcode" and traffic["pool_units"] == 1
    pool = generate.make_pool(_config(), traffic, 2**31 + 77)
    assert len(pool.units) == 1 and sorted(pool.units[0]) == list(range(N_CLIPS))


def test_the_cell_loads_exactly_its_metrics():
    cell = spec.load(CELL)
    assert cell.chips == 1 and cell.traffic["pool_units"] == 1
    assert [m["name"] for m in cell.end_to_end] == ["transcode_msps", "setup_s"]
    bases = ("host_ms", "copy_ms", "glue_ms", "encode_roofline_pct", "decode_roofline_pct",
             "device_idle_pct", "bucket_ms", "host_pair_ms")
    assert [m["name"] for m in cell.per_layer] == [f"{b}.fsd50k" for b in bases]
    assert all(m["moves"] == "transcode_msps" and m["source"] == "device_trace"
               and m["workloads"] == [CELL] for m in cell.per_layer)
    fold = {m["name"] for m in spec.load("esc50-transcode").per_layer}
    assert "bucket_ms.transcode" in fold and not any(n.endswith(".fsd50k") for n in fold)
    for name in (m["name"] for m in cell.per_layer):
        assert callable(reader(name).read)


def _trace(host, calls):
    return tr.Trace(ops=[tr.Op(0, "Memcpy HtoD (Pinned -> Device)", 0.0, 1.0)], host=host,
                    calls=calls, work=[], devices=[0], sm_clock_mhz=1980.0)


def test_bucket_and_host_pair_read_self_time():
    calls = [(0.0, 1000.0), (1000.0, 2000.0)]
    host = [
        tr.HostOp("qoa.host_pair", 10, 60), tr.HostOp("qoa.stage", 60, 400),
        tr.HostOp("qoa.bucket", 70, 110), tr.HostOp("aten::empty", 80, 90),
        tr.HostOp("qoa.host_pair", 1000, 1300), tr.HostOp("qoa.upload", 1100, 1200),
        tr.HostOp("qoa.stage", 1300, 1500), tr.HostOp("qoa.bucket", 1310, 1330),
    ]
    t = _trace(host, calls)
    assert reader("bucket_ms.fsd50k").read(t) == pytest.approx((40 + 20) / 2 / 1e3)
    assert reader("bucket_ms.transcode").read(t) == pytest.approx((40 + 20) / 2 / 1e3)
    # the upload a host pair queues is not its own time
    assert reader("host_pair_ms.fsd50k").read(t) == pytest.approx((50 + 200) / 2 / 1e3)
    # the bucket choice leaves the stage's self time
    assert reader("stage_ms.transcode").read(t) == pytest.approx((300 + 180) / 2 / 1e3)


def test_without_their_spans_they_read_none():
    t = _trace([tr.HostOp("qoa.stage", 0, 50), tr.HostOp("qoa.parse", 50, 90),
                tr.HostOp("aten::copy_", 0, 10)], [(0.0, 100.0)])
    for name in ("bucket_ms.fsd50k", "bucket_ms.transcode", "host_pair_ms.fsd50k"):
        assert reader(name).read(t) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_same_size_tails_parse_on_the_card_machine(card):
    """The set's 37 clips whose last frame holds 5,101-5,119 samples, as
    the benchmark's reference encodes them: the port's parser takes each
    last frame as the tail."""
    from qoabench import frames
    from qoaudio_tpu_torch import bitstream as bs

    files = [f for f in generate.unit_shapes(_config()) if 5101 <= _tail(f) <= 5119]
    assert len(files) == 37
    pool = generate.Pool(files, [list(range(len(files)))], "effects")
    streams = frames.streams_from_pcm(files, generate.synth(pool, 2**31 + 5, "cuda"))
    for f, d in zip(files, streams):
        geo = bs.parse_file_geometry(d)
        assert geo is not None and geo.tail.samples_per_channel == _tail(f)
        assert geo.F_full == f.frames - 1


@pytest.mark.cuda
def test_short_run_is_correct(card):
    p = subprocess.run([sys.executable, "-m", "qoabench.run", "--workload", CELL,
                        "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, p.stderr[-4000:]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert set(r["metrics"]) == {"transcode_msps", "setup_s"}
    assert re.search(r"host_pair_files \+0\b", p.stderr), p.stderr[-4000:]
