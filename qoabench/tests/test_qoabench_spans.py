"""The readers of the program's host stage spans on hand-made traces."""

import json
import os

import pytest

from qoabench import spec
from qoabench import trace as tr
from qoabench.spec import reader

BASES = ("parse_ms", "stage_ms", "upload_ms", "pipeline_ms", "wait_ms", "fetch_ms",
         "assemble_ms", "unspanned_ms")
CELLS = {"transcode": ("esc50-transcode", "transcode_msps"),
         "track": ("fixture-transcode", "transcode_msps.track"),
         "encode": ("esc50-encode", "encode_msps")}


def _trace(host, calls):
    return tr.Trace(ops=[tr.Op(0, "Memcpy HtoD (Pinned -> Device)", 0.0, 1.0)], host=host,
                    calls=calls, work=[], devices=[0], sm_clock_mhz=1980.0)


def _h(name, s, e):
    return tr.HostOp(name, s, e)


def _read(name, t):
    return reader(name).read(t)


def test_self_time_subtracts_nested_spans_only():
    calls = [(0.0, 1000.0), (1000.0, 2000.0)]
    host = [
        # call 1: a stage with an upload inside, an aten op inside, a sibling pipeline
        _h("qoa.stage", 0, 400), _h("qoa.upload", 100, 250), _h("aten::pin_memory", 120, 240),
        _h("aten::copy_", 300, 390), _h("qoa.pipeline", 400, 600), _h("qoa.upload", 450, 500),
        _h("qoa.fetch", 600, 900), _h("qoa.wait", 650, 800),
        # call 2: two stages, one upload inside the second
        _h("qoa.stage", 1000, 1100), _h("qoa.stage", 1200, 1500), _h("qoa.upload", 1300, 1350),
    ]
    t = _trace(host, calls)
    # stage: 400 - 150 and 100 + 300 - 50, over 2 calls; neither the aten ops
    # nor the sibling pipeline (and its upload) come off
    assert _read("stage_ms.transcode", t) == pytest.approx((250 + 350) / 2 / 1e3)
    assert _read("upload_ms.encode", t) == pytest.approx((150 + 50 + 50) / 2 / 1e3)
    assert _read("pipeline_ms.transcode", t) == pytest.approx((200 - 50) / 2 / 1e3)
    assert _read("fetch_ms.track", t) == pytest.approx((300 - 150) / 2 / 1e3)
    assert _read("wait_ms.transcode", t) == pytest.approx(150 / 2 / 1e3)


def test_self_time_counts_only_the_window():
    calls = [(100.0, 200.0)]
    host = [_h("qoa.parse", 0, 150), _h("qoa.parse", 150, 180), _h("qoa.assemble", 300, 400)]
    t = _trace(host, calls)
    assert _read("parse_ms.transcode", t) == pytest.approx(80 / 1e3)
    assert _read("assemble_ms.transcode", t) is None


def test_unspanned_reads_the_uncovered_part_of_each_call():
    calls = [(0.0, 100.0), (100.0, 300.0)]
    host = [_h("qoa.parse", 10, 40), _h("qoa.stage", 30, 90), _h("qoa.upload", 50, 60),
            _h("aten::empty", 90, 100), _h("qoa.fetch", 150, 280)]
    t = _trace(host, calls)
    # call 1: [10, 90] covered, 20 left; call 2: [150, 280] covered, 70 left
    assert _read("unspanned_ms.transcode", t) == pytest.approx((20 + 70) / 2 / 1e3)


def test_a_trace_without_spans_reads_none():
    t = _trace([_h("aten::pin_memory", 0, 50), _h("qoabench.other", 0, 90)], [(0.0, 100.0)])
    for base in BASES:
        for group in CELLS:
            assert _read(f"{base}.{group}", t) is None


def test_every_span_metric_loads_for_its_cell_only():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = [m for m in bench["per_layer"] if m["name"].split(".")[0] in BASES]
    assert len(entries) == 23
    for m in entries:
        cell, moves = CELLS[m["name"].split(".")[1]]
        assert (m["unit"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
            "ms", "device_trace", "host work", moves, [cell])
    for group, (cell, _) in CELLS.items():
        got = {m["name"] for m in spec.load(cell).per_layer if m["name"].split(".")[0] in BASES}
        want = {f"{b}.{group}" for b in BASES if not (group == "encode" and b == "parse_ms")}
        assert got == want
