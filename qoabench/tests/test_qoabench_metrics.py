"""The metric arithmetic on synthetic traces and windows."""

import math

import pytest

from qoabench import generate, harness, roofline
from qoabench import trace as tr
from qoabench.spec import reader


def _trace(ops, calls, devices=(0,), work=None, mhz=1980.0):
    work = work or [tr.CallWork(samples=1_000_000, frame_chains=200, longest_steps=10_240)] * len(calls)
    return tr.Trace(ops=ops, host=[], calls=calls, work=work, devices=list(devices), sm_clock_mhz=mhz)


def _op(name, s, e, dev=0):
    return tr.Op(dev, name, s, e)


ENC, DEC = "void qoa_encode_kernel<true>(short const*)", "qoa_decode_kernel(unsigned long const*)"


def test_union_gaps_and_cover():
    u = tr.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert u == [(0, 3), (5, 9)]
    assert tr.covered(u, 2, 6) == 2
    assert tr.gaps(u, -1, 10) == [(-1, 0), (3, 5), (9, 10)]


def test_host_copy_glue_and_idle():
    calls = [(0.0, 1000.0), (1000.0, 2000.0)]
    ops = [_op(ENC, 100, 400), _op("Memcpy HtoD (Pinned -> Device)", 350, 450),
           _op("Memset (Device)", 1100, 1200), _op("void at::native::index_kernel", 1500, 1600),
           _op(DEC, 1550, 1700)]
    t = _trace(ops, calls)
    # busy: [100, 450] in call 1, [1100, 1200] + [1500, 1700] in call 2
    assert reader("host_ms.transcode").read(t) == pytest.approx(((1000 - 350) + (1000 - 300)) / 2 / 1e3)
    assert reader("copy_ms.transcode").read(t) == pytest.approx(100 / 2 / 1e3)
    assert reader("glue_ms.transcode").read(t) == pytest.approx(200 / 2 / 1e3)
    assert reader("device_idle_pct.transcode").read(t) == pytest.approx(100 * (1 - 650 / 2000))
    assert reader("copy_ms.encode").read(_trace([_op(ENC, 0, 5)], calls)) is None


def test_idle_and_step_over_cards():
    calls = [(0.0, 100.0)]
    ops = [_op(ENC, 0, 80, 0), _op(ENC, 0, 40, 1), _op(ENC, 0, 40, 2), _op(ENC, 0, 40, 3)]
    t = _trace(ops, calls, devices=(0, 1, 2, 3))
    assert reader("device_idle_pct.transcode").read(t) == pytest.approx(100 * (1 - 200 / 400))
    # the busiest card's encode time over the calls' longest chains
    assert reader("encode_step_ns.transcode").read(t) == pytest.approx(1e3 * 80 / 10_240)


def test_roofline_from_shapes_alone():
    samples, chains = 22_810_769, 4_626
    ops_s = samples * (16 * 57 + 4) / (132 * 128 * 1980e6)
    bytes_s = (samples * 2.4 + chains * 16) / 3.35e12
    assert roofline.encode_bound_s(samples, chains, 1980.0) == pytest.approx(max(ops_s, bytes_s))
    assert ops_s > bytes_s
    dec_ops = samples * 28 / (132 * 128 * 1980e6)
    assert roofline.decode_bound_s(samples, chains, 1980.0) == pytest.approx(
        max(dec_ops, bytes_s))
    work = [tr.CallWork(samples, chains, 75 * 5120)] * 2
    t = _trace([_op(ENC, 0, 15_000), _op(ENC, 20_000, 35_000), _op(DEC, 40_000, 40_100)],
               [(0.0, 30_000.0), (30_000.0, 60_000.0)], work=work, mhz=1755.0)
    enc = 2 * roofline.encode_bound_s(samples, chains, 1755.0) / 0.030
    assert reader("encode_roofline_pct.transcode").read(t) == pytest.approx(100 * enc)
    assert reader("decode_roofline_pct.transcode").read(t) == pytest.approx(
        100 * 2 * roofline.decode_bound_s(samples, chains, 1755.0) / 100e-6)


def test_roofline_ignores_the_kernel_library(monkeypatch):
    """The bound reads the shapes and the clock: a rebuilt or replaced
    kernel library leaves it where it is."""
    before = roofline.encode_bound_s(1_000_000, 200, 1980.0), roofline.decode_bound_s(1_000_000, 200, 1980.0)
    from qoaudio_tpu_torch.ops import _build
    from qoaudio_tpu_torch.utils import roofline as port_roofline
    monkeypatch.setattr(_build, "NVCC_FLAGS", ("-O0",))
    monkeypatch.setattr(_build, "sources", lambda: [])
    monkeypatch.setattr(port_roofline, "HBM_BYTES_PER_S", 1.0)
    after = roofline.encode_bound_s(1_000_000, 200, 1980.0), roofline.decode_bound_s(1_000_000, 200, 1980.0)
    assert before == after
    with open(roofline.__file__) as f:
        assert "qoaudio_tpu_torch" not in "".join(l for l in f if l.startswith(("import", "from")))


def _calls(lat, ok=None, gap=0.0):
    out, t = [], 10.0
    for k, x in enumerate(lat):
        out.append(harness.Call([k % 2], t, t + x, True if ok is None else ok[k]))
        t += x + gap
    return out


def test_rate_over_whole_calls_and_tail_over_all_calls():
    pool = generate.Pool([generate.File(2, 44100, 1_000_000), generate.File(1, 44100, 500_000)],
                         [[0], [1]], "music")
    calls = _calls([0.5, 0.25, 0.25, 1.0], gap=0.1)
    # 2.5 M samples over the window start (9.9) to the last end
    rate = harness.end_to_end("transcode_msps", "transcode", calls, pool, 9.9, 3.0)
    assert harness.end_to_end("transcode_msps.track", "transcode", calls, pool, 9.9, 3.0) == rate
    assert rate == pytest.approx((2_000_000 + 500_000) * 2 / 1e6 / (calls[-1].end - 9.9))
    lat = [0.01 * (i + 1) for i in range(100)]
    calls = _calls(lat)
    assert harness.end_to_end("transcode_p95_ms", "transcode", calls, pool, 10.0, 3.0) == \
        pytest.approx(1e3 * 0.95)
    # a failed call counts as the whole window
    failed = _calls(lat, ok=[i != 3 for i in range(100)])
    span = failed[-1].end - 10.0
    assert harness.end_to_end("transcode_p98_ms", "transcode", failed, pool, 10.0, 3.0) == \
        pytest.approx(1e3 * 0.99)
    assert harness.end_to_end("transcode_p100_ms", "transcode", failed, pool, 10.0, 3.0) == \
        pytest.approx(1e3 * span)
    assert harness.end_to_end("setup_s", "transcode", calls, pool, 10.0, 3.25) == 3.25
    with pytest.raises(KeyError):
        harness.end_to_end("encode_msps", "transcode", calls, pool, 10.0, 3.0)
    assert math.isfinite(rate)


def test_breakdown_names_gaps_by_host_work():
    calls = [(0.0, 1000.0)]
    ops = [_op(ENC, 0, 300), _op(ENC, 600, 700), _op("Memcpy DtoH (Device -> Pinned)", 900, 1000)]
    t = _trace(ops, calls)
    t.host = [tr.HostOp("aten::pin_memory", 320, 590), tr.HostOp("cudaMemcpyAsync", 700, 720)]
    b = tr.breakdown(t)
    assert b["device_ops"][0] == [ENC, pytest.approx(400 / 1e6)]
    assert b["idle_gaps"][0] == ["aten::pin_memory (90%)", pytest.approx(300 / 1e6)]
    assert b["idle_gaps"][1] == ["host Python outside profiled ops (most: cudaMemcpyAsync 10%)",
                                 pytest.approx(200 / 1e6)]
