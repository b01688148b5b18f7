"""The port's on-chip transcode experiments, each at a small size on the
CPU (the kernels' plain versions): their parity gates pass, their results
have the shape their ``main`` prints, and ``transcode_profile``'s stages
cover every launch the transcode handle makes.
"""

import pytest
import torch

from qoaudio_tpu import native
from qoaudio_tpu_torch import bench
from qoaudio_tpu_torch.experiments import (bucketed_transcode, decode_calibration,
                                           lane_saturated, transcode_profile)
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode, cuda_gather

pytestmark = pytest.mark.skipif(not native.available(), reason="native engine unavailable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on tiny tensors: one intra-op thread is
    faster than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CLIPS = ((300, 2, 44100), (120, 1, 22050), (200, 2, 48000))


def test_lane_saturated_small():
    res = lane_saturated.run("cpu", {"mixed": CLIPS, "equal": ((400, 2, 44100),) * 3}, iters=1)
    assert list(res) == ["mixed", "equal"]
    assert res["mixed"]["files"] == 3 and res["mixed"]["samples"] == 300 * 2 + 120 + 200 * 2
    assert res["equal"]["samples"] == 2400
    for r in res.values():
        assert r["e2e_msps"] > 0 and r["chip_msps"] > 0
    assert lane_saturated.spot(128) == [0, 32, 64, 96] and lane_saturated.spot(3) == [0, 1, 2]


def test_lane_saturated_gate_fails_on_a_corrupted_decode(monkeypatch):
    fn = cuda_decode.decode_chains_words
    monkeypatch.setattr(cuda_decode, "decode_chains_words", lambda *a: ~fn(*a))
    with pytest.raises(SystemExit, match="PARITY FAILURE"):
        lane_saturated.run("cpu", {"mixed": CLIPS}, iters=1)


def test_bucketed_transcode_small():
    """The byte gates pass ("auto" == False, spot files == native pair);
    three clips do not cut at the CPU model's overhead, and the choice
    says so."""
    r = bucketed_transcode.run("cpu", spec=CLIPS, iters=1)
    assert r["buckets"] is None and "-> one call" in r["choice"]
    assert "5 encode chains, e_mult 1" in r["choice"]
    for k in ("single_e2e_msps", "single_chip_msps", "auto_e2e_msps", "auto_chip_msps"):
        assert r[k] > 0
    spec = bucketed_transcode.mixed_spec()
    assert len(spec) == 256 and sum(ch for _, ch, _ in spec) == 512
    assert sum(spc * ch for spc, ch, _ in spec) == 419_430_400


def test_bucketed_transcode_reports_the_buckets_when_it_cuts(monkeypatch):
    from qoaudio_tpu_torch import bitstream
    from qoaudio_tpu_torch.parallel import corpus

    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    _, pcm, channels, _ = bench.load_pcm()
    streams, _ = bench.build_corpus(pcm.reshape(-1, channels),
                                    CLIPS + ((5120 + 40, 1, 44100),))
    segs, text = bucketed_transcode.describe_choice(
        [bitstream.parse_file_arrays(s) for s in streams], "cpu")
    assert segs == [[0, 1, 2], [3]]
    assert "buckets: 3 files, 1 frames max; 1 files, 2 frames max" in text


def test_decode_calibration_small():
    r = decode_calibration.run("cpu", bench.Sizes(decode_windows=2, decode_chains=8),
                               ks=(1, 2, 4), reps=1)
    assert [row["K"] for row in r["rows"]] == [1, 2, 4] and r["samples"] == 2 * 20 * 8
    for row in r["rows"]:
        assert 0 < row["enqueue_s"] <= row["wall_s"]
    assert r["slope_s"] > 0


@pytest.mark.parametrize("spec, calls", [
    # a clip shorter than a frame: one masked launch (and its lens)
    (((300, 2, 44100),), {"gather": 1, "decode": 1, "relayout": 1, "lens": 1,
                          "encode_full": 0, "encode_masked": 1}),
    # exactly one full frame: the full-window kernel, no lens
    (((5120, 1, 44100),), {"gather": 1, "decode": 1, "relayout": 1, "lens": 0,
                           "encode_full": 1, "encode_masked": 0}),
])
def test_transcode_profile_stages_cover_every_launch(monkeypatch, spec, calls):
    """Count the four wrappers' calls during the profiled runs: every one
    lies inside a stage, and the stages and gaps sum to the total."""
    seen = {"gather": 0, "decode": 0, "encode_full": 0, "encode_masked": 0}
    for mod, name, key in ((cuda_gather, "gather_chains", "gather"),
                           (cuda_decode, "decode_chains_words", "decode"),
                           (cuda_encode, "encode_frames_full", "encode_full"),
                           (cuda_encode, "encode_frames", "encode_masked")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key):
            seen[_key] += 1
            return _fn(*a)
        monkeypatch.setattr(mod, name, counted)
    iters = 2
    r = transcode_profile.run("cpu", spec=spec, iters=iters)
    assert r["calls"] == calls
    # batch_transcode, the handle's gate re-run, a warm run, then the
    # stamped and the unstamped runs
    runs = 3 + 2 * iters
    assert seen == {k: calls[k] * runs for k in seen}
    assert set(transcode_profile.STAGES) <= set(r)
    assert r["total"] == pytest.approx(
        sum(r[s] for s in transcode_profile.STAGES) + r["gaps"], rel=0.05)
    assert r["handle"] > 0 and r["pack"] > 0
    # the wrappers are back in place
    assert cuda_decode.decode_chains_words.__name__ == "counted"
    line = transcode_profile.describe(r)
    assert "decode " in line and "handle without stamps" in line
