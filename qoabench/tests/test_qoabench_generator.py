"""The traffic generator: every seed makes the same shapes, the ones the
configuration lists."""

import json
import os

import pytest
import torch

from qoabench import generate

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


CELLS = [("qoaudio-fixture", "track-transcode"), ("esc50", "fold-transcode"),
         ("esc50", "fold-encode")]


def _shapes(pool):
    return [sorted((pool.files[i].channels, pool.files[i].rate, pool.files[i].samples)
                   for i in files) for files in pool.units]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_every_seed_makes_the_same_shapes(config, traffic):
    cfg, tr = _load("configs", config), _load("traffic", traffic)
    pools = [generate.make_pool(cfg, tr, s) for s in (0, 1, 2**31 + 12345)]
    shapes = [_shapes(p) for p in pools]
    assert shapes[0] == shapes[1] == shapes[2]
    assert len(shapes[0]) == tr["pool_units"]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_each_call_is_the_configured_unit(config, traffic):
    cfg, tr = _load("configs", config), _load("traffic", traffic)
    want = sorted((c, r, n) for c, r, n, count in cfg["files"] for _ in range(count))
    pool = generate.make_pool(cfg, tr, 7)
    assert all(s == want for s in _shapes(pool))


def test_the_cited_shapes():
    esc = generate.unit_shapes(_load("configs", "esc50"))
    assert len(esc) == 400 and set(esc) == {generate.File(1, 44100, 5 * 44100)}
    assert esc[0].frames == 44
    (track,) = generate.unit_shapes(_load("configs", "qoaudio-fixture"))
    assert (track.channels, track.rate, track.samples, track.frames) == (2, 44100, 2_394_122, 468)


def test_the_seed_orders_the_files_within_a_unit():
    cfg = _load("configs", "esc50")
    a, b = (generate.make_pool(cfg, {"pool_units": 2}, s) for s in (1, 2))
    assert a.units != b.units
    assert sorted(a.units[1]) == list(range(400, 800))


def test_content_follows_the_seed():
    cfg = dict(_load("configs", "esc50"), files=[[1, 8000, 300, 3], [2, 8000, 900, 1]])
    pool = generate.make_pool(cfg, {"pool_units": 2}, 5)
    a = generate.synth(pool, 5, "cpu")
    b = generate.synth(pool, 5, "cpu")
    c = generate.synth(pool, 6, "cpu")
    assert [x.shape for x in a] == [(f.channels, f.samples) for f in pool.files]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == torch.int16 and x.abs().max() > 100 for x in a)
