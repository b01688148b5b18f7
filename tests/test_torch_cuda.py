"""The port's CUDA kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and skips without one.  The machine
with the card has no jax, so this file imports none and needs no
conftest; run it there from the repository root with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is compared exactly with its plain PyTorch version on CUDA
tensors, and the fixture's full re-encode through the port matches the
SHA-256 golden of tests/test_native.py.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from qoaudio_tpu_torch import bitstream, codec, native, types
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
from qoaudio_tpu_torch.ops import decode as plain_decode
from qoaudio_tpu_torch.ops import encode as plain_encode
from qoaudio_tpu_torch.parallel import corpus

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures",
    "julien_baker_sprained_ankle.qoa",
)
# the goldens of tests/test_native.py (test_torch_port_rules pins the copy)
REAL_FIXTURE_SHA256 = (
    "b8d822ffee42abe052dfaab00136e86c3c1e9eb6e86cd700867b61a9f45a3372"
)
FIXTURE_REENCODE_SHA256 = (
    "e9f87726aef5d602e248dc839ac7de5c570ad869419984f00274cde76f28c19e"
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fixture_bytes():
    with open(FIXTURE, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != REAL_FIXTURE_SHA256:
        pytest.skip("fixture is not the reference file")
    return data


def _wrap_regime(seed, W, N):
    rng = np.random.default_rng(seed)
    wl = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
        np.uint64
    ) | (rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    st = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
    return wl.byteswap(), st  # raw big-endian words


@pytest.mark.parametrize("W, N", [(256, 1000), (3, 65)])
def test_decode_kernel_matches_plain_and_native(cuda, W, N):
    words_be, st = _wrap_regime(W + N, W, N)
    wd = torch.from_numpy(words_be.view(np.int64)).to(cuda)
    sd = torch.from_numpy(st).to(cuda)
    before = cuda_decode.launches
    got = cuda_decode.decode_chains_words(sd, wd)
    torch.cuda.synchronize()
    assert cuda_decode.launches == before + 1
    assert torch.equal(got, plain_decode.decode_chains_words(sd, wd))
    if native.available():
        assert np.array_equal(got.cpu().numpy(), native.decode_chains(words_be, st))


@pytest.mark.parametrize("W, N", [(256, 1000), (1, 4097), (3, 65), (1, 1)])
def test_decode_kernel_int32_weights_and_ragged_shapes(cuda, W, N):
    """Weights over all of int32 (history over int16): the prediction dot
    and the weight update wrap at every step; chain counts that are no
    multiple of the block, and a single window."""
    words_be, st = _wrap_regime(7 * W + N, W, N)
    st[4:] = np.random.default_rng(W * N).integers(-(1 << 31), 1 << 31, size=(4, N))
    wd = torch.from_numpy(words_be.view(np.int64)).to(cuda)
    sd = torch.from_numpy(st).to(cuda)
    got = cuda_decode.decode_chains_words(sd, wd)
    torch.cuda.synchronize()
    assert torch.equal(got, plain_decode.decode_chains_words(sd, wd))
    if native.available():
        assert np.array_equal(got.cpu().numpy(), native.decode_chains(words_be, st))
    for mode in ("stack", "nostore"):  # the probe's modes carry the same recurrence
        out = cuda_decode.decode_chains_variant(sd, wd, mode)
        assert torch.equal(out[0, 0] if mode == "nostore" else out,
                           got[-1, -1] if mode == "nostore" else got)


def test_decode_kernel_fixture_chains(cuda, fixture_bytes):
    pa = bitstream.parse_file_arrays(fixture_bytes)
    wd = torch.from_numpy(np.ascontiguousarray(pa.words_be).view(np.int64)).to(cuda)
    sd = torch.from_numpy(pa.state).to(cuda)
    got = cuda_decode.decode_chains_words(sd, wd)
    assert torch.equal(got, plain_decode.decode_chains_words(sd, wd))


@pytest.mark.parametrize("mode", plain_decode.VARIANT_MODES)
@pytest.mark.parametrize("threads", [64, 256])
def test_decode_variant_kernel_matches_plain(cuda, mode, threads):
    """Each store mode of the probe against its plain version, on every
    position the mode defines; v0 is the production kernel."""
    W, N = 64, 1000
    words_be, st = _wrap_regime(W * N + threads, W, N)
    wd = torch.from_numpy(words_be.view(np.int64)).to(cuda)
    sd = torch.from_numpy(st).to(cuda)
    before = cuda_decode.variant_launches
    got = cuda_decode.decode_chains_variant(sd, wd, mode, threads)
    torch.cuda.synchronize()
    assert cuda_decode.variant_launches == before + 1
    want = plain_decode.decode_chains_variant(sd, wd, mode)
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "nostore":
        assert torch.equal(got[0, 0], want[0, 0])
    else:
        assert torch.equal(got, want)
    if mode == "v0":
        assert torch.equal(got, cuda_decode.decode_chains_words(sd, wd))


def _windows(seed, F, W, N, masked):
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, size=(F, W, 20, N)).astype(np.int16)
    lens = (rng.integers(0, 21, size=(F, W, N)) if masked
            else np.full((F, W, N), 20)).astype(np.int32)
    x = np.where(np.arange(20)[None, None, :, None] < lens[:, :, None, :], x, 0)
    carry = rng.integers(-65536, 65536, size=(8, N)).astype(np.int32)
    return x.astype(np.int16), lens, carry


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("F, W, N", [(2, 16, 256), (3, 5, 33)])
def test_encode_kernels_match_plain(cuda, masked, F, W, N, wrap):
    """Random windows from a random state, or from a wrap-regime state:
    weights over all of int32 and history over int16 make the prediction
    dot, qoa_div (sf 0 and 1) and the weight update wrap."""
    x, lens, carry = _windows(F * W + N, F, W, N, masked)
    if wrap:
        rng = np.random.default_rng(F * W * N)
        carry = np.concatenate([rng.integers(-32768, 32768, size=(4, N)),
                                rng.integers(-(1 << 31), 1 << 31, size=(4, N))]
                               ).astype(np.int32)
    x, lens, carry = (torch.from_numpy(a).to(cuda) for a in (x, lens, carry))
    if masked:
        got = cuda_encode.encode_frames(carry, x, lens)
        want = plain_encode.encode_frames(carry, x, lens)
    else:
        got = cuda_encode.encode_frames_full(carry, x)
        want = plain_encode.encode_frames_full(carry, x)
        masked_got = cuda_encode.encode_frames(carry, x, lens)
        for g, m in zip(got, masked_got):
            assert torch.equal(g, m)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_masked_kernel_full_and_ended_chains_in_one_warp(cuda):
    """The two chains of a warp: one full and one idle (length 0), both
    idle, both full, and short windows mixed in — the warp-uniform step
    choice and the reset of idle chains must match the plain version.
    Samples past each length are NOT zeroed (the transcode relayout points
    idle slots at real data): neither version may read them."""
    F, W, N = 2, 12, 37  # odd N: the last warp has a spare half
    x, _, carry = _windows(77, F, W, N, masked=False)
    rng = np.random.default_rng(78)
    pattern = rng.integers(0, 4, size=(F, W, N))
    lens = np.where(pattern == 0, 0, 20)
    lens = np.where(pattern == 3, rng.integers(1, 20, size=(F, W, N)), lens)
    lens[:, : W // 2, 0::2] = 0  # even chains idle for half the windows
    x, lens, carry = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                      for a in (x, lens.astype(np.int32), carry))
    got = cuda_encode.encode_frames(carry, x, lens)
    want = plain_encode.encode_frames(carry, x, lens)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_transfer_round_trip_on_cuda(cuda):
    from qoaudio_tpu_torch.utils import transfer

    rng = np.random.default_rng(3)
    arrays = [
        rng.integers(-(1 << 62), 1 << 62, size=(300, 7)),
        rng.integers(-32768, 32768, size=(4, 20, 33)).astype(np.int16),
    ]
    ts = transfer.put_arrays(arrays, cuda)
    assert all(t.device.type == "cuda" for t in ts)
    back = transfer.fetch_arrays(ts)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert b.flags.owndata  # a plain copy, not a view of pinned staging


def test_fixture_reencode_golden(cuda, fixture_bytes):
    out = codec.decode_all(fixture_bytes, backend="native")
    desc = types.QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    (enc,) = corpus.batch_encode([(out.samples, desc)], cuda)
    assert hashlib.sha256(enc).hexdigest() == FIXTURE_REENCODE_SHA256
    corpus.host_pair_files = 0
    (tc,) = corpus.batch_transcode([fixture_bytes], cuda)
    assert corpus.host_pair_files == 0
    assert hashlib.sha256(tc).hexdigest() == FIXTURE_REENCODE_SHA256
    (dec,) = corpus.batch_decode([fixture_bytes], cuda)
    assert np.array_equal(dec.samples, out.samples)


def test_codec_entry_points_on_card(cuda, fixture_bytes, tmp_path):
    from qoaudio_tpu_torch import open_and_decode_all

    want = codec.decode_all(fixture_bytes, backend="native")
    before = cuda_decode.launches
    got = codec.decode_all(fixture_bytes, backend="torch", device=cuda)
    assert cuda_decode.launches == before + 1
    assert np.array_equal(got.samples, want.samples)
    p = tmp_path / "f.qoa"
    p.write_bytes(fixture_bytes)
    assert np.array_equal(
        open_and_decode_all(str(p), backend="torch", device=cuda).samples, want.samples)
    r = codec.decode_range(fixture_bytes, 5000, 12000, backend="torch", device=cuda)
    assert np.array_equal(r.samples, want.samples[2 * 5000 : 2 * 12000])

    desc = types.QoaDesc(want.num_channels, want.sample_rate, want.samples_per_channel)
    full, masked = cuda_encode.full_launches, cuda_encode.masked_launches
    enc = codec.encode_all(want.samples, desc, backend="torch", device=cuda)
    assert hashlib.sha256(enc).hexdigest() == FIXTURE_REENCODE_SHA256
    assert cuda_encode.full_launches > full and cuda_encode.masked_launches > masked


def test_streaming_decoder_on_card(cuda, fixture_bytes, tmp_path):
    from qoaudio_tpu_torch import QoaDecoder

    p = tmp_path / "f.qoa"
    p.write_bytes(fixture_bytes)
    dec = QoaDecoder.open(str(p), backend="torch", device=cuda, readahead=32)
    before = cuda_decode.launches
    got = dec.decode_pending()
    assert cuda_decode.launches > before and dec.prefetch_hits >= 1
    assert np.array_equal(got, codec.decode_all(fixture_bytes, backend="native").samples)
    dec.into_inner().close()


def test_streaming_encoder_on_card(cuda):
    import io

    from qoaudio_tpu_torch import QoaEncoder

    rng = np.random.default_rng(8)
    n = 3 * 5120 + 1234
    pcm = rng.integers(-30000, 30000, size=2 * n).astype(np.int16)
    desc = types.QoaDesc(2, 44100, n)
    want = codec.encode_all(pcm, desc, backend="native")
    assert QoaEncoder(desc, backend="torch", device=cuda).encode(pcm) == want
    enc = QoaEncoder(desc, backend="torch", device=cuda)
    out = io.BytesIO()
    enc.write_header(out)
    for off in range(0, n, 5120):
        enc.encode_frame(pcm[2 * off : 2 * min(n, off + 5120)], out)
    assert out.getvalue() == want


def test_mesh_transcode_on_one_card(cuda):
    """A mesh that lists the card twice: two device groups, each its own
    decode and encode launches, bytes equal to the single-device run."""
    from qoaudio_tpu_torch.parallel import make_mesh

    assert cuda_encode.chains_per_wave(cuda) > 0
    rng = np.random.default_rng(12)
    streams = []
    for i, (n, ch) in enumerate(((5120 * 3 + 17, 2), (900, 1), (5120 + 5, 1), (4000, 2))):
        pcm = rng.integers(-20000, 20000, size=n * ch).astype(np.int16)
        streams.append(codec.encode_all(pcm, types.QoaDesc(ch, 44100, n), backend="native"))
    want = corpus.batch_transcode(streams, cuda)
    before = cuda_decode.launches
    got = corpus.batch_transcode(streams, mesh=make_mesh(devices=("cuda:0",) * 2))
    assert cuda_decode.launches == before + 2
    assert got == want


def test_mesh_over_every_card(cuda):
    """make_mesh() over two or more distinct cards: every card gets files,
    each card its own decode launch, and the three corpus calls equal the
    single-device run; a fetch waits on every card it reads from."""
    from qoaudio_tpu_torch.parallel import make_mesh
    from qoaudio_tpu_torch.utils.transfer import fetch_arrays

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count() == len(set(mesh.devices))
    rng = np.random.default_rng(13)
    files, streams = [], []
    for i in range(2 * mesh.size + 1):
        n, ch = (5120 * 2 + 31 * i, 900 + 7 * i, 5120 + 5)[i % 3], 1 + i % 2
        pcm = rng.integers(-20000, 20000, size=n * ch).astype(np.int16)
        files.append((pcm, types.QoaDesc(ch, 44100, n)))
        streams.append(codec.encode_all(pcm, files[-1][1], backend="native"))
    one = torch.device("cuda:0")
    before = cuda_decode.launches
    got = corpus.batch_transcode(streams, mesh=mesh)
    assert cuda_decode.launches == before + mesh.size
    assert got == corpus.batch_transcode(streams, one)
    dec = corpus.batch_decode(streams, mesh=mesh)
    for g, w in zip(dec, corpus.batch_decode(streams, one)):
        assert np.array_equal(g.samples, w.samples)
    assert corpus.batch_encode(files, mesh=mesh) == corpus.batch_encode(files, one)
    parts = [torch.full((1 << 20,), k, dtype=torch.int32, device=d)
             for k, d in enumerate(mesh.devices)]
    for k, a in enumerate(fetch_arrays(parts)):
        assert (a == k).all()


def _small_bench_sizes():
    from qoaudio_tpu_torch import bench

    return bench.Sizes(
        n_chains=256, frames=2, plain_frames=1, chain_launches=2,
        decode_windows=64, decode_chains=4096, parity_chains=256, decode_launches=3,
        transcode_spec=bench.bench_spec(4), saturated_spec=bench.saturated_spec(8, 4),
        spot_files=(0, 7), host_iters=2, iters=2)


def test_bench_sections_on_card(cuda, fixture_bytes, capsys):
    """The port's bench at a reduced size on the card: every parity gate
    passes on the kernels, each section launches exactly what it needs,
    and the JSON line names the card."""
    import json

    from qoaudio_tpu_torch import bench

    sizes = _small_bench_sizes()
    assert bench.main(cuda, sizes) == 0
    cap = capsys.readouterr()
    (line,) = cap.out.strip().splitlines()
    res = json.loads(line)
    calls = 2 * sizes.iters + 2
    windows = (sizes.iters + 1) * sizes.chain_launches + 2
    assert res["launches"] == {
        "decode": {"decode": (sizes.iters + 1) * sizes.decode_launches + 1, "masked": 0,
                   "full": 0},
        # 4 files of 64-256 frames: a full first chunk, three masked ones
        "transcode": {"decode": calls, "masked": 3 * calls, "full": calls},
        "encode": {"decode": 0, "masked": windows, "full": windows},
        "saturated": {"decode": calls, "masked": 0, "full": calls},
    }
    assert res["device"].startswith(torch.cuda.get_device_name(0))
    for key in ("value", "encode_masked_msps", "decode_batched_msps", "transcode_hbm_msps",
                "transcode_chip_msps", "transcode_saturated_msps",
                "transcode_saturated_chip_msps", "decode_e2e_msps"):
        assert res[key] > 0, key
    assert cap.err.count("parity gate:") == 4


def test_bench_gate_catches_a_wrong_kernel_on_card(cuda, fixture_bytes, monkeypatch, capsys):
    from qoaudio_tpu_torch import bench

    fn = cuda_encode.encode_frames_full

    def off_by_one_bit(state, samples):
        new_state, snaps, words = fn(state, samples)
        return new_state, snaps, words ^ 1

    monkeypatch.setattr(cuda_encode, "encode_frames_full", off_by_one_bit)
    with pytest.raises(SystemExit, match="PARITY FAILURE"):
        bench.main(cuda, _small_bench_sizes())
    assert capsys.readouterr().out == ""


def test_entry_and_dryrun_on_card(cuda, capsys):
    """The flagship step launches the masked kernel once and equals the
    plain version; the dry run passes its six steps on a mesh that repeats
    the cards present, every shard's output on its own device."""
    from qoaudio_tpu_torch import graft_entry

    fn, args = graft_entry.entry(cuda)
    assert all(a.device.type == "cuda" for a in args)
    before = cuda_encode.masked_launches
    words, state = fn(*args)
    torch.cuda.synchronize()
    assert cuda_encode.masked_launches == before + 1
    p_state, _, p_words = plain_encode.encode_frames(*args)
    assert torch.equal(words, p_words) and torch.equal(state, p_state)
    dec, masked = cuda_decode.launches, cuda_encode.masked_launches
    graft_entry.dryrun_multichip(3)
    assert cuda_decode.launches > dec and cuda_encode.masked_launches > masked
    assert "dryrun_multichip OK: 3-device mesh" in capsys.readouterr().out


def test_transcode_profile_and_calibration_on_card(cuda, fixture_bytes):
    from qoaudio_tpu_torch import bench
    from qoaudio_tpu_torch.experiments import decode_calibration, transcode_profile

    r = transcode_profile.run(cuda, spec=bench.bench_spec(4), iters=2)
    assert r["calls"] == {"decode": 1, "relayout": 4, "lens": 3, "encode_full": 1,
                          "encode_masked": 3}
    assert r["steps"]["encode_full"] == 64 * 5120 and r["steps"]["encode_masked"] == 192 * 5120
    assert all(r[s] > 0 for s in transcode_profile.STAGES)
    assert abs(r["total"] - r["handle"]) < 0.2 * r["handle"]
    c = decode_calibration.run(cuda, bench.Sizes(decode_windows=64, decode_chains=4096),
                               ks=(1, 4, 8), reps=2)
    assert c["slope_s"] > 0 and all(row["device_s"] > 0 for row in c["rows"])
