"""The chain gather on the device (``ops/gather.py``, through the
``ops.cuda_gather`` wrapper's CPU route) held bit for bit against the host
gather it replaces on ``batch_transcode``'s path: ``corpus._stage_decode``
of ``bitstream.parse_file_arrays``.

A device group's streams are staged as the corpus layer stages them
(``corpus._stage_streams``: the streams back to back, the table from each
stream's geometry).  And the geometry alone (``parse_file_geometry``)
decides what ``parse_file_arrays`` decided for the corpus layer: whether a
stream takes the device path, its frames, windows and samples.
"""

import numpy as np
import pytest
import torch

from qoaudio_tpu_torch import bitstream as bs
from qoaudio_tpu_torch import codec, native
from qoaudio_tpu_torch import format as fmt
from qoaudio_tpu_torch.ops import cuda_gather, gather
from qoaudio_tpu_torch.parallel import corpus
from qoaudio_tpu_torch.types import QoaDesc

from conftest import make_noise, make_sine
from test_torch_host import FIXTURE, STREAMS

FRAME = fmt.QOA_FRAME_LEN
CLIP = 220_500  # an ESC-50 clip: 43 full frames and a 540-sample tail


@pytest.fixture(autouse=True, scope="module")
def _native():
    if not native.available():
        pytest.skip("native engine unavailable")


def _encode(n: int, channels: int = 1, seed: int = 0, loud: bool = False) -> bytes:
    if loud:  # full-scale noise: wide weights, of both signs
        pcm = make_noise(n, channels, seed=seed, amplitude=32000)
    else:
        pcm = make_sine(n, channels, freq=220.0 + 37 * seed) // 2 + make_noise(
            n, channels, seed=seed, amplitude=3000)
    return codec.encode_all(pcm.astype(np.int16), QoaDesc(channels, 44100, n), backend="native")


def _zero_sample_tail(seed: int) -> bytes:
    """A fixed-mode mono stream of one full frame that ends in a frame
    whose header says 0 samples and whose size field declares one slice.
    The header checks pass (they validate the size alone) and reads are
    sample-driven, so that last frame is its header and LMS words."""
    d = _encode(FRAME, seed=seed)
    tail = fmt.pack_frame_header(1, 44100, 0, fmt.qoa_frame_size(1, 1))
    return d + tail.to_bytes(8, "big") + d[16:32]


def _native_pair(stream: bytes) -> bytes:
    out = codec.decode_all(stream, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return codec.encode_all(out.samples, desc, backend="native")


def _fixture() -> bytes:
    with open(FIXTURE, "rb") as f:
        return f.read()


# name -> the streams of one device group, in group order
GROUPS = {
    "mono-5s-clip": lambda: [_encode(CLIP)],
    "stereo": lambda: [_encode(3 * FRAME + 777, 2, seed=1)],
    "8-channels": lambda: [_encode(2 * FRAME + 123, 8, seed=2)],
    "exact-frames": lambda: [_encode(4 * FRAME, 1, seed=3), _encode(2 * FRAME, 2, seed=4)],
    "short-frame-among-long": lambda: [_encode(CLIP, seed=5), _encode(41, seed=6),
                                       _encode(2 * FRAME + 9, 2, seed=7)],
    "same-size-tails": lambda: [_encode(2 * FRAME + 5_101, seed=8),
                                _encode(FRAME + 5_119, 2, seed=9)],
    "negative-weights": lambda: [_encode(3 * FRAME + 50, 2, seed=10, loud=True)],
    "fixture": lambda: [_fixture()],
    "mixed-bucket-order": lambda: [_encode(n, c, seed=11 + i) for i, (n, c) in enumerate(
        [(300, 1), (5_000, 2), (FRAME + 1, 1), (7 * FRAME + 4_000, 3), (20, 1),
         (2 * FRAME + 5_110, 1), (FRAME, 8)])],
    "zero-sample-tail-last": lambda: [_encode(CLIP, seed=18), _zero_sample_tail(19)],
}


def _gathered(streams):
    """The corpus layer's staging of ``streams`` and the wrapper's gather
    of it on the CPU: (words_be, state) as numpy."""
    geos = [bs.parse_file_geometry(d) for d in streams]
    assert all(corpus._device_eligible(g) for g in geos)
    buf, table, n_chains = corpus._stage_streams(streams, geos, pin=False)
    assert buf.numpy().tobytes() == b"".join(streams)
    W = max(g.max_windows for g in geos)
    before = cuda_gather.launches
    words, state = cuda_gather.gather_chains(buf, torch.from_numpy(table), W, n_chains)
    assert cuda_gather.launches == before  # a CPU tensor runs the plain version
    assert words.dtype == torch.int64 and words.shape == (W, n_chains)
    assert state.dtype == torch.int32 and state.shape == (8, n_chains)
    return words.numpy(), state.numpy()


def _bucket_segments(streams):
    """The groups ``batch_transcode``'s length buckets would make of
    ``streams`` under a cost model that always cuts (every file its own
    wave), each in its bucket's order."""
    geos = [bs.parse_file_geometry(d) for d in streams]
    segs = corpus._length_buckets([g.n_frames for g in geos], [g.channels for g in geos],
                                  1, 64, overhead=1.0)
    assert segs is not None and len(segs) > 1
    return [[streams[i] for i in seg] for seg in segs]


@pytest.mark.parametrize("name", list(GROUPS))
def test_gather_equals_the_host_gather(name):
    streams = GROUPS[name]()
    groups = [streams] + (_bucket_segments(streams) if name == "mixed-bucket-order" else [])
    for group in groups:
        want_words, want_state, _ = corpus._stage_decode([bs.parse_file_arrays(d) for d in group])
        words, state = _gathered(group)
        assert np.array_equal(words, want_words)
        assert np.array_equal(state, want_state)
    if name == "negative-weights":
        assert (state[4:] < 0).any() and (state[4:] > 0).any() and (state[:4] < 0).any()
    if name == "short-frame-among-long":  # the 41-sample clip: rows past its 3 windows
        col = 44  # its one chain, after the 5-s clip's 44
        assert words.shape[0] == 256 and (words[3:, col] == 0).all() and words[2, col] != 0


def _variants(data: bytes):
    """A stream and what a damaged copy of it may look like: cut short
    (mid-frame, mid-tail, to the header), a frame header's channels or
    size changed, and the file header's count set to streaming mode."""
    out = {"as-is": data, "cut-5": data[:-5], "cut-tail-word": data[:-8],
           "header-only": data[:8], "half": data[: len(data) // 2]}
    if len(data) > 24:
        b = bytearray(data)
        b[8] ^= 0x03  # the first frame's channels
        out["channels-changed"] = bytes(b)
        b = bytearray(data)
        b[15] ^= 0x08  # the first frame's size
        out["size-changed"] = bytes(b)
        out["streaming-header"] = fmt.pack_file_header(0) + data[8:]
    return out


HOST_CORPUS = [(case, kind) for case in sorted(STREAMS) for kind in
               ("as-is", "cut-5", "cut-tail-word", "header-only", "half", "channels-changed",
                "size-changed", "streaming-header")]


@pytest.mark.parametrize("case,kind", HOST_CORPUS, ids=[f"{c}-{k}" for c, k in HOST_CORPUS])
def test_geometry_decides_what_the_arrays_decided(case, kind):
    data = _variants(STREAMS[case]())[kind]
    geo, arrays = bs.parse_file_geometry(data), bs.parse_file_arrays(data)
    assert (geo is None) == (arrays is None)
    assert corpus._device_eligible(geo) == corpus._device_eligible(arrays)
    if geo is None:
        return
    assert (geo.n_frames, geo.channels, geo.sample_rate, geo.max_windows) == (
        arrays.n_frames, arrays.channels, arrays.sample_rate, arrays.max_windows)
    tail = [] if geo.tail is None else [geo.tail.samples_per_channel]
    assert np.array_equal([geo.spc0] * geo.F_full + tail, arrays.samples_per_frame)
    assert geo.first_frame_samples == arrays.first_frame_samples
    assert geo.frame_samples == int(arrays.samples_per_frame.sum())
    if corpus._device_eligible(geo):
        assert len(data) % 8 == 0  # staged as int64 words


def test_gather_table_from_the_geometry():
    streams = GROUPS["mixed-bucket-order"]() + [_zero_sample_tail(20)]
    geos = [bs.parse_file_geometry(d) for d in streams]
    _, table, n_chains = corpus._stage_streams(streams, geos, pin=False)
    chains = [g.n_frames * g.channels for g in geos]
    sizes = [len(d) for d in streams]
    assert n_chains == sum(chains)
    assert table[gather.CHAIN].tolist() == np.cumsum([0] + chains[:-1]).tolist()
    assert table[gather.OFFSET].tolist() == (np.cumsum([0] + sizes[:-1]) + 8).tolist()
    assert table[gather.TAIL_WINDOWS].tolist() == [
        0 if g.tail is None else -(-g.tail.samples_per_channel // fmt.QOA_SLICE_LEN)
        for g in geos]


@pytest.mark.parametrize("devices", [1, 2])
def test_batch_transcode_zero_sample_tail_ends_a_group(devices):
    # the file whose last frame holds no samples is the last of its device
    # group: its tail is a chain of zero words, counted by the gather's
    # table as by the relayout
    from qoaudio_tpu_torch.parallel import make_mesh

    streams = [_encode(FRAME + 300, 2, seed=21), _zero_sample_tail(22)]
    geo = bs.parse_file_geometry(streams[1])
    assert corpus._device_eligible(geo) and geo.n_frames == 2 and geo.tail.n_windows == 0
    where = ({"device": "cpu"} if devices == 1
             else {"mesh": make_mesh(devices=("cpu",) * devices)})
    corpus.host_pair_files = 0
    got = corpus.batch_transcode(streams, **where)
    assert corpus.host_pair_files == 0
    assert got == [_native_pair(s) for s in streams]
