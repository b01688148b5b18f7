"""A last frame as long in bytes as a full one: 5,101-5,119 samples fill
the same 256 slice windows as 5,120.

The port's arithmetic parser (``bitstream.parse_file_geometry``) must take
such a frame as the stream's tail, so that ``parse_file_arrays`` gathers
it and ``batch_transcode`` keeps the file on the device path, and must
still refuse every other mismatch.  Streams come from the JAX package's
native encoder; the JAX package's own decode is the PCM they must give.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qoaudio_tpu import codec as jax_codec
from qoaudio_tpu import native as jax_native
from qoaudio_tpu.parallel import corpus as jax_corpus
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch import bitstream as bs
from qoaudio_tpu_torch import codec
from qoaudio_tpu_torch import format as fmt
from qoaudio_tpu_torch.errors import QoaError
from qoaudio_tpu_torch.parallel import corpus

from conftest import make_noise

FRAME = fmt.QOA_FRAME_LEN
# the parse rule's boundaries over 5,099-5,121: 255 against 256 windows,
# the same-size tails 5,101-5,119 (both ends and one inside), an exact
# 5,120, and 5,121, which is no frame
TAILS = (5099, 5100, 5101, 5110, 5119, 5120, 5121)


@pytest.fixture(autouse=True)
def _native():
    if not jax_native.available():
        pytest.skip("native engine unavailable")


def _stream(tail: int, channels: int, full: int = 2, seed: int = 0) -> bytes:
    """``full`` whole frames then a last frame of ``tail`` samples; a tail
    of 5,121 is the 5,119 stream with its last header claiming 5,121
    samples and two more windows of words: 257 windows, no valid frame."""
    n = full * FRAME + (tail if tail <= FRAME else 5119)
    data = jax_codec.encode_all(make_noise(n, channels, seed=seed + tail),
                                QoaDesc(channels, 44100, n), backend="native")
    if tail <= FRAME:
        return data
    last = fmt.QOA_HEADER_SIZE + full * fmt.qoa_frame_size(channels, 256)
    word = fmt.pack_frame_header(channels, 44100, tail, fmt.qoa_frame_size(channels, 257))
    return (fmt.pack_file_header(full * FRAME + tail) + data[8:last]
            + word.to_bytes(8, "big") + data[last + 8:] + bytes(8 * channels))


def _walk_arrays(data: bytes):
    """The general frame walk's (samples per frame, words, state), laid
    out as ``parse_file_arrays`` lays them."""
    batch = bs.stack_frames(bs.parse_file(data).frames)
    words, state = bs.batch_chain_arrays(batch)
    return batch.samples_per_frame, words, state


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("tail", TAILS)
def test_same_size_tail_parses_as_the_walk(tail, channels):
    data = _stream(tail, channels)
    geo = bs.parse_file_geometry(data)
    if tail > FRAME:
        assert geo is None and bs.parse_file_arrays(data) is None
        with pytest.raises(QoaError):
            bs.parse_file(data)
        return
    assert geo is not None
    if tail == FRAME:  # an exact multiple: three full frames, no tail
        assert (geo.F_full, geo.tail) == (3, None)
    else:
        assert geo.F_full == 2 and geo.tail.samples_per_channel == tail
        assert (geo.spc0, geo.W0) == (FRAME, 256)
    pa = bs.parse_file_arrays(data)
    spf, words, state = _walk_arrays(data)
    np.testing.assert_array_equal(pa.samples_per_frame, spf)
    np.testing.assert_array_equal(pa.words_be, words)
    np.testing.assert_array_equal(pa.state, state)
    assert corpus._device_eligible(pa)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("tail", [t for t in TAILS if t <= FRAME])
def test_same_size_tail_decodes_to_the_jax_pcm(tail, channels):
    data = _stream(tail, channels)
    want = jax_codec.decode_all(data, backend="native").samples
    for kw in ({"backend": "native"}, {"backend": "numpy"},
               {"backend": "torch", "device": "cpu"}):
        np.testing.assert_array_equal(codec.decode_all(data, **kw).samples, want)
    n = 2 * FRAME + tail
    for lo, hi in ((0, n), (2 * FRAME - 7, n), (2 * FRAME + 100, n + 50), (FRAME + 3, FRAME + 9)):
        got = codec.decode_range(data, lo, hi, backend="native").samples
        np.testing.assert_array_equal(got, want.reshape(-1, channels)[lo:hi].reshape(-1))


def _patch_last_header(data: bytes, channels: int, **field) -> bytes:
    last = fmt.QOA_HEADER_SIZE + 2 * fmt.qoa_frame_size(channels, 256)
    c, r, s, f = fmt.unpack_frame_header(int.from_bytes(data[last:last + 8], "big"))
    word = fmt.pack_frame_header(field.get("c", c), field.get("r", r), field.get("s", s),
                                 field.get("f", f))
    return data[:last] + word.to_bytes(8, "big") + data[last + 8:]


def _longer_last_frame() -> bytes:
    """A frame of 5,110 samples, then one of the same size claiming 5,115:
    the same 256 windows, but longer than the first frame."""
    one = jax_codec.encode_all(make_noise(5110, 1, seed=9), QoaDesc(1, 44100, 5110),
                               backend="native")[8:]
    c, r, _, f = fmt.unpack_frame_header(int.from_bytes(one[:8], "big"))
    return (fmt.pack_file_header(5110 + 5115) + one
            + fmt.pack_frame_header(c, r, 5115, f).to_bytes(8, "big") + one[8:])


def _short_frame_inside() -> bytes:
    """Frames of 5,120 and 5,110 samples, then a last one of 300: the
    same-size short frame is not the last."""
    head = _stream(5110, 1, full=1)
    last = jax_codec.encode_all(make_noise(300, 1, seed=8), QoaDesc(1, 44100, 300),
                                backend="native")[8:]
    return fmt.pack_file_header(FRAME + 5110 + 300) + head[8:] + last


@pytest.mark.parametrize("change", ["rate", "channels", "longer", "inside", "size_field",
                                    "streaming"])
def test_other_mismatches_still_refused(change):
    """A same-size last frame that changes the rate or the channels, runs
    longer than the first frame, or differs from a full frame only in its
    size field, a same-size short frame before the last, and a
    streaming-mode stream: no geometry, and the walk decides."""
    data = _stream(5110, 1)
    bad = {"rate": lambda: _patch_last_header(data, 1, r=48000),
           "channels": lambda: _patch_last_header(data, 1, c=2),
           "longer": _longer_last_frame,
           "inside": _short_frame_inside,
           "size_field": lambda: _patch_last_header(data, 1, s=FRAME, f=fmt.qoa_frame_size(1, 255)),
           "streaming": lambda: fmt.pack_file_header(0) + data[8:]}[change]()
    assert bs.parse_file_geometry(bad) is None
    assert bs.parse_file_arrays(bad) is None
    walk = {"longer": [5110, 5115], "inside": [FRAME, 5110, 300]}
    if change in walk:
        assert [f.samples_per_channel for f in bs.parse_file(bad).frames] == walk[change]


# ---------------------------------------------------------------------------
# batch_transcode over a small mixed corpus, bucketed on the CPU
# ---------------------------------------------------------------------------

# samples a channel: same-size tails of 5,101 and 5,119, an exact multiple
# of 5,120, a 3-frame and two 1-frame clips
MIXED = ((FRAME + 5101, 1), (FRAME + 5119, 2), (2 * FRAME, 1), (2 * FRAME + 700, 1),
         (300, 2), (4111, 1))


def _mixed():
    files = [(make_noise(n, c, seed=40 + i), QoaDesc(c, 44100, n))
             for i, (n, c) in enumerate(MIXED)]
    return [jax_codec.encode_all(p, d, backend="native") for p, d in files]


def _native_pair(stream):
    out = jax_codec.decode_all(stream, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return jax_codec.encode_all(out.samples, desc, backend="native")


@pytest.fixture
def shrunk(monkeypatch):
    """The CPU cost model of ``test_torch_buckets.py``: a sub-call costs
    one lane-frame, so the corpus splits by length."""
    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    monkeypatch.setattr(jax_corpus, "_BUCKET_OVERHEAD", 1.0)


def test_mixed_corpus_stays_on_the_device_path(shrunk):
    streams = _mixed()
    parsed = [bs.parse_file_arrays(d) for d in streams]
    assert all(corpus._device_eligible(p) for p in parsed)
    segs = corpus._length_buckets([p.n_frames for p in parsed],
                                  [p.channels for p in parsed], 1, 64)
    assert segs is not None and len(segs) >= 2
    corpus.host_pair_files = 0
    got, handle = corpus.batch_transcode(streams, "cpu", return_fused_handle=True)
    assert corpus.host_pair_files == 0
    assert isinstance(handle, corpus._CompositeFusedHandle)
    assert len(handle.handles) == len(segs)
    assert got == corpus.batch_transcode(streams, "cpu", bucket=False)
    assert got == jax_corpus.batch_transcode(streams)
    assert got == [_native_pair(s) for s in streams]


# ---------------------------------------------------------------------------
# The spans of the bucket choice and the host pair
# ---------------------------------------------------------------------------

def _span_counts(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                    if e.name().startswith("qoa."))


def _span_corpus():
    """One two-frame mono file and four one-frame clips: with the shrunk
    model they split into two buckets."""
    sizes = ((FRAME + 37, 1), (80, 2), (133, 2), (186, 1), (239, 2))
    files = [(make_noise(n, c, seed=60 + i), QoaDesc(c, 44100, n))
             for i, (n, c) in enumerate(sizes)]
    return [jax_codec.encode_all(p, d, backend="native") for p, d in files]


def test_bucket_and_host_pair_spans_once_a_call(shrunk):
    streams = _span_corpus()
    segs = corpus._length_buckets([2, 1, 1, 1, 1], [1, 2, 2, 1, 2], 1, 64)
    assert segs is not None and len(segs) == 2
    # a stream the parser refuses takes the host pair inside its span
    mixed = [fmt.pack_file_header(0) + streams[1][8:]] + streams
    corpus.host_pair_files = 0
    out, n = _span_counts(lambda: corpus.batch_transcode(mixed, "cpu"))
    assert corpus.host_pair_files == 1
    assert out == [_native_pair(s) for s in mixed]
    # one host-pair split and one bucket choice a call; a pipeline and an
    # assembly per bucket
    assert (n["qoa.host_pair"], n["qoa.bucket"]) == (1, 1)
    assert n["qoa.pipeline"] == n["qoa.assemble"] == len(segs)
    # unbucketed (the one-frame clips alone): the split only
    out, n = _span_counts(lambda: corpus.batch_transcode(streams[1:], "cpu", bucket=False))
    assert out == [_native_pair(s) for s in streams[1:]]
    assert (n["qoa.host_pair"], n["qoa.bucket"], n["qoa.pipeline"]) == (1, 0, 1)
    _, n = _span_counts(lambda: corpus.batch_decode(mixed, "cpu"))
    assert (n["qoa.host_pair"], n["qoa.bucket"]) == (1, 0)


def test_no_span_without_the_profiler(shrunk, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name} with no profiler")

    streams = _span_corpus()
    want = corpus.batch_transcode(streams, "cpu", bucket=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert corpus.batch_transcode(streams, "cpu") == want
    assert len(corpus.batch_decode(streams, "cpu")) == len(streams)
