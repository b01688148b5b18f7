"""Length bucketing and the transcode handle of the port's corpus layer.

``qoaudio_tpu_torch.parallel.corpus._length_buckets`` must return the JAX
package's partition for the same inputs and constants; ``bucket="auto"``
must give the bytes of ``bucket=False``, of ``qoaudio_tpu`` and of the
native engine (the cost constants shrink, as ``tests/test_parallel.py``
does, so a tiny CPU corpus buckets); and ``return_fused_handle=True`` must
hand out the staged device pipeline, which re-runs with exactly the
launches of the call.  Files stay at 2 frames or fewer: the plain encoder
costs ~1 s per full frame.
"""

import io

import numpy as np
import pytest

from qoaudio_tpu import codec, native
from qoaudio_tpu import format as fmt
from qoaudio_tpu.parallel import corpus as jax_corpus
from qoaudio_tpu.types import QoaDesc
from qoaudio_tpu_torch.ops import cuda_decode, cuda_encode
from qoaudio_tpu_torch.parallel import corpus, make_mesh
from qoaudio_tpu_torch.utils.transfer import fetch_arrays

from conftest import make_noise

# the encoder's wave measured on an H100: 16 resident blocks per SM x 132
# SMs x 2 chains per block
HOPPER_WAVE = 16 * 132 * 2


def _native_pair(stream):
    out = codec.decode_all(stream, backend="native")
    desc = QoaDesc(out.num_channels, out.sample_rate, out.samples_per_channel)
    return codec.encode_all(out.samples, desc, backend="native")


def _frames(files):
    return [-(-d.samples // fmt.QOA_FRAME_LEN) for _, d in files]


@pytest.mark.parametrize("seed", range(16))
def test_length_buckets_match_jax(seed, monkeypatch):
    """A seeded sweep of lengths, channels, e_mult, chunk and overhead; the
    port's partition (which tests only the first cut of each e_mult step)
    equals the JAX package's full dynamic program."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 48))
    groups = rng.choice([1, 3, 17, 64, 65, 200, 468], size=int(rng.integers(1, 4)))
    frames = [int(rng.choice(groups)) + int(rng.integers(0, 3)) for _ in range(n)]
    # up to 8 channels on odd seeds: a file can then span several e_mult
    chans = [int(c) for c in rng.integers(1, 9 if seed % 2 else 3, size=n)]
    e_mult = int(rng.choice([1, 2, 3, 8, 128]))
    chunk = int(rng.choice([1, 4, 64]))
    overhead = float(rng.choice([1.0, 16.0, 300.0, 8192.0]))
    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", overhead)
    monkeypatch.setattr(jax_corpus, "_BUCKET_OVERHEAD", overhead)
    want = jax_corpus._length_buckets(frames, chans, e_mult, chunk)
    assert corpus._length_buckets(frames, chans, e_mult, chunk) == want
    assert corpus._length_buckets(frames, chans, e_mult, chunk, overhead) == want


def test_length_buckets_partition_properties():
    """The JAX package's property cases (tests/test_parallel.py)."""
    frames = [(64, 128, 256)[i % 3] for i in range(32)]
    chans = [(2, 1, 2, 1)[i % 4] for i in range(32)]
    assert corpus._length_buckets(frames, chans, 128, 64) is None
    assert corpus._length_buckets([64] * 256, [2] * 256, 128, 64) is None
    frames = [64] * 128 + [256] * 128
    segs = corpus._length_buckets(frames, [2] * 256, 128, 64)
    assert segs == jax_corpus._length_buckets(frames, [2] * 256, 128, 64)
    assert segs == [list(range(128)), list(range(128, 256))]
    assert corpus._length_buckets([5], [2], 1, 64) is None


def test_hopper_wave_never_buckets_the_smoke_corpus():
    """The 33-file smoke corpus (50 encode chains) under one wave: one
    call costs its longest chain, so no split can pay at any overhead.
    Past two waves of one-frame clips beside 64-frame files it splits."""
    frames = [(64, 128, 256)[i % 3] for i in range(32)] + [468]
    chans = [(2, 1, 2, 1)[i % 4] for i in range(32)] + [2]
    assert sum(chans) == 50
    for overhead in (0.0, 1.0, corpus._CUDA_BUCKET_OVERHEAD_WAVES * HOPPER_WAVE, 8192.0):
        assert corpus._length_buckets(frames, chans, HOPPER_WAVE, 64, overhead) is None
    overhead = corpus._CUDA_BUCKET_OVERHEAD_WAVES * HOPPER_WAVE
    n_clips = 2 * HOPPER_WAVE
    chans = [1] * n_clips + [2] * 32
    segs = corpus._length_buckets([1] * n_clips + [64] * 32, chans,
                                  HOPPER_WAVE, 64, overhead)
    # two buckets: one-frame clips, then the long files topped up to one
    # wave with clips (they ride along at no cost in this model)
    assert segs is not None and len(segs) == 2
    assert sorted(segs[0] + segs[1]) == list(range(n_clips + 32))
    assert set(range(n_clips, n_clips + 32)) <= set(segs[1])
    assert sum(chans[i] for i in segs[1]) <= HOPPER_WAVE


def _bucket_files():
    """One two-frame file and five one-frame stereo clips: with e_mult 1
    and a sub-call overhead of 1 lane-frame the clips split off."""
    files = [(make_noise(5120 + 37, 1, seed=300), QoaDesc(1, 44100, 5120 + 37))]
    for i in range(5):
        n = 80 + 53 * i
        files.append((make_noise(n, 2, seed=301 + i, amplitude=20000),
                      QoaDesc(2, (44100, 22050, 48000)[i % 3], n)))
    return files


@pytest.fixture
def shrunk(monkeypatch):
    if not native.available():
        pytest.skip("native engine unavailable")
    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    monkeypatch.setattr(jax_corpus, "_BUCKET_OVERHEAD", 1.0)
    files = _bucket_files()
    return files, [codec.encode_all(p, d, backend="native") for p, d in files]


@pytest.fixture
def counted(monkeypatch):
    """Count the three wrappers' calls (CPU calls launch nothing)."""
    calls = {"decode": 0, "masked": 0, "full": 0}
    for mod, name, key in ((cuda_decode, "decode_chains_words", "decode"),
                           (cuda_encode, "encode_frames", "masked"),
                           (cuda_encode, "encode_frames_full", "full")):
        fn = getattr(mod, name)

        def run(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(mod, name, run)
    return calls


def test_bucket_auto_byte_equal(shrunk, counted):
    files, streams = shrunk
    segs = corpus._length_buckets(_frames(files), [d.channels for _, d in files], 1, 64)
    assert segs == [[1, 2, 3, 4, 5], [0]], "the corpus must bucket"

    got, handle = corpus.batch_transcode(streams, "cpu", return_fused_handle=True)
    assert counted == {"decode": 2, "masked": 2, "full": 0}  # one sub-call per bucket
    assert got == corpus.batch_transcode(streams, "cpu", bucket=False)
    assert got == jax_corpus.batch_transcode(streams)
    assert got == [_native_pair(s) for s in streams]

    assert isinstance(handle, corpus._CompositeFusedHandle)
    assert len(handle.handles) == len(segs)
    for h in handle.handles:
        assert isinstance(h, corpus.TranscodeFusedHandle)
    counted.update(decode=0, masked=0)
    (buf,) = handle()  # every bucket again; the last bucket's bytes
    assert counted == {"decode": 2, "masked": 2, "full": 0}
    assert handle.handles[-1].assemble(*fetch_arrays([buf])) == [got[0]]


def test_bucket_auto_with_host_pair_stream(shrunk):
    from qoaudio_tpu.streaming import QoaEncoder

    files, streams = shrunk
    pcm = make_noise(2560 * 2, 1, seed=310)
    enc = QoaEncoder(QoaDesc(1, 44100, 2560 * 2))
    buf = io.BytesIO()
    enc.write_header(buf)
    for off in range(0, 2560 * 2, 2560):
        enc.encode_frame(pcm[off : off + 2560], buf)
    mixed = streams[:3] + [buf.getvalue()] + streams[3:]
    corpus.host_pair_files = 0
    got, handle = corpus.batch_transcode(mixed, "cpu", return_fused_handle=True)
    assert corpus.host_pair_files == 1
    assert isinstance(handle, corpus._CompositeFusedHandle)
    assert got == [_native_pair(s) for s in mixed]
    assert got == jax_corpus.batch_transcode(mixed)


def test_bucket_auto_under_cpu_mesh(shrunk, counted):
    files, streams = shrunk
    m = make_mesh(devices=("cpu",) * 2)
    segs = corpus._length_buckets(_frames(files), [d.channels for _, d in files], 2, 64)
    assert segs is not None and len(segs) == 2
    got, handle = corpus.batch_transcode(streams, mesh=m, return_fused_handle=True)
    assert handle is None  # the mesh path hands out no handle
    # the clips' bucket over both devices, the long file's on one
    assert counted == {"decode": 3, "masked": 3, "full": 0}
    assert got == corpus.batch_transcode(streams, mesh=m, bucket=False)
    assert got == [_native_pair(s) for s in streams]


def test_fused_handle_reruns_the_device_pipeline(counted):
    if not native.available():
        pytest.skip("native engine unavailable")
    files = [(make_noise(5120 + 90, 2, seed=320), QoaDesc(2, 44100, 5120 + 90)),
             (make_noise(700, 1, seed=321), QoaDesc(1, 22050, 700))]
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    outs, handle = corpus.batch_transcode(streams, "cpu", chunk_frames=1,
                                          return_fused_handle=True)
    assert isinstance(outs, list) and outs == [_native_pair(s) for s in streams]
    assert isinstance(handle, corpus.TranscodeFusedHandle)
    # the 700-sample clip is not full: both frames take the masked kernel
    assert counted == {"decode": 1, "masked": 2, "full": 0}
    counted.update(decode=0, masked=0)
    (buf,) = handle()
    assert counted == {"decode": 1, "masked": 2, "full": 0}
    assert str(buf.dtype) == "torch.uint8" and buf.device.type == "cpu"
    assert handle.assemble(*fetch_arrays([buf])) == outs
    assert corpus.batch_transcode(streams, "cpu", chunk_frames=1) == outs


def test_fused_handle_none_and_eligible_subset():
    if not native.available():
        pytest.skip("native engine unavailable")
    assert corpus.batch_transcode([], "cpu", return_fused_handle=True) == ([], None)
    good = codec.encode_all(make_noise(400, 2, seed=330), QoaDesc(2, 44100, 400),
                            backend="native")
    m = make_mesh(devices=("cpu",) * 2)
    outs, handle = corpus.batch_transcode([good], mesh=m, return_fused_handle=True)
    assert handle is None and outs == [_native_pair(good)]

    streaming_mode = fmt.pack_file_header(0) + good[8:]  # parser rejects
    outs, handle = corpus.batch_transcode([streaming_mode, good, streaming_mode], "cpu",
                                          return_fused_handle=True)
    assert outs == [_native_pair(good)] * 3
    assert isinstance(handle, corpus.TranscodeFusedHandle)
    assert handle.assemble(*fetch_arrays(handle())) == [outs[1]]  # the eligible file
    outs, handle = corpus.batch_transcode([streaming_mode], "cpu", return_fused_handle=True)
    assert handle is None and outs == [_native_pair(good)]
