"""The frozen reference against the fixture's golden re-encode and against
the port's plain versions (CPU, small sizes)."""

import hashlib
import os

import numpy as np
import pytest
import torch

from qoabench import frames, judge
from qoabench.generate import File
from qoabench.reference import codec as rc
from qoabench.reference import stream

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "julien_baker_sprained_ankle.qoa")
# SHA-256 of encode_all(decode_all(fixture)), as tests/test_native.py pins it
FIXTURE_REENCODE_SHA256 = "e9f87726aef5d602e248dc839ac7de5c570ad869419984f00274cde76f28c19e"


def _noise(n, c, seed, amp=12000):
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None]
    x = amp * np.sin(t * (0.01 + 0.02 * np.arange(c))) + rng.normal(0, amp / 4, (n, c))
    return np.clip(x, -32768, 32767).astype(np.int16)


def test_fixture_reencode_matches_golden():
    data = open(FIXTURE, "rb").read()
    p = stream.parse(data)
    assert p is not None and stream.headers_valid(p)
    f = File(p.channels, p.rate, p.samples)
    x = frames.decode_streams([f], [data], "cpu")
    assert x is not None
    # the native engine's stream only tells the reference which frames may
    # run side by side; the stream below is the reference's own
    from qoaudio_tpu_torch import QoaDesc, codec
    pcm = codec.decode_all(data, backend="native")
    hint = codec.encode_all(pcm.samples, QoaDesc(f.channels, f.rate, f.samples), backend="native")
    counts = judge.compare([f], x, [hint])
    assert counts["files_wrong"] == 0 and counts["frames_wrong"] == 0
    b = frames.batch([f])
    hinted = stream.parse(hint, f.channels, f.samples)
    start, words, end, _ = judge.reference_chain(b, x, judge._guesses(b, [hinted], "cpu"))
    idx = b.frame_chains(0)
    states = np.empty((f.frames, f.channels, 8), np.int32)
    states[0] = rc.initial_state(1, "cpu").numpy()
    states[1:] = end.numpy()[idx[:-1]]
    ours = stream.assemble(f.channels, f.rate, f.samples, states,
                           frames.file_words(b, 0, words.numpy()))
    assert hashlib.sha256(ours).hexdigest() == FIXTURE_REENCODE_SHA256


@pytest.mark.parametrize("nsamp", [[5120, 5120, 800, 799, 41, 20, 1], [5120] * 3])
def test_encoder_matches_port_plain_encoder(nsamp):
    from qoaudio_tpu_torch.ops import encode as plain
    n = len(nsamp)
    x = torch.from_numpy(_noise(5120 * n, 1, 3).reshape(n, 256, 20).transpose(1, 2, 0).copy())
    nsamp = np.array(nsamp)
    for j in range(n):
        flat = x[:, :, j].reshape(-1)
        flat[nsamp[j]:] = 0
        x[:, :, j] = flat.view(256, 20)
    start = rc.initial_state(n, "cpu")
    start[1::2, :4] = torch.tensor([300, -2000, 7000, 12000], dtype=torch.int32)
    words, end = rc.encode_chains(start, x, nsamp)
    lens = torch.from_numpy(np.clip(nsamp[None] - 20 * np.arange(256)[:, None], 0, 20).astype(np.int32))
    state, _, pw = plain.encode_frames(start.t().contiguous(), x[None], lens[None])
    assert torch.equal(end, state.t())
    for j in range(n):
        nw = -(-nsamp[j] // 20)
        assert torch.equal(words[j, :nw], pw[0, :nw, j])


def test_decoder_matches_port_plain_decoder():
    from qoaudio_tpu_torch.ops import decode as plain
    n = 4
    x = torch.from_numpy(_noise(5120 * n, 1, 4).reshape(n, 256, 20).transpose(1, 2, 0).copy())
    start = rc.initial_state(n, "cpu")
    words, _ = rc.encode_chains(start, x, np.full(n, 5120))
    ours = rc.decode_chains(start, words)
    be = torch.from_numpy(words.numpy().T.astype(">u8").view(np.int64).copy())
    theirs = plain.decode_chains_words(start.t().contiguous(), be)
    assert torch.equal(ours, theirs.permute(2, 0, 1).reshape(n, -1))


@pytest.mark.parametrize("samples,channels", [(1, 1), (5120, 2), (5121, 1), (12000, 3)])
def test_stream_round_trip_matches_port_assembly(samples, channels):
    from qoaudio_tpu_torch import bitstream as bs
    g = stream.geometry(samples, channels)
    rng = np.random.default_rng(samples)
    states = rng.integers(-40000, 40000, (g.frames, channels, 8)).astype(np.int32)
    words = rng.integers(0, 2**63, (g.frames, 256, channels)).astype(np.uint64)
    for f in range(g.frames):
        words[f, g.windows[f]:] = 0
    data = stream.assemble(channels, 44100, samples, states, words)
    assert data == bs.assemble_stream_bytes(channels, 44100, samples,
                                            states.transpose(0, 2, 1), words)
    p = stream.parse(data)
    assert stream.headers_valid(p) and (p.channels, p.rate, p.samples) == (channels, 44100, samples)
    assert np.array_equal(p.words, words)
    want = np.concatenate([stream.unpack_lms(stream.pack_lms(states[..., :4])),
                           stream.unpack_lms(stream.pack_lms(states[..., 4:]))], -1)
    assert np.array_equal(p.states, want)
    assert stream.parse(data[:-8]) is None
