"""Host memory that a corpus call reuses from call to call.

The decode staging (``corpus._stage_decode``) fills the decode chains'
words and LMS in place (pinned on request, where the caching host
allocator hands the blocks out again, and ``put_arrays`` uploads such a
tensor as it is), so every byte a file does not cover has to be zeroed
explicitly; the transcode stages the streams themselves in a pinned
buffer they cover whole, and its gather on the card writes every word,
zero past each chain's windows (tests/test_torch_cuda.py); the native
engine's allocator tuning keeps freed heap memory in the process instead
of handing it back to the kernel.  This file imports nothing of jax: the ``cuda`` tests run
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_host_memory.py
"""

import os
import platform
import subprocess
import sys

import numpy as np
import pytest
import torch

from qoaudio_tpu_torch import bitstream as bs
from qoaudio_tpu_torch import codec, native
from qoaudio_tpu_torch.parallel import corpus
from qoaudio_tpu_torch.types import QoaDesc
from qoaudio_tpu_torch.utils.transfer import fetch_arrays, put_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# samples a channel: one short frame (12 windows), a 256-window tail, three
# frames and a 5-window tail, one full frame
LENGTHS = ((230, 1), (2 * 5120 + 5110, 1), (3 * 5120 + 97, 2), (5120, 1))


@pytest.fixture(scope="module")
def streams():
    if not native.available():
        pytest.skip("native engine unavailable")
    out = []
    for k, (n, c) in enumerate(LENGTHS):
        pcm = np.random.default_rng(k).integers(-30000, 30000, n * c).astype(np.int16)
        out.append(codec.encode_all(pcm, QoaDesc(c, 44100, n), backend="native"))
    return out


@pytest.fixture(scope="module")
def parsed(streams):
    out = [bs.parse_file_arrays(d) for d in streams]
    assert all(p is not None for p in out)
    return out


def _zeros_staging(parsed):
    """The staging as zero-filled arrays, then each file's block."""
    W = max(p.max_windows for p in parsed)
    N = sum(p.n_frames * p.channels for p in parsed)
    words = np.zeros((W, N), np.uint64)
    state = np.zeros((8, N), np.int32)
    off = 0
    for p in parsed:
        k = p.n_frames * p.channels
        words[: p.max_windows, off : off + k] = p.words_be
        state[:, off : off + k] = p.state
        off += k
    return words.view(np.int64), state


# which of LENGTHS' files a staging holds: all four, and two in the other
# order (the stereo file of 256-window frames, then the 12-window clip)
CORPORA = {"all": [0, 1, 2, 3], "two": [2, 0]}


@pytest.mark.parametrize("files", CORPORA.values(), ids=list(CORPORA))
def test_staging_zeroes_what_no_file_covers(parsed, files, monkeypatch):
    """Staged into memory full of ones, every byte is the zero-filled
    staging's: the windows a file has fewer of than the longest."""
    parsed = [parsed[i] for i in files]
    empty = torch.empty

    def dirty(*args, **kwargs):
        return empty(*args, **kwargs).fill_(-1)

    monkeypatch.setattr(torch, "empty", dirty)
    words, state, offs = corpus._stage_decode(parsed)
    want_words, want_state = _zeros_staging(parsed)
    assert words.dtype == np.int64 and state.dtype == np.int32
    assert np.array_equal(words, want_words)
    assert np.array_equal(state, want_state)
    assert offs == list(np.cumsum([0] + [p.n_frames * p.channels for p in parsed])[:-1])


def test_put_arrays_takes_host_tensors_as_they_are():
    t = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    a = np.arange(5, dtype=np.int32)
    got = put_arrays([t, a], "cpu")
    assert got[0] is t
    assert np.array_equal(got[1].numpy(), a)


@pytest.mark.skipif(platform.libc_ver()[0] != "glibc", reason="glibc's mallopt")
def test_freed_heap_is_kept_for_the_next_call():
    """Once the engine has tuned the allocator, 256 MB of 1-MB arrays
    freed and made again fault in (almost) no new pages; without the
    tuning glibc hands the freed top of the heap back and the second
    round faults it all in again."""
    code = (
        "import resource, numpy as np\n"
        "from qoaudio_tpu_torch import native\n"
        "assert native.available()\n"
        "def faults():\n"
        "    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt\n"
        "keep = [np.ones(1 << 17, np.uint64) for _ in range(256)]\n"
        "del keep\n"
        "f0 = faults()\n"
        "keep = [np.ones(1 << 17, np.uint64) for _ in range(256)]\n"
        "print(faults() - f0)\n"
    )

    def second_round(env):
        r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        return int(r.stdout.split()[-1])

    tuned = second_round(dict(os.environ))
    untuned = second_round(dict(os.environ, QOA_NO_MALLOPT="1"))
    pages = (256 << 20) // os.sysconf("SC_PAGE_SIZE")
    assert tuned < pages // 20 < untuned



@pytest.mark.skipif(platform.libc_ver()[0] != "glibc", reason="glibc's mallopt")
@pytest.mark.parametrize("opt_out", [False, True], ids=["tuned", "opted_out"])
def test_batch_encode_tunes_the_allocator(opt_out):
    """``batch_encode`` parses no stream, so in a process that only
    encodes the native engine never loads: the call tunes the allocator
    itself, and ``QOA_NO_MALLOPT=1`` still opts out."""
    code = (
        "import numpy as np\n"
        "from qoaudio_tpu_torch import QoaDesc, native\n"
        "from qoaudio_tpu_torch.parallel import batch_encode\n"
        "assert not native._allocator_tuned\n"
        "pcm = (np.arange(230) * 37 % 2000 - 1000).astype(np.int16)\n"
        "(out,) = batch_encode([(pcm, QoaDesc(1, 44100, 230))], 'cpu')\n"
        "print(len(out), native._allocator_tuned)\n"
    )
    env = dict(os.environ)
    env.pop("QOA_NO_MALLOPT", None)
    if opt_out:
        env["QOA_NO_MALLOPT"] = "1"
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_bytes, tuned = r.stdout.split()[-2:]
    assert int(n_bytes) > 0
    assert tuned == str(not opt_out)

@pytest.mark.cuda
def test_pinned_staging_and_fetch_on_card(streams, parsed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    words, state, _ = corpus._stage_decode(parsed, pin=True)
    assert isinstance(words, torch.Tensor) and words.is_pinned() and state.is_pinned()
    want_words, want_state = _zeros_staging(parsed)
    assert np.array_equal(words.numpy(), want_words)
    assert np.array_equal(state.numpy(), want_state)
    for got, want in zip(fetch_arrays(put_arrays([words, state], "cuda")),
                         [want_words, want_state]):
        assert np.array_equal(got, want)
    # staged in pinned blocks, twice over the same blocks: the native
    # decode -> encode pair's bytes
    pair = []
    for d in streams:
        out = codec.decode_all(d, backend="native")
        pair.append(codec.encode_all(out.samples, QoaDesc(
            out.num_channels, out.sample_rate, out.samples_per_channel), backend="native"))
    for _ in range(2):
        assert corpus.batch_transcode(streams, "cuda") == pair
