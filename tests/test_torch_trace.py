"""The port's host stage spans (``utils/timing.span``) on its corpus paths.

Under a CPU ``torch.profiler``, ``batch_transcode`` and ``batch_encode``
mark each host stage once per sub-call as a ``qoa.<stage>`` span, with
``qoa.upload`` inside the stage that queues it, ``qoa.bucket`` inside
``qoa.stage`` and ``qoa.wait`` inside ``qoa.fetch``; the count of spans
does not grow with the files.  With no profiler running ``span`` hands
out one shared no-op context and never enters ``record_function``.  The
bytes do not depend on the profiler.  The corpora are short stereo clips
cut from the repo's fixture track.
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from qoaudio_tpu_torch import QoaDesc, codec
from qoaudio_tpu_torch.parallel import corpus
from qoaudio_tpu_torch.utils import timing, transfer

from conftest import FIXTURE_PATH

CLIP = 160  # samples a channel: one frame of 8 windows, cheap on the plain encoder
STAGES = ("parse", "stage", "upload", "pipeline", "fetch", "wait", "assemble")
# the transcode's own: the host-pair split and the length-bucket choice
TRANSCODE_STAGES = STAGES + ("host_pair", "bucket")
# the span each nested span sits in; the rest sit in no span of the port
PARENTS = {"qoa.upload": {"qoa.stage", "qoa.pipeline"}, "qoa.wait": {"qoa.fetch"},
           "qoa.bucket": {"qoa.stage"}}


@pytest.fixture(scope="module")
def track():
    with open(FIXTURE_PATH, "rb") as f:
        out = codec.decode_all(f.read(), backend="native")
    return out.samples.reshape(-1, out.num_channels)


def _clips(track, n):
    """``n`` stereo clips of the track as (pcm, desc), and their streams."""
    files = [(np.ascontiguousarray(track[50_000 + 7_000 * i:][:CLIP]).reshape(-1),
              QoaDesc(2, 44_100, CLIP)) for i in range(n)]
    return files, [codec.encode_all(p, d, backend="native") for p, d in files]


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the ``qoa.*`` spans as
    (name, start, end, name of the innermost ``qoa.*`` span around it))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.start_ns(), -e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("qoa."))
    found, stack = [], []  # stack: the spans open at each start (one thread)
    for s, neg_end, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        found.append((name, s, -neg_end, stack[-1][0] if stack else None))
        stack.append((name, -neg_end))
    return out, found


def _check_tree(found, names):
    assert {n for n, *_ in found} == {f"qoa.{s}" for s in names}
    for name, _, _, parent in found:
        if name in PARENTS:
            assert parent in PARENTS[name], (name, parent)
        else:
            assert parent is None, (name, parent)


def test_transcode_emits_every_stage_span(track):
    _, streams = _clips(track, 4)
    out, found = _traced(lambda: corpus.batch_transcode(streams, "cpu"))
    assert out == streams  # the reference encoder's bytes, decoded and re-encoded
    _check_tree(found, TRANSCODE_STAGES)
    assert any(p == "qoa.stage" for n, *_, p in found if n == "qoa.upload")


def test_encode_emits_every_stage_span(track):
    files, streams = _clips(track, 4)
    out, found = _traced(lambda: corpus.batch_encode(files, "cpu"))
    assert out == streams
    _check_tree(found, [s for s in STAGES if s != "parse"])
    # the PCM, the start state and the chains' vectors are all queued while staging
    assert {p for n, *_, p in found if n == "qoa.upload"} == {"qoa.stage"}


@pytest.mark.parametrize("entry", ["transcode", "encode"])
def test_span_count_does_not_grow_with_files(track, entry):
    def counts(n):
        files, streams = _clips(track, n)
        call = ((lambda: corpus.batch_transcode(streams, "cpu")) if entry == "transcode"
                else (lambda: corpus.batch_encode(files, "cpu")))
        out, found = _traced(call)
        assert out == streams
        return collections.Counter(n for n, *_ in found)

    assert counts(40) == counts(4)


def test_span_without_profiler_is_the_shared_null_context(track, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function entered for {name} with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert timing.span("qoa.parse") is timing.span("qoa.fetch") is timing._NO_SPAN
    files, streams = _clips(track, 4)
    assert corpus.batch_transcode(streams, "cpu") == streams
    assert corpus.batch_encode(files, "cpu") == streams
    (t,) = transfer.put_arrays([np.arange(3)], "cpu")
    assert transfer.fetch_arrays([t])[0].tolist() == [0, 1, 2]


def test_bytes_do_not_depend_on_the_profiler(track):
    # stereo and mono clips of three lengths, one with a ragged last window
    files = [(np.ascontiguousarray(track[90_000 + 11_000 * i:][:n, :c]).reshape(-1),
              QoaDesc(c, 44_100, n)) for i, (n, c) in enumerate(((300, 2), (233, 1), (160, 2)))]
    streams = [codec.encode_all(p, d, backend="native") for p, d in files]
    for call in (lambda: corpus.batch_transcode(streams, "cpu"),
                 lambda: corpus.batch_encode(files, "cpu")):
        on, found = _traced(call)
        assert found
        assert on == call() == streams
