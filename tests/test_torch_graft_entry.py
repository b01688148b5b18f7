"""The port's entry module (qoaudio_tpu_torch.graft_entry) on the CPU.

``entry("cpu")`` against the JAX tier's ``__graft_entry__.entry()`` on the
same seeded arguments, exactly; the six-step dry run on a 4-shard CPU mesh;
one corrupted output per step, which that step must catch; and step 6's
mixed corpus, which must cut into more than one bucket on the CPU mesh once
a sub-call is priced low enough for a corpus this small.
"""

import re

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from qoaudio_tpu_torch import graft_entry
from qoaudio_tpu_torch.parallel import corpus, make_mesh
from qoaudio_tpu_torch.parallel import mesh as pmesh

CPU4 = ("cpu",) * 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions work on tiny tensors: one intra-op thread is
    faster than many, and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_jax_entry():
    fn, args = graft_entry.entry("cpu")
    jfn, jargs = jax_entry.entry()
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu" and np.array_equal(a.numpy(), np.asarray(j))
    words, state = fn(*args)
    hi, lo, jstate = jfn(*jargs)
    jwords = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(
        np.uint64)
    assert words.dtype == torch.int64 and words.shape == (1, 256, 16)
    assert np.array_equal(words.numpy().view(np.uint64), jwords)
    assert np.array_equal(state.numpy(), np.asarray(jstate))


@pytest.fixture
def cheap_sub_call(monkeypatch):
    """Price one more sub-call at 1 lane-frame, so that step 6's small
    corpus cuts under the CPU cost model and the bucketed path runs."""
    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)


def test_dryrun_passes_on_a_cpu_mesh(capsys, cheap_sub_call):
    graft_entry.dryrun_multichip(4, devices=CPU4)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: 4-device mesh (cpu), 8 chains sharded" in out
    for line in ("sharded encode:", "sharded decode bit-exact", "batch_encode sharded",
                 "batch_decode sharded", "batch_transcode sharded", "batch_transcode bucketed"):
        assert line in out
    assert "the cost model does not cut" not in out
    assert int(re.search(r"the handle's re-run \((\d+) bucket", out).group(1)) > 1


def test_dryrun_passes_where_the_cost_model_does_not_cut(capsys):
    """At the CPU model's own price of a sub-call step 6's corpus stays
    one call, as it does on a card, and the same bytes are required."""
    graft_entry.dryrun_multichip(2, devices=("cpu",) * 2)
    out = capsys.readouterr().out
    assert out.count("the cost model does not cut") == 2
    assert "the handle's re-run (1 bucket(s))" in out
    assert "dryrun_multichip OK: 2-device mesh (cpu), 4 chains sharded" in out


def _flip_bytes(data: bytes) -> bytes:
    return data[:-1] + bytes([data[-1] ^ 1])


def _corrupt(step, monkeypatch):
    """Make the output that dry-run step ``step`` checks wrong, and no
    other step's."""
    if step == 1:
        fn = pmesh.encode_frames_sharded

        def bad(*a):
            states, snaps, words = fn(*a)
            return states, snaps, [words[0] ^ 1] + list(words[1:])
        monkeypatch.setattr(pmesh, "encode_frames_sharded", bad)
    elif step == 2:
        fn = pmesh.decode_chains_sharded

        def bad(*a):
            out = fn(*a)
            return [out[0] + 1] + list(out[1:])
        monkeypatch.setattr(pmesh, "decode_chains_sharded", bad)
    elif step == 3:
        fn = corpus.batch_encode

        def bad(*a, **kw):
            out = fn(*a, **kw)
            return [_flip_bytes(out[0])] + out[1:]
        monkeypatch.setattr(corpus, "batch_encode", bad)
    elif step == 4:
        fn = corpus.batch_decode

        def bad(*a, **kw):
            out = fn(*a, **kw)
            out[1].samples[0] ^= 1
            return out
        monkeypatch.setattr(corpus, "batch_decode", bad)
    else:
        fn = corpus.batch_transcode

        def bad(streams, *a, **kw):
            out = fn(streams, *a, **kw)
            # step 5 transcodes the three-file corpus; step 6's "auto" call
            # under the mesh is the one with a bucket argument and no handle
            hit = len(streams) == 3 if step == 5 else (
                kw.get("bucket") == "auto" and "mesh" in kw)
            return [_flip_bytes(out[0])] + out[1:] if hit else out
        monkeypatch.setattr(corpus, "batch_transcode", bad)


@pytest.mark.parametrize("step", [1, 2, 3, 4, 5, 6])
def test_dryrun_step_catches_a_corrupted_output(step, monkeypatch, cheap_sub_call):
    _corrupt(step, monkeypatch)
    with pytest.raises(graft_entry.DryRunFailure, match=f"step {step}"):
        graft_entry.dryrun_multichip(4, devices=CPU4)


def test_dryrun_catches_an_output_on_the_wrong_device(monkeypatch):
    fn = pmesh.decode_chains_sharded
    monkeypatch.setattr(pmesh, "decode_chains_sharded",
                        lambda *a: [t.to("meta") for t in fn(*a)])
    with pytest.raises(graft_entry.DryRunFailure, match="step 2.*lives on meta"):
        graft_entry.dryrun_multichip(2, devices=("cpu",) * 2)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mixed_corpus_cuts_on_a_cpu_mesh(n, monkeypatch):
    """Step 6's corpus under the CPU cost model (``e_mult`` = the mesh
    size): one call at the model's 8,192 lane-frames a sub-call, more than
    one bucket at 1 lane-frame, on the mesh and on its first device
    alone."""
    from qoaudio_tpu_torch import bitstream, codec

    files = graft_entry.mixed_corpus(n, np.random.default_rng(0))
    assert len(files) == 4 * n + 1
    parsed = [bitstream.parse_file_arrays(codec.encode_all(p, d, backend="native"))
              for p, d in files]
    mesh = make_mesh(devices=("cpu",) * n)
    assert graft_entry._buckets(mesh, parsed) is None
    monkeypatch.setattr(corpus, "_BUCKET_OVERHEAD", 1.0)
    for m in (mesh, pmesh.Mesh(mesh.devices[:1])):
        segs = graft_entry._buckets(m, parsed)
        assert segs is not None and len(segs) > 1
        assert sorted(i for g in segs for i in g) == list(range(len(files)))


def test_dryrun_without_a_card_or_devices_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError):
        graft_entry.entry()  # "cuda" by default: no tensor lands on the CPU instead
