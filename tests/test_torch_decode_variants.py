"""The store-shape probe's plain version against the Pallas probe.

``experiments/pallas_decode_variants.py::run_variant`` runs under the TPU
interpreter on the CPU (as tests/test_pallas_interpret.py runs the decode
kernel), for each of its five store modes at subs=8, W=8, N=1,024 with
one window block (``wblk=W``), against the port's plain
``decode_chains_variant`` on the same chains.  Exact on every position
each mode defines: all of ``v0``, ``stack`` and ``storeonly``, every
element of ``pack32``, and out[0, 0, :] of ``nostore`` (the interpreter
leaves the rest of that output undefined).
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from qoaudio_tpu_torch.ops import cuda_decode
from qoaudio_tpu_torch.ops import decode as plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBS, W, LANES = 8, 8, 128
N = SUBS * LANES


@pytest.fixture(scope="module")
def probe():
    """The experiment module, loaded from its file without writing
    bytecode next to it."""
    path = os.path.join(ROOT, "experiments", "pallas_decode_variants.py")
    spec = importlib.util.spec_from_file_location("pallas_decode_variants", path)
    mod = importlib.util.module_from_spec(spec)
    saved = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.dont_write_bytecode = saved
    return mod


@pytest.fixture(scope="module")
def chains():
    """Wrap-regime chains: random words with every scalefactor, random
    LMS state."""
    rng = np.random.default_rng(2027)
    logical = rng.integers(0, 1 << 63, size=(W, N), dtype=np.int64).astype(
        np.uint64
    ) | (rng.integers(0, 16, size=(W, N), dtype=np.uint64) << np.uint64(60))
    state = rng.integers(-32768, 32768, size=(8, N)).astype(np.int32)
    return logical, state


def _run_variant(probe, logical, state, mode):
    from jax.experimental.pallas import tpu as pltpu

    hi = (logical >> np.uint64(32)).astype(np.uint32)
    lo = (logical & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with pltpu.force_tpu_interpret_mode():
        out = np.asarray(probe.run_variant(state, hi, lo, subs=SUBS, wblk=W, mode=mode))
    return out.reshape(out.shape[0], out.shape[1], N)  # (W, 20 or 10, N)


@pytest.mark.parametrize("mode", plain.VARIANT_MODES)
def test_variant_plain_matches_pallas_interpreted(probe, chains, mode):
    logical, state = chains
    want = _run_variant(probe, logical, state, mode)
    words_be = torch.from_numpy(logical.byteswap().view(np.int64))
    got = cuda_decode.decode_chains_variant(torch.from_numpy(state), words_be, mode)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    if mode == "nostore":
        assert np.array_equal(got[0, 0].numpy(), want[0, 0])
    else:
        assert np.array_equal(got.numpy(), want)
    if mode == "pack32":  # unpacks to the decode, as the probe's unpack32
        assert torch.equal(plain.unpack_pack32(got),
                           plain.decode_chains_words(torch.from_numpy(state), words_be))


def test_variant_modes_agree_with_the_decode(chains):
    """v0 and stack are the decode, nostore's defined output is the last
    decoded sample, storeonly is the codes; an unknown mode raises."""
    logical, state = chains
    st = torch.from_numpy(state)
    wb = torch.from_numpy(logical.byteswap().view(np.int64))
    ref = plain.decode_chains_words(st, wb)
    assert torch.equal(plain.decode_chains_variant(st, wb, "v0"), ref)
    assert torch.equal(plain.decode_chains_variant(st, wb, "stack"), ref)
    assert torch.equal(plain.decode_chains_variant(st, wb, "nostore")[0, 0], ref[-1, -1])
    codes = plain.decode_chains_variant(st, wb, "storeonly")
    for k in range(20):
        want = ((logical >> np.uint64(57 - 3 * k)) & np.uint64(7)).astype(np.int16)
        assert np.array_equal(codes[:, k].numpy(), want)
    with pytest.raises(ValueError, match="store mode"):
        cuda_decode.decode_chains_variant(st, wb, "v1")
    with pytest.raises(ValueError, match="threads"):
        cuda_decode.decode_chains_variant(st, wb, "v0", threads=96)
