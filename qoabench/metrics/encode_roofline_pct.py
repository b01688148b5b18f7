"""The encode kernels' share of their bound: the least time the window's
encode work could take on the card (``qoabench/roofline.py``, from the
calls' shapes) over the device time of the ``qoa_encode`` kernels, in %."""

from qoabench import roofline
from qoabench.trace import Trace


def read(t: Trace):
    spent = sum(o.end - o.start for o in t.ops if o.kind == "encode") / 1e6
    if not spent:
        return None
    bound = sum(roofline.encode_bound_s(w.samples, w.frame_chains, t.sm_clock_mhz)
                for w in t.work)
    return 100.0 * bound / spent
