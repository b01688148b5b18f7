"""The encoders' time per dependent step: the busiest card's
``qoa_encode`` device time over the window, over the dependent steps of
each call's longest chain (20 x its windows), in ns.  On one card and one
sub-call this is the kernels' time per launch over the steps of a chain
in that launch, summed over the launches: the latency view of a serial
chain."""

from qoabench.trace import Trace


def read(t: Trace):
    per_card = {}
    for o in t.ops:
        if o.kind == "encode":
            per_card[o.device] = per_card.get(o.device, 0.0) + (o.end - o.start)
    if not per_card:
        return None
    return 1e3 * max(per_card.values()) / sum(w.longest_steps for w in t.work)
