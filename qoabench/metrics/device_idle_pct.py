"""Device idle: the share of the window in which no operation ran on a
card, averaged over the cell's cards, in %."""

from qoabench.trace import Trace, busy_us


def read(t: Trace):
    lo, hi = t.window
    idle = [1.0 - busy_us(t, d) / (hi - lo) for d in t.devices]
    return 100.0 * sum(idle) / len(idle)
