"""Host work the spans miss: the part of each call that no ``qoa.*`` span
of the program covers, mean over the window's calls, in ms
(``_spans.unspanned_ms``)."""

from qoabench.metrics._spans import unspanned_ms
from qoabench.trace import Trace


def read(t: Trace):
    return unspanned_ms(t)
