"""qoaudio_tpu_torch — the QOA codec's device tier in PyTorch and CUDA.

The port of ``qoaudio_tpu``'s batched corpus path (decode -> relayout ->
encode) to PyTorch, with the Pallas kernels rewritten by hand in CUDA C++
for Hopper (``csrc/``).  Plain tensor functions stand where the JAX
package has jitted ones; every public entry point takes an explicit
``device``.  A CPU device runs the plain PyTorch versions of the kernels,
a CUDA device runs the kernels themselves, and nothing falls back from
one to the other.

The host tier (format, bitstream, codec, types, native engine) imports no
jax, so the port re-exports it from ``qoaudio_tpu`` instead of copying it.
This package never imports jax.
"""

from qoaudio_tpu import bitstream, codec, native, types  # noqa: F401
from qoaudio_tpu import format  # noqa: F401,A004

__all__ = ["bitstream", "codec", "format", "native", "types"]
