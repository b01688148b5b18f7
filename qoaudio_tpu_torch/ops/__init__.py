"""Codec ops on tensors: plain PyTorch versions and their CUDA kernels.

* ``layout``      — word and state conversions between the JAX package's
  layout and the port's;
* ``decode``      — plain LMS decoder (CPU and CUDA tensors alike);
* ``encode``      — plain 16-candidate encoder;
* ``assemble``    — plain stream assembly (QOA bytes from the encoder's
  outputs) and its per-file table;
* ``gather``      — plain chain gather (the decoder's words and LMS state
  from the QOA streams themselves) and its per-file table;
* ``cuda_decode`` / ``cuda_encode`` / ``cuda_assemble`` / ``cuda_gather`` —
  wrappers that launch the hand-written kernels for CUDA tensors and take
  the plain versions for CPU tensors;
* ``_build``      — builds ``csrc/*.cu`` with nvcc at first use.
"""
