"""The benchmark's frozen plain reference of the QOA codec.

Plain NumPy (stream parse and assembly, ``stream.py``) and plain PyTorch
(the decoder and the 16-candidate encoder, ``codec.py``), written from the
QOA format and the reference encoder's search, with the format's tables
derived from the specification's formulas (``tables.py``).

It imports nothing of the program under test, nothing of the JAX package
and nothing of JAX: the benchmark judges the program's output with it and
makes the transcode inputs with it, so a change to the program can never
move the yardstick.
"""
