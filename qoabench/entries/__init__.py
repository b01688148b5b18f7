"""One module per entry point a mix can drive, found by the mix's
``entry``.  Each gives:

* ``prepare(pool, pcm)``: the run's inputs, made once from the files'
  PCM (``(channels, samples)`` int16 tensors on the device);
* ``call(inputs, files, place)``: the call on the inputs of ``files``, as
  they are (immutable: ``bytes``, or read-only arrays), ``place`` being
  ``{"device": ...}`` or ``{"mesh": ...}``; returns one QOA stream per file;
* ``chains(pool, inputs, files, device)``: the samples the program had to
  encode, as the reference works them out, laid out as
  ``frames.chains_of_pcm``; None when the inputs do not parse.
"""
