"""Batched corpus paths on one device or over a mesh of devices.

Over a mesh every path gives each device whole files, so a file's chains
always lie on one device.

* :func:`batch_encode` / :func:`batch_decode` — many files in one batched
  chain axis, on ``device`` or in one group of whole files per device of
  ``mesh``;
* :func:`batch_transcode` — decode -> on-device relayout -> encode with
  the PCM device-resident end to end, with length bucketing and an
  optional handle onto the staged device pipeline;
* :func:`transcode_corpus` — file-level decode / re-encode / verify;
* :func:`make_mesh` — the devices a call runs on (see ``mesh``).
"""

from .corpus import (  # noqa: F401
    CorpusFile,
    TranscodeFusedHandle,
    TranscodeReport,
    batch_decode,
    batch_encode,
    batch_transcode,
    transcode_corpus,
)
from .mesh import Mesh, make_mesh  # noqa: F401

__all__ = [
    "CorpusFile",
    "Mesh",
    "TranscodeFusedHandle",
    "TranscodeReport",
    "batch_decode",
    "batch_encode",
    "batch_transcode",
    "make_mesh",
    "transcode_corpus",
]
