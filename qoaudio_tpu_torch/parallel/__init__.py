"""Batched corpus paths on one device or over a mesh of devices.

* :func:`batch_encode` / :func:`batch_decode` — many files in one batched
  chain axis, on ``device`` or sharded over ``mesh``;
* :func:`batch_transcode` — decode -> on-device relayout -> encode with
  the PCM device-resident end to end, with length bucketing and an
  optional handle onto the staged device pipeline;
* :func:`transcode_corpus` — file-level decode / re-encode / verify;
* :func:`make_mesh` — the devices a call shards over (see ``mesh``).
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
