"""Batched corpus paths on one device (see ``corpus``)."""

from .corpus import (  # noqa: F401
    CorpusFile,
    TranscodeReport,
    batch_decode,
    batch_encode,
    batch_transcode,
    transcode_corpus,
)

__all__ = [
    "CorpusFile",
    "TranscodeReport",
    "batch_decode",
    "batch_encode",
    "batch_transcode",
    "transcode_corpus",
]
