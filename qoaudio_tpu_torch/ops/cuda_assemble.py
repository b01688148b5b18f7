"""Wrapper of the CUDA stream assembly kernel (``csrc/qoa_assemble.cu``).

For CPU tensors it runs the plain version (``ops/assemble.py``); for CUDA
tensors it launches the kernel on the current stream or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from . import assemble as _plain

launches = 0


def assemble_streams(snaps: torch.Tensor, words: torch.Tensor, table: torch.Tensor,
                     n_bytes: int, n_frames: int) -> torch.Tensor:
    """Every file of ``table`` as its QOA stream, back to back (contract of
    ``ops.assemble.assemble_streams``).

    snaps int32 (F, 8, N); words int64 (F, W, N) logical slice words;
    table int64 (TABLE_ROWS, n_files) with ``n_bytes`` and ``n_frames``,
    all three from ``ops.assemble.file_table``.  Returns uint8 (n_bytes,).
    """
    global launches
    device = _build.kernel_device(snaps, words, table)
    if device is None:
        return _plain.assemble_streams(snaps, words, table, n_bytes, n_frames)
    lib = _build.library()
    F, n_win, n_ch = words.shape
    _build.require(words, "words", torch.int64, (F, n_win, n_ch))
    _build.require(snaps, "snaps", torch.int32, (F, 8, n_ch))
    _build.require(table, "table", torch.int64, (_plain.TABLE_ROWS, table.shape[1]))
    out = torch.empty(n_bytes, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.qoa_assemble_cuda(
            snaps.data_ptr(), words.data_ptr(), n_win, n_ch, table.data_ptr(),
            table.shape[1], n_frames, out.data_ptr(), stream,
        )
    _build.check(rc, "qoa_assemble_cuda")
    launches += 1
    return out
