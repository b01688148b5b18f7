"""Wrapper of the CUDA chain gather kernel (``csrc/qoa_gather.cu``).

For CPU tensors it runs the plain version (``ops/gather.py``); for CUDA
tensors it launches the kernel on the current stream or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from . import gather as _plain

launches = 0


def gather_chains(streams: torch.Tensor, table: torch.Tensor, n_windows: int,
                  n_chains: int):
    """Every decode chain of ``table``'s files, read from their streams
    (contract of ``ops.gather.gather_chains``).

    streams int64 (n_words,): the files' QOA streams back to back; table
    int64 (TABLE_ROWS, n_files) and ``n_chains`` from
    ``ops.gather.file_table``; ``n_windows`` the rows to give, at least
    every chain's windows.  Returns (words_be int64 (n_windows, n_chains)
    raw big-endian, state int32 (8, n_chains)).
    """
    global launches
    device = _build.kernel_device(streams, table)
    if device is None:
        return _plain.gather_chains(streams, table, n_windows, n_chains)
    lib = _build.library()
    _build.require(streams, "streams", torch.int64, (streams.shape[0],))
    _build.require(table, "table", torch.int64, (_plain.TABLE_ROWS, table.shape[1]))
    words = torch.empty((n_windows, n_chains), dtype=torch.int64, device=device)
    state = torch.empty((8, n_chains), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.qoa_gather_cuda(
            streams.data_ptr(), table.data_ptr(), table.shape[1], n_windows, n_chains,
            words.data_ptr(), state.data_ptr(), stream,
        )
    _build.check(rc, "qoa_gather_cuda")
    launches += 1
    return words, state
