"""What both kernels share: id canonicalization and the launch tiling.

``launch_tiling`` picks the rows per block (a template instance of both
``csrc`` kernels, dispatched by ``csrc/common.cuh``) and how far K is split
across blocks; the split planes are summed by ``common.cuh``'s ordered
reduction.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["canonical_idx", "launch_tiling", "ROWS_PER_BLOCK"]

ROWS_PER_BLOCK = (4, 16, 64)        # the BM instances of the csrc kernels


def canonical_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ids in [0, n): narrow dtypes store ids ≥ 2^(bits−1) as
    negatives (two's complement)."""
    idx = idx.to(torch.int32)
    return torch.where(idx < 0, idx + n, idx)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def launch_tiling(M: int, K: int, N: int, device) -> tuple[int, int, int]:
    """(rows per block, K splits, K per split): enough blocks for every SM
    at small M, each split a whole number of 32-deep stages."""
    bm = next((b for b in ROWS_PER_BLOCK if M <= b), ROWS_PER_BLOCK[-1])
    tiles = -(-N // 64) * -(-M // bm)
    sms = _sm_count(device.index if device.index is not None
                    else torch.cuda.current_device())
    splits = 1
    while tiles * splits < 2 * sms and K >= 256 * splits:
        splits *= 2
    k_chunk = -(-K // splits)
    k_chunk = -(-k_chunk // 32) * 32
    return bm, -(-K // k_chunk), k_chunk
