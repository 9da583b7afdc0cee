"""page_gather: ``out[b, p] = pool[clip(page_table[b, p], 0, n_pages − 1)]``.

Replaces ``repro/kernels/page_gather.py::page_gather_kernel`` (the Pallas TPU
kernel, reached through ``page_gather_pallas``): the gather of the paged KV
cache, which assembles each serving slot's logical K/V sequence, or its
per-token scales, from one layer's page pool.  The CUDA kernel is
``csrc/page_gather.cu``; its header says what bounds it on the card (bytes:
each gathered page read once and written once) and how it spreads a call
over the card.  It moves bytes, so it is bit-exact with the plain version
for every dtype.

``page_gather_cuda`` gathers one pool; ``page_gather_many_cuda`` gathers up
to four pools that share a page table (a paged layer's K, V and their
scales) in one launch, bit-identical to one ``page_gather_cuda`` a pool.
``page_gather_plain`` and ``page_gather_many_plain`` are the same functions
in plain PyTorch: the CPU path, and what ``chip_smoke.py`` holds the kernel
against on the card.  The CUDA wrappers are never replaced by the plain
versions.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["page_gather_plain", "page_gather_cuda", "page_gather_many_plain",
           "page_gather_many_cuda", "MAX_POOLS"]

_PT_DTYPES = (torch.int32, torch.int64)
MAX_POOLS = 4


def _check(pool: torch.Tensor, page_table: torch.Tensor) -> None:
    if pool.ndim < 2:
        raise ValueError(f"pool must be (n_pages, page, ...); got "
                         f"{tuple(pool.shape)}")
    if page_table.ndim != 2 or page_table.dtype not in _PT_DTYPES:
        raise ValueError(f"page_table must be (B, P) int32/int64; got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")


def page_gather_plain(pool: torch.Tensor,
                      page_table: torch.Tensor) -> torch.Tensor:
    """pool: (n_pages, page, *rest) any dtype; page_table: (B, P) int.
    Returns (B, P, page, *rest) in pool.dtype.

    Ids are cast to int32 and clamped into the pool, as
    ``page_gather_pallas`` does: an out-of-range id reads the nearest end
    page rather than faulting.
    """
    _check(pool, page_table)
    pt = page_table.to(torch.int32).clamp(0, pool.shape[0] - 1)
    return pool[pt.long()]


def page_gather_many_plain(pools, page_table: torch.Tensor) -> list:
    """``[page_gather_plain(pool, page_table) for pool in pools]``."""
    return [page_gather_plain(pool, page_table) for pool in pools]


def _lib():
    lib = build.load("page_gather")
    fn = lib.page_gather_launch
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp, ci, ci] + [vp, vp, ci, ll, ci] * MAX_POOLS
                       + [vp])
        fn.restype = ci
    return fn


def _launch(pools, page_table: torch.Tensor) -> list:
    """One launch gathering every pool of ``pools`` with ``page_table``."""
    if not 1 <= len(pools) <= MAX_POOLS:
        raise ValueError(f"{len(pools)} pools; one launch takes 1 to "
                         f"{MAX_POOLS}")
    if not (page_table.is_cuda and all(p.is_cuda for p in pools)):
        raise ValueError("page_gather_cuda takes CUDA tensors")
    _check(pools[0], page_table)
    B, P = page_table.shape
    outs, args = [], []
    for pool in pools:
        _check(pool, page_table)
        if not pool.is_contiguous():
            raise ValueError("page_gather_cuda takes a contiguous pool")
        if pool.device != page_table.device:
            raise ValueError("pools and page table on different devices")
        n_pages = pool.shape[0]
        if n_pages == 0 or n_pages >= 1 << 31:
            raise ValueError(f"n_pages {n_pages} out of range")
        out = torch.empty((B, P) + tuple(pool.shape[1:]), dtype=pool.dtype,
                          device=pool.device)
        page_bytes = math.prod(pool.shape[1:]) * pool.element_size()
        vec = int(page_bytes % 16 == 0 and pool.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        outs.append(out)
        if page_bytes:                   # a pool of empty pages has no copy
            args += [pool.data_ptr(), out.data_ptr(), n_pages, page_bytes,
                     vec]
    n_pools = len(args) // 5
    if B * P == 0 or n_pools == 0:
        return outs
    args += [0, 0, 1, 1, 0] * (MAX_POOLS - n_pools)
    pt = page_table.to(torch.int32).contiguous()
    err = _lib()(pt.data_ptr(), B * P, n_pools, *args,
                 torch.cuda.current_stream(pt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"page_gather kernel launch failed: cudaError "
                           f"{err}")
    page_gather_cuda.launches += 1
    return outs


def page_gather_cuda(pool: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (B, P, page, *rest).

    ``pool`` may be a view at an offset (one layer of the (L, n_pages, ...)
    pool) but must be contiguous; it is never copied.  An int64 page table
    is cast to int32 once.  Raises on anything the kernel does not take and
    when the launch reports an error.
    """
    return _launch([pool], page_table)[0]


def page_gather_many_cuda(pools, page_table: torch.Tensor) -> list:
    """``[page_gather_cuda(pool, page_table) for pool in pools]`` in one
    launch: up to four contiguous pools of any page shape and dtype."""
    return _launch(list(pools), page_table)


page_gather_cuda.launches = 0
