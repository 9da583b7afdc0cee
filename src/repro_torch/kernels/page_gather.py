"""page_gather: ``out[b, p] = pool[clip(page_table[b, p], 0, n_pages − 1)]``.

Replaces ``repro/kernels/page_gather.py::page_gather_kernel`` (the Pallas TPU
kernel, reached through ``page_gather_pallas``): the gather of the paged KV
cache, which assembles each serving slot's logical K/V sequence, or its
per-token scales, from one layer's page pool.  The CUDA kernel is
``csrc/page_gather.cu``; its header says what bounds it on the card (bytes:
each gathered page read once and written once) and why it is one block per
page.  It moves bytes, so it is bit-exact with the plain version for every
dtype.

``page_gather_plain`` is the same function in plain PyTorch: the CPU path,
and what ``chip_smoke.py`` holds the kernel against on the card.
``page_gather_cuda`` launches the kernel; it is never replaced by the plain
version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

__all__ = ["page_gather_plain", "page_gather_cuda"]

_PT_DTYPES = (torch.int32, torch.int64)


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


def _lib():
    lib = build.load("page_gather")
    fn = lib.page_gather_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ci, ctypes.c_longlong, vp]
        fn.restype = ci
    return fn


def page_gather_cuda(pool: torch.Tensor,
                     page_table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (B, P, page, *rest).

    ``pool`` may be a view at an offset (one layer of the (L, n_pages, ...)
    pool) but must be contiguous; it is never copied.  An int64 page table
    is cast to int32 once.  Raises on anything the kernel does not take and
    when the launch reports an error.
    """
    if not (pool.is_cuda and page_table.is_cuda):
        raise ValueError("page_gather_cuda takes CUDA tensors")
    _check(pool, page_table)
    if not pool.is_contiguous():
        raise ValueError("page_gather_cuda takes a contiguous pool")
    n_pages = pool.shape[0]
    if n_pages == 0 or n_pages >= 1 << 31:
        raise ValueError(f"n_pages {n_pages} out of range")
    B, P = page_table.shape
    out = torch.empty((B, P) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    page_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    if out.numel() == 0:
        return out
    pt = page_table.to(torch.int32).contiguous()
    err = _lib()(pool.data_ptr(), pt.data_ptr(), out.data_ptr(), B * P,
                 n_pages, page_bytes,
                 torch.cuda.current_stream(pool.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"page_gather kernel launch failed: cudaError "
                           f"{err}")
    page_gather_cuda.launches += 1
    return out


page_gather_cuda.launches = 0
