"""lut_matmul: the paper's §4 engine, ``acc[m,n] = Σ_k T[a_idx[m,k], w_idx[k,n]]``
in int32 with wrap-around.

Replaces ``repro/kernels/lut_matmul.py::lut_matmul_kernel`` (the Pallas TPU
kernel, reached through ``lut_matmul_pallas``).  The CUDA kernel is
``csrc/lut_matmul.cu``; its header says what bounds it on the card (4-byte
table lookups at data-dependent addresses, served from L2 because one
layer's 16 MB table does not fit in shared memory) and what its design does
about that (index tiles staged in shared memory, one table row per k shared
by a warp's neighbouring columns, K split across blocks when output tiles are
few).  It accumulates in uint32 and is bit-exact with the plain version.

``lut_matmul_plain`` is the same function in plain PyTorch: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.
``lut_matmul_cuda`` launches the kernel; it is never replaced by the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import canonical_idx, launch_tiling

__all__ = ["lut_matmul_plain", "lut_matmul_cuda", "wrap_int32"]

_IDX_DTYPES = (torch.int8, torch.int16, torch.int32)
_CUBE = 1 << 24             # elements of one gathered (M, kc, N) chunk


def wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """int64 sums → int32 with two's-complement wrap-around (what an int32
    accumulator holds after the same additions)."""
    return ((acc + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _scaled_rows(a_idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Canonical row ids pre-multiplied by the column count (int32), as
    ``lut_matmul_pallas`` passes them to its kernel."""
    rows, n_cols = table.shape
    return canonical_idx(a_idx, rows) * n_cols


def lut_matmul_plain(a_idx: torch.Tensor, w_idx: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """a_idx: (M, K) int rows of the table; w_idx: (K, N) int columns;
    table: (R, C) int32.  Returns (M, N) int32 accumulators.

    Flat address ``a·C + w`` clamped into the table, K gathered in chunks
    so the (M, kc, N) intermediate stays bounded, sums wrapped to int32.
    """
    M, K = a_idx.shape
    N = w_idx.shape[1]
    rows, n_cols = table.shape
    a = _scaled_rows(a_idx, table)
    w = canonical_idx(w_idx, n_cols)
    flat = table.reshape(-1).to(torch.int32)
    kc = max(1, min(K, _CUBE // max(M * N, 1)))
    acc = torch.zeros((M, N), dtype=torch.int64, device=a_idx.device)
    for k0 in range(0, K, kc):
        addr = (a[:, k0:k0 + kc, None] + w[None, k0:k0 + kc, :]).clamp(
            0, rows * n_cols - 1)
        acc += flat[addr.long()].sum(dim=1, dtype=torch.int64)
    return wrap_int32(acc)


def _lib():
    lib = build.load("lut_matmul")
    fn = lib.lut_matmul_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, ci, vp, ci, ci, vp, vp,
                       ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def lut_matmul_cuda(a_idx: torch.Tensor, w_idx: torch.Tensor,
                    table: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (M, N) int32.

    Raises on anything the kernel does not take (device, dtype, shape,
    contiguity) and when the launch reports an error.
    """
    if not (a_idx.is_cuda and w_idx.is_cuda and table.is_cuda):
        raise ValueError("lut_matmul_cuda takes CUDA tensors")
    if a_idx.dtype != torch.int32 or table.dtype != torch.int32:
        raise TypeError("a_idx and table must be int32")
    if w_idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"w_idx dtype {w_idx.dtype} not in {_IDX_DTYPES}")
    if a_idx.ndim != 2 or w_idx.ndim != 2 or table.ndim != 2 \
            or a_idx.shape[1] != w_idx.shape[0]:
        raise ValueError(f"shapes {tuple(a_idx.shape)}, {tuple(w_idx.shape)},"
                         f" table {tuple(table.shape)}")
    if not (a_idx.is_contiguous() and w_idx.is_contiguous()
            and table.is_contiguous()):
        raise ValueError("lut_matmul_cuda takes contiguous tensors")
    if table.numel() >= 1 << 31:
        raise ValueError("table too large for 32-bit addresses")
    M, K = a_idx.shape
    N = w_idx.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=a_idx.device)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    a = _scaled_rows(a_idx, table).contiguous()
    bm, splits, k_chunk = launch_tiling(M, K, N, a_idx.device)
    part = (torch.empty((splits, M, N), dtype=torch.int32,
                        device=a_idx.device) if splits > 1 else None)
    err = _lib()(a.data_ptr(), w_idx.data_ptr(), w_idx.element_size(),
                 table.data_ptr(), table.shape[1], table.numel(),
                 out.data_ptr(), part.data_ptr() if part is not None else None,
                 M, K, N, bm, splits, k_chunk,
                 torch.cuda.current_stream(a_idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: cudaError {err}")
    lut_matmul_cuda.launches += 1
    return out


lut_matmul_cuda.launches = 0
