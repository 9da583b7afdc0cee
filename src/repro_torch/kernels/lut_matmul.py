"""lut_matmul: the paper's §4 engine, ``acc[m,n] = Σ_k T[a_idx[m,k], w_idx[k,n]]``
in int32 with wrap-around.

Replaces ``repro/kernels/lut_matmul.py::lut_matmul_kernel`` (the Pallas TPU
kernel, reached through ``lut_matmul_pallas``).  The CUDA kernel is
``csrc/lut_matmul.cu``; its header says what bounds it on the card.  Term
by term through L2, every 4-byte lookup cost some 28 bytes of L2 sectors;
now each block copies the table rows T[a[m,k], 0:C] of its k-chunk into a
shared-memory ring with bulk (TMA) copies, and its columns (up to 6144 a
block) take their terms from there, so the bound is shared-memory lookups.
A term whose w lies outside [0, C) reads the flat address ``a·C + w`` from
device memory, clamped into the table, as before.  ``_common.lut_plan``
picks the route (rows staged, or every lookup through L2 where rows are too
long to stage or off 16-byte boundaries or, at M <= 4, a site has at most
1024 columns) and the K split; the splits add into a zeroed accumulator with
integer atomics (uint32 sums wrap the same in any order) and the last block
of a tile copies it out, in the same launch.  Bit-exact with the plain
version.

``lut_matmul_plain`` is the same function in plain PyTorch: the CPU path, and
what ``chip_smoke.py`` holds the kernel against on the card.
``lut_matmul_cuda`` launches the kernel; it is never replaced by the plain
version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (Plan, canonical_idx, check_plan,
                                        is_aligned, lut_plan, scratch,
                                        sm_count)

__all__ = ["lut_matmul_plain", "lut_matmul_cuda", "plan_for", "wrap_int32"]

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
        fn.argtypes = [vp, vp, ci, vp, ci, ci, ci, vp, vp, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


_ROUTES = ("smem", "l2")                   # lut_matmul.cu's Route


def plan_for(a_idx: torch.Tensor, w_idx: torch.Tensor,
             table: torch.Tensor) -> Plan:
    """The route and tiling ``lut_matmul_cuda`` takes for these CUDA
    operands."""
    M, K = a_idx.shape
    return lut_plan(M, K, w_idx.shape[1], n_cols=table.shape[1],
                    idx_bytes=w_idx.element_size(), sms=sm_count(a_idx.device))


def lut_matmul_cuda(a_idx: torch.Tensor, w_idx: torch.Tensor,
                    table: torch.Tensor, plan: Plan | None = None
                    ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (M, N) int32.  ``plan``
    overrides the planned route and tiling (``_common.lut_plan`` with other
    arguments), for holding each route against the plain version.

    Raises on anything the kernel does not take (device, dtype, shape,
    contiguity, a plan that does not split K into whole stages) and when
    the launch reports an error.
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
    if plan is None:
        plan = plan_for(a_idx, w_idx, table)
    else:
        check_plan(plan, K, {"smem": plan.bm in (4, 16),
                             "l2": plan.bm in (4, 16, 64)}, 1 << 30)
    dev = a_idx.device
    acc = counters = None
    if plan.splits > 1:
        acc = scratch("lut_matmul.acc", dev, M * N, torch.int32)
        counters = scratch("lut_matmul.counters", dev, plan.tiles, torch.int32)
    rows, n_cols = table.shape
    err = _lib()(a_idx.data_ptr(), w_idx.data_ptr(), w_idx.element_size(),
                 table.data_ptr(), rows, n_cols, table.numel(),
                 out.data_ptr(), acc.data_ptr() if acc is not None else None,
                 counters.data_ptr() if counters is not None else None,
                 M, K, N, _ROUTES.index(plan.route), plan.bm, plan.threads,
                 plan.stages, plan.splits, plan.k_chunk,
                 int(is_aligned(w_idx, N)), int(is_aligned(table, n_cols)),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_matmul kernel launch failed: cudaError {err}")
    lut_matmul_cuda.launches += 1
    return out


lut_matmul_cuda.launches = 0
