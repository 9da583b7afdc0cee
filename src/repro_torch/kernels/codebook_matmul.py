"""codebook_matmul: ``out = x @ codebook[w_idx]`` with f32 accumulation.

Replaces ``repro/kernels/codebook_matmul.py::codebook_matmul_kernel`` (the
Pallas TPU kernel, reached through ``codebook_matmul_pallas``).  The CUDA
kernel is ``csrc/codebook_matmul.cu``; its header says what bounds it on the
card (device-memory bytes of the narrow id matrix, at every row count the
serving path gives it) and its two routes: tensor cores for bf16 x with
16-byte aligned rows at every M (ids dequantized to bf16 in shared memory,
``mma.sync``), and an FMA tile for the rest (f32 x on the reduced model).
``_common.codebook_plan`` picks the route and the K split; the splits of a
tile meet in one thread block cluster of the same launch, in a fixed
order.

``codebook_matmul_plain`` is the same function in plain PyTorch: the CPU
path, and what ``chip_smoke.py`` holds the kernel against on the card,
within ``parity_tolerance``.  ``codebook_matmul_cuda`` launches the kernel;
it is never replaced by the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import (MAX_CLUSTER, Plan, canonical_idx,
                                        check_plan, codebook_plan, is_aligned,
                                        sm_count)

__all__ = ["codebook_matmul_plain", "codebook_matmul_cuda", "parity_tolerance",
           "plan_for", "MAX_BOOK"]

MAX_BOOK = 16384                       # codebook entries held in shared memory
_IDX_DTYPES = (torch.int8, torch.int16, torch.int32)
_X_DTYPES = (torch.float32, torch.bfloat16)


def codebook_matmul_plain(x: torch.Tensor, w_idx: torch.Tensor,
                          codebook: torch.Tensor) -> torch.Tensor:
    """x: (M, K) float; w_idx: (K, N) int; codebook: (W,).  (M, N) f32.

    Each weight is rounded to x's dtype before the product, as the Pallas
    kernel does; the product runs in f32.
    """
    n_book = codebook.shape[-1]
    ids = canonical_idx(w_idx, n_book).clamp(0, n_book - 1)
    w = codebook.to(torch.float32)[ids.long()].to(x.dtype)
    return x.to(torch.float32) @ w.to(torch.float32)


def parity_tolerance(x: torch.Tensor, w_idx: torch.Tensor,
                     codebook: torch.Tensor, margin: float = 16.0
                     ) -> torch.Tensor:
    """(M, N) limit on |kernel − plain| for the same inputs.

    Both round each weight to x's dtype, so they differ only in the order
    of K f32 additions.  The rounding errors of running sums of terms of
    random sign add up like a random walk: one order errs by about
    2⁻²⁴·√K·‖x_m ⊙ w_n‖₂.  The limit is ``margin`` times that estimate.
    Skipping the rounding of weights to bf16 errs by about
    2⁻⁹·‖x_m ⊙ w_n‖₂/√3, hundreds of estimates at the K of the serving
    path, so that fault cannot pass (``tests/test_torch_kernels.py``
    checks both sides on the CPU).
    """
    n_book = codebook.shape[-1]
    ids = canonical_idx(w_idx, n_book).clamp(0, n_book - 1)
    w = codebook.to(torch.float32)[ids.long()].to(x.dtype).to(torch.float32)
    xf = x.to(torch.float32)
    norm = torch.sqrt((xf * xf) @ (w * w))
    return margin * 2.0 ** -24 * math.sqrt(x.shape[1]) * norm


def _lib():
    lib = build.load("codebook_matmul")
    fn = lib.codebook_matmul_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, ci, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


_ROUTES = ("mma", "fma")                   # codebook_matmul.cu's Route


def _plan(x: torch.Tensor, w_idx: torch.Tensor):
    M, K = x.shape
    N = w_idx.shape[1]
    vec_ok = is_aligned(w_idx, N) and is_aligned(x, K)
    return codebook_plan(M, K, N, bf16=x.dtype == torch.bfloat16,
                         vec_ok=vec_ok, sms=sm_count(x.device)), vec_ok


def plan_for(x: torch.Tensor, w_idx: torch.Tensor) -> Plan:
    """The route and tiling ``codebook_matmul_cuda`` takes for these CUDA
    operands."""
    return _plan(x, w_idx)[0]


def codebook_matmul_cuda(x: torch.Tensor, w_idx: torch.Tensor,
                         codebook: torch.Tensor, plan: Plan | None = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (M, N) f32.  ``plan``
    overrides the planned route and tiling (``_common.codebook_plan`` with
    other arguments), for holding each route against the plain version.

    Raises on anything the kernel does not take (device, dtype, shape,
    contiguity, codebook size, a plan these operands cannot take) and when
    the launch reports an error.
    """
    if not (x.is_cuda and w_idx.is_cuda and codebook.is_cuda):
        raise ValueError("codebook_matmul_cuda takes CUDA tensors")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_X_DTYPES}")
    if w_idx.dtype not in _IDX_DTYPES:
        raise TypeError(f"w_idx dtype {w_idx.dtype} not in {_IDX_DTYPES}")
    if codebook.dtype != torch.float32 or codebook.ndim != 1:
        raise TypeError("codebook must be a 1-D float32 tensor")
    if x.ndim != 2 or w_idx.ndim != 2 or x.shape[1] != w_idx.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w_idx.shape)}")
    if not (x.is_contiguous() and w_idx.is_contiguous()
            and codebook.is_contiguous()):
        raise ValueError("codebook_matmul_cuda takes contiguous tensors")
    n_book = codebook.shape[0]
    if not 1 <= n_book <= MAX_BOOK:
        raise ValueError(f"codebook of {n_book} entries; the kernel holds "
                         f"1..{MAX_BOOK} in shared memory")
    M, K = x.shape
    N = w_idx.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    planned, vec_ok = _plan(x, w_idx)
    if plan is None:
        plan = planned
    else:
        mma_ok = x.dtype == torch.bfloat16 and vec_ok and K % 8 == 0
        check_plan(plan, K, {"mma": mma_ok and plan.bm in (16, 64),
                             "fma": plan.bm == 64}, MAX_CLUSTER)
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_idx.data_ptr(), w_idx.element_size(), codebook.data_ptr(),
                 n_book, out.data_ptr(), M, K, N, _ROUTES.index(plan.route),
                 plan.bm, plan.splits, plan.k_chunk, int(vec_ok),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"codebook_matmul kernel launch failed: "
                           f"cudaError {err}")
    codebook_matmul_cuda.launches += 1
    return out


codebook_matmul_cuda.launches = 0
