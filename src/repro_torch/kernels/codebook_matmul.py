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

The gated launch, ``codebook_swiglu_cuda``, is a SwiGLU FFN's gate and up
products at the paper's working point with the quantized activation
(``act_quant``'s act_apply form) as their epilogue, one launch of the same
source: ``h = T(act_q(T(x @ W1)) * T(x @ W3))``, T = x's dtype.  It takes
the plan of one codebook_matmul of that shape for both products
(``_common.swiglu_plan``), so ``h`` equals the unfused chain of two
``codebook_matmul_cuda`` launches, their casts, ``act_quant_cuda`` and the
product bit for bit.  ``codebook_swiglu_plain`` is that chain in plain
PyTorch; ``swiglu_epilogue_plain`` its epilogue alone, which applied to the
kernel's own accumulators gives the kernel's ``h`` exactly.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import act_quant as aq
from repro_torch.kernels import build
from repro_torch.kernels._common import (MAX_CLUSTER, Plan, canonical_idx,
                                        check_plan, codebook_plan, is_aligned,
                                        sm_count, swiglu_plan)

__all__ = ["codebook_matmul_plain", "codebook_matmul_cuda", "parity_tolerance",
           "plan_for", "MAX_BOOK", "codebook_swiglu_plain",
           "codebook_swiglu_cuda", "swiglu_epilogue_plain"]

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


def swiglu_epilogue_plain(g: torch.Tensor, u: torch.Tensor, dtype, kind: str,
                          levels: int) -> torch.Tensor:
    """The gated launch's epilogue: the f32 sums G and U rounded to
    ``dtype``, then ``act_q(G) * U`` in ``dtype`` (act_apply form)."""
    return aq.act_quant_plain(g.to(dtype), kind, levels, form="act_apply",
                              with_index=False, mul=u.to(dtype))[0]


def codebook_swiglu_plain(x: torch.Tensor, w1_idx: torch.Tensor,
                          book1: torch.Tensor, w3_idx: torch.Tensor,
                          book3: torch.Tensor, kind: str,
                          levels: int) -> torch.Tensor:
    """x: (M, K) float; w1_idx, w3_idx: (K, N) int; book1, book3: (W,).
    (M, N) in x's dtype: the unfused chain a SwiGLU FFN runs at
    ``act_levels > 0`` (two codebook products, each cast to x's dtype, the
    quantized activation of the first times the second)."""
    return swiglu_epilogue_plain(codebook_matmul_plain(x, w1_idx, book1),
                                 codebook_matmul_plain(x, w3_idx, book3),
                                 x.dtype, kind, levels)


def _lib():
    lib = build.load("codebook_matmul")
    fn = lib.codebook_matmul_launch
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, ci, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def _swiglu_lib():
    lib = build.load("codebook_matmul")
    fn = lib.codebook_swiglu_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, ci, vp, vp, ci, vp, ci, vp, ci, vp,
                       ci, ci, ci, ci, ci, ci, ci, ci, ci, cf, cf, cf, vp]
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


def _check(name: str, x: torch.Tensor, *pairs) -> None:
    """Raise on operands the kernel does not take: x (M, K) and each
    (w_idx (K, N), codebook (W,)) pair, all CUDA and contiguous."""
    if not (x.is_cuda and all(t.is_cuda for p in pairs for t in p)):
        raise ValueError(f"{name} takes CUDA tensors")
    if x.dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {x.dtype} not in {_X_DTYPES}")
    for w_idx, codebook in pairs:
        if w_idx.dtype not in _IDX_DTYPES:
            raise TypeError(f"w_idx dtype {w_idx.dtype} not in {_IDX_DTYPES}")
        if codebook.dtype != torch.float32 or codebook.ndim != 1:
            raise TypeError("codebook must be a 1-D float32 tensor")
        if x.ndim != 2 or w_idx.ndim != 2 or x.shape[1] != w_idx.shape[0]:
            raise ValueError(f"shapes {tuple(x.shape)} @ "
                             f"{tuple(w_idx.shape)}")
        if not (x.is_contiguous() and w_idx.is_contiguous()
                and codebook.is_contiguous()):
            raise ValueError(f"{name} takes contiguous tensors")
        if not 1 <= codebook.shape[0] <= MAX_BOOK:
            raise ValueError(f"codebook of {codebook.shape[0]} entries; the "
                             f"kernel holds 1..{MAX_BOOK} in shared memory")


def _check_plan(plan: Plan, x: torch.Tensor, vec_ok: bool) -> None:
    K = x.shape[1]
    mma_ok = x.dtype == torch.bfloat16 and vec_ok and K % 8 == 0
    check_plan(plan, K, {"mma": mma_ok and plan.bm in (16, 64),
                         "fma": plan.bm == 64}, MAX_CLUSTER)


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
    _check("codebook_matmul_cuda", x, (w_idx, codebook))
    n_book = codebook.shape[0]
    M, K = x.shape
    N = w_idx.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0 or K == 0:
        return out.zero_()
    planned, vec_ok = _plan(x, w_idx)
    if plan is None:
        plan = planned
    else:
        _check_plan(plan, x, vec_ok)
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


def codebook_swiglu_cuda(x: torch.Tensor, w1_idx: torch.Tensor,
                         book1: torch.Tensor, w3_idx: torch.Tensor,
                         book3: torch.Tensor, kind: str, levels: int,
                         plan: Plan | None = None) -> torch.Tensor:
    """Launch the gated kernel on CUDA tensors; (M, N) in x's dtype, equal
    bit for bit to ``codebook_matmul_cuda`` of each product with ``plan``,
    cast to x's dtype, then ``act_quant_cuda(g, kind, levels,
    form="act_apply", mul=u)``.  ``plan`` overrides the planned route and
    tiling, as for ``codebook_matmul_cuda``.

    Raises on anything the kernel does not take (as codebook_matmul_cuda;
    id matrices of two shapes or dtypes; a kind or level count act_quant
    does not take; codebooks that do not fit in shared memory together)
    and when the launch reports an error.
    """
    _check("codebook_swiglu_cuda", x, (w1_idx, book1), (w3_idx, book3))
    if w1_idx.shape != w3_idx.shape or w1_idx.dtype != w3_idx.dtype:
        raise ValueError(f"w1 {tuple(w1_idx.shape)} {w1_idx.dtype} and w3 "
                         f"{tuple(w3_idx.shape)} {w3_idx.dtype} differ")
    lo, step, qmax, _ = aq._scalars(kind, levels, "act_apply", x.dtype)
    M, K = x.shape
    N = w1_idx.shape[1]
    n_books = book1.shape[0] + book3.shape[0]
    vec_ok = (is_aligned(w1_idx, N) and is_aligned(w3_idx, N)
              and is_aligned(x, K))
    planned = swiglu_plan(M, K, N, bf16=x.dtype == torch.bfloat16,
                          vec_ok=vec_ok, sms=sm_count(x.device),
                          n_books=n_books)
    if plan is None:
        plan = planned
    else:
        _check_plan(plan, x, vec_ok)
    if K == 0:
        raise ValueError("codebook_swiglu_cuda takes K > 0")
    h = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return h
    err = _swiglu_lib()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w1_idx.data_ptr(),
        w3_idx.data_ptr(), w1_idx.element_size(), book1.data_ptr(),
        book1.shape[0], book3.data_ptr(), book3.shape[0], h.data_ptr(), M, K,
        N, _ROUTES.index(plan.route), plan.bm, plan.splits, plan.k_chunk,
        int(vec_ok), aq.KINDS.index(kind), lo, step, qmax,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"codebook_swiglu kernel launch failed: "
                           f"cudaError {err}")
    codebook_swiglu_cuda.launches += 1
    return h


codebook_swiglu_cuda.launches = 0
