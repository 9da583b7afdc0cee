"""codebook_matmul: ``out = x @ codebook[w_idx]`` with f32 accumulation.

Replaces ``repro/kernels/codebook_matmul.py::codebook_matmul_kernel`` (the
Pallas TPU kernel, reached through ``codebook_matmul_pallas``).  The CUDA
kernel is ``csrc/codebook_matmul.cu``; its header says what bounds it on the
card (device-memory bytes of the narrow id matrix at decode shapes) and what
its design does about that (ids read once per row tile and dequantized
through a codebook held in shared memory, K split across blocks when output
tiles are few, partial planes summed in a fixed order).

``codebook_matmul_plain`` is the same function in plain PyTorch: the CPU
path, and what ``chip_smoke.py`` holds the kernel against on the card,
within ``parity_tolerance``.  ``codebook_matmul_cuda`` launches the kernel; it is never replaced by the
plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels._common import canonical_idx, launch_tiling

__all__ = ["codebook_matmul_plain", "codebook_matmul_cuda", "parity_tolerance",
           "MAX_BOOK"]

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
        fn.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp,
                       ci, ci, ci, ci, ci, ci, vp]
        fn.restype = ci
    return fn


def codebook_matmul_cuda(x: torch.Tensor, w_idx: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors; (M, N) f32.

    Raises on anything the kernel does not take (device, dtype, shape,
    contiguity, codebook size) and when the launch reports an error.
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
    bm, splits, k_chunk = launch_tiling(M, K, N, x.device)
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    err = _lib()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                 w_idx.data_ptr(), w_idx.element_size(), codebook.data_ptr(),
                 n_book, out.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 M, K, N, bm, splits, k_chunk,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"codebook_matmul kernel launch failed: "
                           f"cudaError {err}")
    codebook_matmul_cuda.launches += 1
    return out


codebook_matmul_cuda.launches = 0
