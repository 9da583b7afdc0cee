"""kmeans_assign: one Lloyd step of 1-D k-means (paper §2.2) — each value's
center (``searchsorted`` over the midpoints, side right) and the per-center
sums and counts.

Replaces ``repro/kernels/kmeans1d.py::kmeans_assign_kernel`` (the Pallas TPU
kernel, reached through ``kmeans_assign_pallas``).  The CUDA kernel is
``csrc/kmeans_assign.cu``; its header says what bounds it on the card (8
bytes a value: the value read, its index written) and how it sums without
float atomics, so that a Lloyd step gives the same codebook every run.

``kmeans_assign_plain`` is the same function in plain PyTorch (the CPU
path, and what ``chip_smoke.py`` holds the kernel against on the card):
``searchsorted``, ``index_add_`` and ``bincount``.  ``idx`` and ``counts``
of the two are equal; ``sums`` add in other orders, and each is held to
the f64 sum (``exact_sums``): the plain version's running sums within
their worst-case bound (``sums_bound``), the kernel's tree within 16
times its random-walk estimate (``sums_tolerance``).
``kmeans_assign_cuda`` launches the kernel; it is never replaced by the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["kmeans_assign_plain", "kmeans_assign_cuda", "exact_sums",
           "sums_bound", "sums_tolerance", "launch_grid", "MAX_K"]

MAX_K = 4096                 # centers the kernel holds in shared memory
_CHUNK = 16384               # values a block takes, at least
_MAX_BLOCKS = 2640           # 132 SMs x 5 resident blocks at k = 1000, x 4
_TOL_CHUNK = 1 << 26         # values per chunk of exact_sums


def _check(values: torch.Tensor, centers: torch.Tensor) -> None:
    if values.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"kmeans_assign takes f32 values and centers; got "
                        f"{values.dtype}, {centers.dtype}")
    if values.ndim != 1 or centers.ndim != 1 or centers.shape[0] < 1:
        raise ValueError(f"kmeans_assign takes (n,) values and (k,) centers; "
                         f"got {tuple(values.shape)}, {tuple(centers.shape)}")


def kmeans_assign_plain(values: torch.Tensor, centers: torch.Tensor):
    """values: (n,) f32; centers: (k,) f32, sorted.  Returns (idx (n,)
    int32, sums (k,) f32, counts (k,) f32)."""
    _check(values, centers)
    k = centers.shape[0]
    bounds = ((centers[:-1] + centers[1:]) / 2.0).contiguous()
    idx = torch.searchsorted(bounds, values.contiguous(), right=True,
                             out_int32=True)
    sums = torch.zeros(k, dtype=torch.float32,
                       device=values.device).index_add_(0, idx, values)
    counts = torch.bincount(idx, minlength=k).to(torch.float32)
    return idx, sums, counts


def exact_sums(values: torch.Tensor, idx: torch.Tensor, k: int):
    """(sums in f64, Σ|v| in f64, counts) per center: the yardstick the f32
    sums are held to (f64 rounding is some 10⁹ times finer)."""
    f64, dev = torch.float64, values.device
    sums = torch.zeros(k, dtype=f64, device=dev)
    abs_sum = torch.zeros(k, dtype=f64, device=dev)
    n_c = torch.zeros(k, dtype=f64, device=dev)
    for v, i in zip(values.split(_TOL_CHUNK), idx.split(_TOL_CHUNK)):
        i, v = i.long(), v.to(f64)
        sums.index_add_(0, i, v)
        abs_sum.index_add_(0, i, v.abs())
        n_c.index_add_(0, i, torch.ones_like(v))
    return sums, abs_sum, n_c


def sums_bound(abs_sum: torch.Tensor, n_c: torch.Tensor) -> torch.Tensor:
    """(k,) worst-case bound on |f32 sums − exact sums| for running sums,
    the plain version's order (``index_add_``; float atomics, in any
    order, on the card): γ_d · Σ|v| with γ_d = d·2⁻²⁴/(1 − d·2⁻²⁴) and
    d = n_c, the longest chain of f32 additions a value passes through
    (Higham).

    A worst-case bound and not a random-walk estimate: the values of a
    cluster are few distinct bf16 numbers, so the roundings of a running
    sum repeat instead of cancelling.  At the full model's n the plain
    version's float atomics err by some 24 times the estimate
    2⁻²⁴·√n_c·Σ|v| (PERF.md).
    """
    return _gamma(n_c) * abs_sum


def sums_tolerance(abs_sum: torch.Tensor, n_c: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(k,) limit on |kernel sums − exact sums|: 16 × the random-walk
    estimate 2⁻²⁴·√d·Σ|v| of the kernel's summation tree, or its
    worst-case bound γ_d·Σ|v| where that is tighter (short chains).  d is
    the longest chain a value passes through: 31 additions in a lane
    group, one a warp iteration, 8 warps and the blocks, at most n_c.  At
    the full model's n (d = 5226) that is 6.9·10⁻⁵ of a cluster's Σ|v|,
    against 3.1·10⁻⁴ for the worst-case bound: a kernel that loses or adds
    twice that share of a cluster's values goes past it."""
    blocks, chunk = launch_grid(n)
    depth = 31 + -(-chunk // 256) + 8 + blocks
    d = torch.clamp(n_c, max=float(depth))
    return torch.minimum(16 * 2.0 ** -24 * d.sqrt(), _gamma(d)) * abs_sum


def _gamma(d: torch.Tensor) -> torch.Tensor:
    du = d * 2.0 ** -24
    return du / (1.0 - du).clamp(min=1e-12)


def launch_grid(n: int) -> tuple[int, int]:
    """(blocks, values a block) of the kernel: a function of n alone, so
    that the order of the sums, and so the result, does not depend on the
    card.  Chunks are whole multiples of 256 values."""
    n = max(n, 1)
    blocks = min(_MAX_BLOCKS, -(-n // _CHUNK))
    chunk = -(-n // blocks)
    chunk = -(-chunk // 256) * 256
    return -(-n // chunk), chunk


def _lib():
    lib = build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ll, vp, ci, vp, vp, vp, vp, vp, ci, ll, vp]
        fn.restype = ci
    return fn


def kmeans_assign_cuda(values: torch.Tensor, centers: torch.Tensor):
    """Launch the CUDA kernels on CUDA tensors; (idx, sums, counts).

    Raises on anything the kernel does not take (device, dtype, shape,
    k > MAX_K) and when a launch reports an error.  Non-contiguous inputs
    are copied to contiguous ones first.
    """
    if not (values.is_cuda and centers.is_cuda):
        raise ValueError("kmeans_assign_cuda takes CUDA tensors")
    _check(values, centers)
    k = centers.shape[0]
    if k > MAX_K:
        raise ValueError(f"{k} centers; the kernel holds at most {MAX_K} in "
                         "shared memory")
    v, c = values.contiguous(), centers.contiguous()
    n = v.shape[0]
    dev = v.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    sums = torch.empty(k, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    blocks, chunk = launch_grid(n)
    part_s = torch.empty((blocks, k), dtype=torch.float32, device=dev)
    part_c = torch.empty((blocks, k), dtype=torch.int32, device=dev)
    err = _lib()(v.data_ptr(), n, c.data_ptr(), k, idx.data_ptr(),
                 sums.data_ptr(), counts.data_ptr(), part_s.data_ptr(),
                 part_c.data_ptr(), blocks, chunk,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: cudaError "
                           f"{err}")
    kmeans_assign_cuda.launches += 1
    return idx, sums, counts


kmeans_assign_cuda.launches = 0

