"""kmeans_assign: one Lloyd step of 1-D k-means (paper §2.2) — each value's
center (``searchsorted`` over the midpoints, side right) and the per-center
sums and counts.

Replaces ``repro/kernels/kmeans1d.py::kmeans_assign_kernel`` (the Pallas TPU
kernel, reached through ``kmeans_assign_pallas``).  The CUDA kernel is
``csrc/kmeans_assign.cu``; its header says what bounds it on the card (8
bytes a value in the full form: the value read, its index written; 4 in
the sums-only form), how its bucketed search finds the same index as a
search over every midpoint, and how it sums in 64-bit fixed point with
integer atomics, so that a Lloyd step gives the same codebook every run.

``kmeans_assign_plain`` is the same function in plain PyTorch (the CPU
path, and what ``chip_smoke.py`` holds the kernel against on the card):
``searchsorted``, ``index_add_`` and ``bincount``.  ``idx`` and ``counts``
of the two are equal; ``sums`` add in other ways, and each is held to the
f64 sum (``exact_sums``): the plain version's running sums within their
worst-case bound (``sums_bound``), the kernel's within ``sums_tolerance``
(the contract, kept from the summation tree it was set for) and within
``fixed_point_bound`` (the bound of its own fixed-point arithmetic).
``bucket_table``, ``bucketed_search`` and ``fixed_point_sums`` repeat the
kernel's own arithmetic in plain PyTorch, for the tests.

``kmeans_assign_cuda`` launches the kernel (full form: idx, sums,
counts); ``kmeans_stats_cuda`` launches its sums-only form, which the
Lloyd loop takes; ``kmeans_search_cuda`` the search alone, for timing.
All three count in ``kmeans_assign_cuda.launches`` and are never replaced
by the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["kmeans_assign_plain", "kmeans_stats_plain", "kmeans_assign_cuda",
           "kmeans_stats_cuda", "kmeans_search_cuda", "finite_extremes",
           "exact_sums",
           "sums_bound", "sums_tolerance", "fixed_point_bound",
           "launch_grid", "bucket_table", "bucketed_search",
           "fixed_point_sums", "MAX_K", "BUCKETS"]

MAX_K = 4096                 # centers the kernel holds in shared memory
_CHUNK = 16384               # values a block takes, at least
_MAX_BLOCKS = 2640           # 132 SMs x 5 resident blocks at k = 1000, x 4
_TOL_CHUNK = 1 << 26         # values per chunk of exact_sums
BUCKETS = 8192               # the kernel's search buckets, half a sign
_OCTAVES = 16                # of |v| below the largest |midpoint|
_SHIFT = 15                  # 2^(23 − _SHIFT) = 256 buckets an octave
_MODES = {"full": 0, "stats": 1, "search": 2}


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


def kmeans_stats_plain(values: torch.Tensor, centers: torch.Tensor):
    """(sums, counts) of ``kmeans_assign_plain``."""
    return kmeans_assign_plain(values, centers)[1:]


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
    estimate 2⁻²⁴·√d·Σ|v| of an f32 summation tree, or its worst-case
    bound γ_d·Σ|v| where that is tighter (short chains), with d = 31 + one
    a warp iteration + 8 + blocks, at most n_c: the tree of the kernel
    this limit was set for (lanes, warps, blocks), kept as the contract.
    At the full model's n (d = 5226) that is 6.9·10⁻⁵ of a cluster's
    Σ|v|, against 3.1·10⁻⁴ for the worst-case bound: a kernel that loses
    or adds twice that share of a cluster's values goes past it.

    The kernel now sums in fixed point (``fixed_point_sums``), with no
    tree: its own arithmetic's limit is ``fixed_point_bound``, which the
    kernel is held to as well; at the full n it is nearly 10³ times
    tighter than this one."""
    blocks, chunk = launch_grid(n)
    depth = 31 + -(-chunk // 256) + 8 + blocks
    d = torch.clamp(n_c, max=float(depth))
    return torch.minimum(16 * 2.0 ** -24 * d.sqrt(), _gamma(d)) * abs_sum


def _gamma(d: torch.Tensor, unit: float = 2.0 ** -24) -> torch.Tensor:
    du = d * unit
    return du / (1.0 - du).clamp(min=1e-12)


def fixed_point_bound(exact: torch.Tensor, abs_sum: torch.Tensor,
                      n_c: torch.Tensor, centers: torch.Tensor, extremes,
                      n: int) -> torch.Tensor:
    """(k,) limit on |kernel sums − exact sums| from the kernel's own
    arithmetic (``fixed_point_sums``): each of a center's n_c values
    rounded to the nearest multiple of 1/scale (half of it at most, so
    2^−(63 − L) of the largest |v| the center can hold, n < 2^L), the
    integer sum exact, then one f32 rounding (2⁻²⁴ of its size); plus the
    error of the f64 yardstick ``exact_sums`` itself (running sums,
    γ₅₃(n_c)·Σ|v|).  ``extremes`` are those the kernel was given."""
    scale = _fixed_point_scale(centers, extremes, n).double()
    e = n_c * 0.5 / scale
    return (e + 2.0 ** -24 * (exact.abs() + e) + 2.0 ** -149
            + _gamma(n_c, 2.0 ** -53) * abs_sum)


def launch_grid(n: int) -> tuple[int, int]:
    """(blocks, values a block) of the kernel: a function of n alone, so
    that the order of the sums, and so the result, does not depend on the
    card.  Chunks are whole multiples of 256 values."""
    n = max(n, 1)
    blocks = min(_MAX_BLOCKS, -(-n // _CHUNK))
    chunk = -(-n // blocks)
    chunk = -(-chunk // 256) * 256
    return -(-n // chunk), chunk


def _midpoints(centers: torch.Tensor) -> torch.Tensor:
    return ((centers[:-1] + centers[1:]) / 2.0).contiguous()


def _bucket_base(centers: torch.Tensor) -> int:
    """f32 bits of |v| at the first bucket: ``_OCTAVES`` octaves below
    the power of two above the largest |midpoint|."""
    m = _midpoints(centers)
    ex = 0
    if m.numel():
        hi = torch.maximum(m[0].abs(), m[-1].abs())
        if bool(hi > 0) and bool(torch.isfinite(hi)):
            ex = int(torch.frexp(hi).exponent)
    return (min(max(ex + 127, _OCTAVES), 255) - _OCTAVES) << 23


def _bucket(v: torch.Tensor, base: int) -> torch.Tensor:
    """The kernel's bucket of each value: the exponent and top mantissa
    bits of |v| clamped into the ``_OCTAVES`` octaves above ``base``,
    mirrored for negative v (−0 counts as +0); never decreasing as v
    grows."""
    u = (v + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    a = (u & 0x7FFFFFFF).clamp(base, base + (_OCTAVES << 23) - 1)
    g = (a - base) >> _SHIFT
    half = BUCKETS // 2
    return torch.where(u >= 1 << 31, half - 1 - g, half + g)


def bucket_table(centers: torch.Tensor) -> torch.Tensor:
    """(BUCKETS + 1,) int64: entry b is the number of midpoints whose
    bucket lies below b, so a value of bucket b has its index in
    [table[b], table[b + 1]] (the kernel's prologue)."""
    b = _bucket(_midpoints(centers), _bucket_base(centers))
    return torch.searchsorted(b, torch.arange(BUCKETS + 1,
                                              device=centers.device))


def bucketed_search(values: torch.Tensor, centers: torch.Tensor
                    ) -> torch.Tensor:
    """int32 indices as the kernel finds them: the value's bucket range,
    then a binary search over that range alone with the compare
    ``bounds[j] <= v``, of the depth of the longest range."""
    bounds = _midpoints(centers)
    table = bucket_table(centers)
    b = _bucket(values, _bucket_base(centers))
    pos = table[b]
    n_left = table[b + 1] - pos
    longest = int((table[1:] - table[:-1]).max())
    st = 1 << (longest.bit_length() - 1) if longest else 0
    while st:
        live = st <= n_left
        j = (pos + st - 1).clamp(max=bounds.numel() - 1)
        ge = live & (bounds[j] <= values)
        pos = torch.where(ge, pos + st, pos)
        n_left = torch.where(live, torch.where(ge, n_left - st, st - 1),
                             n_left)
        st >>= 1
    return pos.to(torch.int32)


def _fixed_point_scale(centers: torch.Tensor, extremes, n: int
                       ) -> torch.Tensor:
    """(k,) f32 power-of-two scales 2^e, |v|·2^e < 2^(62 − L) for every
    |v| a center can hold (n < 2^L): between its midpoints, or between an
    extreme and the first or last midpoint (the kernel's prologue)."""
    dev = centers.device
    lo, hi = (float(x) for x in extremes)
    mids = _midpoints(centers)
    below = torch.cat([torch.tensor([lo], device=dev), mids])
    above = torch.cat([mids, torch.tensor([hi], device=dev)])
    top = torch.maximum(below.abs(), above.abs()).to(torch.float32)
    _, ex = torch.frexp(top)
    ex = torch.where((top > 0) & torch.isfinite(top), ex,
                     torch.zeros_like(ex))
    room = 62 - max(n.bit_length(), 1)
    return torch.ldexp(torch.ones_like(top), (room - ex).clamp(-126, 126))


def fixed_point_sums(values: torch.Tensor, idx: torch.Tensor,
                     centers: torch.Tensor, extremes) -> torch.Tensor:
    """(k,) f32 sums as the kernel adds them: each finite value times its
    center's power-of-two scale 2^e (|v|·2^e < 2^(62 − L) for every |v|
    the center can hold, between its midpoints or between ``extremes``
    (lo, hi) and the first or last midpoint, where n < 2^L), rounded to an
    integer, the integers added exactly, the sum rounded to f32 once and
    divided by the scale; NaN where a center holds a NaN or both
    infinities, else the infinity it holds."""
    k = centers.numel()
    dev = centers.device
    scale = _fixed_point_scale(centers, extremes, values.numel())
    i = idx.long()
    fin = torch.isfinite(values)
    q = torch.round(torch.where(fin, values, 0.0) * scale[i]).to(torch.int64)
    total = torch.zeros(k, dtype=torch.int64,
                        device=values.device).index_add_(0, i, q)
    sums = total.to(torch.float32) * (1.0 / scale)

    def holds(mask):
        return torch.zeros(k, dtype=torch.bool, device=dev).index_put_(
            (i[mask],), torch.ones((), dtype=torch.bool, device=dev))
    pos, neg = holds(values == float("inf")), holds(values == -float("inf"))
    nan = holds(torch.isnan(values)) | (pos & neg)
    sums = torch.where(pos, float("inf"), sums)
    sums = torch.where(neg, -float("inf"), sums)
    return torch.where(nan, float("nan"), sums)


def _lib():
    lib = build.load("kmeans_assign")
    fn = lib.kmeans_assign_launch
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp, ll, vp, ci, vp, ci, vp, vp, vp, vp, vp, ci, ll,
                       vp]
        fn.restype = ci
        lib.kmeans_assign_scratch_bytes.argtypes = [ci]
        lib.kmeans_assign_scratch_bytes.restype = ll
    return lib


def _launch(values: torch.Tensor, centers: torch.Tensor, extremes,
            form: str):
    if not (values.is_cuda and centers.is_cuda):
        raise ValueError("kmeans_assign_cuda takes CUDA tensors")
    _check(values, centers)
    k = centers.shape[0]
    if k > MAX_K:
        raise ValueError(f"{k} centers; the kernel holds at most {MAX_K} in "
                         "shared memory")
    v, c = values.contiguous(), centers.contiguous()
    if v.data_ptr() % 16:
        v = v.clone()                 # the kernel loads 16-byte vectors
    n = v.shape[0]
    if n >= 1 << 32:
        raise ValueError(f"{n} values; the kernel's 64-bit fixed-point sums "
                         "take fewer than 2^32")
    dev = v.device
    if extremes is None:
        extremes = finite_extremes(v) if form != "search" \
            else torch.zeros(2, device=dev)
    ext = torch.as_tensor(extremes, dtype=torch.float32,
                          device=dev).reshape(2)
    mode = _MODES[form]
    idx = torch.empty(n if mode != 1 else 0, dtype=torch.int32, device=dev)
    sums = torch.empty(k, dtype=torch.float32, device=dev)
    counts = torch.empty(k, dtype=torch.float32, device=dev)
    fault = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _lib()
    scratch = torch.empty(lib.kmeans_assign_scratch_bytes(k),
                          dtype=torch.uint8, device=dev)
    blocks, chunk = launch_grid(n)
    err = lib.kmeans_assign_launch(
        v.data_ptr(), n, c.data_ptr(), k, ext.data_ptr(), mode,
        idx.data_ptr(), sums.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), fault.data_ptr(), blocks, chunk,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_assign kernel launch failed: cudaError "
                           f"{err}")
    kmeans_assign_cuda.launches += 1
    if mode != 2 and int(fault.item()):
        raise ValueError("kmeans_assign: a finite value lies beyond the "
                         "extremes its center's fixed-point sum was scaled "
                         "for, and that sum could have overflowed")
    return idx, sums, counts


def finite_extremes(values: torch.Tensor) -> torch.Tensor:
    """(2,) f32 on the values' device: the smallest and largest finite
    value (0, 0 when there is none), the ``extremes`` the kernel scales
    its sums for."""
    ext = torch.stack(torch.aminmax(values)) if values.numel() else \
        torch.zeros(2, device=values.device)
    if not bool(torch.isfinite(ext).all()):
        fin = values[torch.isfinite(values)]
        ext = torch.stack(torch.aminmax(fin)) if fin.numel() else \
            torch.zeros(2, device=values.device)
    return ext


def kmeans_assign_cuda(values: torch.Tensor, centers: torch.Tensor):
    """Launch the CUDA kernel's full form on CUDA tensors; (idx, sums,
    counts).

    The wrapper reads the extremes the sums are scaled for with one
    ``aminmax`` pass (``finite_extremes``) and, after the launch, the
    kernel's overflow flag (one sync).  Raises on anything the kernel does
    not take (device, dtype, shape, k > MAX_K, n ≥ 2³²) and when a launch
    reports an error.  Non-contiguous or unaligned inputs are copied first.
    """
    return _launch(values, centers, None, "full")


def kmeans_stats_cuda(values: torch.Tensor, centers: torch.Tensor,
                      extremes=None):
    """(sums, counts) of the kernel's sums-only form, which writes no
    index: bit-identical to those of ``kmeans_assign_cuda``.

    ``extremes`` (lo, hi), a pair of floats or a (2,) tensor on the card,
    spare the ``aminmax`` pass when the caller has them.  A finite value
    beyond them is caught where it could overflow its center's sum: the
    kernel flags it and the call raises ValueError."""
    return _launch(values, centers, extremes, "stats")[1:]


def kmeans_search_cuda(values: torch.Tensor, centers: torch.Tensor):
    """The indices of the kernel's search alone, no sums (for timing what
    the search costs)."""
    return _launch(values, centers, None, "search")[0]


kmeans_assign_cuda.launches = 0
