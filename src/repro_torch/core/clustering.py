"""Weight clustering (paper §2.2), the port's copy of
``repro/core/clustering.py``: the three ways to pick the |W| centers
(``kmeans1d``, the paper's default; the closed-form ``laplacian_l1``;
``uniform``), ``assign_to_centers`` and ``quantize_to_centers``.

``kmeans1d`` runs each Lloyd step through ``ops.kmeans_stats`` (the
``kmeans_assign`` kernel's sums-only form for CUDA tensors).
``subsample`` draws from a ``torch.Generator``: its draws cannot be the
reference's ``jax.random`` ones, only their number and kind.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = ["kmeans1d", "laplacian_l1_levels", "laplacian_l1_centers",
           "uniform_centers", "assign_to_centers", "quantize_to_centers",
           "quantile_f32", "quantization_mse", "subsample"]

_MSE_CHUNK = 1 << 26          # values per chunk of the final MSE pass


def assign_to_centers(values: torch.Tensor,
                      centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center index (int32) for each value; ``centers`` sorted.

    The midpoint-boundary trick: nearest-center regions in 1-D are the
    intervals between adjacent-center midpoints, so a right-sided
    ``searchsorted`` over the |W|−1 midpoints gives the argmin.
    """
    boundaries = ((centers[:-1] + centers[1:]) / 2.0).contiguous()
    return torch.searchsorted(boundaries,
                              values.to(boundaries.dtype).contiguous(),
                              right=True, out_int32=True)


def quantize_to_centers(values: torch.Tensor,
                        centers: torch.Tensor) -> torch.Tensor:
    """Replace each value with its assigned (sorted) center's value."""
    idx = assign_to_centers(values, centers)
    return centers[idx.long()].to(values.dtype)


def subsample(values: torch.Tensor, fraction: float,
              generator: torch.Generator) -> torch.Tensor:
    """Random subsample (paper §3.3: 2 % of AlexNet's weights for k-means):
    m = max(1, int(n·fraction)) draws with replacement, as the reference
    draws them, from ``generator`` (on values' device)."""
    n = values.shape[0]
    m = max(1, int(n * fraction))
    idx = torch.randint(0, n, (m,), generator=generator,
                        device=values.device)
    return values[idx]


def laplacian_l1_levels(n_centers: int) -> np.ndarray:
    """Normalized positive levels L_0..L_m for the L1-optimal Laplacian grid.

    Odd N:  centers at {0, ±L_1 .. ±L_m}, m=(N−1)/2, with exp(−L_i)=1−2i/N.
    Even N: centers at {±L_1 .. ±L_m}, m=N/2, with exp(−L_i)=1−(2i−1)/N.
    Returned array is the positive half including L_0=0 for odd N.
    """
    if n_centers < 1:
        raise ValueError("need at least one center")
    n = n_centers
    if n % 2 == 1:
        i = np.arange(0, (n - 1) // 2 + 1, dtype=np.float64)
        tail = 1.0 - 2.0 * i / n
    else:
        i = np.arange(1, n // 2 + 1, dtype=np.float64)
        tail = 1.0 - (2.0 * i - 1.0) / n
    return -np.log(np.maximum(tail, 1e-300))


def laplacian_l1_centers(values: torch.Tensor, n_centers: int,
                         nudge: bool = True) -> torch.Tensor:
    """Closed-form centers ``a ± b·L_i`` fitted to ``values`` (paper §2.2).

    ``a`` is the mean; ``b`` starts at ``W_max / L_max`` and is nudged
    outward early in training (``W_max < 0.5``) and inward late
    (``W_max > 1.25``), as ``repro.core.clustering`` does.  Returns the
    sorted f32 centers on ``values``' device.
    """
    v = values.reshape(-1).to(torch.float32)
    levels = torch.as_tensor(laplacian_l1_levels(n_centers),
                             dtype=torch.float32, device=v.device)
    lv = levels.cpu()
    l_max = float(lv[-1])
    d_max = float(lv[-1] - lv[-2]) if lv.shape[0] > 1 else 1.0

    a = torch.mean(v)
    w_max = torch.clamp(torch.max(torch.abs(v - a)), min=1e-12)
    b = w_max / l_max
    if nudge:
        out = b * (1.0 + d_max / (2.0 * torch.clamp(1.0 - w_max, min=1e-6)
                                  * l_max))
        inw = b * (1.0 - d_max / (4.0 * l_max))
        b = torch.where(w_max < 0.5, out, torch.where(w_max > 1.25, inw, b))

    pos = a + b * levels
    neg = a - b * (levels[1:] if n_centers % 2 == 1 else levels)
    return torch.sort(torch.cat([neg, pos])).values


def uniform_centers(values: torch.Tensor, n_centers: int) -> torch.Tensor:
    """Equally-spaced centers between min and max (Lin et al. baseline).

    ``t`` is ``jnp.linspace(0, 1, n)`` as XLA compiles it: ``i·r`` with
    ``r`` the f32 reciprocal of ``n − 1`` (XLA turns a division by a
    constant into that product), the last entry exactly 1; then ``lo +
    t·(hi − lo)`` rounded op by op, as the reference runs it eagerly.
    """
    v = values.reshape(-1).to(torch.float32)
    lo, hi = torch.min(v), torch.max(v)
    f32, dev = torch.float32, v.device
    if n_centers > 1:
        t = torch.cat([torch.arange(n_centers - 1, dtype=f32, device=dev)
                       * _f32_reciprocal(n_centers - 1, dev),
                       torch.ones(1, dtype=f32, device=dev)])
    else:
        t = torch.zeros(n_centers, dtype=f32, device=dev)
    return lo + t * (hi - lo)


def _f32_reciprocal(n: int, device) -> torch.Tensor:
    """1/n rounded to f32, as XLA folds a division by the constant n."""
    return (torch.tensor(1.0) / torch.tensor(float(n))).to(device)


def quantile_f32(sorted_v: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """``jnp.quantile(v, qs)`` (method 'linear') of the sorted f32 values.

    As JAX computes it: the position ``q·(n − 1)`` in f32 (above 2²⁴
    values ``n`` and the position are rounded), its floor and ceiling
    clamped to the array, and ``low·(1 − w) + high·w`` in f32, with the
    second product and the sum fused into one rounding as XLA compiles it
    (emulated in f64).  ``torch.quantile`` would refuse more than 2²⁴
    values.
    """
    n = sorted_v.shape[0]
    f32 = torch.float32
    n_f = torch.tensor(n, dtype=f32, device=qs.device)
    pos = qs.to(f32) * (n_f - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = torch.clamp(low, 0.0, n_f - 1.0).to(torch.int64)
    high = torch.clamp(high, 0.0, n_f - 1.0).to(torch.int64)
    f64 = torch.float64
    return (sorted_v[high].to(f64) * hw.to(f64)
            + (sorted_v[low] * lw).to(f64)).to(f32)


def quantization_mse(v: torch.Tensor, centers: torch.Tensor) -> float:
    """Mean squared quantization error, f32 errors summed in f64 by chunk
    (the full model's 1.7·10⁹ values would not fit three times over)."""
    total = 0.0
    for part in v.split(_MSE_CHUNK):
        d = centers[assign_to_centers(part, centers).long()] - part
        total += float(torch.sum(d * d, dtype=torch.float64))
    return total / max(v.shape[0], 1)


def kmeans1d(values: torch.Tensor, k: int, iters: int = 50) -> torch.Tensor:
    """1-D k-means over ``values`` (flattened).  Returns sorted f32 centers.

    Lloyd from the reference's two deterministic inits, the data quantiles
    at ``(i + 0.5)/k`` (the division as XLA compiles it, a product with
    the f32 reciprocal of k) and a uniform min..max grid, ``iters`` steps
    each; the candidate with the lower MSE wins, the first on a tie (as
    ``jnp.argmin``).  Empty clusters keep their previous center.  Each
    step is one ``ops.kmeans_stats`` (the kernel's sums-only form, given
    the extreme values), so a clustering event launches the kernel
    ``2 · iters`` times.  The candidates run one after the other
    (the reference's ``vmap`` is not a semantic).
    """
    v = values.reshape(-1).to(torch.float32)
    f32, dev = torch.float32, v.device
    qs = (torch.arange(k, dtype=f32, device=dev) + 0.5) * _f32_reciprocal(
        k, dev)
    sorted_v = torch.sort(v).values          # the int64 indices go at once
    init_q = quantile_f32(sorted_v, qs)
    lo, hi = sorted_v[0].clone(), sorted_v[-1].clone()
    del sorted_v
    init_u = lo + (hi - lo) * qs
    extremes = torch.stack([lo, hi])

    best, best_mse = None, None
    for centers in (init_q, init_u):
        for _ in range(iters):
            sums, counts = ops.kmeans_stats(v, centers, extremes)
            new = torch.where(counts > 0,
                              sums / torch.clamp(counts, min=1.0), centers)
            centers = torch.sort(new).values
        mse = quantization_mse(v, centers)
        if best is None or mse < best_mse:
            best, best_mse = centers, mse
    return best
