"""Weight clustering (paper §2.2), the port's copy of the parts of
``repro/core/clustering.py`` that serving compression needs:
``assign_to_centers``, ``quantize_to_centers`` and the closed-form
Laplacian-L1 centers.  k-means and its random init come with training.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["laplacian_l1_levels", "laplacian_l1_centers",
           "assign_to_centers", "quantize_to_centers"]


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
