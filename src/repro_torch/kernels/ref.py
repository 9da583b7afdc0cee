"""Plain-torch oracles, the port's copy of ``repro/kernels/ref.py``.
Deliberately naive: clarity over speed."""

from __future__ import annotations

import torch

from repro_torch.kernels.kmeans1d import kmeans_assign_plain
from repro_torch.kernels.lut_matmul import wrap_int32

__all__ = ["codebook_matmul_ref", "lut_matmul_ref", "act_quant_ref",
           "kmeans_assign_ref"]


def codebook_matmul_ref(x: torch.Tensor, w_idx: torch.Tensor,
                        codebook: torch.Tensor) -> torch.Tensor:
    """out = x @ codebook[w_idx] — dequantize-then-matmul ground truth.

    x: (M, K) float; w_idx: (K, N) int; codebook: (W,) float. out: (M, N) f32.
    Negative ids wrap, as numpy-style indexing does.
    """
    w = codebook[w_idx.long()].to(x.dtype)
    return x.to(torch.float32) @ w.to(torch.float32)


def lut_matmul_ref(a_idx: torch.Tensor, w_idx: torch.Tensor,
                   table: torch.Tensor) -> torch.Tensor:
    """acc[m, n] = Σ_k table[a_idx[m, k], w_idx[k, n]] (paper §4 engine),
    summed in int32 with wrap-around as the JAX oracle sums.

    a_idx: (M, K) int32; w_idx: (K, N) int32; table: (R, C) int32.
    """
    flat = table.reshape(-1)
    n_cols = table.shape[1]
    addr = a_idx.long()[:, :, None] * n_cols + w_idx.long()[None, :, :]
    return wrap_int32(flat[addr].sum(dim=1, dtype=torch.int64))


def act_quant_ref(x: torch.Tensor, kind: str, levels: int) -> torch.Tensor:
    """Quantized activation values (forward semantics only): the oracle
    *is* ``act_apply``, as in the reference."""
    from repro_torch.core.activations import ActQuantConfig, act_apply
    return act_apply(ActQuantConfig(kind, levels), x)


# (assignment, per-center sum, per-center count) for sorted centers: the
# oracle *is* the plain version, ``searchsorted`` over the midpoints, then
# f32 segment sums and integer counts.
kmeans_assign_ref = kmeans_assign_plain
