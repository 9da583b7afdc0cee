"""Integer-only inference (paper §4, Fig. 9), the port's copy of
``repro/core/fixedpoint.py``.

Everything at inference time is: table lookups, integer adds, one arithmetic
bit-shift per unit.  No multiplies, no floats, no non-linearity evaluation.

    acc[n]  = Σ_k  M[a_idx[k], w_idx[k, n]]  (+ M[bias_row, b_idx[n]])
    bin     = (acc >> s) + zero_offset        # arithmetic shift ≡ floor(x/Δx)
    a_idx'  = act_table[clip(bin)]            # next layer's row indices

The final (linear) layer stops at ``acc``; its float meaning is
``acc · Δx / 2^s`` (``LutTables.decode``), computed only by callers that
need float outputs, never by the engine itself.

With int32 tables (``acc_bits=32``) the contraction of ``int_linear`` is
``ops.lut_matmul``: the ``lut_matmul`` kernel for CUDA tensors, its plain
version for CPU tensors.  The tensors' device decides, as for every op of
the port; there is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.activations import ActQuantConfig
from repro_torch.core.lut import LutTables
from repro_torch.kernels import ops
from repro_torch.kernels.lut_matmul import wrap_int32

__all__ = [
    "input_to_indices",
    "int_linear",
    "acc_to_act_index",
    "int_mlp_forward",
]

_CUBE = 1 << 24             # elements of one gathered (M, kc, N) int64 chunk


def _jt(tables: LutTables, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Device copies of the integer tables: ``mult`` in its accumulator
    dtype (int32 or int64; torch needs no x64 switch) and ``act_table``
    in int32."""
    dt = torch.int32 if tables.acc_dtype == np.dtype(np.int32) else torch.int64
    mult = torch.from_numpy(np.ascontiguousarray(tables.mult)).to(device, dt)
    act = torch.from_numpy(np.ascontiguousarray(tables.act_table)).to(
        device, torch.int32)
    return mult, act


def input_to_indices(x: torch.Tensor, cfg: ActQuantConfig) -> torch.Tensor:
    """Quantize network *inputs* to activation-level indices (Table 1,
    "quantized inputs" columns: inputs share the activation level grid):
    ``round((clip(x, lo, hi) − lo) / step)`` in x's dtype, half to even,
    with ``lo``, ``hi`` and ``step`` rounded to x's dtype first, as the
    reference's weakly typed scalars are.  int32."""
    lo, hi = cfg.out_range

    def t(v):
        return torch.tensor(v, dtype=torch.float64).to(x.device, x.dtype)

    q = torch.round((torch.clamp(x, t(lo), t(hi)) - t(lo)) / t(cfg.step))
    return q.to(torch.int32)


def _int_linear(a_idx: torch.Tensor, w_idx: torch.Tensor,
                b_idx: torch.Tensor | None, mult: torch.Tensor,
                bias_row: int) -> torch.Tensor:
    """``int_linear`` on the device copy ``mult`` of the table."""
    K, N = w_idx.shape
    batch = a_idx.shape[:-1]
    a2 = a_idx.reshape(-1, K)
    if mult.dtype == torch.int32:
        a2 = a2.to(torch.int32).contiguous()
        w = w_idx if w_idx.dtype == torch.int16 else w_idx.to(torch.int32)
        acc = ops.lut_matmul(a2, w.contiguous(), mult)
        if b_idx is not None:
            acc = wrap_int32(acc.long() + mult[bias_row, b_idx.long()].long())
    else:
        # int64 tables: the reference's own gather-sum in int64 (lut_matmul
        # is int32 by contract), chunked over K
        n_cols = mult.shape[1]
        flat = mult.reshape(-1)
        a = a2.long() * n_cols
        w = w_idx.long()
        kc = max(1, min(K, _CUBE // max(a2.shape[0] * N, 1)))
        acc = torch.zeros((a2.shape[0], N), dtype=torch.int64,
                          device=a2.device)
        for k0 in range(0, K, kc):
            acc += flat[a[:, k0:k0 + kc, None] + w[None, k0:k0 + kc, :]].sum(
                dim=1)
        if b_idx is not None:
            acc = acc + mult[bias_row, b_idx.long()]
    return acc.reshape(*batch, N)


def int_linear(a_idx: torch.Tensor, w_idx: torch.Tensor,
               b_idx: torch.Tensor | None, tables: LutTables) -> torch.Tensor:
    """acc[..., n] = Σ_k M[a_idx[..., k], w_idx[k, n]] (+ bias row lookup).

    a_idx: (..., K) activation-level indices (the bias row allowed).
    w_idx: (K, N) codebook indices in [0, |W|] (int16 or int32; others
           are taken as int32).
    b_idx: (N,) codebook indices of the biases, or None.
    Returns the accumulators in the tables' dtype.

    int32 tables: one ``ops.lut_matmul`` over (M, K) × (K, N), M the
    flattened batch, then the bias lookup, both in wrapping int32.  The
    reference pads K to a multiple of its ``k_chunk`` with (bias_row,
    identity_col) terms and subtracts them afterwards; in wrapping int32
    the unpadded sum is the same.  int64 tables (``acc_bits=64``): the
    ``lut_matmul`` kernel takes int32 tables only, as the reference's
    Pallas kernel does, so the sum is a plain int64 gather over K chunks
    on either device, the reference's own arithmetic (not a fallback from
    the kernel: the table's dtype picks it before any launch).
    """
    mult, _ = _jt(tables, a_idx.device)
    return _int_linear(a_idx, w_idx, b_idx, mult, tables.bias_row)


def _acc_to_act_index(acc: torch.Tensor, act_table: torch.Tensor,
                      tables: LutTables) -> torch.Tensor:
    bins = torch.bitwise_right_shift(acc, tables.s)    # arithmetic: signed
    # the reference's astype(int32) wraps an int64 shift; + zero_offset in
    # wrapping int32
    bins = wrap_int32(wrap_int32(bins.long()).long() + tables.zero_offset)
    bins = torch.clamp(bins, 0, tables.act_table.shape[0] - 1)
    return act_table[bins.long()]


def acc_to_act_index(acc: torch.Tensor, tables: LutTables) -> torch.Tensor:
    """Bit-shift + activation-table lookup (Fig. 9): accumulator -> next
    layer's activation-level row index (int32)."""
    _, act_table = _jt(tables, acc.device)
    return _acc_to_act_index(acc, act_table, tables)


def int_mlp_forward(layers, x_idx: torch.Tensor, tables: LutTables,
                    final_linear: bool = True) -> torch.Tensor:
    """Run a whole MLP with the integer engine.

    layers: sequence of (w_idx (K,N), b_idx (N,) | None).
    x_idx:  (..., K0) activation-level indices of the (quantized) inputs.
    Returns the final layer's raw integer accumulators if final_linear
    (regression / logits), else the final activation indices.
    """
    mult, act_table = _jt(tables, x_idx.device)
    a = x_idx
    for li, (w_idx, b_idx) in enumerate(layers):
        acc = _int_linear(a, w_idx, b_idx, mult, tables.bias_row)
        if li == len(layers) - 1 and final_linear:
            return acc
        a = _acc_to_act_index(acc, act_table, tables)
    return a
