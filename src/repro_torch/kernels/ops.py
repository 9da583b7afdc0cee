"""Public ops of the kernels package, routed by the device of their operands.

A CUDA tensor goes to the hand-written kernel (``*_cuda``), which launches
or raises; a CPU tensor goes to the plain PyTorch version (``*_plain``).
There is no fallback from one to the other.  Each CUDA wrapper counts its
launches in a ``launches`` attribute (``launch_counts`` reads them all).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import act_quant as _aq
from repro_torch.kernels import codebook_matmul as _cm
from repro_torch.kernels import kmeans1d as _km
from repro_torch.kernels import lut_matmul as _lm
from repro_torch.kernels import page_gather as _pg

__all__ = ["codebook_matmul", "codebook_swiglu", "lut_matmul", "gather_pages",
           "gather_pages_many", "act_quant", "act_quant_index",
           "act_apply_quant", "kmeans_assign", "kmeans_stats",
           "launch_counts", "reset_launch_counts", "KERNELS"]

KERNELS = {"codebook_matmul": _cm.codebook_matmul_cuda,
           "codebook_swiglu": _cm.codebook_swiglu_cuda,
           "lut_matmul": _lm.lut_matmul_cuda,
           "page_gather": _pg.page_gather_cuda,
           "act_quant": _aq.act_quant_cuda,
           "kmeans_assign": _km.kmeans_assign_cuda}


def _route(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "cpu"
    raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


def codebook_matmul(x, w_idx, codebook):
    """(M, N) f32 = x @ codebook[w_idx], each weight rounded to x.dtype."""
    if _route(x, w_idx, codebook) == "cuda":
        return _cm.codebook_matmul_cuda(x, w_idx, codebook)
    return _cm.codebook_matmul_plain(x, w_idx, codebook)


def codebook_swiglu(x, w1_idx, book1, w3_idx, book3, kind: str,
                    levels: int):
    """(M, N) in x.dtype: ``act_q(T(x @ book1[w1_idx])) * T(x @ book3[
    w3_idx])``, T = x.dtype, act_q the quantized activation's act_apply
    form: a SwiGLU FFN's gate and up products and its activation, one
    kernel launch on the card."""
    if _route(x, w1_idx, book1, w3_idx, book3) == "cuda":
        return _cm.codebook_swiglu_cuda(x, w1_idx, book1, w3_idx, book3,
                                        kind, levels)
    return _cm.codebook_swiglu_plain(x, w1_idx, book1, w3_idx, book3, kind,
                                     levels)


def lut_matmul(a_idx, w_idx, table):
    """(M, N) int32 accumulators of the §4 engine (wrapping adds)."""
    if _route(a_idx, w_idx, table) == "cuda":
        return _lm.lut_matmul_cuda(a_idx, w_idx, table)
    return _lm.lut_matmul_plain(a_idx, w_idx, table)


def gather_pages(pool, page_table):
    """out[b, p] = pool[page_table[b, p]], ids clamped into the pool: the
    paged KV cache's gather.  pool: (n_pages, page, *rest); page_table:
    (B, P) int.  Returns (B, P, page, *rest)."""
    if _route(pool, page_table) == "cuda":
        return _pg.page_gather_cuda(pool, page_table)
    return _pg.page_gather_plain(pool, page_table)


def gather_pages_many(pools, page_table):
    """``[gather_pages(pool, page_table) for pool in pools]``: up to four
    pools that share one page table (a paged layer's K, V and their
    scales), one kernel launch on the card."""
    if _route(page_table, *pools) == "cuda":
        return _pg.page_gather_many_cuda(pools, page_table)
    return _pg.page_gather_many_plain(pools, page_table)


def _act_quant(x, kind: str, levels: int, form: str, with_index: bool,
               mul=None):
    operands = (x,) if mul is None else (x, mul)
    fn = (_aq.act_quant_cuda if _route(*operands) == "cuda"
          else _aq.act_quant_plain)
    return fn(x, kind, levels, form=form, with_index=with_index, mul=mul)


class _ActQuant(torch.autograd.Function):
    """Forward: the kernel form of ``act_quant``.  Backward: the derivative
    of the underlying (unquantized) nonlinearity (paper §2.1), computed in
    x's dtype as ``repro/kernels/ops.py::_aq_bwd`` computes it — plain
    PyTorch there as here (it is jnp, not a Pallas kernel)."""

    @staticmethod
    def forward(ctx, x, kind, levels):
        ctx.save_for_backward(x)
        ctx.kind = kind
        return _act_quant(x.detach(), kind, levels, "kernel", False)[0]

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        kind = ctx.kind
        if kind == "tanh":
            d = 1.0 - torch.tanh(x) ** 2
        elif kind == "relu6":
            d = ((x > 0.0) & (x < 6.0)).to(g.dtype)
        elif kind == "sigmoid":
            s = torch.sigmoid(x)
            d = s * (1.0 - s)
        elif kind == "rtanh":
            d = torch.where(x > 0.0, 1.0 - torch.tanh(x) ** 2,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        else:
            raise ValueError(kind)
        return (g * d).to(x.dtype), None, None


def act_quant(x, kind: str, levels: int):
    """f(x) snapped to ``levels`` levels (the Pallas kernel's arithmetic),
    with the underlying function's derivative as its gradient."""
    return _ActQuant.apply(x, kind, levels)


def act_quant_index(x, kind: str, levels: int):
    """Level indices only (int32; no gradient path)."""
    return _act_quant(x.detach(), kind, levels, "kernel", True)[1]


def act_apply_quant(x, kind: str, levels: int, with_index: bool = False,
                    mul=None):
    """(y, int32 index or None) in the ``act_apply`` form: what
    ``core.activations.act_apply`` and ``act_index`` compute; with ``mul``
    (x's shape and dtype), y is that times ``mul`` in x's dtype, in the
    same launch."""
    return _act_quant(x, kind, levels, "act_apply", with_index, mul)


def kmeans_assign(values, centers):
    """(assignment idx int32, per-center sums f32, per-center counts f32)
    of ``values`` (flattened, as f32) to the sorted ``centers``."""
    v = values.reshape(-1).to(torch.float32)
    c = centers.to(torch.float32)
    if _route(v, c) == "cuda":
        return _km.kmeans_assign_cuda(v, c)
    return _km.kmeans_assign_plain(v, c)


def kmeans_stats(values, centers, extremes=None):
    """(sums, counts) of ``kmeans_assign``: what a Lloyd step reads, from
    the kernel's sums-only form, which writes no index.  ``extremes``
    (lo, hi), the smallest and largest finite value, spare the kernel a
    pass to find them; the plain version does not need them."""
    v = values.reshape(-1).to(torch.float32)
    c = centers.to(torch.float32)
    if _route(v, c) == "cuda":
        return _km.kmeans_stats_cuda(v, c, extremes)
    return _km.kmeans_stats_plain(v, c)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
