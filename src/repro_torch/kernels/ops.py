"""Public ops of the kernels package, routed by the device of their operands.

A CUDA tensor goes to the hand-written kernel (``*_cuda``), which launches
or raises; a CPU tensor goes to the plain PyTorch version (``*_plain``).
There is no fallback from one to the other.  Each CUDA wrapper counts its
launches in a ``launches`` attribute (``launch_counts`` reads them all).

Gradients are those of ``repro/kernels/ops.py`` and of what JAX
differentiates through ``repro/core/activations.act_apply``: ``act_quant``
and ``act_apply_quant`` (with and without ``mul``) pass the underlying
function's derivative, ``codebook_matmul`` has ``_cm_bwd``'s.  The
backward passes are plain PyTorch, as the reference computes them in jnp.
``codebook_swiglu``, ``lut_matmul``, the page gathers, ``act_quant_index``
and the k-means ops have no gradient in the reference: they refuse an
operand that requires grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import act_quant as _aq
from repro_torch.kernels._common import canonical_idx
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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _refuse_grad(name: str, *tensors) -> None:
    """The reference defines no gradient for ``name``: refuse an operand
    that requires one rather than return a result autograd cannot see
    through."""
    if _needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no gradient (the JAX package defines none): call "
            "it under torch.no_grad or on tensors that do not require grad")


def _codebook_matmul(x, w_idx, codebook):
    if _route(x, w_idx, codebook) == "cuda":
        return _cm.codebook_matmul_cuda(x, w_idx, codebook)
    return _cm.codebook_matmul_plain(x, w_idx, codebook)


class _CodebookMatmul(torch.autograd.Function):
    """Forward: the kernel (the plain version on the CPU).  Backward:
    ``repro/kernels/ops.py::_cm_bwd`` — ``dx = g @ codebook[w_idx].T`` in
    x's dtype (the weights as g's dtype, not rounded to x's), and the
    codebook's gradient a scatter-add of ``xᵀg`` (f32) over the raw int32
    ids into ``codebook.shape[0]`` segments.  ``jax.ops.segment_sum``
    drops ids outside [0, |W|), so a negative narrow id (an id ≥ 2^(bits −
    1) of int8/int16 storage) adds nothing there, while the forward and
    ``dx`` wrap it; the port does the same.  The ids get no gradient."""

    @staticmethod
    def forward(ctx, x, w_idx, codebook):
        ctx.save_for_backward(x, w_idx, codebook)
        return _codebook_matmul(x.detach(), w_idx, codebook.detach())

    @staticmethod
    def backward(ctx, g):
        x, w_idx, codebook = ctx.saved_tensors
        n = codebook.shape[0]
        dx = dbook = None
        if ctx.needs_input_grad[0]:
            ids = canonical_idx(w_idx, n).clamp(0, n - 1).long()
            dx = (g @ codebook[ids].to(g.dtype).T).to(x.dtype)
        if ctx.needs_input_grad[2]:
            xtg = (x.to(torch.float32).T @ g.to(torch.float32)).reshape(-1)
            ids = w_idx.to(torch.int64).reshape(-1)
            keep = (ids >= 0) & (ids < n)
            dbook = torch.zeros(n, dtype=torch.float32, device=g.device)
            dbook.index_add_(0, ids[keep], xtg[keep])
            dbook = dbook.to(codebook.dtype)
        return dx, None, dbook


def codebook_matmul(x, w_idx, codebook):
    """(M, N) f32 = x @ codebook[w_idx], each weight rounded to x.dtype;
    differentiable in x and the codebook (``_CodebookMatmul``)."""
    if _needs_grad(x, codebook):
        return _CodebookMatmul.apply(x, w_idx, codebook)
    return _codebook_matmul(x, w_idx, codebook)


def codebook_swiglu(x, w1_idx, book1, w3_idx, book3, kind: str,
                    levels: int):
    """(M, N) in x.dtype: ``act_q(T(x @ book1[w1_idx])) * T(x @ book3[
    w3_idx])``, T = x.dtype, act_q the quantized activation's act_apply
    form: a SwiGLU FFN's gate and up products and its activation, one
    kernel launch on the card.  No gradient."""
    _refuse_grad("codebook_swiglu", x, book1, book3)
    if _route(x, w1_idx, book1, w3_idx, book3) == "cuda":
        return _cm.codebook_swiglu_cuda(x, w1_idx, book1, w3_idx, book3,
                                        kind, levels)
    return _cm.codebook_swiglu_plain(x, w1_idx, book1, w3_idx, book3, kind,
                                     levels)


def lut_matmul(a_idx, w_idx, table):
    """(M, N) int32 accumulators of the §4 engine (wrapping adds)."""
    _refuse_grad("lut_matmul", table)
    if _route(a_idx, w_idx, table) == "cuda":
        return _lm.lut_matmul_cuda(a_idx, w_idx, table)
    return _lm.lut_matmul_plain(a_idx, w_idx, table)


def gather_pages(pool, page_table):
    """out[b, p] = pool[page_table[b, p]], ids clamped into the pool: the
    paged KV cache's gather.  pool: (n_pages, page, *rest); page_table:
    (B, P) int.  Returns (B, P, page, *rest)."""
    _refuse_grad("gather_pages", pool)
    if _route(pool, page_table) == "cuda":
        return _pg.page_gather_cuda(pool, page_table)
    return _pg.page_gather_plain(pool, page_table)


def gather_pages_many(pools, page_table):
    """``[gather_pages(pool, page_table) for pool in pools]``: up to four
    pools that share one page table (a paged layer's K, V and their
    scales), one kernel launch on the card."""
    _refuse_grad("gather_pages_many", *pools)
    if _route(page_table, *pools) == "cuda":
        return _pg.page_gather_many_cuda(pools, page_table)
    return _pg.page_gather_many_plain(pools, page_table)


def _act_quant(x, kind: str, levels: int, form: str, with_index: bool,
               mul=None):
    operands = (x,) if mul is None else (x, mul)
    fn = (_aq.act_quant_cuda if _route(*operands) == "cuda"
          else _aq.act_quant_plain)
    return fn(x, kind, levels, form=form, with_index=with_index, mul=mul)


def _underlying_grad(x, g, kind: str):
    """g times the derivative of the underlying (unquantized) function at
    x, in x's dtype, in the order JAX's jvp rules take it when it
    differentiates the reference's ``act_apply`` (each operation rounded to
    x's dtype): tanh ``(g + g·t)·(1 − t)``, t = tanh(x); sigmoid ``g·(s·(1
    − s))``, s as ``jax.nn.sigmoid`` rounds it; ``clip``/``maximum`` pass
    half of g at a tie (relu6 at x = 0 and 6, rtanh at tanh(x) = 0), as
    ``lax.max_p``'s balanced rule does."""
    dt, f32 = x.dtype, torch.float32
    if dt == f32:
        r = lambda v: v                                          # noqa: E731
    else:
        r = lambda v: v.to(dt).to(f32)                           # noqa: E731
    xf, gf = x.to(f32), g.to(f32)

    def balanced(gv, above, tie):
        return gv * torch.where(above, 1.0, torch.where(tie, 0.5, 0.0))

    def through_tanh(gv, t):
        return r(r(gv + r(gv * t)) * r(1.0 - t))

    if kind == "tanh":
        d = through_tanh(gf, r(torch.tanh(xf)))
    elif kind == "relu6":
        # clip(x, 0, 6) = minimum(maximum(x, 0), 6): min's rule, then max's
        m = torch.clamp(xf, min=0.0)
        d = balanced(balanced(gf, m < 6.0, m == 6.0), xf > 0.0, xf == 0.0)
    elif kind == "sigmoid":
        one = torch.ones((), dtype=f32, device=x.device)
        s = r(torch.div(one, r(one + r(torch.exp(-xf)))))
        d = r(gf * r(s * r(1.0 - s)))
    elif kind == "rtanh":
        t = r(torch.tanh(xf))
        d = through_tanh(balanced(gf, t > 0.0, t == 0.0), t)
    else:
        raise ValueError(kind)
    return d.to(dt)


class _ActQuant(torch.autograd.Function):
    """Forward: the kernel form of ``act_quant``.  Backward: the derivative
    of the underlying (unquantized) nonlinearity (paper §2.1), computed in
    x's dtype as ``repro/kernels/ops.py::_aq_bwd`` computes it — plain
    PyTorch there as here (it is jnp, not a Pallas kernel): 0 at relu6's
    and rtanh's corners, unlike ``act_apply``'s."""

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


class _ActApply(torch.autograd.Function):
    """Forward: the ``act_apply`` form of the kernel (the plain version on
    the CPU), which emits q(f(x)).  Backward: what JAX takes through the
    reference's ``f(x) + stop_gradient(q(f(x)) − f(x))`` (times ``mul``),
    the underlying derivative (``_underlying_grad``); with ``mul``, ``d mul
    = g·q(f(x))`` and ``d x`` from ``g·mul``.  With ``mul`` the launch runs
    without it and the product is taken after it, in x's dtype: the
    activation is kept for ``d mul``, and the fused launch rounds the same
    f32 product once, so the bits are the fused launch's."""

    @staticmethod
    def forward(ctx, x, mul, kind, levels):
        y = _act_quant(x.detach(), kind, levels, "act_apply", False)[0]
        ctx.kind = kind
        ctx.save_for_backward(x, mul, y if mul is not None else None)
        return y if mul is None else y * mul.detach()

    @staticmethod
    def backward(ctx, g):
        x, mul, y = ctx.saved_tensors
        dmul = None
        if mul is not None:
            if ctx.needs_input_grad[1]:
                dmul = (g * y).to(mul.dtype)
            g = g * mul
        dx = _underlying_grad(x, g, ctx.kind) if ctx.needs_input_grad[0] \
            else None
        return dx, dmul, None, None


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
    same launch.  y is differentiable in x and ``mul`` (``_ActApply``);
    the index has no gradient, and a call for it refuses an input that
    requires one."""
    if _needs_grad(x, mul):
        if with_index:
            _refuse_grad("the quantized activation's level index", x, mul)
        return _ActApply.apply(x, mul, kind, levels), None
    return _act_quant(x, kind, levels, "act_apply", with_index, mul)


def kmeans_assign(values, centers):
    """(assignment idx int32, per-center sums f32, per-center counts f32)
    of ``values`` (flattened, as f32) to the sorted ``centers``."""
    _refuse_grad("kmeans_assign", values, centers)
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
    _refuse_grad("kmeans_stats", values, centers)
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
