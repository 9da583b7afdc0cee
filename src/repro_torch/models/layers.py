"""Shared layers: quant-aware dense, norms, embeddings, SwiGLU and the
biased MLP (the port's copy of ``repro/models/layers.py``).  All run under
autograd but the gated codebook launch (``ops.codebook_swiglu``, which has
no gradient in the reference either) and the lut backend."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.activations import ActQuantConfig, act_apply
from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch, ops, probes
from repro_torch.kernels._common import canonical_idx

__all__ = ["dense_init", "dense", "dequantize", "rms_norm_init", "rms_norm",
           "layer_norm_init", "layer_norm", "embed_init", "embed_lookup",
           "embed_logits", "ffn_act", "swiglu_init", "swiglu", "mlp_init",
           "mlp_block"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               std: float | None = None, layers: tuple = (),
               bias: bool = False):
    """{'w': normal · d_in^-0.5}, and {'b': zeros} with ``bias``;
    ``layers`` prepends stacked dims."""
    std = (d_in ** -0.5) if std is None else std
    w = torch.randn(layers + (d_in, d_out), generator=gen, device=device)
    p = {"w": (w * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros(layers + (d_out,), dtype=dtype, device=device)
    return p


def dequantize(p) -> torch.Tensor:
    """f32 weight matrix of an index-form dict: codebook[w_idx]."""
    book = p["codebook"]
    ids = canonical_idx(p["w_idx"], book.shape[-1])
    return book.to(torch.float32)[ids.long()]


def dense(p, x: torch.Tensor, backend: dispatch.BackendSpec = dispatch.DENSE,
          kind: str | None = None):
    """x @ W.  W is dense ('w') or codebook-indexed ('w_idx' + 'codebook').

    Index-form weights go through ``backend``: ``dense`` gathers the
    codebook and runs a plain matmul in x's dtype; ``codebook`` and ``lut``
    run their kernels (``kernels.dispatch.backend_matmul``).

    ``kind`` ('col' | 'row' | None) is the layer's tensor-parallel role,
    read only when ``backend`` has a mesh of more than one rank: W is then
    this rank's shard (``ServeEngine`` places them), a 'col' product
    returns this rank's columns, a 'row' product takes this rank's K-slice
    of x and sums the partial products over the ``model`` group, each as ``dispatch._sharded_matmul`` routes the
    kernels; the plain matmul of the ``dense`` backend shards the same way.
    """
    if "w_idx" in p:
        if backend.name != "dense" and p["w_idx"].ndim == 2:
            y = dispatch.backend_matmul(x, p["w_idx"], p["codebook"],
                                        backend, table=p.get("lut_table"),
                                        kind=kind)
            if "b" in p:
                y = y + p["b"].to(x.dtype)
            return y
        w = dequantize(p).to(x.dtype)
    else:
        w = p["w"].to(x.dtype)
    y = _plain_matmul(x, w, backend, kind)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _plain_matmul(x, w, backend: dispatch.BackendSpec, kind) -> torch.Tensor:
    """x @ w, on a tensor-parallel backend by ``kind``: 'row' (x this
    rank's K-slice) sums the rank's partial product over the ``model``
    group, 'col' and replicated products are local."""
    if dispatch.tp_degree(backend) == 1:
        return x @ w
    if kind == "row":
        dispatch.count_route(backend, "row")
        return collectives.psum(x @ w, backend.mesh)
    dispatch.count_route(backend, "col" if kind == "col" else "replicated")
    return x @ w


def rms_norm_init(d: int, dtype, device, layers: tuple = ()):
    return {"scale": torch.ones(layers + (d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layer_norm_init(d: int, dtype, device, layers: tuple = ()):
    return {"scale": torch.ones(layers + (d,), dtype=dtype, device=device),
            "bias": torch.zeros(layers + (d,), dtype=dtype, device=device)}


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """(x − mean) · rsqrt(var + eps) · scale + bias in f32, the variance
    biased as ``jnp.var``'s, cast back to x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device,
               std: float = 0.02):
    t = torch.randn((vocab, d), generator=gen, device=device)
    return {"table": (t * std).to(dtype)}


def embed_lookup(p, ids: torch.Tensor) -> torch.Tensor:
    if "w_idx" in p:  # codebook-compressed embedding table
        book = p["codebook"]
        rows = canonical_idx(p["w_idx"][ids], book.shape[-1])
        return book[rows.long()]
    return p["table"][ids]


def embed_logits(p, x: torch.Tensor) -> torch.Tensor:
    """Tied-softmax logits x @ E^T in f32."""
    t = dequantize(p) if "w_idx" in p else p["table"]
    return x.to(torch.float32) @ t.to(torch.float32).T


def _bounded(kind: str) -> str:
    """The kind quantized at ``levels > 0``: the unbounded kinds are
    swapped for relu6, as the paper swaps AlexNet's ReLU for ReLU6
    (§3.3)."""
    return {"silu": "relu6", "gelu": "relu6", "relu": "relu6"}.get(kind, kind)


def ffn_act(x: torch.Tensor, kind: str, levels: int,
            mul: torch.Tensor | None = None) -> torch.Tensor:
    """The paper's activation-quantization site.

    levels == 0: the continuous nonlinearity (baseline).
    levels  > 0: ``act_apply`` of ``_bounded(kind)`` (the ``act_quant``
                 kernel on the card), times ``mul`` in the same launch when
                 it is given.  For relu6 the inputs outside its rails,
                 which the quantized function pins to an end level, are
                 counted first (``probes.tap_act``, a no-op unless a
                 probes frame is open; tanh and sigmoid saturate with no
                 clip).  Under a mesh x is the rank's columns of the
                 col-sharded hidden, and each rank counts its own.
    """
    if levels > 0:
        bounded = _bounded(kind)
        if bounded == "relu6":
            probes.tap_act(x, 0.0, 6.0)
        return act_apply(ActQuantConfig(bounded, levels), x, mul)
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    if kind == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if kind == "tanh":
        return torch.tanh(x)
    raise ValueError(kind)


def swiglu_init(gen: torch.Generator, d: int, ff: int, dtype, device,
                layers: tuple = ()):
    return {"w1": dense_init(gen, d, ff, dtype, device, layers=layers),
            "w3": dense_init(gen, d, ff, dtype, device, layers=layers),
            "w2": dense_init(gen, ff, d, dtype, device, layers=layers)}


def _gated_codebook(p, backend: dispatch.BackendSpec) -> bool:
    """Both of the FFN's gate and up matrices are 2-D index-form weights
    without bias, and the backend is codebook: one gated launch computes
    them with their activation (``ops.codebook_swiglu``)."""
    return backend.name == "codebook" and all(
        "w_idx" in w and w["w_idx"].ndim == 2 and "b" not in w
        for w in (p["w1"], p["w3"]))


def swiglu(p, x: torch.Tensor, act_kind: str = "silu", act_levels: int = 0,
           backend: dispatch.BackendSpec = dispatch.DENSE) -> torch.Tensor:
    """w2 · (act(x · w1) * (x · w3)).  At ``act_levels > 0`` the product
    runs in the activation's launch (``ffn_act(..., mul=)``), and on the
    codebook backend both matmuls run in it too (``ops.codebook_swiglu``,
    the unfused chain's bits in one launch).

    While a probes frame is open the codebook FFN takes the unfused chain
    instead (two ``codebook_matmul`` launches, then ``act_quant`` with its
    multiplier): the gated launch never writes the gate's pre-activation,
    whose saturation ``ffn_act`` counts, and the reference counts two
    routed matmuls there.  The chain gives the gated launch's bits, so the
    tokens do not change."""
    if act_levels > 0 and _gated_codebook(p, backend) \
            and not probes.active():
        w1, w3 = p["w1"], p["w3"]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if dispatch.tp_degree(backend) > 1:
            dispatch.count_route(backend, "col", 2)
        h = ops.codebook_swiglu(x2, w1["w_idx"], w1["codebook"], w3["w_idx"],
                                w3["codebook"], _bounded(act_kind),
                                act_levels).reshape(*x.shape[:-1], -1)
    elif act_levels > 0:
        h = ffn_act(dense(p["w1"], x, backend, "col"), act_kind, act_levels,
                    mul=dense(p["w3"], x, backend, "col"))
    else:
        h = (ffn_act(dense(p["w1"], x, backend, "col"), act_kind, act_levels)
             * dense(p["w3"], x, backend, "col"))
    return dense(p["w2"], h, backend, "row")


def mlp_init(gen: torch.Generator, d: int, ff: int, dtype, device,
             layers: tuple = (), bias: bool = True):
    return {"w1": dense_init(gen, d, ff, dtype, device, layers=layers,
                             bias=bias),
            "w2": dense_init(gen, ff, d, dtype, device, layers=layers,
                             bias=bias)}


def mlp_block(p, x: torch.Tensor, act_kind: str = "gelu", act_levels: int = 0,
              backend: dispatch.BackendSpec = dispatch.DENSE) -> torch.Tensor:
    """w2 · act(x · w1), each product with its bias.  At ``act_levels > 0``
    the activation is ``ffn_act``'s quantized relu6 (gelu swapped, no
    multiplier: the ``act_quant`` kernel on the card)."""
    h = ffn_act(dense(p["w1"], x, backend, "col"), act_kind, act_levels)
    return dense(p["w2"], h, backend, "row")
