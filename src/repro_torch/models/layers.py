"""Shared layers: quant-aware dense, norms, embeddings, SwiGLU (the port's
copy of the serving parts of ``repro/models/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.activations import ActQuantConfig, act_apply
from repro_torch.kernels import dispatch
from repro_torch.kernels._common import canonical_idx

__all__ = ["dense_init", "dense", "dequantize", "rms_norm_init", "rms_norm",
           "embed_init", "embed_lookup", "embed_logits", "ffn_act",
           "swiglu_init", "swiglu"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               std: float | None = None, layers: tuple = ()):
    """{'w': normal · d_in^-0.5}; ``layers`` prepends stacked dims."""
    std = (d_in ** -0.5) if std is None else std
    w = torch.randn(layers + (d_in, d_out), generator=gen, device=device)
    return {"w": (w * std).to(dtype)}


def dequantize(p) -> torch.Tensor:
    """f32 weight matrix of an index-form dict: codebook[w_idx]."""
    book = p["codebook"]
    ids = canonical_idx(p["w_idx"], book.shape[-1])
    return book.to(torch.float32)[ids.long()]


def dense(p, x: torch.Tensor, backend: dispatch.BackendSpec = dispatch.DENSE):
    """x @ W.  W is dense ('w') or codebook-indexed ('w_idx' + 'codebook').

    Index-form weights go through ``backend``: ``dense`` gathers the
    codebook and runs a plain matmul in x's dtype; ``codebook`` and ``lut``
    run their kernels (``kernels.dispatch.backend_matmul``).
    """
    if "w_idx" in p:
        if backend.name != "dense" and p["w_idx"].ndim == 2:
            y = dispatch.backend_matmul(x, p["w_idx"], p["codebook"],
                                        backend, table=p.get("lut_table"))
            if "b" in p:
                y = y + p["b"].to(x.dtype)
            return y
        w = dequantize(p).to(x.dtype)
    else:
        w = p["w"].to(x.dtype)
    y = x @ w
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rms_norm_init(d: int, dtype, device, layers: tuple = ()):
    return {"scale": torch.ones(layers + (d,), dtype=dtype, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


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


def ffn_act(x: torch.Tensor, kind: str, levels: int) -> torch.Tensor:
    """The paper's activation-quantization site.

    levels == 0: the continuous nonlinearity (baseline).
    levels  > 0: ``act_apply`` (the ``act_quant`` kernel on the card); the
                 unbounded kinds are swapped for relu6, as the paper swaps
                 AlexNet's ReLU for ReLU6 (§3.3).  The reference's
                 saturation probe (``probes.tap_act``) comes with the
                 probes.
    """
    if levels > 0:
        bounded = {"silu": "relu6", "gelu": "relu6",
                   "relu": "relu6"}.get(kind, kind)
        return act_apply(ActQuantConfig(bounded, levels), x)
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


def swiglu(p, x: torch.Tensor, act_kind: str = "silu", act_levels: int = 0,
           backend: dispatch.BackendSpec = dispatch.DENSE) -> torch.Tensor:
    h = (ffn_act(dense(p["w1"], x, backend), act_kind, act_levels)
         * dense(p["w3"], x, backend))
    return dense(p["w2"], h, backend)
