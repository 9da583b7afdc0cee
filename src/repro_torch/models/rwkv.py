"""RWKV-6 ("Finch"): attention-free time-mix with data-dependent decay (the
port's copy of ``repro/models/rwkv.py``).

Per head (dim P), state S ∈ R^{P×P}:
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t
    y_t = r_t · (S_{t-1} + diag(u) · k_t ⊗ v_t)
with w_t = exp(−exp(w0 + LoRA(x_t))) the data-dependent decay.  Token-shift
mixes x_t with x_{t−1}.

Prefill and training run the exact recurrence token by token
(``_wkv_scan``; the reference's chunked ``lax.scan`` computes the same
steps, checkpointed per chunk under autograd on both sides), decode its
O(1) step.  The casts are the reference's: the scan takes r, k and v as bf16
streams and the decay in f32, keeps its state in f32 and rounds each
step's output to bf16; the decode step keeps r, k and v in f32.  Every
projection goes through ``layers.dense`` with the caller's ``backend`` and
every gate through ``layers.ffn_act``, the paper's activation site.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.layers import (dense, dense_init, ffn_act, rms_norm,
                                       rms_norm_init)

__all__ = ["RWKVConfig", "rwkv_tm_init", "rwkv_tm_apply", "rwkv_tm_decode",
           "rwkv_cm_init", "rwkv_cm_apply", "rwkv_cm_decode",
           "init_rwkv_cache"]


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    d_model: int
    head_dim: int = 64
    d_ff: int = 0                 # channel-mix hidden; 0 → 3.5·d
    lora_rank: int = 32
    chunk: int = 128
    act_kind: str = "relu"        # channel-mix uses squared relu
    act_levels: int = 0

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def ff(self) -> int:
        return self.d_ff or int(3.5 * self.d_model)


def _mix_init(gen, n: int, d: int, dtype, device, layers: tuple):
    u = torch.rand(layers + (n, d), generator=gen, device=device)
    return (u * 0.5 + 0.25).to(dtype)


def rwkv_tm_init(gen: torch.Generator, cfg: RWKVConfig, dtype, device,
                 layers: tuple = ()):
    """The time-mix's parameters with the reference's init: ``mix`` U·0.5 +
    0.25, the five projections and the LoRA's down matrix N(0, 1/d_in), its
    up matrix N(0, 0.01²), ``w0`` = log(e − 1), ``u`` = 0.5.  ``layers``
    prepends stacked dims."""
    d = cfg.d_model
    w0 = torch.log(torch.tensor(math.e, dtype=torch.float32) - 1)
    p = {"mix": _mix_init(gen, 5, d, dtype, device, layers)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, d, dtype, device, layers=layers)
    p["w0"] = torch.full(layers + (d,), float(w0), device=device).to(dtype)
    p["w_lora_a"] = dense_init(gen, d, cfg.lora_rank, dtype, device,
                               layers=layers)
    p["w_lora_b"] = dense_init(gen, cfg.lora_rank, d, dtype, device,
                               std=0.01, layers=layers)
    p["u"] = torch.full(layers + (d,), 0.5, device=device).to(dtype)
    p["ln_out"] = rms_norm_init(d, dtype, device, layers=layers)
    return p


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} stream.  prev: (B, 1, D), the last token before x (its
    dtype promotes with x's, as ``jnp.concatenate``'s does)."""
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def _tm_projections(p, x, x_prev, backend):
    mix = p["mix"].to(x.dtype)
    xs = _token_shift(x, x_prev)

    def lerp(i):
        return x * mix[i][None, None, :] + xs * (1.0 - mix[i][None, None, :])
    r = dense(p["wr"], lerp(0), backend)
    k = dense(p["wk"], lerp(1), backend)
    v = dense(p["wv"], lerp(2), backend)
    g = dense(p["wg"], lerp(3), backend)
    # the data-dependent decay (Finch): w = exp(-exp(w0 + lora(x)))
    dd = dense(p["w_lora_b"], torch.tanh(dense(p["w_lora_a"], lerp(4),
                                               backend)), backend)
    logw = -torch.exp(_clip(
        p["w0"].to(torch.float32)[None, None, :] + dd.to(torch.float32),
        -8.0, 4.0))
    return r, k, v, g, logw             # logw = log decay ∈ (−∞, 0)


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: minimum(maximum(x, lo), hi), whose gradient is half
    at a tie with a bound, as JAX's ``max``/``min`` rules give it
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _bonus(r, u, k, v):
    """einsum('bhp,hp,bhp,bhq->bhq', r, u, k, v): (Σ_p r·u·k) v."""
    return torch.einsum("bhp,bhq->bhq", r * u * k, v)


def _wkv_steps(r, k, v, u, logw, s):
    """The recurrence over the tokens of one chunk from state ``s``: (y
    bf16, the last state)."""
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt = (a[:, t].to(torch.float32) for a in (r, k, v))
        y = torch.einsum("bhp,bhpq->bhq", rt, s) + _bonus(rt, u, kt, vt)
        s = s * torch.exp(logw[:, t].to(torch.float32))[..., None] + \
            torch.einsum("bhp,bhq->bhpq", kt, vt)
        ys.append(y.to(torch.bfloat16))
    return torch.stack(ys, dim=1), s


def _wkv_scan(r, k, v, u, logw, cfg: RWKVConfig, s0=None):
    """The exact WKV recurrence over L tokens.

    r, k, v: (B, L, H, P) bf16 streams; logw: (B, L, H, P) f32; u: (H, P)
    f32; s0: (B, H, P, P) or None.  The state stays f32 and each step's
    output is rounded to bf16, as the reference's chunked scan rounds it.
    L must be a whole number of chunks of ``min(cfg.chunk, L)`` tokens, as
    the reference asserts.  Under autograd each chunk runs under
    ``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    per chunk: the backward keeps the states at chunk boundaries and
    recomputes one chunk's steps at a time, where the token loop would
    keep every step's (B, H, P, P) state.  Returns (y (B, L, H, P) bf16,
    s_last (B, H, P, P) f32).
    """
    B, L, H, P = r.shape
    Q = min(cfg.chunk, L)
    if L % Q:
        raise ValueError(f"the WKV scan runs whole chunks: L={L} is no "
                         f"multiple of the chunk {Q}")
    s = (torch.zeros((B, H, P, P), dtype=torch.float32, device=r.device)
         if s0 is None else s0.to(torch.float32))
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, u, logw, s))
    ys = []
    for c in range(0, L, Q):
        args = tuple(a[:, c:c + Q] for a in (r, k, v)) + (
            u, logw[:, c:c + Q], s)
        if remat:
            y, s = torch.utils.checkpoint.checkpoint(_wkv_steps, *args,
                                                     use_reentrant=False)
        else:
            y, s = _wkv_steps(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _gate(y, g, cfg: RWKVConfig):
    """``y * ffn_act(g, 'silu')``: at ``act_levels > 0`` one act_quant
    launch with y as its multiplier when the two share a dtype (the
    product's bits are the same in either order), else the activation and
    then the product."""
    if cfg.act_levels > 0 and y.dtype == g.dtype:
        return ffn_act(g, "silu", cfg.act_levels, mul=y)
    return y * ffn_act(g, "silu", cfg.act_levels)


def rwkv_tm_apply(p, x, cfg: RWKVConfig, state=None,
                  backend: dispatch.BackendSpec = dispatch.DENSE):
    """Time-mix block over a prompt (prefill).  x: (B, L, D).  Returns (out,
    {'s': (B, H, P, P) f32, 'x_tm': x's last token})."""
    B, L, D = x.shape
    H, P = cfg.n_heads, cfg.head_dim
    x_prev = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
              if state is None else state["x_tm"])
    r, k, v, g, logw = _tm_projections(p, x, x_prev, backend)
    rh, kh, vh = (a.reshape(B, L, H, P).to(torch.bfloat16) for a in (r, k, v))
    u = p["u"].to(torch.float32).reshape(H, P)
    s0 = None if state is None else state["s"]
    # the decay stays f32: bf16 would quantize exp(logw) ≈ 1 − ε
    y, s_last = _wkv_scan(rh, kh, vh, u, logw.reshape(B, L, H, P), cfg, s0)
    y = rms_norm(p["ln_out"], y.reshape(B, L, D).to(x.dtype))
    out = dense(p["wo"], _gate(y, g, cfg), backend)
    return out, {"s": s_last, "x_tm": x[:, -1:, :]}


def rwkv_tm_decode(p, x, cfg: RWKVConfig, state,
                   backend: dispatch.BackendSpec = dispatch.DENSE):
    """The O(1) decode step.  x: (B, 1, D); r, k and v stay f32."""
    B, _, D = x.shape
    H, P = cfg.n_heads, cfg.head_dim
    r, k, v, g, logw = _tm_projections(p, x, state["x_tm"], backend)
    rh, kh, vh = (a.reshape(B, H, P).to(torch.float32) for a in (r, k, v))
    w = torch.exp(logw.reshape(B, H, P))
    u = p["u"].to(torch.float32).reshape(H, P)
    s = state["s"].to(torch.float32)
    y = torch.einsum("bhp,bhpq->bhq", rh, s) + _bonus(rh, u, kh, vh)
    s_new = s * w[:, :, :, None] + torch.einsum("bhp,bhq->bhpq", kh, vh)
    y = rms_norm(p["ln_out"], y.reshape(B, 1, D).to(x.dtype))
    return dense(p["wo"], _gate(y, g, cfg), backend), {"s": s_new, "x_tm": x}


def rwkv_cm_init(gen: torch.Generator, cfg: RWKVConfig, dtype, device,
                 layers: tuple = ()):
    return {"mix": _mix_init(gen, 2, cfg.d_model, dtype, device, layers),
            "wk": dense_init(gen, cfg.d_model, cfg.ff, dtype, device,
                             layers=layers),
            "wv": dense_init(gen, cfg.ff, cfg.d_model, dtype, device,
                             layers=layers)}


def _cm(p, x, xs, cfg: RWKVConfig, backend):
    mix = p["mix"].to(x.dtype)
    xk = x * mix[0][None, None] + xs * (1 - mix[0][None, None])
    h = dense(p["wk"], xk, backend)
    h = ffn_act(torch.relu(h) if cfg.act_levels == 0 else h, "relu",
                cfg.act_levels)
    h = h * h  # squared relu (rwkv)
    return dense(p["wv"], h, backend)


def rwkv_cm_apply(p, x, cfg: RWKVConfig, state=None,
                  backend: dispatch.BackendSpec = dispatch.DENSE):
    B, L, D = x.shape
    x_prev = (torch.zeros((B, 1, D), dtype=x.dtype, device=x.device)
              if state is None else state["x_cm"])
    out = _cm(p, x, _token_shift(x, x_prev), cfg, backend)
    return out, {"x_cm": x[:, -1:, :]}


def rwkv_cm_decode(p, x, cfg: RWKVConfig, state,
                   backend: dispatch.BackendSpec = dispatch.DENSE):
    return _cm(p, x, state["x_cm"], cfg, backend), {"x_cm": x}


def init_rwkv_cache(cfg: RWKVConfig, batch: int, dtype=torch.float32,
                    device=None):
    H, P = cfg.n_heads, cfg.head_dim
    dev = resolve_device(device)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=dev)  # noqa: E731
    return {"s": z(batch, H, P, P), "x_tm": z(batch, 1, cfg.d_model),
            "x_cm": z(batch, 1, cfg.d_model)}
