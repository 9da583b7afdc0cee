"""Mamba2 (SSD) block in the chunked state-space dual form (the port's copy
of ``repro/models/ssm.py``).

Recurrence per head (state N, head dim P):
    h_t = exp(A·Δ_t) · h_{t-1} + Δ_t · B_t ⊗ x_t        h ∈ R^{N×P}
    y_t = C_t · h_t + D · x_t

Chunked evaluation (chunk Q): the intra-chunk term is a masked quadratic
"attention" with decay weights, and the chunk states pass through a short
scan of length L/Q.  The activation sites of the paper's technique are the
conv output and the z gate, both through ``layers.ffn_act``; the two
projections go through ``layers.dense`` with the caller's ``backend``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.layers import (dense, dense_init, ffn_act, rms_norm,
                                       rms_norm_init)

__all__ = ["SSMConfig", "ssm_init", "ssm_apply", "ssm_decode_step",
           "init_ssm_cache"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int = 64        # N
    head_dim: int = 64       # P
    expand: int = 2
    conv_width: int = 4
    n_groups: int = 1        # B/C groups
    chunk: int = 128
    act_kind: str = "silu"
    act_levels: int = 0

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen: torch.Generator, cfg: SSMConfig, dtype, device,
             layers: tuple = ()):
    """The reference's init: the fused ``in_proj`` [z | x | B | C | dt] and
    ``out_proj`` N(0, 1/d_in), ``conv_w`` N(0, 0.2²), ``A_log`` =
    log(linspace(1, 16, H)), ``D`` = 1, ``dt_bias`` = 0.  ``layers``
    prepends stacked dims."""
    din = cfg.d_inner
    G, N, H = cfg.n_groups, cfg.d_state, cfg.n_heads
    proj_out = 2 * din + 2 * G * N + H
    conv = torch.randn(layers + (cfg.conv_width, din + 2 * G * N),
                       generator=gen, device=device) * 0.2
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    return {
        "in_proj": dense_init(gen, cfg.d_model, proj_out, dtype, device,
                              layers=layers),
        "out_proj": dense_init(gen, din, cfg.d_model, dtype, device,
                               layers=layers),
        "conv_w": conv.to(dtype),
        "A_log": a_log.expand(layers + (H,)).to(dtype).contiguous(),
        "D": torch.ones(layers + (H,), dtype=dtype, device=device),
        "dt_bias": torch.zeros(layers + (H,), dtype=dtype, device=device),
        "norm": rms_norm_init(din, dtype, device, layers=layers),
    }


def _split(cfg: SSMConfig, zxbcdt):
    din, G, N = cfg.d_inner, cfg.n_groups, cfg.d_state
    z, x, B, C, dt = torch.split(
        zxbcdt, [din, din, G * N, G * N, cfg.n_heads], dim=-1)
    return z, x, B, C, dt


def _causal_conv(x, w, state=None):
    """Depthwise causal conv of width K.  x: (B, L, C); w: (K, C); state:
    (B, K-1, C), the previous tokens' tail (decode).  The K shifted products
    add in Python's ``sum`` order, from 0, as the reference's do."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(K))
    return out, xp[:, -(K - 1):, :]


class _Cumsum(torch.autograd.Function):
    """Cumulative sum along ``dim`` in XLA's order: the forward a running
    sum from the first element, the backward each output's sum Σ_{j≥i}
    g_j taken from g_i upwards (``jnp.cumsum``'s transpose).  The chunk's
    log decays are summed so, which keeps the SSD scan's cancelling
    gradient sums (``A_log``'s) in the reference's rounding."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim = dim
        parts = x.unbind(dim)
        acc, out = parts[0], [parts[0]]
        for p in parts[1:]:
            acc = acc + p
            out.append(acc)
        return torch.stack(out, dim)

    @staticmethod
    def backward(ctx, g):
        dim, n = ctx.dim, g.shape[ctx.dim]
        y = g.clone()
        for k in range(1, n):
            y.narrow(dim, 0, n - k).add_(g.narrow(dim, k, n - k))
        return y, None


def _ssd_chunked(xh, dt, A, B, C, cfg: SSMConfig, h0=None):
    """Chunked SSD scan.

    xh: (Bt, L, H, P); dt: (Bt, L, H) (post-softplus); A: (H,) negative;
    B, C: (Bt, L, G, N).  L must be a whole number of chunks of ``min(
    cfg.chunk, L)`` tokens, as the reference asserts.  Returns (y (Bt, L,
    H, P), h_last (Bt, H, N, P) f32).
    """
    Bt, L, H, P = xh.shape
    G, N, Q = cfg.n_groups, cfg.d_state, min(cfg.chunk, L)
    if L % Q:
        raise ValueError(f"the SSD scan runs whole chunks: L={L} is no "
                         f"multiple of the chunk {Q}")
    nC = L // Q
    rep = H // G

    xc = xh.reshape(Bt, nC, Q, H, P)
    dtc = dt.reshape(Bt, nC, Q, H)
    Bc = B.reshape(Bt, nC, Q, G, N)
    Cc = C.reshape(Bt, nC, Q, G, N)

    g = dtc * A[None, None, None, :]                  # per-step log decay
    gcum = _Cumsum.apply(g, 2)
    gtot = gcum[:, :, -1, :]                          # (Bt, nC, H)

    # intra-chunk: y_i += Σ_{j<=i} C_i·B_j exp(gcum_i − gcum_j) dt_j x_j.
    # The exponent is masked to −inf before exp (the upper triangle would
    # overflow), then the decay masked again.
    Lmat = gcum[:, :, :, None, :] - gcum[:, :, None, :, :]   # (Bt,nC,Q,Q,H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    decay = torch.exp(torch.where(mask, Lmat, float("-inf")))
    decay = torch.where(mask, decay, 0.0)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)          # (Bt,nC,Q,Q,G)
    cb = torch.repeat_interleave(cb, rep, dim=-1)            # groups → heads
    w_ij = cb * decay
    y_intra = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w_ij, dtc, xc)

    # chunk states: S_c = Σ_j exp(gtot − gcum_j) dt_j B_j ⊗ x_j
    sdec = torch.exp(gtot[:, :, None, :] - gcum)             # (Bt,nC,Q,H)
    Brep = torch.repeat_interleave(Bc, rep, dim=-2)          # (Bt,nC,Q,H,N)
    S = torch.einsum("bcjh,bcjhn,bcjhp->bchnp", sdec * dtc, Brep, xc)

    # inter-chunk scan: h_c = exp(gtot_c)·h_{c-1} + S_c
    h = (torch.zeros((Bt, H, N, P), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.to(torch.float32))
    h_prev = []
    for c in range(nC):
        h_prev.append(h)
        h = h * torch.exp(gtot[:, c].to(torch.float32))[:, :, None, None] \
            + S[:, c].to(torch.float32)
    h_prev = torch.stack(h_prev, dim=1)                      # (Bt,nC,H,N,P)

    # inter-chunk contribution: y_i += C_i · exp(gcum_i) · h_{c-1}
    Crep = torch.repeat_interleave(Cc, rep, dim=-2)          # (Bt,nC,Q,H,N)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           Crep * torch.exp(gcum)[..., None],
                           h_prev.to(Crep.dtype))
    return (y_intra + y_inter).reshape(Bt, L, H, P), h


def _gated_norm(p, y, z, cfg: SSMConfig):
    """rms_norm(y * ffn_act(z)), y and z in the block's dtype: at
    ``act_levels > 0`` one act_quant launch with y as its multiplier (the
    product's bits are the same in either order)."""
    if cfg.act_levels > 0:
        gated = ffn_act(z, cfg.act_kind, cfg.act_levels, mul=y)
    else:
        gated = y * ffn_act(z, cfg.act_kind, cfg.act_levels)
    return rms_norm(p["norm"], gated)


def _conv_act(p, xi, Bm, Cm, cfg: SSMConfig, state=None):
    """The causal conv over [x | B | C] and its activation (the paper's
    site), split back: (x, B, C, the conv's new tail)."""
    conv_out, tail = _causal_conv(torch.cat([xi, Bm, Cm], dim=-1),
                                  p["conv_w"], state)
    conv_out = ffn_act(conv_out, cfg.act_kind, cfg.act_levels)
    GN = cfg.n_groups * cfg.d_state
    xi, Bm, Cm = torch.split(conv_out, [cfg.d_inner, GN, GN], dim=-1)
    return xi, Bm, Cm, tail


def _dt(p, dt):
    return F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))


def ssm_apply(p, x, cfg: SSMConfig,
              backend: dispatch.BackendSpec = dispatch.DENSE):
    """The full Mamba2 block over a prompt.  x: (B, L, D) → (B, L, D)."""
    Bt, L, _ = x.shape
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xi, Bm, Cm, dt = _split(cfg, dense(p["in_proj"], x, backend))
    xi, Bm, Cm, _ = _conv_act(p, xi, Bm, Cm, cfg)
    A = -torch.exp(p["A_log"].to(torch.float32))
    f32 = torch.float32
    y, _ = _ssd_chunked(xi.reshape(Bt, L, H, P).to(f32), _dt(p, dt), A,
                        Bm.reshape(Bt, L, G, N).to(f32),
                        Cm.reshape(Bt, L, G, N).to(f32), cfg)
    y = y + xi.reshape(Bt, L, H, P).to(f32) \
        * p["D"].to(f32)[None, None, :, None]
    y = y.reshape(Bt, L, cfg.d_inner).to(x.dtype)
    return dense(p["out_proj"], _gated_norm(p, y, z, cfg), backend)


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=torch.float32,
                   device=None):
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                         dtype=dtype, device=dev),
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.n_groups * cfg.d_state),
                            dtype=dtype, device=dev),
    }


def ssm_decode_step(p, x, cfg: SSMConfig, cache,
                    backend: dispatch.BackendSpec = dispatch.DENSE):
    """One token.  x: (B, 1, D) → (out (B, 1, D), the new cache), O(1) in
    the context's length; the cache keeps its dtypes."""
    Bt = x.shape[0]
    H, P, G, N = cfg.n_heads, cfg.head_dim, cfg.n_groups, cfg.d_state
    z, xi, Bm, Cm, dt = _split(cfg, dense(p["in_proj"], x, backend))
    xi, Bm, Cm, conv_state = _conv_act(p, xi, Bm, Cm, cfg, cache["conv"])
    f32 = torch.float32
    dt = _dt(p, dt)[:, 0]                                       # (B, H)
    A = -torch.exp(p["A_log"].to(f32))
    xh = xi.reshape(Bt, H, P).to(f32)
    Bh = torch.repeat_interleave(Bm.reshape(Bt, G, N), H // G, dim=1).to(f32)
    Ch = torch.repeat_interleave(Cm.reshape(Bt, G, N), H // G, dim=1).to(f32)
    decay = torch.exp(dt * A[None, :])                          # (B, H)
    h = cache["h"].to(f32) * decay[:, :, None, None] + \
        torch.einsum("bh,bhn,bhp->bhnp", dt, Bh, xh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, h) \
        + xh * p["D"].to(f32)[None, :, None]
    y = y.reshape(Bt, 1, cfg.d_inner).to(x.dtype)
    out = dense(p["out_proj"], _gated_norm(p, y, z, cfg), backend)
    return out, {"h": h.to(cache["h"].dtype),
                 "conv": conv_state.to(cache["conv"].dtype)}
