"""Attention: GQA + RoPE + qk-norm, flash-chunked prefill softmax, and the
contiguous KV-cache decode step (the port's copy of the single-device,
float-cache parts of ``repro/models/attention.py``).

Shapes: activations (B, L, D); grouped queries (B, L, KV, G, hd); caches
(L_layers, B, S, KV, hd).  Attention is plain torch (einsum, mask, softmax).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import dispatch
from repro_torch.models.layers import dense, rms_norm

__all__ = ["AttnConfig", "rope", "decode_attention", "flash_attention",
           "attn_apply", "attn_decode_cached"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int = 0                # 0 → d_model // n_heads
    qk_norm: bool = False            # qwen3 family
    rope_theta: float = 1e4
    window: int = 0                  # sliding-window size; 0 = full
    causal: bool = True
    kv_block: int = 1024             # flash KV chunk

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv


# --- rotary ------------------------------------------------------------------

def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding over *interleaved* pairs (x[..., ::2], x[..., 1::2]).

    x: (B, L, H, hd); pos: (B, L).  This is the JAX package's pairing, not
    the half-split rotation of other code bases.
    """
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = pos.to(torch.float32)[..., None] * freqs          # (B, L, hd/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., ::2].to(torch.float32), x[..., 1::2].to(torch.float32)
    out = torch.stack([xf1 * cos - xf2 * sin, xf1 * sin + xf2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --- decode attention (Lq == 1) ---------------------------------------------

def decode_attention(q, k, v, kv_len, exclude=None, extra_kv=None):
    """q: (B,1,KV,G,hd); k/v: (B,S,KV,hd) cache, read *before* this step's
    write; the fresh K/V come in through ``extra_kv`` and ``exclude`` masks
    the slot they will be written to.  ``kv_len``/``exclude``: (B,) vectors.
    """
    B, Lq, KV, G, hd = q.shape
    Lk = k.shape[1]
    qf = q.to(torch.float32) * hd ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.to(torch.float32))
    idx = torch.arange(Lk, device=q.device)[None, None, None, None, :]
    mask = idx < kv_len.reshape(B, 1, 1, 1, 1)
    if exclude is not None:
        mask = mask & (idx != exclude.reshape(B, 1, 1, 1, 1))
    s = torch.where(mask, s, NEG_INF)
    if extra_kv is not None:
        k_new, v_new = extra_kv                       # (B, 1, KV, hd)
        s_new = torch.einsum("bqkgd,bskd->bkgqs", qf, k_new.to(torch.float32))
        s = torch.cat([s, s_new], dim=-1)
    p = torch.softmax(s, dim=-1)
    if extra_kv is not None:
        out = torch.einsum("bkgqs,bskd->bqkgd", p[..., :Lk],
                           v.to(torch.float32))
        out = out + torch.einsum("bkgqs,bskd->bqkgd", p[..., Lk:],
                                 extra_kv[1].to(torch.float32))
    else:
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.to(q.dtype)


# --- prefill: online softmax over KV blocks ---------------------------------

def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    window: int = 0, kv_block: int = 1024):
    """Online-softmax attention over KV blocks (forward only).

    q: (B, Lq, KV, G, hd); k, v: (B, Lk, KV, hd).  Scores and the P·V
    product accumulate in f32; P is rounded to v's dtype first, as the
    reference does.  Returns (B, Lq, KV, G, hd) in q.dtype.
    """
    B, Lq, KV, G, hd = q.shape
    Lk = k.shape[1]
    blk = min(kv_block, Lk)
    scale = hd ** -0.5
    qpos = q_offset + torch.arange(Lq, device=q.device)
    qf = q.to(torch.float32)
    acc = torch.zeros((B, KV, G, Lq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, KV, G, Lq), dtype=torch.float32, device=q.device)
    for start in range(0, Lk, blk):
        # a ragged last block is simply shorter: the reference's padded
        # keys are masked and add exp(-inf) = 0 to every sum
        kblk, vblk = k[:, start:start + blk], v[:, start:start + blk]
        kpos = start + torch.arange(kblk.shape[1], device=q.device)
        s = torch.einsum("bqkgd,bckd->bkgqc", qf,
                         kblk.to(torch.float32)) * scale
        mask = torch.ones((Lq, kpos.shape[0]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd",
                          p.to(vblk.dtype).to(torch.float32),
                          vblk.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)       # (B, Lq, KV, G, hd)


# --- projections and the two serving forms -----------------------------------

def _project_qkv(p, x, cfg: AttnConfig, pos, backend):
    B, L, _ = x.shape
    hd, KV, G = cfg.hd, cfg.n_kv, cfg.groups
    q = dense(p["wq"], x, backend).reshape(B, L, KV, G, hd)
    k = dense(p["wk"], x, backend).reshape(B, L, KV, hd)
    v = dense(p["wv"], x, backend).reshape(B, L, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    q = rope(q.reshape(B, L, KV * G, hd), pos, cfg.rope_theta
             ).reshape(B, L, KV, G, hd)
    k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: AttnConfig,
               backend: dispatch.BackendSpec = dispatch.DENSE):
    """Prefill self-attention over the whole (right-padded) prompt.

    x: (B, L, D).  Returns (out, {'k', 'v'}): the layer's K/V planes
    (B, L, KV, hd), which become the cache.  Causal masking keeps real
    queries from seeing the padded tail.
    """
    B, L, _ = x.shape
    pos = torch.arange(L, device=x.device)[None].expand(B, L)
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    out = flash_attention(q, k, v, causal=cfg.causal, window=cfg.window,
                          kv_block=cfg.kv_block)
    out = dense(p["wo"], out.reshape(B, L, cfg.n_heads * cfg.hd), backend)
    return out, {"k": k, "v": v}


def attn_decode_cached(p, x, cfg: AttnConfig, *, pos, insert_at, valid_len,
                       k_all, v_all, layer: int,
                       backend: dispatch.BackendSpec = dispatch.DENSE):
    """One decode step of one layer against the stacked (L, B, S, KV, hd)
    cache.  pos: (B, 1) RoPE positions; insert_at/valid_len: (B,) per-slot
    write position and attendable length.

    Attention reads the layer's cache *before* the write (the insert slot
    masked, the fresh K/V folded in through ``extra_kv``), then the fresh
    K/V are written into ``k_all``/``v_all`` in place.  Returns the
    attention output (B, 1, D).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    k_l, v_l = k_all[layer], v_all[layer]
    out = decode_attention(q, k_l, v_l, valid_len, exclude=insert_at,
                           extra_kv=(k, v))
    rows = torch.arange(B, device=x.device)
    k_l[rows, insert_at] = k[:, 0].to(k_l.dtype)
    v_l[rows, insert_at] = v[:, 0].to(v_l.dtype)
    return dense(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.hd), backend)
