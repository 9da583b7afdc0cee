"""Attention: GQA + RoPE + qk-norm, flash-chunked prefill softmax, the
contiguous KV-cache decode step, and the paged KV cache's chunked prefill and
decode step with int8 pages (the port's copy of the single-device parts of
``repro/models/attention.py``).

Shapes: activations (B, L, D); grouped queries (B, L, KV, G, hd); contiguous
caches (L_layers, B, S, KV, hd); page pools (L_layers, n_pages, page, KV, hd).
Attention is plain torch (einsum, mask, softmax); page gathers go through
``kernels.ops.gather_pages_many``.  The port writes caches and pools in
place.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import dispatch, ops
from repro_torch.models.layers import dense, rms_norm

__all__ = ["AttnConfig", "rope", "decode_attention", "flash_attention",
           "attn_apply", "attn_decode_cached", "chunk_attention",
           "attn_decode_paged", "attn_prefill_chunk", "quantize_kv",
           "dequantize_kv", "KV_QMAX"]

NEG_INF = -1e30
KV_QMAX = 127.0


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


# --- int8 KV pages ------------------------------------------------------------

def quantize_kv(t):
    """(B, L, KV, hd) float -> (int8 values, per-(B, L, KV) bf16 scales).

    Symmetric per-token-per-head max-abs quantization.  Values divide by the
    f32 scale; only the stored scale is rounded to bf16.  ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    tf = t.to(torch.float32)
    amax = torch.amax(tf.abs(), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / KV_QMAX
    q = torch.clamp(torch.round(tf / scale), -KV_QMAX, KV_QMAX)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def dequantize_kv(q, scale):
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


# --- paged KV cache -----------------------------------------------------------
#
# Logical position s of slot b lives at pool[page_table[b, s // page],
# s % page]; gathering a page-table row reassembles a sequence whose index IS
# the logical position, so decode_attention's and chunk_attention's masks
# apply unchanged.

def _gather_paged_kv(k_pool, v_pool, page_table, layer: int, scales=None):
    """(B, P·page, KV, hd) K/V of one layer, dequantized to f32 when
    ``scales`` (ks, vs), each (L, n_pages, page, KV), are given.  One
    gather of every pool of the layer (one kernel launch on the card)."""
    B, P = page_table.shape
    page, KV, hd = k_pool.shape[2:]
    pools = [k_pool[layer], v_pool[layer]]
    if scales is not None:
        pools += [scales[0][layer], scales[1][layer]]
    got = ops.gather_pages_many(pools, page_table)
    k_l = got[0].reshape(B, P * page, KV, hd)
    v_l = got[1].reshape(B, P * page, KV, hd)
    if scales is not None:
        k_l = dequantize_kv(k_l, got[2].reshape(B, P * page, KV))
        v_l = dequantize_kv(v_l, got[3].reshape(B, P * page, KV))
    return k_l, v_l


def _past_mask(past_len, B: int, S: int, device):
    """(B or 1, 1, 1, 1, S) mask idx < past_len, past_len scalar or (B,)."""
    idx = torch.arange(S, device=device)[None, None, None, None, :]
    if isinstance(past_len, torch.Tensor) and past_len.ndim == 1:
        return idx < past_len.reshape(B, 1, 1, 1, 1)
    return idx < past_len


def chunk_attention(q, k_past, v_past, past_len, k_new, v_new):
    """Chunked-prefill attention: full attention to the valid past, causal
    within the chunk.

    q: (B, C, KV, G, hd), queries at positions past_len..past_len+C−1;
    k_past/v_past: (B, S, KV, hd) gathered pages, valid prefix ``past_len``
    (scalar or (B,)); k_new/v_new: (B, C, KV, hd), the chunk's own K/V, not
    yet written to the pool.
    """
    B, C, KV, G, hd = q.shape
    S = k_past.shape[1]
    qf = q.to(torch.float32) * hd ** -0.5
    s_past = torch.einsum("bqkgd,bskd->bkgqs", qf, k_past.to(torch.float32))
    s_past = torch.where(_past_mask(past_len, B, S, q.device), s_past,
                         NEG_INF)
    s_new = torch.einsum("bqkgd,bckd->bkgqc", qf, k_new.to(torch.float32))
    causal = (torch.arange(C, device=q.device)[:, None]
              >= torch.arange(C, device=q.device)[None, :])
    s_new = torch.where(causal, s_new, NEG_INF)
    p = torch.softmax(torch.cat([s_past, s_new], dim=-1), dim=-1)
    out = (torch.einsum("bkgqs,bskd->bqkgd", p[..., :S],
                        v_past.to(torch.float32))
           + torch.einsum("bkgqc,bckd->bqkgd", p[..., S:],
                          v_new.to(torch.float32)))
    return out.to(q.dtype)


def _store_token(k, v, k_pool, v_pool, scales, layer: int, pid, off):
    """Write K/V (quantized when ``scales`` is given) at (layer, pid, off)
    of the pools, in place; pid/off index the page and in-page axes."""
    if scales is not None:
        kq, ksc = quantize_kv(k)
        vq, vsc = quantize_kv(v)
        scales[0][layer, pid, off] = ksc.to(scales[0].dtype)
        scales[1][layer, pid, off] = vsc.to(scales[1].dtype)
        k, v = kq, vq
    k_pool[layer, pid, off] = k.to(k_pool.dtype)
    v_pool[layer, pid, off] = v.to(v_pool.dtype)


def attn_decode_paged(p, x, cfg: AttnConfig, *, pos, page_table, write_pid,
                      write_off, valid_len, k_pool, v_pool, layer: int,
                      scales=None,
                      backend: dispatch.BackendSpec = dispatch.DENSE):
    """Paged decode step of one layer: gather pages, attend, then write the
    token's K/V into its page in place.

    page_table: (B, P) page ids per slot; write_pid/write_off: (B,) page and
    in-page offset receiving this token (retired slots' all-zero rows send
    it to the trash page 0).  valid_len: (B,) attendable prefix (= ``pos``:
    the fresh token enters through ``extra_kv``, so no slot is excluded).
    ``scales`` (ks, vs) present ⇒ int8 pages.  Returns the attention output
    (B, 1, D).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    out = decode_attention(q, k_l, v_l, valid_len, extra_kv=(k, v))
    # index_put_ without accumulate: retired slots may all write page 0 at
    # one offset, and any one of their values may land there
    _store_token(k[:, 0], v[:, 0], k_pool, v_pool, scales, layer,
                 write_pid.long(), write_off.long())
    return dense(p["wo"], out.reshape(B, 1, cfg.n_heads * cfg.hd), backend)


def attn_prefill_chunk(p, x, cfg: AttnConfig, *, pos, page_table, write_pid,
                       past_len, k_pool, v_pool, layer: int, scales=None,
                       backend: dispatch.BackendSpec = dispatch.DENSE):
    """One page-sized prefill chunk of one request against the paged cache.

    x: (1, C, D) with C == page size; ``past_len`` tokens already live in
    the pages of ``page_table`` (1, P).  The chunk's K/V are written as one
    page at id ``write_pid`` (0, the trash page, for a shared prefix page
    recomputed only for its logits).  Returns the attention output
    (1, C, D).
    """
    B, C, _ = x.shape
    if B != 1:
        raise ValueError(f"attn_prefill_chunk is batch-of-one (got B={B}); "
                         "prompts stream through chunks one request at a "
                         "time")
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    out = chunk_attention(q, k_l, v_l, past_len, k, v)
    _store_token(k[0], v[0], k_pool, v_pool, scales, layer, int(write_pid),
                 slice(None))
    return dense(p["wo"], out.reshape(B, C, cfg.n_heads * cfg.hd), backend)
