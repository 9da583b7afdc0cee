"""Attention: GQA + RoPE / M-RoPE + qk-norm, flash-chunked prefill softmax
(causal, or not for an encoder; cross-attention over an encoder's memory),
the contiguous KV-cache decode step and speculative verify, with their
tensor-parallel form over a sequence-sharded cache (the flash-decode
join), and the paged KV cache's chunked prefill, decode step and
speculative verify with int8 pages, with their tensor-parallel form over
in-page-sharded pools (the port's copy of ``repro/models/attention.py``).

Shapes: activations (B, L, D); grouped queries (B, L, KV, G, hd); contiguous
caches (L_layers, B, S, KV, hd); page pools (L_layers, n_pages, page, KV, hd).
Attention is plain torch (einsum, mask, softmax); page gathers go through
``kernels.ops.gather_pages_many``.  The port writes caches and pools in
place.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import dispatch, ops, probes
from repro_torch.models.layers import dense, rms_norm

__all__ = ["AttnConfig", "rope", "decode_attention", "flash_attention",
           "attn_apply", "attn_decode_cached", "attn_verify_cached",
           "chunk_attention", "attn_decode_paged", "attn_verify_paged",
           "attn_prefill_chunk", "quantize_kv", "dequantize_kv", "KV_QMAX"]

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
    rope_sections: tuple = ()        # M-RoPE (qwen2-vl): head_dim split
    window: int = 0                  # sliding-window size; 0 = full
    causal: bool = True              # False for encoder self-attn
    kv_block: int = 1024             # flash KV chunk

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        return self.n_heads // self.n_kv


# --- rotary ------------------------------------------------------------------

def _section_ids(sections: tuple, n: int) -> list:
    """The position stream of each of the ``n`` frequency bands: band f
    belongs to the section that covers it, cut at 2 (three streams), the
    last id repeated where ``sections`` cover fewer than ``n`` bands and
    the ids past ``n`` dropped, as ``jnp.repeat(...,
    total_repeat_length=n)`` gives them."""
    ids = [min(i, 2) for i, c in enumerate(sections) for _ in range(c)]
    if not ids:
        return [0] * n
    return (ids + [ids[-1]] * n)[:n]


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e4,
         sections: tuple = ()) -> torch.Tensor:
    """Rotary embedding over *interleaved* pairs (x[..., ::2], x[..., 1::2]).

    x: (B, L, H, hd); pos: (B, L), or (3, B, L) for M-RoPE (qwen2-vl): the
    hd/2 frequency bands are split into ``sections`` driven by the
    (temporal, height, width) streams (``_section_ids``).  A (B, L) pos
    drives every band, which is standard RoPE whatever the sections.  This
    is the JAX package's pairing, not the half-split rotation of other
    code bases.
    """
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    if pos.ndim == 3:
        sec = torch.tensor(_section_ids(sections, hd // 2), device=x.device)
        p_sel = pos.to(torch.float32)[sec].permute(1, 2, 0)  # (B, L, hd/2)
        ang = p_sel * freqs
    else:
        ang = pos.to(torch.float32)[..., None] * freqs      # (B, L, hd/2)
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
    """Online-softmax attention over KV blocks.

    q: (B, Lq, KV, G, hd); k, v: (B, Lk, KV, hd).  Scores and the P·V
    product accumulate in f32; P is rounded to v's dtype first, as the
    reference does.  Returns (B, Lq, KV, G, hd) in q.dtype.  Under
    autograd the backward is the reference's flash backward
    (``_FlashAttention``): only (q, k, v, out, m, denom) are kept, and each
    block's probabilities are recomputed.
    """
    args = (causal, q_offset, window, kv_block)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, *args)
    return _flash_forward(q, k, v, *args)[0]


def _kv_blocks(Lk: int, kv_block: int):
    """(start, stop) of each KV block; a ragged last block is simply
    shorter: the reference's padded keys are masked and add exp(-inf) = 0
    to every sum (and their gradients are cut off)."""
    blk = min(kv_block, Lk)
    return [(a, min(a + blk, Lk)) for a in range(0, Lk, blk)]


def _block_mask(qpos, start: int, stop: int, causal: bool, window: int):
    kpos = torch.arange(start, stop, device=qpos.device)
    mask = torch.ones((qpos.shape[0], stop - start), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return mask


def _flash_forward(q, k, v, causal, q_offset, window, kv_block):
    """(out, m, denom): the output and the running max and denominator of
    each query row, (B, KV, G, Lq) f32."""
    B, Lq, KV, G, hd = q.shape
    scale = hd ** -0.5
    qpos = q_offset + torch.arange(Lq, device=q.device)
    qf = q.to(torch.float32)
    acc = torch.zeros((B, KV, G, Lq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G, Lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    denom = torch.zeros((B, KV, G, Lq), dtype=torch.float32, device=q.device)
    for start, stop in _kv_blocks(k.shape[1], kv_block):
        kblk, vblk = k[:, start:stop], v[:, start:stop]
        s = torch.einsum("bqkgd,bckd->bkgqc", qf,
                         kblk.to(torch.float32)) * scale
        s = torch.where(_block_mask(qpos, start, stop, causal, window), s,
                        NEG_INF)
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
    return out.permute(0, 3, 1, 2, 4).to(q.dtype), m, denom


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_flash_cvjp``: forward as ``_flash_forward``;
    backward ``_flash_cvjp_bwd`` (``repro/models/attention.py``), block by
    block: P re-derived from the saved (m, denom), ``dV = Pᵀ·dOut`` (P in
    dOut's dtype), ``dS = P ⊙ (dOut·Vᵀ − δ)`` with ``δ = Σ_d dOut·Out``,
    ``dK = dSᵀ·Q·scale`` and ``dQ += dS·K·scale`` (dS in q's dtype), each
    product accumulated in f32.  Plain PyTorch, as the reference's is jnp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window, kv_block):
        out, m, denom = _flash_forward(q, k, v, causal, q_offset, window,
                                       kv_block)
        ctx.save_for_backward(q, k, v, out, m, denom)
        ctx.args = (causal, q_offset, window, kv_block)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, denom = ctx.saved_tensors
        causal, q_offset, window, kv_block = ctx.args
        f32 = torch.float32
        Lq, hd = q.shape[1], q.shape[-1]
        scale = hd ** -0.5
        gT = g.permute(0, 2, 3, 1, 4).to(f32)                # (B,KV,G,Lq,hd)
        delta = torch.einsum("bkgqd,bkgqd->bkgq", gT,
                             out.permute(0, 2, 3, 1, 4).to(f32))
        denom = torch.clamp(denom, min=1e-30)
        m = torch.where(m <= NEG_INF / 2, 0.0, m)  # masked rows: p stays 0
        qpos = q_offset + torch.arange(Lq, device=q.device)
        qf = q.to(f32)
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dks, dvs = [], []
        for start, stop in _kv_blocks(k.shape[1], kv_block):
            kblk = k[:, start:stop].to(f32)
            vblk = v[:, start:stop].to(f32)
            s = torch.einsum("bqkgd,bckd->bkgqc", qf, kblk) * scale
            s = torch.where(_block_mask(qpos, start, stop, causal, window),
                            s, NEG_INF)
            p = torch.exp(s - m[..., None]) / denom[..., None]
            pc = p.to(g.dtype).to(f32)
            dvs.append(torch.einsum("bkgqc,bkgqd->bckd", pc, gT))
            ds = p * (torch.einsum("bkgqd,bckd->bkgqc", gT, vblk)
                      - delta[..., None])
            dsc = ds.to(q.dtype).to(f32)
            dks.append(torch.einsum("bkgqc,bqkgd->bckd", dsc, qf) * scale)
            dq = dq + torch.einsum("bkgqc,bckd->bqkgd", dsc, kblk) * scale
        dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


# --- projections and the two serving forms -----------------------------------

def _whole_qkv(q, k, v, backend):
    """The column-sharded q, k, v of a tensor-parallel backend made whole
    on every rank, by one all-gather of the three (the cache is sharded
    over the sequence, so every rank attends with all heads)."""
    if dispatch.tp_degree(backend) == 1:
        return q, k, v
    tp = backend.mesh.tp
    sizes = [t.shape[-1] for t in (q, k, v)]
    got = collectives.all_gather(torch.cat([q, k, v], dim=-1), backend.mesh)
    blocks = got.reshape(*got.shape[:-1], tp, sum(sizes))
    return tuple(b.reshape(*got.shape[:-1], tp * n)
                 for b, n in zip(blocks.split(sizes, dim=-1), sizes))


def _out_proj(p, out, backend):
    """wo on the attention output (B, L, H·hd), a row-parallel product: on
    a tensor-parallel backend the output is whole on every rank and wo
    takes this rank's block of its columns, the rows of its (H·hd/tp, D)
    shard."""
    tp = dispatch.tp_degree(backend)
    if tp > 1:
        n = out.shape[-1] // tp
        m = backend.mesh.coords["model"]
        out = out[..., m * n:(m + 1) * n]
    return dense(p["wo"], out, backend, "row")


def _project_qkv(p, x, cfg: AttnConfig, pos, backend, kv_src=None):
    """q from x; k and v from ``kv_src`` (an encoder's memory, for
    cross-attention), else from x.  RoPE (M-RoPE with ``cfg.rope_sections``)
    rotates self-attention's q and k only.  The three products are
    column-parallel; on a tensor-parallel backend they are gathered whole
    (``_whole_qkv``)."""
    B, L, _ = x.shape
    hd, KV, G = cfg.hd, cfg.n_kv, cfg.groups
    src = x if kv_src is None else kv_src
    Lk = src.shape[1]
    q, k, v = _whole_qkv(dense(p["wq"], x, backend, "col"),
                         dense(p["wk"], src, backend, "col"),
                         dense(p["wv"], src, backend, "col"), backend)
    q = q.reshape(B, L, KV, G, hd)
    k = k.reshape(B, Lk, KV, hd)
    v = v.reshape(B, Lk, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    if kv_src is None:
        q = rope(q.reshape(B, L, KV * G, hd), pos, cfg.rope_theta,
                 cfg.rope_sections).reshape(B, L, KV, G, hd)
        k = rope(k, pos, cfg.rope_theta, cfg.rope_sections)
    return q, k, v


def attn_apply(p, x, cfg: AttnConfig,
               backend: dispatch.BackendSpec = dispatch.DENSE, *, pos=None,
               kv_override=None):
    """Attention over a whole (right-padded) prompt, no cache.

    x: (B, L, D); pos: RoPE positions (B, L) or (3, B, L), ``arange(L)``
    when None.  ``kv_override``: (B, Lk, D) encoder memory for
    cross-attention: K and V are projected from it, RoPE is skipped and
    no query is masked.  Otherwise the mask is causal when ``cfg.causal``
    is set (which keeps real queries from seeing a padded tail), full for
    an encoder.  Returns (out, {'k', 'v'}): the K/V planes (B, Lk, KV,
    hd), which become a decoder's cache.
    """
    B, L, _ = x.shape
    if pos is None:
        pos = torch.arange(L, device=x.device)[None].expand(B, L)
    q, k, v = _project_qkv(p, x, cfg, pos, backend, kv_override)
    out = flash_attention(q, k, v, causal=cfg.causal and kv_override is None,
                          window=cfg.window, kv_block=cfg.kv_block)
    out = _out_proj(p, out.reshape(B, L, cfg.n_heads * cfg.hd), backend)
    return out, {"k": k, "v": v}


def attn_decode_cached(p, x, cfg: AttnConfig, *, pos, insert_at, valid_len,
                       k_all, v_all, layer: int, scales=None,
                       backend: dispatch.BackendSpec = dispatch.DENSE,
                       exclude=None):
    """One decode step of one layer against the stacked (L, B, S, KV, hd)
    cache.  pos: (B, 1) RoPE positions; insert_at/valid_len: (B,) per-slot
    write position and attendable length; ``exclude``: the (B,) slot
    masked, ``insert_at`` when None; ``scales`` (ks_all, vs_all), each (L,
    B, S, KV), when the cache is int8 (``quantize_kv``).

    Attention reads the layer's cache *before* the write (dequantized when
    ``scales`` are given; the excluded slot masked, the fresh float K/V
    folded in through ``extra_kv``), then the fresh K/V (quantized, with their
    scales) are written into ``k_all``/``v_all`` in place.  Returns the
    attention output (B, 1, D).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    excl = insert_at if exclude is None else exclude
    if getattr(backend, "mesh", None) is not None:
        num, denom, m_glob = _decode_cached_sharded(
            q, k, v, k_all, v_all, scales, layer, insert_at, valid_len, excl,
            backend.mesh)
        out = _join_fresh(q, k, v, num, denom, m_glob)
        return _out_proj(p, out.reshape(B, 1, cfg.n_heads * cfg.hd), backend)
    k_l, v_l = k_all[layer], v_all[layer]
    if scales is not None:
        k_att = dequantize_kv(k_l, scales[0][layer])
        v_att = dequantize_kv(v_l, scales[1][layer])
    else:
        k_att, v_att = k_l, v_l
    out = decode_attention(q, k_att, v_att, valid_len, exclude=excl,
                           extra_kv=(k, v))
    rows = torch.arange(B, device=x.device)
    k_new, v_new = k[:, 0], v[:, 0]
    if scales is not None:
        (k_new, ksc), (v_new, vsc) = quantize_kv(k_new), quantize_kv(v_new)
        scales[0][layer, rows, insert_at] = ksc
        scales[1][layer, rows, insert_at] = vsc
    k_l[rows, insert_at] = k_new.to(k_l.dtype)
    v_l[rows, insert_at] = v_new.to(v_l.dtype)
    return _out_proj(p, out.reshape(B, 1, cfg.n_heads * cfg.hd), backend)


def attn_verify_cached(p, x, cfg: AttnConfig, *, pos, insert_at, valid_len,
                       k_all, v_all, layer: int, scales=None,
                       backend: dispatch.BackendSpec = dispatch.DENSE):
    """Speculative verify of one layer against the stacked (L, B, S, KV,
    hd) cache: per slot, the pending token and K draft proposals.

    x: (B, K1, D); pos: (B, K1) RoPE positions; insert_at: (B,) first row
    written (the K1 rows land at ``clip(insert_at, 0, S − K1)``, so retired
    slots verify harmlessly into their own tail); valid_len: (B,) the
    attendable cached prefix.  Attention is ``chunk_attention``'s: full to
    the valid prefix (the layer dequantized first when ``scales`` (ks_all,
    vs_all) are given), causal among the K1 fresh tokens, which enter
    before they are written.  Then their K/V (quantized, with their scales)
    are written in place.  Returns the attention output (B, K1, D).
    """
    B, K1, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    if getattr(backend, "mesh", None) is not None:
        S = k_all.shape[2] * backend.mesh.tp
        num, denom, m_glob = _decode_cached_sharded(
            q, k, v, k_all, v_all, scales, layer,
            torch.clamp(insert_at, 0, S - K1), valid_len, None, backend.mesh)
        out = _join_fresh(q, k, v, num, denom, m_glob)
        return _out_proj(p, out.reshape(B, K1, cfg.n_heads * cfg.hd), backend)
    k_l, v_l = k_all[layer], v_all[layer]
    if scales is not None:
        k_att = dequantize_kv(k_l, scales[0][layer])
        v_att = dequantize_kv(v_l, scales[1][layer])
    else:
        k_att, v_att = k_l, v_l
    out = chunk_attention(q, k_att, v_att, valid_len, k, v)
    S = k_l.shape[1]
    cols = (torch.clamp(insert_at.long(), 0, S - K1)[:, None]
            + torch.arange(K1, device=x.device)[None])             # (B, K1)
    rows = torch.arange(B, device=x.device)[:, None]
    if scales is not None:
        (k, ksc), (v, vsc) = quantize_kv(k), quantize_kv(v)
        scales[0][layer, rows, cols] = ksc.to(scales[0].dtype)
        scales[1][layer, rows, cols] = vsc.to(scales[1].dtype)
    k_l[rows, cols] = k.to(k_l.dtype)
    v_l[rows, cols] = v.to(v_l.dtype)
    return _out_proj(p, out.reshape(B, K1, cfg.n_heads * cfg.hd), backend)


# --- the sequence-sharded flash-decode join (tensor parallelism) -------------

def _pay_dtype(dt):
    """The partial output's collective dtype: f32 for an f32 cache, bf16
    otherwise (the reference's ``_pay_dtype``)."""
    return torch.float32 if dt == torch.float32 else torch.bfloat16


def _join_fresh(q, k_new, v_new, num, denom, m_glob):
    """Fold the Lq fresh tokens (causal among themselves) into the joined
    softmax statistics of the sharded past, then normalize: the online
    twin of ``chunk_attention``'s concatenated softmax.

    q: (B, Lq, KV, G, hd); k_new/v_new: (B, Lq, KV, hd); num: (B, KV, G,
    Lq, hd); denom/m_glob: (B, KV, G, Lq).  Returns (B, Lq, KV, G, hd) in
    q.dtype.
    """
    Lq, hd = q.shape[1], q.shape[-1]
    qf = q.to(torch.float32) * hd ** -0.5
    s_new = torch.einsum("bqkgd,bckd->bkgqc", qf, k_new.to(torch.float32))
    ar = torch.arange(Lq, device=q.device)
    s_new = torch.where(ar[:, None] >= ar[None, :], s_new, NEG_INF)
    m2 = torch.maximum(m_glob, torch.amax(s_new, dim=-1))
    corr = torch.exp(m_glob - m2)
    e_new = torch.exp(s_new - m2[..., None])
    num = num * corr[..., None] + torch.einsum(
        "bkgqc,bckd->bkgqd", e_new, v_new.to(torch.float32))
    denom = denom * corr + torch.sum(e_new, dim=-1)
    out = num / torch.clamp(denom[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def _slice_scores(q, k_l, gidx, vlen, excl):
    """Scores (B, KV, G, Lq, S_loc) of q (B, Lq, KV, G, hd) against one
    slice k_l (B, S_loc, KV, hd) of the sequence whose rows hold the
    global positions ``gidx`` (S_loc,): q scaled and rounded to the
    slice's dtype, products accumulated in f32, positions at or past
    ``vlen`` (B,) and the position ``excl`` (B,) (None: none) masked to
    NEG_INF."""
    B, hd = q.shape[0], q.shape[-1]
    f32 = torch.float32
    qf = (q.to(f32) * hd ** -0.5).to(k_l.dtype).to(f32)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_l.to(f32))
    mask = gidx[None, :] < vlen.reshape(B, 1)
    if excl is not None:
        mask = mask & (gidx[None, :] != excl.reshape(B, 1))
    return torch.where(mask[:, None, None, None, :], s, NEG_INF)


def _slice_partials(s, m_glob, v_l):
    """One slice's share of the joined softmax under the joined row max
    ``m_glob`` (B, KV, G, Lq): its denominator (f32) and its partial output
    (B, KV, G, Lq, hd) in ``_pay_dtype``, the two that are summed over the
    slices."""
    f32 = torch.float32
    pr = torch.exp(s - m_glob[..., None])
    pv = torch.einsum("bkgqs,bskd->bkgqd", pr.to(v_l.dtype).to(f32),
                      v_l.to(f32))
    return torch.sum(pr, dim=-1), pv.to(_pay_dtype(v_l.dtype))


def _join_slices(s, v_l, mesh):
    """The ranks' slices joined: the pmax of the row max (floored at
    NEG_INF/10), then the psums of the denominators and of the partial
    outputs (in ``_pay_dtype``; O(B·H·hd·Lq) bytes, never the cache).
    Returns (num (B, KV, G, Lq, hd) f32, denom, m_glob) for
    ``_join_fresh``."""
    m_glob = torch.clamp(collectives.pmax(torch.amax(s, dim=-1), mesh),
                         min=NEG_INF / 10)
    den, pv = _slice_partials(s, m_glob, v_l)
    denom = collectives.psum(den, mesh)
    return collectives.psum(pv, mesh).to(torch.float32), denom, m_glob


@probes.fence()
def _decode_cached_sharded(q, k, v, k_all, v_all, scales, layer: int, ins,
                           vlen, excl, mesh):
    """Flash attention of the Lq fresh queries over this rank's S/tp slice
    of the cache (the reference's ``_decode_cached_shardmap``).

    k_all/v_all: (L, B, S_loc, KV, hd), this rank's rows [start, start +
    S_loc) of the global sequence, start = rank · S_loc; ``scales`` their
    (L, B, S_loc, KV) int8 scales.  q (B, Lq, KV, G, hd) and the fresh
    k/v (B, Lq, KV, hd) are whole on every rank.  ins/vlen/excl: (B,)
    global row ids: the first row the Lq fresh tokens are written to, the
    attendable length, and a row masked (None: none).

    Scores over the local slice (an int8 slice dequantized to q's dtype,
    q rounded to the slice's dtype, products accumulated in f32) are joined
    across ranks by ``_join_slices``.  Then the fresh
    rows are written on their owning rank only, at (row − start) mod
    S_loc (elsewhere the current value is written back; Lq ≤ S_loc keeps
    a slot's rows distinct).  The numerics probes record nothing here
    (``probes.fence``), as the reference's shard_map body drops its
    ``quantize_kv`` tap.  Returns (num, denom, m_glob) for
    ``_join_fresh``.
    """
    B, Lq = q.shape[:2]
    S_loc = k_all.shape[2]
    start = mesh.coords["model"] * S_loc
    k_raw, v_raw = k_all[layer], v_all[layer]
    if scales is not None:
        # the reference dequantizes to bf16 in any model; in q's dtype an
        # f32 model keeps the one-device noise floor (its f32 payload's aim)
        k_l = dequantize_kv(k_raw, scales[0][layer]).to(q.dtype)
        v_l = dequantize_kv(v_raw, scales[1][layer]).to(q.dtype)
    else:
        k_l, v_l = k_raw, v_raw
    s = _slice_scores(q, k_l, start + torch.arange(S_loc, device=q.device),
                      vlen, excl)
    num, denom, m_glob = _join_slices(s, v_l, mesh)
    rows = ins.reshape(B, 1).long() + torch.arange(Lq, device=q.device)
    owner = (rows >= start) & (rows < start + S_loc)
    loc = (rows - start) % S_loc
    bidx = torch.arange(B, device=q.device)[:, None]

    def put(sl, new):
        cur = sl[bidx, loc]
        ow = owner.reshape(owner.shape + (1,) * (cur.ndim - 2))
        sl[bidx, loc] = torch.where(ow, new.to(sl.dtype), cur)

    if scales is not None:
        (k, ksc), (v, vsc) = quantize_kv(k), quantize_kv(v)
        put(scales[0][layer], ksc)
        put(scales[1][layer], vsc)
    put(k_raw, k)
    put(v_raw, v)
    return num, denom, m_glob


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
    qi, sc = q.to(torch.int8), scale[..., 0].to(torch.bfloat16)
    # the round-trip error against the stored (int8, bf16 scale) pair: a
    # no-op unless a probes frame is open
    probes.tap_kv(t, qi, sc)
    return qi, sc


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


@probes.fence()
def _paged_flash_sharded(q, k, v, k_pool, v_pool, scales, layer: int,
                         page_table, write_pid, write_off, vlen, mesh):
    """Flash attention of the Lq fresh queries over this rank's in-page
    slice of the slots' pages (the reference's ``_paged_flash_shardmap``).

    k_pool/v_pool: (L, n_pages, page_loc, KV, hd), this rank's contiguous
    pool: rows [rank · page_loc, (rank + 1) · page_loc) of every page,
    page_loc = page / tp; ``scales`` their (L, n_pages, page_loc, KV) int8
    scales.  The page table (B, P) is the same on every rank.  q (B, Lq,
    KV, G, hd) and the fresh k/v (B, Lq, KV, hd) are whole on every rank;
    write_pid/write_off: (B, Lq) each fresh token's page and *global*
    in-page offset; vlen: (B,) the attendable prefix.

    One ``gather_pages_many`` launch gathers this rank's slice of the
    pages (int8 pages dequantized to f32, the reference's choice here;
    float pages stay in their dtype).  Local row t holds the global
    position (t // page_loc) · page + rank · page_loc + t % page_loc, which
    the mask reads.  The slices are joined by ``_join_slices``.  A rank
    writes only the fresh tokens it owns (write_off // page_loc == rank),
    at offset write_off % page_loc; the others go to its trash page 0 at
    offset 0, which nothing reads unmasked (``index_put_`` without
    accumulate: any of the aliased values may land there).  The numerics
    probes record nothing here, as in ``_decode_cached_sharded``.  Returns
    (num, denom, m_glob) for ``_join_fresh``.
    """
    m_id = mesh.coords["model"]
    page_loc = k_pool.shape[2]
    page = page_loc * mesh.tp
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    t = torch.arange(k_l.shape[1], device=q.device)
    gpos = (t // page_loc) * page + m_id * page_loc + t % page_loc
    s = _slice_scores(q, k_l, gpos, vlen, None)
    num, denom, m_glob = _join_slices(s, v_l, mesh)
    owner = (write_off // page_loc) == m_id
    zero = torch.zeros((), dtype=torch.long, device=q.device)
    _store_token(k, v, k_pool, v_pool, scales, layer,
                 torch.where(owner, write_pid.long(), zero),
                 torch.where(owner, write_off.long() % page_loc, zero))
    return num, denom, m_glob


def _paged_sharded_out(p, q, k, v, k_pool, v_pool, scales, layer: int,
                       page_table, write_pid, write_off, vlen, cfg, backend):
    """The paged attention of a tensor-parallel backend, joined and through
    wo: (B, Lq, D)."""
    B, Lq = q.shape[:2]
    num, denom, m_glob = _paged_flash_sharded(
        q, k, v, k_pool, v_pool, scales, layer, page_table, write_pid,
        write_off, vlen, backend.mesh)
    out = _join_fresh(q, k, v, num, denom, m_glob)
    return _out_proj(p, out.reshape(B, Lq, cfg.n_heads * cfg.hd), backend)


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
    ``scales`` (ks, vs) present ⇒ int8 pages.  On a tensor-parallel
    backend the pools are this rank's in-page slices and the ranks join
    (``_paged_flash_sharded``).  Returns the attention output (B, 1, D).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    if getattr(backend, "mesh", None) is not None:
        return _paged_sharded_out(p, q, k, v, k_pool, v_pool, scales, layer,
                                  page_table, write_pid[:, None],
                                  write_off[:, None], valid_len, cfg, backend)
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    out = decode_attention(q, k_l, v_l, valid_len, extra_kv=(k, v))
    # index_put_ without accumulate: retired slots may all write page 0 at
    # one offset, and any one of their values may land there
    _store_token(k[:, 0], v[:, 0], k_pool, v_pool, scales, layer,
                 write_pid.long(), write_off.long())
    return _out_proj(p, out.reshape(B, 1, cfg.n_heads * cfg.hd), backend)


def attn_verify_paged(p, x, cfg: AttnConfig, *, pos, page_table, write_pid,
                      write_off, valid_len, k_pool, v_pool, layer: int,
                      scales=None,
                      backend: dispatch.BackendSpec = dispatch.DENSE):
    """Speculative verify of one layer against the paged cache (the paged
    twin of ``attn_verify_cached``): gather the slots' pages, attend as
    ``chunk_attention`` does (full to the valid prefix ``valid_len`` (B,),
    causal among the K1 fresh tokens), then write each fresh token's K/V
    (quantized, with their scales, for int8 pages) in place.

    x: (B, K1, D); pos: (B, K1) RoPE positions; write_pid/write_off:
    (B, K1) page and in-page offset of each token (the K1 tokens may
    straddle a page boundary; positions past a slot's pages and retired
    slots route to the trash page 0).  On a tensor-parallel backend, as
    ``attn_decode_paged``.  Returns the attention output (B, K1, D).
    """
    B, K1, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    if getattr(backend, "mesh", None) is not None:
        # each token's owner from its own offset: the K1 may straddle pages
        return _paged_sharded_out(p, q, k, v, k_pool, v_pool, scales, layer,
                                  page_table, write_pid, write_off,
                                  valid_len, cfg, backend)
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    out = chunk_attention(q, k_l, v_l, valid_len, k, v)
    _store_token(k, v, k_pool, v_pool, scales, layer, write_pid.long(),
                 write_off.long())
    return _out_proj(p, out.reshape(B, K1, cfg.n_heads * cfg.hd), backend)


def attn_prefill_chunk(p, x, cfg: AttnConfig, *, pos, page_table, write_pid,
                       past_len, k_pool, v_pool, layer: int, scales=None,
                       backend: dispatch.BackendSpec = dispatch.DENSE):
    """One page-sized prefill chunk of one request against the paged cache.

    x: (1, C, D) with C == page size; ``past_len`` tokens already live in
    the pages of ``page_table`` (1, P).  The chunk's K/V are written as one
    page at id ``write_pid`` (0, the trash page, for a shared prefix page
    recomputed only for its logits).  On a tensor-parallel backend the
    chunk is written token by token, each rank keeping its in-page slice,
    and the ranks join (``_paged_flash_sharded``).  Returns the attention
    output (1, C, D).
    """
    B, C, _ = x.shape
    if B != 1:
        raise ValueError(f"attn_prefill_chunk is batch-of-one (got B={B}); "
                         "prompts stream through chunks one request at a "
                         "time")
    q, k, v = _project_qkv(p, x, cfg, pos, backend)
    if getattr(backend, "mesh", None) is not None:
        # per token, as the reference: page write_pid at offsets 0..C−1,
        # each rank keeping its in-page slice (write_pid 0: all to trash)
        dev = x.device
        return _paged_sharded_out(
            p, q, k, v, k_pool, v_pool, scales, layer, page_table,
            torch.full((1, C), int(write_pid), dtype=torch.long, device=dev),
            torch.arange(C, device=dev)[None],
            torch.full((1,), int(past_len), dtype=torch.long, device=dev),
            cfg, backend)
    k_l, v_l = _gather_paged_kv(k_pool, v_pool, page_table, layer, scales)
    out = chunk_attention(q, k_l, v_l, past_len, k, v)
    _store_token(k[0], v[0], k_pool, v_pool, scales, layer, int(write_pid),
                 slice(None))
    return _out_proj(p, out.reshape(B, C, cfg.n_heads * cfg.hd), backend)
