"""Decoder LM of the dense and mixture-of-experts families: init, prefill,
the contiguous decode step and speculative verify step, and the paged KV
cache's chunked prefill, decode step and speculative verify step (the
port's copy of the KV-cache serving parts of
``repro/models/transformer.py``).  A ``moe`` model's blocks carry
``'moe'`` (``models/moe.py``) where a dense model's carry ``'mlp'``; every
FFN site goes through ``_ffn``, which takes the routed FFN when the layer
has one, as the reference's ``_dense_block`` does.

Parameters are a nested dict in the JAX package's layout: per-layer tensors
are stacked under ``params['blocks']`` with a leading layer dim, and the
layer loop walks views of that stack (the port's stand-in for
``lax.scan``).  The contiguous cache is {'kv': {'k', 'v'}: (L, B, S, KV,
hd), 'pos': (B,)}, with int8 'k'/'v' and bf16 {'k_scale', 'v_scale': (L,
B, S, KV)} when ``cfg.kv_quant`` is set; the paged pool is {'k', 'v': (L,
n_pages, page, KV, hd)} plus {'k_scale', 'v_scale': (L, n_pages, page, KV)} for int8 pages, and a
paged decode cache adds 'page_table' (B, P) and 'pos' (B,).  Both write the
new tokens' K/V in place.

Numerics probes (``kernels/probes.py``): a prefill's ``batch`` or a decode
or chunk cache may carry ``'probes'``, the engine's probe state.  Each
layer's body (attention, FFN and, where the cache is int8, the quantization
of its K/V) then runs under ``probes.layer(ps, i)``, and the forward adds
its token count (and, paged, the page-table ids outside the pool) in
place.  The tied logits stay outside every frame, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch, probes
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M

__all__ = ["FAMILIES", "init_params", "prefill", "decode_step", "verify_step",
           "init_cache", "attn_cfg", "moe_cfg", "init_paged_cache",
           "prefill_chunk"]

FAMILIES = ("dense", "moe")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def attn_cfg(cfg) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.window, causal=True, kv_block=cfg.kv_block)


def moe_cfg(cfg) -> M.MoEConfig:
    return M.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.moe_capacity,
                       token_chunks=cfg.moe_token_chunks,
                       act_kind=cfg.act_kind, act_levels=cfg.act_levels)


def init_params(gen: torch.Generator, cfg, device=None):
    """Random parameters with the reference's standard deviations:
    embeddings N(0, 0.02²), every dense matrix N(0, 1/d_in), norm scales 1,
    and for ``moe`` the experts' (``moe.moe_init``).  Drawn from ``gen`` (a
    ``torch.Generator`` on ``device``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port builds the {FAMILIES} families; got {cfg.family!r}")
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d, hd, n = cfg.d_model, cfg.hd, (cfg.n_layers,)
    p = {"embed": L.embed_init(gen, cfg.padded_vocab, d, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.padded_vocab, dt, dev)
    p["final_norm"] = L.rms_norm_init(d, dt, dev)
    attn = {"wq": L.dense_init(gen, d, cfg.n_heads * hd, dt, dev, layers=n),
            "wk": L.dense_init(gen, d, cfg.n_kv * hd, dt, dev, layers=n),
            "wv": L.dense_init(gen, d, cfg.n_kv * hd, dt, dev, layers=n),
            "wo": L.dense_init(gen, cfg.n_heads * hd, d, dt, dev, layers=n)}
    if cfg.qk_norm:
        attn["q_norm"] = L.rms_norm_init(hd, dt, dev, layers=n)
        attn["k_norm"] = L.rms_norm_init(hd, dt, dev, layers=n)
    p["blocks"] = {"ln1": L.rms_norm_init(d, dt, dev, layers=n),
                   "attn": attn,
                   "ln2": L.rms_norm_init(d, dt, dev, layers=n)}
    if cfg.family == "moe":
        p["blocks"]["moe"] = M.moe_init(gen, moe_cfg(cfg), dt, dev, layers=n)
    else:
        p["blocks"]["mlp"] = L.swiglu_init(gen, d, cfg.d_ff, dt, dev,
                                           layers=n)
    return p


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked parameter dict."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _ffn(p_l, h, cfg, backend):
    """The layer's FFN on the residual ``h``: the routed experts when the
    layer has them (their products are plain, as the reference's; the
    backend runs the index-form matmuls only), else the SwiGLU."""
    if "moe" in p_l:
        return M.moe_apply(p_l["moe"], L.rms_norm(p_l["ln2"], h),
                           moe_cfg(cfg))
    return L.swiglu(p_l["mlp"], L.rms_norm(p_l["ln2"], h), cfg.act_kind,
                    cfg.act_levels, backend)


def _logits(p, cfg, x, backend):
    if cfg.tie_embeddings:
        logits = L.embed_logits(p["embed"], x)
    else:   # an untied head runs through the backend, as the reference's
        logits = L.dense(p["lm_head"], x, backend).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:  # mask padded ids
        logits[..., cfg.vocab:] = -1e30
    return logits


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Contiguous decode cache with per-slot positions.  ``cfg.kv_quant``:
    int8 K/V planes with per-token-per-head bf16 scales (``dtype`` is then
    not read), as the reference builds them."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    if cfg.kv_quant:
        kv = {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
              "v": torch.zeros(shape, dtype=torch.int8, device=dev),
              "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=dev),
              "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                     device=dev)}
    else:
        kv = {"k": torch.zeros(shape, dtype=dtype, device=dev),
              "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return {"kv": kv,
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, cfg, batch, backend=dispatch.DENSE):
    """Forward over the right-padded prompt batch.

    batch: {'tokens': (B, S) int, 'lengths': (B,) int (optional),
    'probes': the probe state (optional)}.
    Returns (logits (B, 1, V) at each row's last real position, cache with
    K/V planes (L, B, S, KV, hd), int8 with their scales (L, B, S, KV) when
    ``cfg.kv_quant`` is set, and ``pos`` = lengths).
    """
    dt = _dtype(cfg)
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else dt
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    lengths = batch.get("lengths")
    if lengths is None:
        lengths = torch.full((B,), Sq, dtype=torch.int32, device=tokens.device)
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    ps = batch.get("probes") or {}
    planes = []
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):
            a, kv = A.attn_apply(p_l["attn"], L.rms_norm(p_l["ln1"], x),
                                 acfg, backend)
            x = x + a
            x = x + _ffn(p_l, x, cfg, backend)
            if cfg.kv_quant:
                (kq, ksc), (vq, vsc) = (A.quantize_kv(kv["k"]),
                                        A.quantize_kv(kv["v"]))
                planes.append({"k": kq, "v": vq, "k_scale": ksc,
                               "v_scale": vsc})
            else:
                planes.append({"k": kv["k"].to(cdt), "v": kv["v"].to(cdt)})
    if ps:
        probes.bump(ps, "tokens", lengths.sum())
    cache = {"kv": {name: torch.stack([p[name] for p in planes])
                    for name in planes[0]},
             "pos": lengths.to(torch.int32)}
    last = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(B, device=x.device), last][:, None]
    x_last = L.rms_norm(params["final_norm"], x_last)
    return _logits(params, cfg, x_last, backend), cache


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype=torch.bfloat16,
                     device=None):
    """Paged KV page pool: (L, n_pages, page, KV, hd) tensors.

    ``dtype=torch.int8`` stores pages quantized with per-token-per-head bf16
    scales (``attention.quantize_kv``); a float dtype stores them plain.
    Page 0 is the allocator's trash page (``serving/kvcache.py``).
    """
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv, cfg.hd)
    if dtype == torch.int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _paged_scales(cache):
    if "k_scale" in cache:
        return (cache["k_scale"], cache["v_scale"])
    return None


def _page_oob(ps: dict, page_table, cache) -> None:
    """Count the ids of ``page_table`` outside the pool's [0, n_pages),
    which the gather clamps (a device sum; no-op without probes)."""
    if ps:
        n_pages = cache["k"].shape[1]
        probes.bump(ps, "page_oob",
                    ((page_table < 0) | (page_table >= n_pages)).sum())


def prefill_chunk(params, cfg, batch, cache, backend=dispatch.DENSE):
    """Chunked prefill: one page-sized chunk of ONE request's prompt.

    batch keys: ``tokens`` (1, C) with C == page size (the last chunk
    right-padded); ``start`` (int) absolute position of tokens[0],
    page-aligned; ``length`` (int) real tokens in the chunk; ``page_row``
    (P,) int32 the slot's page table; ``write_pid`` (int) page receiving the
    chunk's K/V (0 = trash).  ``cache`` is the pool (``init_paged_cache``),
    written in place, and may carry ``'probes'``.  Returns (logits (1, 1,
    V) at the chunk's last real position, the same pool).
    """
    dt = _dtype(cfg)
    tokens = batch["tokens"]
    start, length = int(batch["start"]), int(batch["length"])
    page_table = batch["page_row"].to(torch.int32)[None]           # (1, P)
    write_pid = int(batch["write_pid"])
    C = tokens.shape[1]
    pos = start + torch.arange(C, device=tokens.device)[None]       # (1, C)
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    scales = _paged_scales(cache)
    ps = cache.get("probes") or {}
    _page_oob(ps, page_table, cache)
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):    # the int8 page store's tap falls here
            x = x + A.attn_prefill_chunk(
                p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg, pos=pos,
                page_table=page_table, write_pid=write_pid, past_len=start,
                k_pool=cache["k"], v_pool=cache["v"], layer=i,
                scales=scales, backend=backend)
            x = x + _ffn(p_l, x, cfg, backend)
    probes.bump(ps, "tokens", length)
    x_last = L.rms_norm(params["final_norm"], x[:, length - 1:length])
    return _logits(params, cfg, x_last, backend), cache


def _decode_step_paged(params, cfg, tokens, cache, backend):
    """One paged decode step: per-slot page tables, (B,) positions.

    Logical position s of slot b lives at pool[page_table[b, s // page],
    s % page].  The attendable prefix is ``min(pos, S_cap)`` with no slot
    excluded: the fresh token enters through ``extra_kv``.  Retired slots
    carry all-zero page-table rows, so their writes land in the trash page.
    """
    dt = _dtype(cfg)
    pos = cache["pos"]
    pt = cache["page_table"]
    B = tokens.shape[0]
    page = cache["k"].shape[2]
    S_cap = pt.shape[1] * page
    ins = torch.clamp(pos, max=S_cap - 1).long()
    vlen = torch.clamp(pos, max=S_cap)
    write_pid = pt[torch.arange(B, device=pt.device), ins // page]
    write_off = ins % page
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    scales = _paged_scales(cache)
    ps = cache.get("probes") or {}
    _page_oob(ps, pt, cache)
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):
            x = x + A.attn_decode_paged(
                p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg,
                pos=pos[:, None], page_table=pt, write_pid=write_pid,
                write_off=write_off, valid_len=vlen, k_pool=cache["k"],
                v_pool=cache["v"], layer=i, scales=scales, backend=backend)
            x = x + _ffn(p_l, x, cfg, backend)
    probes.bump(ps, "tokens", B)
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), {**cache, "pos": pos + 1}


def decode_step(params, cfg, tokens, cache, backend=dispatch.DENSE):
    """One decode step for every slot.  tokens: (B, 1).  ``cache['pos']``
    is the (B,) vector of per-slot positions.  A cache carrying a
    ``page_table`` is a page pool and takes the paged step.

    Retired slots keep decoding into ``min(pos, S-1)`` until the engine
    reuses them, and count as tokens for the probes, as the reference's
    do.  The cache's K/V planes (and, for ``cfg.kv_quant``, their
    scales) are updated in place; the returned cache carries ``pos + 1``.
    """
    if "page_table" in cache:
        return _decode_step_paged(params, cfg, tokens, cache, backend)
    dt = _dtype(cfg)
    pos_v = cache["pos"]
    S = cache["kv"]["k"].shape[2]
    ins = torch.clamp(pos_v, max=S - 1).long()
    vlen = torch.clamp(pos_v + 1, max=S)
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    kv = cache["kv"]
    scales = (kv["k_scale"], kv["v_scale"]) if cfg.kv_quant else None
    ps = cache.get("probes") or {}
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):
            x = x + A.attn_decode_cached(
                p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg,
                pos=pos_v[:, None], insert_at=ins, valid_len=vlen,
                k_all=kv["k"], v_all=kv["v"], layer=i, scales=scales,
                backend=backend)
            x = x + _ffn(p_l, x, cfg, backend)
    probes.bump(ps, "tokens", tokens.shape[0])
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), {**cache, "pos": pos_v + 1}


def _verify_step_paged(params, cfg, tokens, cache, backend):
    """Paged speculative verify: K1 tokens a slot against gathered pages.

    Logical position ``pos + i`` of slot b is written at page
    ``page_table[b, (pos + i) // page]``, offset ``(pos + i) % page``;
    positions past the slot's page span (speculative overshoot beyond the
    admission reservation, which the engine clamps away) and retired
    slots (all-zero rows) route to the trash page 0.  The attendable
    prefix is ``min(pos, P·page)``.  Not instrumented: see
    ``verify_step``.
    """
    dt = _dtype(cfg)
    pos = cache["pos"]
    pt = cache["page_table"]
    B, K1 = tokens.shape
    page = cache["k"].shape[2]
    P = pt.shape[1]
    ppos = pos[:, None].long() + torch.arange(K1, device=tokens.device)[None]
    pidx = ppos // page
    rows = torch.arange(B, device=pt.device)[:, None]
    write_pid = torch.where(pidx < P, pt[rows, torch.clamp(pidx, max=P - 1)],
                            torch.zeros((), dtype=pt.dtype, device=pt.device))
    write_off = ppos % page
    vlen = torch.clamp(pos, max=P * page)
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    scales = _paged_scales(cache)
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        x = x + A.attn_verify_paged(
            p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg, pos=ppos,
            page_table=pt, write_pid=write_pid, write_off=write_off,
            valid_len=vlen, k_pool=cache["k"], v_pool=cache["v"], layer=i,
            scales=scales, backend=backend)
        x = x + _ffn(p_l, x, cfg, backend)
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), cache


def verify_step(params, cfg, tokens, cache, backend=dispatch.DENSE):
    """Speculative verify: score K1 tokens per slot in one forward.

    tokens: (B, K1), per slot the pending token then K draft proposals.
    Returns (logits (B, K1, V) at every position, the cache): ``logits[:,
    i]`` is the target's distribution for the token after ``tokens[:, i]``.
    K/V of all K1 tokens are written in place at rows pos..pos+K1−1 of each
    slot (contiguous: clamped to ``S − K1``, int8 with their scales under
    ``cfg.kv_quant``; a cache with a ``page_table`` is a page pool and
    takes the paged verify, ``_verify_step_paged``); ``cache['pos']``
    comes back unchanged: the caller advances it by the accepted count,
    and the rejected rows above it are fenced by every later step's valid
    length.

    No probes frame is opened here: the engine refuses probes with
    ``spec``, as the reference's does, so a verify never carries a probe
    state.
    """
    if "page_table" in cache:
        return _verify_step_paged(params, cfg, tokens, cache, backend)
    dt = _dtype(cfg)
    B, K1 = tokens.shape
    pos_v = cache["pos"]
    S = cache["kv"]["k"].shape[2]
    ins = torch.clamp(pos_v, max=S - K1)
    vlen = torch.clamp(pos_v, max=S)
    ppos = pos_v[:, None] + torch.arange(K1, device=tokens.device)[None]
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    kv = cache["kv"]
    scales = (kv["k_scale"], kv["v_scale"]) if cfg.kv_quant else None
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        x = x + A.attn_verify_cached(
            p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg, pos=ppos,
            insert_at=ins, valid_len=vlen, k_all=kv["k"], v_all=kv["v"],
            layer=i, scales=scales, backend=backend)
        x = x + _ffn(p_l, x, cfg, backend)
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), cache
