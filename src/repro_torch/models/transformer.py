"""Dense-family decoder LM: init, prefill, contiguous decode step (the port's
copy of the dense-family serving parts of ``repro/models/transformer.py``).

Parameters are a nested dict in the JAX package's layout: per-layer tensors
are stacked under ``params['blocks']`` with a leading layer dim, and the
layer loop walks views of that stack (the port's stand-in for
``lax.scan``).  The cache is {'kv': {'k', 'v'}: (L, B, S, KV, hd),
'pos': (B,)}; decode writes the new token's K/V into it in place.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models import attention as A
from repro_torch.models import layers as L

__all__ = ["init_params", "prefill", "decode_step", "init_cache", "attn_cfg"]

_FAMILIES = ("dense",)
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def attn_cfg(cfg) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        window=cfg.window, causal=True, kv_block=cfg.kv_block)


def init_params(gen: torch.Generator, cfg, device=None):
    """Random parameters with the reference's standard deviations:
    embeddings N(0, 0.02²), every dense matrix N(0, 1/d_in), norm scales 1.
    Drawn from ``gen`` (a ``torch.Generator`` on ``device``)."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port builds the {_FAMILIES} families; got {cfg.family!r}")
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
                   "ln2": L.rms_norm_init(d, dt, dev, layers=n),
                   "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, dev, layers=n)}
    return p


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked parameter dict."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _logits(p, cfg, x):
    if cfg.tie_embeddings:
        logits = L.embed_logits(p["embed"], x)
    else:
        logits = L.dense(p["lm_head"], x).to(torch.float32)
    if cfg.padded_vocab != cfg.vocab:  # mask padded ids
        logits[..., cfg.vocab:] = -1e30
    return logits


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Contiguous decode cache with per-slot positions."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                   "v": torch.zeros(shape, dtype=dtype, device=dev)},
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params, cfg, batch, backend=dispatch.DENSE):
    """Forward over the right-padded prompt batch.

    batch: {'tokens': (B, S) int, 'lengths': (B,) int (optional)}.
    Returns (logits (B, 1, V) at each row's last real position, cache with
    K/V planes (L, B, S, KV, hd) and ``pos`` = lengths).
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
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        a, kv = A.attn_apply(p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg,
                             backend)
        x = x + a
        x = x + L.swiglu(p_l["mlp"], L.rms_norm(p_l["ln2"], x),
                         cfg.act_kind, cfg.act_levels, backend)
        ks.append(kv["k"].to(cdt))
        vs.append(kv["v"].to(cdt))
    cache = {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
             "pos": lengths.to(torch.int32)}
    last = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(B, device=x.device), last][:, None]
    x_last = L.rms_norm(params["final_norm"], x_last)
    return _logits(params, cfg, x_last), cache


def decode_step(params, cfg, tokens, cache, backend=dispatch.DENSE):
    """One decode step for every slot.  tokens: (B, 1).  ``cache['pos']``
    is the (B,) vector of per-slot positions.

    Retired slots keep decoding into ``min(pos, S-1)`` until the engine
    reuses them.  The cache's K/V planes are updated in place; the returned
    cache carries ``pos + 1``.
    """
    dt = _dtype(cfg)
    pos_v = cache["pos"]
    S = cache["kv"]["k"].shape[2]
    ins = torch.clamp(pos_v, max=S - 1).long()
    vlen = torch.clamp(pos_v + 1, max=S)
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        x = x + A.attn_decode_cached(
            p_l["attn"], L.rms_norm(p_l["ln1"], x), acfg, pos=pos_v[:, None],
            insert_at=ins, valid_len=vlen, k_all=k_all, v_all=v_all, layer=i,
            backend=backend)
        x = x + L.swiglu(p_l["mlp"], L.rms_norm(p_l["ln2"], x),
                         cfg.act_kind, cfg.act_levels, backend)
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x), {**cache, "pos": pos_v + 1}
