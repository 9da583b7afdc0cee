"""Decoder LMs of the dense, mixture-of-experts, vision-language,
encoder-decoder, RWKV-6 and Mamba2/Zamba2 hybrid families (the port's copy
of ``repro/models/transformer.py``): init, the trunk ``forward``, prefill
and the decode step for every family; the training loss ``loss_fn`` for
every family (``forward`` runs under autograd, each block, the
encoder's included, and each of the hybrid's groups checkpointed when
``cfg.remat`` is set, as the reference's ``jax.checkpoint``); the
speculative verify step and the paged KV cache's chunked prefill, decode
step and verify step for the paged families (dense, moe).  A ``moe`` model's
blocks carry ``'moe'`` (``models/moe.py``) where a dense model's carry
``'mlp'``; every FFN site goes through ``_ffn``, which takes the routed
FFN when the layer has one, as the reference's ``_dense_block`` does.

The ``vlm`` family (qwen2-vl) is the dense tree; its prompts come in as
precomputed embeddings with M-RoPE positions (3, B, L), its decode looks
tokens up and rotates them with one position stream.  The ``audio``
family (whisper) is an encoder-decoder: a non-causal encoder over frame
embeddings (``_encoder``), and decoder blocks of layer norms, causal
self-attention, cross-attention over the encoder's output and a biased
MLP; its cache adds that output as ``memory``.  Both have the contiguous
cache, ``lengths`` and per-slot positions of the dense family, and no
paged cache or verify step, as in the reference.

The recurrent families (``ssm_rwkv``: ``models/rwkv.py``; ``hybrid``: a
stack of Mamba2 blocks, ``models/ssm.py``, with one shared attention block
applied before every group of ``shared_attn_every`` of them on concat(h,
embeddings)) keep the reference's uniform-batch contract: their caches
carry a 0-d ``pos``, their prefill takes no ``lengths``, and they have no
paged cache and no verify step.  Their decode returns fresh state tensors
(the reference's dtypes, promotions included), but the hybrid's shared
K/V ring is written in place.

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
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch, probes
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as S
from repro_torch.tree import leaves

__all__ = ["FAMILIES", "init_params", "forward", "loss_fn", "prefill",
           "decode_step",
           "verify_step", "init_cache", "attn_cfg", "moe_cfg", "ssm_cfg",
           "rwkv_cfg", "init_paged_cache", "prefill_chunk"]

FAMILIES = ("dense", "moe", "vlm", "audio", "ssm_rwkv", "hybrid")
_KV_FAMILIES = ("dense", "moe", "vlm", "audio")   # contiguous KV cache
_PAGED_FAMILIES = ("dense", "moe")   # KV-cache LMs: paged cache, verify
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def attn_cfg(cfg, *, causal: bool = True) -> A.AttnConfig:
    return A.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.hd, qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        rope_sections=cfg.rope_sections, window=cfg.window, causal=causal,
        kv_block=cfg.kv_block)


def moe_cfg(cfg) -> M.MoEConfig:
    return M.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.top_k,
                       capacity_factor=cfg.moe_capacity,
                       token_chunks=cfg.moe_token_chunks, fsdp=cfg.fsdp,
                       act_kind=cfg.act_kind, act_levels=cfg.act_levels)


def ssm_cfg(cfg) -> S.SSMConfig:
    return S.SSMConfig(d_model=cfg.d_model, d_state=cfg.ssm_state,
                       head_dim=cfg.ssm_head_dim, chunk=cfg.ssm_chunk,
                       act_kind="silu", act_levels=cfg.act_levels)


def rwkv_cfg(cfg) -> R.RWKVConfig:
    return R.RWKVConfig(d_model=cfg.d_model, head_dim=cfg.rwkv_head_dim,
                        d_ff=cfg.d_ff, chunk=cfg.ssm_chunk,
                        act_levels=cfg.act_levels)


def _attn_init(gen, cfg, dt, dev, layers: tuple = ()):
    d, hd = cfg.d_model, cfg.hd

    def mat(d_in, d_out):
        return L.dense_init(gen, d_in, d_out, dt, dev, layers=layers)
    attn = {"wq": mat(d, cfg.n_heads * hd), "wk": mat(d, cfg.n_kv * hd),
            "wv": mat(d, cfg.n_kv * hd), "wo": mat(cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = L.rms_norm_init(hd, dt, dev, layers=layers)
        attn["k_norm"] = L.rms_norm_init(hd, dt, dev, layers=layers)
    return attn


def init_params(gen: torch.Generator, cfg, device=None):
    """Random parameters with the reference's initializers: embeddings and
    the encoder's position table N(0, 0.02²), every dense matrix N(0,
    1/d_in) with zero biases, norm scales 1 (and layer-norm biases 0), and
    the experts', RWKV-6's and Mamba2's own (``moe.moe_init``,
    ``rwkv.rwkv_tm_init``/``rwkv_cm_init``, ``ssm.ssm_init``).  Drawn from
    ``gen`` (a ``torch.Generator`` on ``device``)."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port builds the {FAMILIES} families; got {cfg.family!r}")
    dev = resolve_device(device)
    dt = _dtype(cfg)
    d, n = cfg.d_model, (cfg.n_layers,)
    p = {"embed": L.embed_init(gen, cfg.padded_vocab, d, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.padded_vocab, dt, dev)
    if cfg.family == "audio":
        p["final_norm"] = L.layer_norm_init(d, dt, dev)
        p.update(_audio_init(gen, cfg, dt, dev))
        return p
    p["final_norm"] = L.rms_norm_init(d, dt, dev)
    norm = lambda: L.rms_norm_init(d, dt, dev, layers=n)  # noqa: E731
    if cfg.family == "ssm_rwkv":
        rc = rwkv_cfg(cfg)
        p["blocks"] = {"ln1": norm(),
                       "tm": R.rwkv_tm_init(gen, rc, dt, dev, layers=n),
                       "ln2": norm(),
                       "cm": R.rwkv_cm_init(gen, rc, dt, dev, layers=n)}
        return p
    if cfg.family == "hybrid":
        p["blocks"] = {"ln": norm(),
                       "ssm": S.ssm_init(gen, ssm_cfg(cfg), dt, dev,
                                         layers=n)}
        # the shared block: concat(h, embeddings) -> d, attention, SwiGLU
        p["shared"] = {"in_proj": L.dense_init(gen, 2 * d, d, dt, dev),
                       "ln1": L.rms_norm_init(d, dt, dev),
                       "attn": _attn_init(gen, cfg, dt, dev),
                       "ln2": L.rms_norm_init(d, dt, dev),
                       "mlp": L.swiglu_init(gen, d, cfg.d_ff, dt, dev)}
        return p
    p["blocks"] = {"ln1": norm(), "attn": _attn_init(gen, cfg, dt, dev, n),
                   "ln2": norm()}
    if cfg.family == "moe":
        p["blocks"]["moe"] = M.moe_init(gen, moe_cfg(cfg), dt, dev, layers=n)
    else:
        p["blocks"]["mlp"] = L.swiglu_init(gen, d, cfg.d_ff, dt, dev,
                                           layers=n)
    return p


def _audio_init(gen, cfg, dt, dev):
    """The encoder-decoder's own parameters: the encoder's position table
    ``enc_pos`` (enc_len, d), its blocks (layer norms, non-causal
    self-attention, the biased MLP) and final ``enc_norm``, and the
    decoder's blocks, which add cross-attention (``ln_x``, ``xattn``)."""
    d = cfg.d_model
    enc, dec = (cfg.enc_layers,), (cfg.n_layers,)

    def ln(n):
        return L.layer_norm_init(d, dt, dev, layers=n)
    table = torch.randn((cfg.enc_len, d), generator=gen, device=dev) * 0.02
    return {"enc_pos": {"table": table.to(dt)},
            "enc_blocks": {"ln1": ln(enc),
                           "attn": _attn_init(gen, cfg, dt, dev, enc),
                           "ln2": ln(enc),
                           "mlp": L.mlp_init(gen, d, cfg.d_ff, dt, dev,
                                             layers=enc)},
            "blocks": {"ln1": ln(dec),
                       "attn": _attn_init(gen, cfg, dt, dev, dec),
                       "ln_x": ln(dec),
                       "xattn": _attn_init(gen, cfg, dt, dev, dec),
                       "ln2": ln(dec),
                       "mlp": L.mlp_init(gen, d, cfg.d_ff, dt, dev,
                                         layers=dec)},
            "enc_norm": L.layer_norm_init(d, dt, dev)}


def _layer(tree, i: int):
    """Views of layer ``i`` of a stacked parameter dict."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _training(params) -> bool:
    """Autograd records this forward: grad mode is on and a parameter
    requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in leaves(params))


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter dict, as ``_layer`` gives
    them, by one ``torch.unbind`` a leaf: its backward stacks the layers'
    gradients once (a ``v[i]`` view would add a full-size zero-filled
    gradient a layer)."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unbind(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def _layers(tree, n: int, train: bool) -> list:
    """The ``n`` layers of a stacked parameter dict: unbound once under
    autograd (``_unbind``), views (``_layer``) otherwise."""
    return _unbind(tree, n) if train else [_layer(tree, i) for i in range(n)]


def _remat(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``on`` (its
    activations recomputed in the backward, as the reference's
    ``jax.checkpoint``)."""
    if on:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _norm(cfg):
    """The decoder's norm: layer norm for the encoder-decoder, RMS norm for
    every other family."""
    return L.layer_norm if cfg.family == "audio" else L.rms_norm


def _kv_block(p_l, x, cfg, backend, pos=None, memory=None):
    """One pre-norm block of the KV-cache families over whole prompts:
    (x, the layer's K/V planes).  ``pos``: RoPE positions (None: 0..L−1);
    ``memory``: the encoder's output, which a decoder block of the
    encoder-decoder attends after its self-attention."""
    a, kv = A.attn_apply(p_l["attn"], _norm(cfg)(p_l["ln1"], x), attn_cfg(cfg),
                         backend, pos=pos)
    x = x + a
    if cfg.family == "audio":
        return _dec_tail(p_l, x, memory, cfg, backend), kv
    return x + _ffn(p_l, x, cfg, backend), kv


def _dec_tail(p_l, x, memory, cfg, backend):
    """A decoder block of the encoder-decoder after its self-attention:
    cross-attention over ``memory`` (its K/V projected anew on every call,
    as the reference's are), then the biased MLP."""
    c, _ = A.attn_apply(p_l["xattn"], L.layer_norm(p_l["ln_x"], x),
                        attn_cfg(cfg, causal=False), backend,
                        kv_override=memory)
    x = x + c
    return x + L.mlp_block(p_l["mlp"], L.layer_norm(p_l["ln2"], x),
                           cfg.act_kind, cfg.act_levels, backend)


def _enc_block(p_l, x, cfg, backend):
    """A non-causal pre-norm block of the encoder."""
    a, _ = A.attn_apply(p_l["attn"], L.layer_norm(p_l["ln1"], x),
                        attn_cfg(cfg, causal=False), backend)
    x = x + a
    return x + L.mlp_block(p_l["mlp"], L.layer_norm(p_l["ln2"], x),
                           cfg.act_kind, cfg.act_levels, backend)


def _encoder(params, cfg, frames, backend):
    """The encoder over (B, enc_len, d) frame embeddings (the reference's
    stub of a conv front end): the position table added (read as
    ``enc_pos['table']``, so a compressed table raises ``KeyError``, as
    the reference's does), non-causal pre-norm blocks (``_remat``'d under
    autograd), ``enc_norm``."""
    train = _training(params)
    x = (frames.to(_dtype(cfg))
         + params["enc_pos"]["table"][None, :frames.shape[1]])
    for p_l in _layers(params["enc_blocks"], cfg.enc_layers, train):
        x = _remat(train and cfg.remat, _enc_block, p_l, x, cfg, backend)
    return L.layer_norm(params["enc_norm"], x)


def _embed_prompt(params, cfg, batch):
    """(x, RoPE positions) of a prompt batch: the vlm takes precomputed
    embeddings ``batch['embeds']`` (B, L, d) and ``batch['positions']``
    (3, B, L) (optional), every other family looks its tokens up."""
    if cfg.family == "vlm":
        return batch["embeds"].to(_dtype(cfg)), batch.get("positions")
    x = L.embed_lookup(params["embed"], batch["tokens"])
    return x.to(_dtype(cfg)), None


def _ffn(p_l, h, cfg, backend):
    """The layer's FFN on the residual ``h``: the routed experts when the
    layer has them (their products are plain, as the reference's; the
    backend runs the index-form matmuls only), else the SwiGLU."""
    if "moe" in p_l:
        return M.moe_apply(p_l["moe"], L.rms_norm(p_l["ln2"], h),
                           moe_cfg(cfg), getattr(backend, "mesh", None))
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


# --- the recurrent families' blocks ------------------------------------------

def _rwkv_block(p_l, x, cfg, backend, state=None, decode=False):
    """Time-mix then channel-mix, each on its pre-norm residual.  Returns
    (x, the layer's new state {'s', 'x_tm', 'x_cm'})."""
    rc = rwkv_cfg(cfg)
    f_tm = R.rwkv_tm_decode if decode else R.rwkv_tm_apply
    f_cm = R.rwkv_cm_decode if decode else R.rwkv_cm_apply
    tm, st_tm = f_tm(p_l["tm"], L.rms_norm(p_l["ln1"], x), rc, state, backend)
    x = x + tm
    cm, st_cm = f_cm(p_l["cm"], L.rms_norm(p_l["ln2"], x), rc, state, backend)
    return x + cm, {**st_tm, **st_cm}


def _shared_in(shared, h, x0, backend):
    """The shared block's input: concat(h, embeddings) projected to d."""
    return L.dense(shared["in_proj"], torch.cat([h, x0], dim=-1), backend)


def _shared_mlp(shared, hin, cfg, backend):
    return hin + L.swiglu(shared["mlp"], L.rms_norm(shared["ln2"], hin),
                          cfg.act_kind, cfg.act_levels, backend)


def _shared_block(shared, h, x0, cfg, backend):
    """The hybrid's shared attention block over a prompt (no cache)."""
    hin = _shared_in(shared, h, x0, backend)
    a, _ = A.attn_apply(shared["attn"], L.rms_norm(shared["ln1"], hin),
                        attn_cfg(cfg), backend)
    return h + _shared_mlp(shared, hin + a, cfg, backend)


def _mamba_block(p_l, x, cfg, backend, cache=None):
    """A Mamba2 block on its pre-norm residual: over a prompt, or one decode
    step when ``cache`` ({'h', 'conv'}) is given.  Returns (x, the new
    cache or None)."""
    sc = ssm_cfg(cfg)
    h = L.rms_norm(p_l["ln"], x)
    if cache is None:
        return x + S.ssm_apply(p_l["ssm"], h, sc, backend), None
    y, new = S.ssm_decode_step(p_l["ssm"], h, sc, cache, backend)
    return x + y, new


def _groups(cfg) -> int:
    """The hybrid's groups: one shared block before each run of
    ``shared_attn_every`` Mamba2 blocks."""
    return cfg.n_layers // cfg.shared_attn_every


def _rwkv_trunk(params, cfg, x, backend):
    """RWKV-6's layers over whole prompts: (x, each layer's final state)."""
    states = []
    for i in range(cfg.n_layers):
        x, st = _rwkv_block(_layer(params["blocks"], i), x, cfg, backend)
        states.append(st)
    return x, states


def _kv_block_x(p_l, x, cfg, backend, pos=None, memory=None):
    """``_kv_block``'s x alone (a forward keeps no K/V)."""
    return _kv_block(p_l, x, cfg, backend, pos, memory)[0]


def _rwkv_block_x(p_l, x, cfg, backend):
    """``_rwkv_block``'s x alone (a forward keeps no state)."""
    return _rwkv_block(p_l, x, cfg, backend)[0]


def _hybrid_group(shared, group, x, x0, cfg, backend):
    """One of the hybrid's groups: the shared block, then its
    ``shared_attn_every`` Mamba2 blocks (``group``: their layers)."""
    x = _shared_block(shared, x, x0, cfg, backend)
    for p_l in group:
        x, _ = _mamba_block(p_l, x, cfg, backend)
    return x


def forward(params, cfg, batch, backend=dispatch.DENSE):
    """The trunk over whole prompts, no cache: logits (B, L, padded_vocab)
    f32 at every position.  batch: {'tokens': (B, L)}; the vlm's
    {'embeds': (B, L, d), 'positions': (3, B, L) (optional)} in place of
    the token lookup; the encoder-decoder's {'frames': (B, enc_len, d)}
    beside its tokens.  Under autograd (``_training``) the layers are
    unbound once and, with ``cfg.remat``, each block (the encoder's too)
    runs under ``torch.utils.checkpoint``, recomputed in the backward; the
    hybrid checkpoints each group (its shared block and its Mamba2
    blocks), as the reference's ``jax.checkpoint(group)``: the shared
    parameters and the embeddings ``x0`` gather gradient from every
    group."""
    train = _training(params)
    remat = train and cfg.remat
    x, pos = _embed_prompt(params, cfg, batch)
    per_layer = _layers(params["blocks"], cfg.n_layers, train)
    if cfg.family in _KV_FAMILIES:
        memory = (_encoder(params, cfg, batch["frames"], backend)
                  if cfg.family == "audio" else None)
        for p_l in per_layer:
            x = _remat(remat, _kv_block_x, p_l, x, cfg, backend, pos, memory)
    elif cfg.family == "ssm_rwkv":
        for p_l in per_layer:
            x = _remat(remat, _rwkv_block_x, p_l, x, cfg, backend)
    elif cfg.family == "hybrid":
        G, x0 = cfg.shared_attn_every, x
        for g in range(_groups(cfg)):
            x = _remat(remat, _hybrid_group, params["shared"],
                       per_layer[g * G:(g + 1) * G], x, x0, cfg, backend)
    else:
        raise ValueError(cfg.family)
    return _logits(params, cfg, _norm(cfg)(params["final_norm"], x), backend)


def loss_fn(params, cfg, batch, backend=dispatch.DENSE):
    """Next-token CE (teacher forcing) in f32, mean over real (non-pad)
    targets (``batch['mask']``, optional): (loss, {'loss', 'ntokens'}).
    batch as ``forward`` takes it."""
    logits = forward(params, cfg, batch, backend)
    targets = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    true = torch.take_along_dim(lg, targets[..., None], dim=-1)[..., 0]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, dtype=torch.float32,
                       device=targets.device)
            if mask is None else mask[:, 1:].to(torch.float32))
    loss = torch.sum((lse - true) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)
    return loss, {"loss": loss.detach(), "ntokens": torch.sum(mask)}


def _recurrent_init_cache(cfg, batch, max_len, dtype, dev):
    """The recurrent families' decode cache: RWKV-6's f32 states (L, B, H,
    P, P) and token-shift rows in ``dtype``; the hybrid's f32 SSM states,
    conv tails in ``dtype`` and the shared block's K/V ring, whose length
    is ``max_len`` up to 65,536 and ``min(max_len, cfg.long_window)`` past
    it.  ``pos`` is a 0-d int32, as the reference's."""
    Lg = cfg.n_layers

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    pos = z(dt=torch.int32)
    if cfg.family == "ssm_rwkv":
        rc = rwkv_cfg(cfg)
        H, P = rc.n_heads, rc.head_dim
        return {"s": z(Lg, batch, H, P, P, dt=torch.float32),
                "x_tm": z(Lg, batch, 1, cfg.d_model),
                "x_cm": z(Lg, batch, 1, cfg.d_model), "pos": pos}
    sc = ssm_cfg(cfg)
    win = min(max_len, cfg.long_window) if max_len > 65536 else max_len
    ring = (_groups(cfg), batch, win, cfg.n_kv, cfg.hd)
    return {"h": z(Lg, batch, sc.n_heads, sc.d_state, sc.head_dim,
                   dt=torch.float32),
            "conv": z(Lg, batch, sc.conv_width - 1,
                      sc.d_inner + 2 * sc.n_groups * sc.d_state),
            "shared_k": z(*ring), "shared_v": z(*ring), "pos": pos}


def _recurrent_prefill(params, cfg, tokens, backend):
    """Prefill of the recurrent families (whole prompts, no ``lengths``).

    RWKV-6: logits at the last position and the layers' final states, the
    token-shift rows in the cache dtype, ``pos`` = the prompt length.  The
    hybrid, as the reference's: ``forward``'s last logits and a *zero*
    cache of length S at ``pos`` 0, which does not hold the prompt (its
    generation path is ``init_cache`` and the prompt fed through
    ``decode_step``)."""
    dt = _dtype(cfg)
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else dt
    B, Sq = tokens.shape
    if cfg.family == "hybrid":
        logits = forward(params, cfg, {"tokens": tokens}, backend)
        return logits[:, -1:], init_cache(cfg, B, Sq, cdt, tokens.device)
    x, states = _rwkv_trunk(
        params, cfg, L.embed_lookup(params["embed"], tokens).to(dt), backend)
    cache = {"s": torch.stack([st["s"] for st in states]),
             "x_tm": torch.stack([st["x_tm"].to(cdt) for st in states]),
             "x_cm": torch.stack([st["x_cm"].to(cdt) for st in states]),
             "pos": torch.tensor(Sq, dtype=torch.int32, device=tokens.device)}
    x_last = L.rms_norm(params["final_norm"], x[:, -1:])
    return _logits(params, cfg, x_last, backend), cache


def _recurrent_decode(params, cfg, tokens, cache, backend):
    """One decode step of a uniform batch: every row at the cache's 0-d
    ``pos``.  The hybrid's shared block writes its K/V at ``pos % win`` of
    the ring and attends ``min(pos + 1, win)`` entries."""
    pos_s = cache["pos"]
    B = tokens.shape[0]
    x = L.embed_lookup(params["embed"], tokens).to(_dtype(cfg))
    blocks = params["blocks"]
    if cfg.family == "ssm_rwkv":
        states = []
        for i in range(cfg.n_layers):
            st = {k: cache[k][i] for k in ("s", "x_tm", "x_cm")}
            x, st = _rwkv_block(_layer(blocks, i), x, cfg, backend, st,
                                decode=True)
            states.append(st)
        new = {k: torch.stack([st[k] for st in states])
               for k in ("s", "x_tm", "x_cm")}
    else:
        G, x0, shared = cfg.shared_attn_every, x, params["shared"]
        win = cache["shared_k"].shape[2]
        pos = pos_s.reshape(1, 1).expand(B, 1)
        ins = (pos_s % win).long().reshape(1).expand(B)
        vlen = torch.clamp(pos_s + 1, max=win).reshape(1).expand(B)
        acfg = attn_cfg(cfg)
        hs, convs = [], []
        for g in range(_groups(cfg)):
            hin = _shared_in(shared, x, x0, backend)
            hin = hin + A.attn_decode_cached(
                shared["attn"], L.rms_norm(shared["ln1"], hin), acfg,
                pos=pos, insert_at=ins, valid_len=vlen,
                k_all=cache["shared_k"], v_all=cache["shared_v"], layer=g,
                backend=backend)
            x = x + _shared_mlp(shared, hin, cfg, backend)
            for j in range(G):
                i = g * G + j
                x, c = _mamba_block(_layer(blocks, i), x, cfg, backend,
                                    {"h": cache["h"][i],
                                     "conv": cache["conv"][i]})
                hs.append(c["h"])
                convs.append(c["conv"])
        new = {"h": torch.stack(hs), "conv": torch.stack(convs),
               "shared_k": cache["shared_k"], "shared_v": cache["shared_v"]}
    x = L.rms_norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), {**new, "pos": pos_s + 1}


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    """Contiguous decode cache with per-slot positions.  ``cfg.kv_quant``:
    int8 K/V planes with per-token-per-head bf16 scales (``dtype`` is then
    not read), as the reference builds them.  The encoder-decoder's adds
    the encoder's output ``memory`` (B, enc_len, d) in ``dtype``.  The
    recurrent families' caches are ``_recurrent_init_cache``'s."""
    dev = resolve_device(device)
    if cfg.family not in _KV_FAMILIES:
        return _recurrent_init_cache(cfg, batch, max_len, dtype, dev)
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
    cache = {"kv": kv,
             "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family == "audio":
        cache["memory"] = torch.zeros((batch, cfg.enc_len, cfg.d_model),
                                      dtype=dtype, device=dev)
    return cache


def prefill(params, cfg, batch, backend=dispatch.DENSE):
    """Forward over the right-padded prompt batch.

    batch: {'tokens': (B, S) int, 'lengths': (B,) int (optional),
    'probes': the probe state (optional)}, and the inputs ``forward``
    names for the vlm ('embeds', 'positions') and the encoder-decoder
    ('frames').
    Returns (logits (B, 1, V) at each row's last real position, cache with
    K/V planes (L, B, S, KV, hd), int8 with their scales (L, B, S, KV) when
    ``cfg.kv_quant`` is set, ``pos`` = lengths, and the encoder-decoder's
    ``memory`` in the cache dtype).  The recurrent families take whole
    prompts only (``_recurrent_prefill``).
    """
    dt = _dtype(cfg)
    cdt = torch.bfloat16 if cfg.dtype == "bfloat16" else dt
    tokens = batch["tokens"]
    B, Sq = tokens.shape
    lengths = batch.get("lengths")
    if cfg.family not in _KV_FAMILIES:
        if lengths is not None:
            raise NotImplementedError(
                f"per-request prompt lengths need a KV cache; family "
                f"{cfg.family!r} carries recurrent state through the padding")
        return _recurrent_prefill(params, cfg, tokens, backend)
    if lengths is None:
        lengths = torch.full((B,), Sq, dtype=torch.int32, device=tokens.device)
    x, pos = _embed_prompt(params, cfg, batch)
    memory = (_encoder(params, cfg, batch["frames"], backend)
              if cfg.family == "audio" else None)
    ps = batch.get("probes") or {}
    planes = []
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):
            x, kv = _kv_block(p_l, x, cfg, backend, pos, memory)
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
    if memory is not None:
        cache["memory"] = memory.to(cdt)
    last = torch.clamp(lengths.long() - 1, min=0)
    x_last = x[torch.arange(B, device=x.device), last][:, None]
    x_last = _norm(cfg)(params["final_norm"], x_last)
    return _logits(params, cfg, x_last, backend), cache


def init_paged_cache(cfg, n_pages: int, page_size: int, dtype=torch.bfloat16,
                     device=None, tp: int = 1):
    """Paged KV page pool: (L, n_pages, page, KV, hd) tensors.

    ``dtype=torch.int8`` stores pages quantized with per-token-per-head bf16
    scales (``attention.quantize_kv``); a float dtype stores them plain.
    Page 0 is the allocator's trash page (``serving/kvcache.py``).  The
    KV-cache families only.  ``tp`` > 1 builds one tensor-parallel rank's
    pool: page / tp rows of every page (its in-page slice), each tensor
    contiguous.
    """
    if cfg.family not in _PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged KV cache serves families {_PAGED_FAMILIES}; got "
            f"{cfg.family!r}")
    if page_size % tp:
        raise ValueError(f"page_size {page_size} does not split over tp "
                         f"{tp}")
    dev = resolve_device(device)
    shape = (cfg.n_layers, n_pages, page_size // tp, cfg.n_kv, cfg.hd)
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
    if cfg.family not in _PAGED_FAMILIES:
        raise NotImplementedError(cfg.family)
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
    page = cache["k"].shape[2] * dispatch.tp_degree(backend)   # global rows
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
    is the (B,) vector of per-slot positions, or a 0-d position every row
    is at (the reference's uniform batch: on a full cache the write lands
    on its last row and nothing is masked, as there).  A cache carrying a
    ``page_table`` is a page pool and takes the paged step.  The vlm looks
    its tokens up in ``embed`` and decodes with one position stream
    (standard RoPE, as the reference's); the encoder-decoder attends
    ``cache['memory']`` in every layer, its K/V projected anew each step,
    as the reference's.

    Retired slots keep decoding into ``min(pos, S-1)`` until the engine
    reuses them, and count as tokens for the probes, as the reference's
    do.  The cache's K/V planes (and, for ``cfg.kv_quant``, their
    scales) are updated in place; the returned cache carries ``pos + 1``.

    The recurrent families decode uniform batches only: their 0-d ``pos``
    is every row's (``_recurrent_decode``).
    """
    if "page_table" in cache:
        return _decode_step_paged(params, cfg, tokens, cache, backend)
    if cfg.family not in _KV_FAMILIES:
        if cache["pos"].ndim == 1:
            raise NotImplementedError(
                f"per-slot decode positions need a KV cache; family "
                f"{cfg.family!r} carries recurrent state")
        return _recurrent_decode(params, cfg, tokens, cache, backend)
    dt = _dtype(cfg)
    B = tokens.shape[0]
    pos_c = cache["pos"]
    pos_v = pos_c if pos_c.ndim == 1 else pos_c.reshape(1).expand(B)
    S = cache["kv"]["k"].shape[2] * dispatch.tp_degree(backend)
    ins = torch.clamp(pos_v, max=S - 1).long()
    if pos_c.ndim == 1:
        vlen, excl = torch.clamp(pos_v + 1, max=S), ins
    else:   # the reference's uniform batch: unclamped, past a full cache
        vlen, excl = pos_v + 1, pos_v     # nothing masked, the write clamped
    x = L.embed_lookup(params["embed"], tokens).to(dt)
    acfg = attn_cfg(cfg)
    norm = _norm(cfg)
    kv = cache["kv"]
    scales = (kv["k_scale"], kv["v_scale"]) if cfg.kv_quant else None
    ps = cache.get("probes") or {}
    for i in range(cfg.n_layers):
        p_l = _layer(params["blocks"], i)
        with probes.layer(ps, i):
            x = x + A.attn_decode_cached(
                p_l["attn"], norm(p_l["ln1"], x), acfg,
                pos=pos_v[:, None], insert_at=ins, valid_len=vlen,
                k_all=kv["k"], v_all=kv["v"], layer=i, scales=scales,
                backend=backend, exclude=excl)
            if cfg.family == "audio":
                x = _dec_tail(p_l, x, cache["memory"], cfg, backend)
            else:
                x = x + _ffn(p_l, x, cfg, backend)
    probes.bump(ps, "tokens", B)
    x = norm(params["final_norm"], x)
    return _logits(params, cfg, x, backend), {**cache, "pos": pos_c + 1}


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
    page = cache["k"].shape[2] * dispatch.tp_degree(backend)   # global rows
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
    if cfg.family not in _PAGED_FAMILIES:
        raise NotImplementedError(
            f"verify_step serves KV-cache families {_PAGED_FAMILIES}; got "
            f"{cfg.family!r}")
    dt = _dtype(cfg)
    B, K1 = tokens.shape
    pos_v = cache["pos"]
    S = cache["kv"]["k"].shape[2] * dispatch.tp_degree(backend)
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
