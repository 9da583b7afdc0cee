"""The port's encoder-decoder family (``audio``: whisper-small) against the
JAX package's, computed live in this process (f32, seeded numpy inputs,
the reference's ``PRNGKey(0)`` weights carried across by
``bridge.from_jax_params``):

* the layers it adds: ``layer_norm`` within 1e-6 in f32 and one bf16 ulp
  in bf16, the biased ``mlp_block`` at act_levels 0 (gelu) and 32 (relu6
  quantized; level flips at ties counted by ``families_rig.lock_acts``);
* attention without a causal mask, and cross-attention under
  ``kv_override`` with 1 or 8 queries over 16 or 40 keys (40 in blocks of
  32 and a tail of 8), within 1e-5;
* the reduced whisper-small (2 encoder and 2 decoder layers, enc_len 16):
  on dense (the float weights), codebook and lut (compressed at |W| 256),
  at act_levels 0 and 32, ``forward``, ``prefill`` with and without
  ``lengths`` and 8 greedy decodes: tokens equal, logits within 1e-3, the
  cache's K/V planes and ``memory`` of the reference's shapes and dtypes,
  lut's activation snaps held to the reference's with the ties counted
  (``families_rig.lock_snaps``);
* the twin of the reference's ``test_decode_matches_forward`` on the port
  alone;
* the reference's ``enc_pos`` quirk: at enc_len 32 the compressed tree
  holds the position table in index form and both prefills raise
  ``KeyError: 'table'``; with ``exclude="enc_pos"`` the compressed trees
  equal leaf for leaf and both serve the same tokens on codebook;
* the refusals: training (``loss_fn``, ``forward`` under autograd), the
  paged cache and the verify step, with the reference's text where it has
  one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from families_rig import (  # noqa: E402
    BACKENDS, N_WEIGHTS, assert_cache_like, assert_runs_agree, inputs,
    lock_snaps,
    lock_acts, lut_specs, reference_model, refusal, run_port, run_reference,
    with_levels)
from recurrent_rig import bf16_ties, leaves, np_tree  # noqa: E402
from repro_torch.bridge import to_numpy_tree  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

from repro_torch.kernels import dispatch as TD  # noqa: E402

torch.set_num_threads(2)

NAME = "whisper-small"
N_NEW = 8


def _both(tree):
    import jax
    import jax.numpy as jnp
    from repro_torch.bridge import from_jax_params
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, "cpu"))


# --- layers ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """f32 within 1e-6; bf16 within one bf16 step (the f32 sums round
    apart at a bf16 rounding boundary), the ties counted."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 96)) * 3 + 1).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(96)).astype(np.float32),
         "bias": (0.1 * rng.standard_normal(96)).astype(np.float32)}
    jp, tp = _both(p)
    if dtype == "bfloat16":
        jp = {k: v.astype(jnp.bfloat16) for k, v in jp.items()}
        tp = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    want = JL.layer_norm(jp, jnp.asarray(x).astype(dtype))
    got = TL.layer_norm(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    w = np.asarray(want.astype(jnp.float32))
    g = got.to(torch.float32).numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    else:
        assert bf16_ties(g, w) <= g.size // 100


@pytest.mark.parametrize("levels", [0, 32])
def test_mlp_block_matches_reference(levels, monkeypatch):
    """dense → gelu (levels 0) or quantized relu6 (32) → dense, with
    biases; at 32 the activation levels are held to the reference's and
    the flips at level-boundary ties counted."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as JL
    rng = np.random.default_rng(1)
    d, ff = 64, 160
    p = {"w1": {"w": (rng.standard_normal((d, ff)) * d ** -0.5
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(ff)).astype(np.float32)},
         "w2": {"w": (rng.standard_normal((ff, d)) * ff ** -0.5
                      ).astype(np.float32),
                "b": (0.1 * rng.standard_normal(d)).astype(np.float32)}}
    x = (rng.standard_normal((2, 7, d)) * 2).astype(np.float32)
    jp, tp = _both(p)
    stats = lock_acts(JL, TL, monkeypatch)
    want = JL.mlp_block(jp, jnp.asarray(x), "gelu", levels)
    got = TL.mlp_block(tp, torch.from_numpy(x), "gelu", levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert stats["sites"] == 1 and not stats["pending"]
    assert stats["flips"] == 0, stats


def _attn_case(rng, cfg_kw):
    from repro.models import attention as JA
    jcfg, tcfg = JA.AttnConfig(**cfg_kw), TA.AttnConfig(**cfg_kw)
    d, hd = cfg_kw["d_model"], tcfg.hd
    p = {k: {"w": (rng.standard_normal((d, n * hd)) * d ** -0.5
                   ).astype(np.float32)}
         for k, n in (("wq", tcfg.n_heads), ("wk", tcfg.n_kv),
                      ("wv", tcfg.n_kv))}
    p["wo"] = {"w": (rng.standard_normal((tcfg.n_heads * hd, d))
                     * (tcfg.n_heads * hd) ** -0.5).astype(np.float32)}
    return jcfg, tcfg, _both(p)


ATTN = dict(d_model=64, n_heads=4, n_kv=2, head_dim=16, rope_theta=1e4,
            kv_block=32)


@pytest.mark.parametrize("L", [8, 40])
def test_noncausal_attention_matches_reference(L):
    """The encoder's self-attention: RoPE on 0..L−1, no mask (40 keys in
    blocks of 32 and a tail of 8)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import attention as JA
    rng = np.random.default_rng(L)
    jcfg, tcfg, (jp, tp) = _attn_case(rng, dict(ATTN, causal=False))
    x = rng.standard_normal((2, L, 64)).astype(np.float32)
    want, _ = JA.attn_apply(jp, jnp.asarray(x), jcfg)
    got, kv = TA.attn_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    causal, _ = TA.attn_apply(tp, torch.from_numpy(x),
                              TA.AttnConfig(**dict(ATTN, causal=True)))
    assert float((causal - got).abs().max()) > 1e-3   # the mask matters
    assert tuple(kv["k"].shape) == (2, L, 2, 16)


@pytest.mark.parametrize("Lq,Lk", [(1, 16), (8, 16), (1, 40), (8, 40)])
def test_cross_attention_matches_reference(Lq, Lk):
    """``kv_override``: K and V from the memory, no RoPE, no mask, with 1
    query (a decode step) or 8 (a prefill) over 16 keys or 40 (a tail
    block of 8 at kv_block 32); a causal config is not causal here."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import attention as JA
    rng = np.random.default_rng(10 * Lq + Lk)
    jcfg, tcfg, (jp, tp) = _attn_case(rng, ATTN)
    x = rng.standard_normal((2, Lq, 64)).astype(np.float32)
    mem = rng.standard_normal((2, Lk, 64)).astype(np.float32)
    want, _ = JA.attn_apply(jp, jnp.asarray(x), jcfg,
                            kv_override=jnp.asarray(mem))
    got, kv = TA.attn_apply(tp, torch.from_numpy(x), tcfg,
                            kv_override=torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert tuple(kv["k"].shape) == (2, Lk, 2, 16)


# --- the reduced model ------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    pytest.importorskip("jax")
    ns = reference_model(NAME, n_weights=N_WEIGHTS)
    return {0: ns, 32: with_levels(ns, 32)}


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("backend", BACKENDS)
def test_reduced_whisper_matches_reference(backend, levels, models,
                                           monkeypatch):
    """Dense on the float weights, codebook and lut on the compressed
    tree: ``forward``, ``prefill`` with and without ``lengths`` and 8
    greedy decodes give the reference's tokens, logits within 1e-3; the
    prefill cache's K/V planes and ``memory`` have the reference's shapes
    and dtypes.  On lut every activation snap is held to the reference's
    level, and a level that differs must be a half-way tie
    (``lock_snaps``)."""
    ns = models[levels]
    jspec, tspec = lut_specs(ns)
    from repro.kernels import dispatch as JD
    snaps = lock_snaps(JD, TD, monkeypatch) if backend == "lut" else None
    jp = ns.params if backend == "dense" else None
    tp = ns.tparams if backend == "dense" else None
    for lengths in (None, [6, 4]):
        batch = inputs(ns.cfg, 2, 6, 3, lengths)
        kw = dict(forward=lengths is None)
        want = run_reference(ns, batch, N_NEW, backend, jspec, jp, **kw)
        got = run_port(ns, batch, N_NEW, backend, tspec, tp, **kw)
        assert_runs_agree(got, want, what=f"{backend} lengths {lengths}")
        assert_cache_like(got["cache"], want["cache"])
    assert snaps is None or (snaps["snaps"] and not snaps["pending"])


def test_decode_matches_forward():
    """The reference's ``test_decode_matches_forward`` for whisper-small on
    the port alone: the memory put in ``init_cache``'s cache, then 12
    tokens one decode at a time within 2e-2 of ``forward``'s logits."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build
    cfg = configs.get(NAME).reduced()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    B, S = 2, 12
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg, B, S, 5).items()}
    cache = model.init_cache(B, 24, dtype=torch.float32, device="cpu")
    assert tuple(cache["memory"].shape) == (B, cfg.enc_len, cfg.d_model)
    cache["memory"] = T._encoder(params, cfg, batch["frames"],
                                 T.dispatch.DENSE).to(torch.float32)
    outs = []
    for t in range(S):
        lg, cache = model.decode(params, batch["tokens"][:, t:t + 1].long(),
                                 cache)
        outs.append(lg)
    full = model.forward(params, {**batch, "tokens": batch["tokens"].long()})
    assert float((torch.cat(outs, 1) - full).abs().max()) < 2e-2


def test_scalar_pos_decodes_as_the_reference(models):
    """A 0-d ``pos`` (the reference's uniform batch, which its prefill
    without ``lengths`` returns) on the prefill's own cache, which has no
    room: 3 greedy decodes give the reference's tokens, logits within 1e-3
    (the first attends the whole prompt, each writes the cache's last
    row); the position comes back advanced, 0-d.  On a cache with room a
    0-d position decodes as the same (B,) positions."""
    import jax
    import jax.numpy as jnp
    ns = models[0]
    batch = inputs(ns.cfg, 2, 6, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    with jax.disable_jit():
        jl, jc = ns.model.prefill(ns.params, jb)
        want = []
        for _ in range(3):
            nxt = jnp.argmax(jl[:, -1], axis=-1).astype(jnp.int32)
            jl, jc = ns.model.decode(ns.params, nxt[:, None], jc)
            want.append(np.asarray(jl))
    assert jc["pos"].ndim == 0
    tl, tc = ns.tmodel.prefill(ns.tparams, tb)
    tc["pos"] = torch.tensor(6, dtype=torch.int32)
    for w in want:
        tl, tc = ns.tmodel.decode(ns.tparams, torch.argmax(
            tl[:, -1], dim=-1)[:, None], tc)
        np.testing.assert_allclose(tl.numpy(), w, rtol=0, atol=1e-3)
    assert tc["pos"].ndim == 0 and int(tc["pos"]) == 9
    room = {**tc, "kv": {k: torch.cat([v, torch.zeros_like(v)], dim=2)
                         for k, v in tc["kv"].items()}}
    vec = {**room, "kv": {k: v.clone() for k, v in room["kv"].items()},
           "pos": torch.tensor([9, 9], dtype=torch.int32)}
    nxt = torch.tensor([[3], [4]])
    a, ca = ns.tmodel.decode(ns.tparams, nxt, room)
    b, cb = ns.tmodel.decode(ns.tparams, nxt, vec)
    assert torch.equal(a, b)
    assert int(ca["pos"]) == 10 and cb["pos"].tolist() == [10, 10]


# --- the enc_pos quirk ------------------------------------------------------

def test_compressed_enc_pos_raises_as_the_reference():
    """At enc_len 32 the position table (32 × 128 = 4096 values) reaches
    ``to_codebook_params``' ``min_size``: it goes into index form, and the
    encoder's read of ``enc_pos['table']`` raises ``KeyError`` in both
    packages."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = reference_model(NAME, levels=32, n_weights=N_WEIGHTS, enc_len=32)
    assert "w_idx" in ns.index["enc_pos"] and "w_idx" in ns.tindex["enc_pos"]
    batch = inputs(ns.cfg, 2, 4, 8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = refusal(lambda: ns.model.prefill(ns.index, jb))
    got = refusal(lambda: ns.tmodel.prefill(ns.tindex, tb))
    assert got == want == ("KeyError", "'table'")


@pytest.fixture(scope="module")
def excluded():
    pytest.importorskip("jax")
    return reference_model(NAME, levels=32, n_weights=N_WEIGHTS,
                           exclude="enc_pos", enc_len=32)


def test_compressed_tree_with_exclusion_matches_reference(excluded):
    """``exclude="enc_pos"``: the table stays float, and the port's
    compression of the bridged clustered tree equals the reference's
    leaf for leaf (ids exact, codebooks and float leaves equal)."""
    from repro_torch.bridge import from_jax_params
    from repro_torch.core.quantizer import QuantizerState
    from repro_torch.serving import to_codebook_params
    ns = excluded
    assert "table" in ns.index["enc_pos"]
    books = {k: torch.from_numpy(np.asarray(v))
             for k, v in ns.state.codebooks.items()}
    mine = to_codebook_params(from_jax_params(np_tree(ns.clustered), "cpu"),
                              ns.wq, QuantizerState(codebooks=books))
    want = dict(leaves(np_tree(ns.index)))
    got = dict(leaves(to_numpy_tree(mine)))
    assert set(got) == set(want)
    assert any(p.startswith("/enc_blocks/") and p.endswith("w_idx")
               for p in want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype, path
        np.testing.assert_array_equal(got[path], w, err_msg=path)


def test_compressed_with_exclusion_serves_as_the_reference(excluded):
    """With the table kept float both packages serve the compressed tree
    on the codebook backend (dense and lut take the same tree at enc_len
    16 above): tokens equal, logits within 1e-3."""
    ns = excluded
    batch = inputs(ns.cfg, 2, 5, 9)
    want = run_reference(ns, batch, 4, "codebook")
    got = run_port(ns, batch, 4, "codebook")
    assert_runs_agree(got, want, what="codebook")


# --- refusals ---------------------------------------------------------------

def test_refusals():
    """The family trains; what still refuses a gradient, as the
    reference defines none: the quantized activation's level index (the
    §4 engine's) and the codebook backend's gated FFN launch, on the
    encoder's first FFN input under the loss; the paged cache and the
    verify step refuse the family with the reference's text."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from train_rig import (first_ffn_input, refused_gated_ffn,
                           refused_level_index)
    ns = reference_model(NAME)
    batch = inputs(ns.cfg, 2, 4, 2)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"] = tb["tokens"].long()
    x = first_ffn_input(ns.tmodel, ns.tparams, tb)
    refused_level_index(x)
    refused_gated_ffn(x)
    assert refusal(lambda: ns.tmodel.init_paged_cache(4, 8, device="cpu")) \
        == refusal(lambda: ns.model.init_paged_cache(4, 8))
    jcache = ns.model.init_cache(2, 8, dtype=jnp.float32)
    tcache = ns.tmodel.init_cache(2, 8, dtype=torch.float32, device="cpu")
    assert refusal(lambda: ns.tmodel.verify(ns.tparams, tb["tokens"],
                                            tcache)) \
        == refusal(lambda: ns.model.verify(ns.params,
                                           jnp.asarray(batch["tokens"]),
                                           jcache))
