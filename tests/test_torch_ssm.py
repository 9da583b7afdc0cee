"""The port's Mamba2 block (``repro_torch/models/ssm.py``) and the ``hybrid``
family's model (zamba2: Mamba2 blocks with one shared attention block
before every group) against the JAX package's, computed live in this
process (f32, seeded numpy inputs):

* each function of ``ssm.py`` within ``atol 1e-5``: the split of the fused
  projection, the causal conv with and without its decode tail, the
  chunked SSD scan at one chunk and at three, with and without an initial
  state, the block over a prompt and its decode step at ``act_levels`` 0
  and 32, the init and the cache;
* the reduced zamba2-2.7b (4 layers, shared every 2) through the bridge:
  ``forward`` logits within 1e-4, the prefill quirk (``forward``'s last
  logits and a zero cache of the prompt's length at ``pos`` 0), decode
  from ``init_cache`` over the prompt (logits and every cache leaf within
  1e-4, and within the reference's own 2e-2 of ``forward``), the shared
  block's K/V ring at ``max_len`` 70,000 (64 entries) wrapping over 70
  steps;
* compression of the tree, leaf for leaf, and the greedy tokens of the
  compressed model on the dense, codebook and lut backends equal to the
  reference's;
* every refusal of a recurrent family with the reference's exception type
  and text, ``ServeEngine``'s included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from recurrent_rig import (  # noqa: E402
    BACKENDS, REFUSALS, assert_tree_close, greedy_port, greedy_reference,
    leaves, lut_specs, np_tree, reference_model, refusal, refusal_calls)
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5
D, N, HP = 32, 16, 16        # d_inner 64: 4 heads of 16, state 16


def _cfgs(JS, chunk=8, levels=0, groups=1):
    kw = dict(d_model=D, d_state=N, head_dim=HP, chunk=chunk,
              n_groups=groups, act_levels=levels)
    return JS.SSMConfig(**kw), TS.SSMConfig(**kw)


def _params(seed, cfg):
    """Seeded numpy parameters of a Mamba2 block (``cfg`` either side's),
    with A_log, D and dt_bias spread away from their init values."""
    rng = np.random.default_rng(seed)
    din, G, H = cfg.d_inner, cfg.n_groups, cfg.n_heads
    n = lambda *s, std=1.0: (rng.standard_normal(s) * std  # noqa: E731
                             ).astype(np.float32)
    proj = 2 * din + 2 * G * N + H
    return {"in_proj": {"w": n(D, proj, std=D ** -0.5)},
            "out_proj": {"w": n(din, D, std=din ** -0.5)},
            "conv_w": n(cfg.conv_width, din + 2 * G * N, std=0.2),
            "A_log": np.log(np.linspace(1, 16, H)).astype(np.float32)
            + n(H, std=0.1),
            "D": 1.0 + n(H, std=0.2), "dt_bias": n(H, std=0.5),
            "norm": {"scale": 1.0 + n(din, std=0.1)}}


def _both(tree):
    import jax
    import jax.numpy as jnp
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, "cpu"))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(to_numpy_tree(got).astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               rtol=0, atol=atol, err_msg=what)


# --- functions -------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_split_and_causal_conv_match_reference(with_state):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as JS
    jcfg, tcfg = _cfgs(JS)
    rng = np.random.default_rng(0)
    L = 1 if with_state else 9
    z = rng.standard_normal((2, L, 2 * tcfg.d_inner + 2 * N
                             + tcfg.n_heads)).astype(np.float32)
    for g, w in zip(TS._split(tcfg, torch.from_numpy(z)),
                    JS._split(jcfg, jnp.asarray(z))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    C = tcfg.d_inner + 2 * N
    x = rng.standard_normal((2, L, C)).astype(np.float32)
    w = (rng.standard_normal((4, C)) * 0.2).astype(np.float32)
    st = rng.standard_normal((2, 3, C)).astype(np.float32) \
        if with_state else None
    jo, jt = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    to, tt = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             None if st is None else torch.from_numpy(st))
    _close(to, jo, what="conv")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    del jax


SCAN_CASES = {"one_chunk": (8, False, 1), "one_chunk_h0": (8, True, 1),
              "three_chunks": (24, False, 1),
              "three_chunks_h0": (24, True, 1),
              "three_chunks_two_groups": (24, True, 2)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_ssd_chunked_matches_reference(case):
    """The chunked scan (exponent masked before exp, groups repeated onto
    heads as ``jnp.repeat`` does): outputs and the last state within
    1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as JS
    L, with_h0, G = SCAN_CASES[case]
    jcfg, tcfg = _cfgs(JS, groups=G)
    H = tcfg.n_heads
    rng = np.random.default_rng(1)
    xh = rng.standard_normal((2, L, H, HP)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, L, H)))).astype(np.float32)
    A = -np.linspace(1, 16, H).astype(np.float32)
    Bm, Cm = ((rng.standard_normal((2, L, G, N)) * 0.5).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((2, H, N, HP)).astype(np.float32) \
        if with_h0 else None
    args = (xh, dt, A, Bm, Cm)
    jy, jh = JS._ssd_chunked(*map(jnp.asarray, args), jcfg,
                             None if h0 is None else jnp.asarray(h0))
    ty, th = TS._ssd_chunked(*map(torch.from_numpy, args), tcfg,
                             None if h0 is None else torch.from_numpy(h0))
    assert np.isfinite(ty.numpy()).all()
    _close(ty, jy, what="y")
    _close(th, jh, what="h_last")
    if L > tcfg.chunk:     # L − 1 tokens: no whole number of chunks
        with pytest.raises(ValueError, match="whole chunks"):
            TS._ssd_chunked(*(torch.from_numpy(a[:, :L - 1]) if a.ndim > 1
                              else torch.from_numpy(a) for a in args), tcfg)
    del jax


@pytest.mark.parametrize("L", [8, 24])
@pytest.mark.parametrize("levels", [0, 32])
def test_ssm_apply_matches_reference(L, levels):
    """The block over a prompt: the conv's activation and the z gate (the
    act_quant launch with y as its multiplier at ``act_levels`` 32, the
    reference run eagerly there) within 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as JS
    jcfg, tcfg = _cfgs(JS, levels=levels)
    jp, tp = _both(_params(2, tcfg))
    x = np.random.default_rng(3).standard_normal((2, L, D)).astype(np.float32)
    with jax.disable_jit(levels > 0):
        want = JS.ssm_apply(jp, jnp.asarray(x), jcfg)
    _close(TS.ssm_apply(tp, torch.from_numpy(x), tcfg), want)


@pytest.mark.parametrize("levels", [0, 32])
def test_ssm_decode_step_matches_reference(levels):
    """Four decode steps from a seeded cache: outputs and the cache (its
    dtypes kept) within 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as JS
    jcfg, tcfg = _cfgs(JS, levels=levels)
    jp, tp = _both(_params(4, tcfg))
    rng = np.random.default_rng(5)
    cache = {"h": rng.standard_normal((2, tcfg.n_heads, N, HP)
                                      ).astype(np.float32),
             "conv": rng.standard_normal((2, 3, tcfg.d_inner + 2 * N)
                                         ).astype(np.float32)}
    jc, tc = _both(cache)
    for _ in range(4):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        with jax.disable_jit(levels > 0):
            want, jc = JS.ssm_decode_step(jp, jnp.asarray(x), jcfg, jc)
        got, tc = TS.ssm_decode_step(tp, torch.from_numpy(x), tcfg, tc)
        _close(got, want, what="out")
        assert_tree_close(tc, jc, ATOL, "cache")


def test_init_functions_follow_the_reference():
    """The port's own init: the reference's shapes and dtypes, A_log = log
    of linspace(1, 16, H), D 1, dt_bias 0, conv_w std 0.2; the cache's
    zeros."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ssm as JS
    jcfg, tcfg = _cfgs(JS)
    ref = np_tree(JS.ssm_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    own = TS.ssm_init(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                      "cpu", layers=(3,))
    assert {p: (tuple(t.shape[1:]), str(t.dtype).split(".")[-1])
            for p, t in leaves(own)} \
        == {p: (a.shape, str(a.dtype)) for p, a in leaves(ref)}
    for name in ("A_log", "D", "dt_bias"):
        for layer in to_numpy_tree(own[name]):
            np.testing.assert_array_equal(layer, ref[name].astype(np.float32))
    big = TS.ssm_init(torch.Generator().manual_seed(1),
                      TS.SSMConfig(d_model=256), torch.float32, "cpu")
    assert abs(float(big["conv_w"].std()) / 0.2 - 1) < 0.05
    assert abs(float(big["in_proj"]["w"].std()) * 256 ** 0.5 - 1) < 0.05
    assert_tree_close(TS.init_ssm_cache(tcfg, 3, torch.bfloat16, "cpu"),
                      JS.init_ssm_cache(jcfg, 3, jnp.bfloat16), 0.0, "cache")


# --- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba_models():
    pytest.importorskip("jax")
    return {lv: reference_model("zamba2-2.7b", levels=lv) for lv in (0, 32)}


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(1, vocab, shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("levels", [0, 32])
def test_reduced_model_matches_reference(levels, zamba_models):
    """The reduced zamba2-2.7b (4 Mamba2 layers, the shared block before
    each pair, d 128, f32) through the bridge: ``forward`` over a 3-chunk
    prompt within 1e-4; the prefill quirk, as the reference's: its logits
    are ``forward``'s last, its cache a zero cache of the prompt's length at
    ``pos`` 0; then the prompt (at ``act_levels`` 32, where the reference
    runs eagerly, its first chunk) fed from ``init_cache`` through
    ``decode``: logits and every cache leaf within 1e-4 at each step, and
    the logits within the reference's own 2e-2 of ``forward``'s."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = zamba_models[levels]
    S = 3 * ns.cfg.ssm_chunk
    toks = _tokens(6, ns.cfg.vocab, (2, S))
    tt = torch.from_numpy(toks).long()
    with jax.disable_jit(levels > 0):
        jf = ns.model.forward(ns.params, {"tokens": jnp.asarray(toks)})
        jl, jc = ns.model.prefill(ns.params, {"tokens": jnp.asarray(toks)})
    tf = ns.tmodel.forward(ns.tparams, {"tokens": tt})
    _close(tf, jf, 1e-4, "forward logits")
    tl, tc = ns.tmodel.prefill(ns.tparams, {"tokens": tt})
    assert torch.equal(tl, tf[:, -1:])
    _close(tl, jl, 1e-4, "prefill logits")
    assert_tree_close(tc, jc, 0.0, "prefill cache")
    assert tc["pos"].ndim == 0 and int(tc["pos"]) == 0
    assert tc["shared_k"].shape[2] == S
    assert not any(bool(t.any()) for _, t in leaves(tc))

    jc = ns.model.init_cache(2, S, dtype=jnp.float32)
    tc = ns.tmodel.init_cache(2, S, dtype=torch.float32, device="cpu")
    step = jax.jit(ns.model.decode) if levels == 0 else ns.model.decode
    worst, n_dec = 0.0, S if levels == 0 else ns.cfg.ssm_chunk
    for t in range(n_dec):
        with jax.disable_jit(levels > 0):
            jd, jc = step(ns.params, jnp.asarray(toks[:, t:t + 1]), jc)
        td, tc = ns.tmodel.decode(ns.tparams, tt[:, t:t + 1], tc)
        _close(td, jd, 1e-4, f"decode logits {t}")
        assert_tree_close(tc, jc, 1e-4, f"cache after step {t}")
        worst = max(worst, float((td[:, 0] - tf[:, t]).abs().max()))
    assert int(tc["pos"]) == n_dec
    assert worst < 2e-2


def test_shared_ring_wraps_as_the_reference():
    """``max_len`` 70,000 > 65,536: the shared block's K/V ring holds
    ``long_window`` = 64 entries; 70 decode steps write ``pos % 64`` and
    attend ``min(pos + 1, 64)``: logits within 1e-4 at every step, the
    ring and the states within 1e-4 after it wrapped."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = reference_model("zamba2-2.7b")
    jc = ns.model.init_cache(1, 70_000, dtype=jnp.float32)
    tc = ns.tmodel.init_cache(1, 70_000, dtype=torch.float32, device="cpu")
    assert tc["shared_k"].shape == (2, 1, 64, ns.cfg.n_kv, ns.cfg.hd)
    assert_tree_close(tc, jc, 0.0, "init_cache")
    toks = _tokens(7, ns.cfg.vocab, (1, 70))
    step = jax.jit(ns.model.decode)
    for t in range(70):
        jd, jc = step(ns.params, jnp.asarray(toks[:, t:t + 1]), jc)
        td, tc = ns.tmodel.decode(ns.tparams,
                                  torch.from_numpy(toks[:, t:t + 1]).long(),
                                  tc)
        _close(td, jd, 1e-4, f"logits at step {t}")
    assert_tree_close(tc, jc, 1e-4, "cache after the wrap")
    assert int(tc["pos"]) == 70


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_and_compression_of_the_tree(dtype):
    """The bridge carries the reduced zamba2-2.7b's tree both ways; the
    port's ``cluster_params`` clusters every leaf (A_log, dt_bias, D,
    conv_w and the norms too) onto the reference's codebook, and given it
    ``to_codebook_params`` gives the reference's index form leaf for leaf:
    the Mamba2 projections (stacked) and the shared block's (not stacked)
    in index form, ``conv_w`` dense; the lut fan-in the engine would take
    is the embedding's rows (512), as the reference's."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.models.model_zoo import build
    from repro_torch.bridge import from_jax_state
    from repro_torch.core import quantizer as TQ
    from repro_torch.serving import compress as TC

    tree = np_tree(build(C.get("zamba2-2.7b").reduced().replace(
        dtype=dtype)).init(jax.random.PRNGKey(0)))
    tp = from_jax_params(tree, "cpu")
    want, got = dict(leaves(tree)), dict(leaves(to_numpy_tree(tp)))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a.astype(np.float32), path)
    if dtype == "bfloat16":
        return
    ns = reference_model("zamba2-2.7b", levels=32, n_weights=256)
    wq = TQ.WeightQuantConfig(num_weights=256, method=ns.wq.method)
    pq, state = TQ.cluster_params(ns.tparams, wq, TQ.init_state(wq),
                                  ns.wq.interval)
    book = np.asarray(ns.state.codebooks[""])
    np.testing.assert_allclose(state.codebooks[""].numpy(), book,
                               rtol=1e-6, atol=1e-9)
    for path, t in leaves(pq):
        assert torch.isin(t, state.codebooks[""]).all(), path
    cp = TC.to_codebook_params(from_jax_params(np_tree(ns.clustered), "cpu"),
                               wq, from_jax_state({"": book}, device="cpu"))
    assert cp["blocks"]["ssm"]["in_proj"]["w_idx"].ndim == 3
    assert cp["shared"]["in_proj"]["w_idx"].ndim == 2
    assert torch.is_tensor(cp["blocks"]["ssm"]["conv_w"])
    assert_tree_close(cp, ns.index, 0.0, "index form")
    jspec, tspec = lut_specs(ns)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)


@pytest.fixture(scope="module")
def compressed():
    pytest.importorskip("jax")
    return reference_model("zamba2-2.7b", levels=32, n_weights=256)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compressed_greedy_tokens_match_reference(backend, compressed):
    """The compressed model at |A| 32, |W| 256 (on the codebook backend the
    shared block's FFN is one gated launch): an 8-token prompt fed from
    ``init_cache`` through ``decode`` (the hybrid's generation path) and 4
    greedy decodes give the reference's tokens on ``backend``."""
    ns = compressed
    toks = _tokens(8, ns.cfg.vocab, (2, 8))
    jspec, tspec = lut_specs(ns)
    want = greedy_reference(ns, toks, 4, backend, jspec, feed=True)
    got = greedy_port(ns, toks, 4, backend, tspec, feed=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_reference(name, zamba_models):
    from repro.serving import ServeEngine as JEngine
    from repro_torch.serving import ServeEngine as TEngine
    ns = zamba_models[0]
    if name == "engine":
        want = refusal(lambda: JEngine(ns.model, ns.params, max_len=16))
        got = refusal(lambda: TEngine(ns.tmodel, ns.tparams, max_len=16,
                                      device="cpu"))
    else:
        want = refusal(refusal_calls(ns.model, ns.params, "jax")[name])
        got = refusal(refusal_calls(ns.tmodel, ns.tparams, "torch")[name])
    assert got == want
    assert want[0] == "NotImplementedError"
