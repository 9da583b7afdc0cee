"""The port's RWKV-6 (``repro_torch/models/rwkv.py``) and the ``ssm_rwkv``
family's model against the JAX package's, computed live in this process
(f32, seeded numpy inputs):

* each function of ``rwkv.py`` within ``atol 1e-5``: the token shift (with
  the dtype promotion of a bf16 shift row), the projections and the
  data-dependent decay, the WKV scan at one chunk and at three, with and
  without an initial state, the time-mix and channel-mix blocks over a
  prompt and their decode steps at ``act_levels`` 0 and 32, the cache;
* the scan takes r, k and v as bf16 and rounds each step's output to
  bf16, as the reference's does: an f32 difference in the last bit (XLA
  fuses multiply-adds and has its own exp) moves a value lying on a
  rounding boundary by one bf16 step.  Such ties are counted and bounded,
  and wherever a scan runs inside a block or a model, the port's streams
  are held to the reference's and continue from them
  (``recurrent_rig.lock_streams``), so that everything else is compared
  on equal streams;
* the reduced rwkv6-7b through the bridge: ``forward``, ``prefill`` and
  ``decode`` logits within 1e-4, the states too; on the port's own
  streams, within 1e-4 but at the few positions a tie reaches, and there
  within the tie's own effect; the port's own init;
* compression of the tree, leaf for leaf, and the greedy tokens of the
  compressed model on the dense, codebook and lut backends equal to the
  reference's, on the reference's streams and on the port's own;
* ``forward`` of the dense and MoE families (reduced qwen3-1.7b,
  qwen3-moe-30b-a3b) at every position;
* every refusal of a recurrent family with the reference's exception type
  and text, ``ServeEngine``'s included.

The hybrid family is held in ``test_torch_ssm.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from recurrent_rig import (  # noqa: E402
    BACKENDS, REFUSALS, assert_tree_close, bf16_ties, greedy_port,
    greedy_reference, leaves, lock_streams, lut_specs, np_tree,
    reference_model, refusal, refusal_calls)
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.models import rwkv as TR  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5
D, HD, FF, RANK = 64, 16, 96, 8        # 4 heads of 16, a narrow block


def _cfgs(JR, chunk=8, levels=0):
    kw = dict(d_model=D, head_dim=HD, d_ff=FF, lora_rank=RANK, chunk=chunk,
              act_levels=levels)
    return JR.RWKVConfig(**kw), TR.RWKVConfig(**kw)


def _params(seed, part="tm"):
    """Seeded numpy parameters of a time-mix or channel-mix block, with the
    decay's LoRA up matrix wide enough that the clip of w0 + LoRA bites."""
    rng = np.random.default_rng(seed)
    n = lambda *s, std=1.0: (rng.standard_normal(s) * std  # noqa: E731
                             ).astype(np.float32)
    if part == "cm":
        return {"mix": rng.uniform(0.25, 0.75, (2, D)).astype(np.float32),
                "wk": {"w": n(D, FF, std=D ** -0.5)},
                "wv": {"w": n(FF, D, std=FF ** -0.5)}}
    p = {"mix": rng.uniform(0.25, 0.75, (5, D)).astype(np.float32),
         "w0": n(D, std=4.0), "u": n(D, std=0.5),
         "w_lora_a": {"w": n(D, RANK, std=D ** -0.5)},
         "w_lora_b": {"w": n(RANK, D, std=2.0)},
         "ln_out": {"scale": 1.0 + n(D, std=0.1)}}
    for k in ("wr", "wk", "wv", "wg", "wo"):
        p[k] = {"w": n(D, D, std=D ** -0.5)}
    return p


def _state(seed, B):
    rng = np.random.default_rng(seed)
    return {"s": rng.standard_normal((B, D // HD, HD, HD)).astype(np.float32),
            "x_tm": rng.standard_normal((B, 1, D)).astype(np.float32),
            "x_cm": rng.standard_normal((B, 1, D)).astype(np.float32)}


def _both(tree):
    """A numpy tree as (jnp tree, torch tree)."""
    import jax
    import jax.numpy as jnp
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, "cpu"))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(to_numpy_tree(got).astype(np.float64),
                               np.asarray(want).astype(np.float64),
                               rtol=0, atol=atol, err_msg=what)


# --- functions -------------------------------------------------------------

def test_token_shift_and_its_dtype_promotion():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    prev = rng.standard_normal((2, 1, D)).astype(np.float32)
    for px, pt in ((jnp.asarray(prev), torch.from_numpy(prev)),
                   (jnp.asarray(prev).astype(jnp.bfloat16),
                    torch.from_numpy(prev).bfloat16())):
        want = JR._token_shift(jnp.asarray(x), px)
        got = TR._token_shift(torch.from_numpy(x), pt)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a decode step: x is one token, the shift row is the previous one
    got = TR._token_shift(torch.from_numpy(x[:, :1]), torch.from_numpy(prev))
    np.testing.assert_array_equal(got.numpy(), prev)
    del jax


@pytest.mark.parametrize("L", [1, 24])
def test_tm_projections_match_reference(L):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    jp, tp = _both(_params(1))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, L, D)).astype(np.float32)
    prev = rng.standard_normal((2, 1, D)).astype(np.float32)
    want = JR._tm_projections(jp, jnp.asarray(x), jnp.asarray(prev))
    got = TR._tm_projections(tp, torch.from_numpy(x), torch.from_numpy(prev),
                             TR.dispatch.DENSE)
    for name, g, w in zip("rkvg", got[:4], want[:4]):
        _close(g, w, what=name)
    # logw reaches −e⁴: its f32 exp is held relative to its size there
    lw = np.asarray(want[4])
    np.testing.assert_allclose(got[4].numpy(), lw, rtol=ATOL, atol=ATOL,
                               err_msg="logw")
    assert lw.min() <= -np.exp(4.0) * (1 - 1e-6) \
        and lw.max() >= -np.exp(-8.0) * (1 + 1e-6), "the clip never bites"
    del jax


SCAN_CASES = {"one_chunk": (8, False), "one_chunk_s0": (8, True),
              "three_chunks": (24, False), "three_chunks_s0": (24, True)}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_wkv_scan_matches_reference(case):
    """The state within 1e-5; the bf16 outputs within 1e-5 but for rounding
    ties, each one bf16 step apart, at most 1 in 1000."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    L, with_s0 = SCAN_CASES[case]
    jcfg, tcfg = _cfgs(JR)
    rng = np.random.default_rng(3)
    B, H = 3, D // HD
    r, k, v = (rng.standard_normal((B, L, H, HD)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(np.clip(rng.standard_normal((B, L, H, HD)), -8, 4)
                 ).astype(np.float32)
    u = rng.standard_normal((H, HD)).astype(np.float32) * 0.5
    s0 = _state(4, B)["s"] if with_s0 else None
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(a).bfloat16()       # noqa: E731
    jy, js = JR._wkv_scan(jb(r), jb(k), jb(v), jnp.asarray(u),
                          jnp.asarray(lw), jcfg,
                          None if s0 is None else jnp.asarray(s0))
    ty, ts = TR._wkv_scan(tb(r), tb(k), tb(v), torch.from_numpy(u),
                          torch.from_numpy(lw), tcfg,
                          None if s0 is None else torch.from_numpy(s0))
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _close(ts, js, what="state")
    ties = bf16_ties(ty.float().numpy(),
                     np.asarray(jy.astype(jnp.float32)), ATOL)
    assert ties <= ty.numel() // 1000
    del jax


def test_scans_refuse_partial_chunks():
    """L = 12 at chunk 8: the reference asserts, the port raises."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    jcfg, tcfg = _cfgs(JR)
    a = np.zeros((1, 12, D // HD, HD), np.float32)
    u = np.zeros((D // HD, HD), np.float32)
    with pytest.raises(AssertionError):
        JR._wkv_scan(*(jnp.asarray(a),) * 3, jnp.asarray(u), jnp.asarray(a),
                     jcfg)
    with pytest.raises(ValueError, match="whole chunks"):
        TR._wkv_scan(*(torch.from_numpy(a),) * 3, torch.from_numpy(u),
                     torch.from_numpy(a), tcfg)
    del jax


BLOCK_CASES = [(L, st, lv) for L in (8, 24) for st in (False, True)
               for lv in (0, 32)]


@pytest.mark.parametrize("L,with_state,levels", BLOCK_CASES)
def test_tm_apply_matches_reference(L, with_state, levels, monkeypatch):
    """The time-mix block over a prompt, its scan's streams held to the
    reference's (``lock_streams``; ties at most 1 in 1000): output and
    state within 1e-5.  At ``act_levels`` 32 the gate is the act_quant
    launch with its multiplier; the reference runs eagerly there."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    ties = lock_streams(JR, TR, monkeypatch)
    jcfg, tcfg = _cfgs(JR, levels=levels)
    jp, tp = _both(_params(5))
    x = np.random.default_rng(6).standard_normal((2, L, D)).astype(np.float32)
    st = _state(7, 2) if with_state else None
    jst, tst = _both(st) if st else (None, None)
    with jax.disable_jit(levels > 0):
        want, wst = JR.rwkv_tm_apply(jp, jnp.asarray(x), jcfg, jst)
    got, gst = TR.rwkv_tm_apply(tp, torch.from_numpy(x), tcfg, tst)
    _close(got, want, what="out")
    assert_tree_close(gst, wst, ATOL, "state")
    assert ties["scans"] == 1
    assert ties["r"] + ties["k"] + ties["v"] + ties["y"] <= x.size // 250


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("shift_dtype", ["float32", "bfloat16"])
def test_tm_decode_matches_reference(levels, shift_dtype):
    """Three decode steps from a seeded state: outputs and states within
    1e-5 (r, k and v stay f32 here, no bf16 rounding); a bf16 shift row
    promotes to f32 on both sides."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    jcfg, tcfg = _cfgs(JR, levels=levels)
    jp, tp = _both(_params(8))
    st = _state(9, 2)
    jst, tst = _both(st)
    jst["x_tm"] = jst["x_tm"].astype(shift_dtype)
    tst["x_tm"] = tst["x_tm"].to(getattr(torch, shift_dtype))
    rng = np.random.default_rng(10)
    for _ in range(3):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        with jax.disable_jit(levels > 0):
            want, jst = JR.rwkv_tm_decode(jp, jnp.asarray(x), jcfg, jst)
        got, tst = TR.rwkv_tm_decode(tp, torch.from_numpy(x), tcfg, tst)
        _close(got, want, what="out")
        assert_tree_close(tst, jst, ATOL, "state")


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_cm_apply_and_decode_match_reference(levels, with_state):
    """The channel mix (squared relu, relu6 snapped at ``act_levels`` 32)
    over a prompt and one decode step: within 1e-5."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    jcfg, tcfg = _cfgs(JR, levels=levels)
    jp, tp = _both(_params(11, "cm"))
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 9, D)) * 2).astype(np.float32)
    st = _state(13, 2)
    jst, tst = _both({"x_cm": st["x_cm"]})
    with jax.disable_jit(levels > 0):
        want, wst = JR.rwkv_cm_apply(jp, jnp.asarray(x), jcfg,
                                     jst if with_state else None)
        wd, wdst = JR.rwkv_cm_decode(jp, jnp.asarray(x[:, :1]), jcfg, jst)
    got, gst = TR.rwkv_cm_apply(tp, torch.from_numpy(x), tcfg,
                                tst if with_state else None)
    gd, gdst = TR.rwkv_cm_decode(tp, torch.from_numpy(x[:, :1]), tcfg, tst)
    _close(got, want, what="out")
    _close(gd, wd, what="decode out")
    assert_tree_close(gst, wst, ATOL, "state")
    assert_tree_close(gdst, wdst, ATOL, "decode state")


def test_init_functions_follow_the_reference():
    """The port's own init: the reference's shapes and dtypes, its constant
    leaves exactly (w0 = log(e − 1), u = 0.5, norm scales 1) and its
    distributions (mix in [0.25, 0.75), the LoRA's up matrix std 0.01);
    ``init_rwkv_cache`` zeros of the reference's shapes."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    jcfg, tcfg = _cfgs(JR)
    jt = JR.rwkv_tm_init(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)
    jc = JR.rwkv_cm_init(jax.random.PRNGKey(1), jcfg, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    tt = TR.rwkv_tm_init(gen, tcfg, torch.bfloat16, "cpu")
    tc = TR.rwkv_cm_init(gen, tcfg, torch.bfloat16, "cpu")
    for own, ref in ((tt, jt), (tc, jc)):
        assert {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
                for p, t in leaves(own)} \
            == {p: (a.shape, str(a.dtype)) for p, a in leaves(np_tree(ref))}
    for name in ("w0", "u"):
        np.testing.assert_array_equal(to_numpy_tree(tt[name]),
                                      np.asarray(jt[name], np.float32))
    np.testing.assert_array_equal(to_numpy_tree(tt["ln_out"]["scale"]), 1.0)
    for mix in (tt["mix"], tc["mix"]):
        m = mix.float()
        assert float(m.min()) >= 0.25 and float(m.max()) <= 0.75
    big = TR.rwkv_tm_init(gen, TR.RWKVConfig(d_model=512, head_dim=64),
                          torch.float32, "cpu")
    assert abs(float(big["w_lora_b"]["w"].std()) / 0.01 - 1) < 0.05
    assert abs(float(big["wr"]["w"].std()) * 512 ** 0.5 - 1) < 0.05
    cache = TR.init_rwkv_cache(tcfg, 3, torch.bfloat16, "cpu")
    want = JR.init_rwkv_cache(jcfg, 3, jnp.bfloat16)
    assert_tree_close(cache, want, 0.0, "cache")


# --- the model ---------------------------------------------------------------

@pytest.fixture(scope="module")
def rwkv_models():
    pytest.importorskip("jax")
    return {lv: reference_model("rwkv6-7b", levels=lv) for lv in (0, 32)}


@pytest.mark.parametrize("levels", [0, 32])
def test_reduced_model_matches_reference(levels, rwkv_models, monkeypatch):
    """The reduced rwkv6-7b (2 layers, d 128, f32) through the bridge, the
    scans' streams held to the reference's (``lock_streams``; ties counted,
    at most 1 in 100 elements): a 3-chunk prompt's prefill logits and cache
    within 1e-4 (the 0-d pos included); 6 decode steps from that cache
    (no bf16 stream there), logits and states within 1e-4; ``forward``'s
    logits at every position within 1e-4, its last ones equal to
    prefill's within 1e-6."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import rwkv as JR
    ties = lock_streams(JR, TR, monkeypatch)
    ns = rwkv_models[levels]
    toks = np.random.default_rng(14).integers(
        1, ns.cfg.vocab, (2, 3 * ns.cfg.ssm_chunk)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with jax.disable_jit(levels > 0):
        jl, jc = ns.model.prefill(ns.params, {"tokens": jnp.asarray(toks)})
    tl, tc = ns.tmodel.prefill(ns.tparams, {"tokens": tt})
    _close(tl, jl, 1e-4, "prefill logits")
    assert tc["pos"].ndim == 0 and int(tc["pos"]) == toks.shape[1]
    assert_tree_close(tc, jc, 1e-4, "prefill cache")
    nxt = np.random.default_rng(15).integers(1, ns.cfg.vocab, (6, 2, 1))
    for step in nxt.astype(np.int32):
        with jax.disable_jit(levels > 0):
            jd, jc = ns.model.decode(ns.params, jnp.asarray(step), jc)
        td, tc = ns.tmodel.decode(ns.tparams, torch.from_numpy(step).long(),
                                  tc)
        _close(td, jd, 1e-4, "decode logits")
        assert_tree_close(tc, jc, 1e-4, "decode cache")
    with jax.disable_jit(levels > 0):
        jf = ns.model.forward(ns.params, {"tokens": jnp.asarray(toks)})
    tf = ns.tmodel.forward(ns.tparams, {"tokens": tt})
    assert tf.shape == (2, toks.shape[1], ns.cfg.padded_vocab)
    _close(tf, jf, 1e-4, "forward logits")
    _close(tf[:, -1:], tl.numpy(), 1e-6, "forward's last logits")
    assert ties["scans"] == 2 * ns.cfg.n_layers
    n = 2 * toks.size * ns.cfg.d_model * ns.cfg.n_layers
    assert ties["r"] + ties["k"] + ties["v"] + ties["y"] <= n * 4 // 100


# The effect of one rounding tie of the scan's bf16 streams on a logit, with
# the port's own streams: an f32 last-bit difference at act_levels 0
# (1.41e-4 measured), an activation moved across a level boundary at
# act_levels 32 (2.06e-2 measured; a level step of |A| 32 is 6/31)
TIE_EFFECT = {0: 3e-4, 32: 3e-2}


@pytest.mark.parametrize("levels", [0, 32])
def test_reduced_model_unlocked_matches_reference(levels, rwkv_models):
    """The reduced rwkv6-7b as above, but on the port's own scan streams
    (no ``lock_streams``): prefill's last logits and ``forward``'s at every
    position within 1e-4 of the reference's, but at the positions a tie of
    the scan's bf16 streams reaches (at most 1 in 32 of them), which stay
    within ``TIE_EFFECT``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = rwkv_models[levels]
    toks = np.random.default_rng(14).integers(
        1, ns.cfg.vocab, (2, 3 * ns.cfg.ssm_chunk)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    with jax.disable_jit(levels > 0):
        jl, _ = ns.model.prefill(ns.params, {"tokens": jnp.asarray(toks)})
        jf = ns.model.forward(ns.params, {"tokens": jnp.asarray(toks)})
    tl, _ = ns.tmodel.prefill(ns.tparams, {"tokens": tt})
    tf = ns.tmodel.forward(ns.tparams, {"tokens": tt})
    for what, got, want in (("prefill", tl, jl), ("forward", tf, jf)):
        err = np.abs(got.numpy().astype(np.float64)
                     - np.asarray(want, np.float64)).max(axis=-1)
        assert err.max() <= TIE_EFFECT[levels], (what, err.max())
        assert (err > 1e-4).sum() <= max(1, err.size // 32), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_from_init_cache_matches_reference(dtype):
    """Decode from ``init_cache`` (f32 and the default bf16 rows: the bf16
    shift rows promote to f32 after the first step, on both sides) over
    a prompt: logits and caches within 1e-4, dtypes equal."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = reference_model("rwkv6-7b")
    toks = np.random.default_rng(16).integers(1, ns.cfg.vocab, (2, 5)
                                              ).astype(np.int32)
    jc = ns.model.init_cache(2, 8, dtype=getattr(jnp, dtype))
    tc = ns.tmodel.init_cache(2, 8, dtype=getattr(torch, dtype),
                              device="cpu")
    assert_tree_close(tc, jc, 0.0, "init_cache")
    for t in range(toks.shape[1]):
        jd, jc = ns.model.decode(ns.params, jnp.asarray(toks[:, t:t + 1]), jc)
        td, tc = ns.tmodel.decode(ns.tparams,
                                  torch.from_numpy(toks[:, t:t + 1]).long(),
                                  tc)
        _close(td, jd, 1e-4, "decode logits")
        assert_tree_close(tc, jc, 1e-4, f"cache after step {t}")
    del jax


def test_bridge_and_compression_of_the_tree():
    """The bridge carries the reduced rwkv6-7b's tree both ways (bf16).
    The port's ``cluster_params`` clusters every leaf (mix, w0, u and the
    norms too) onto the reference's codebook, and given the reference's
    codebook ``to_codebook_params`` gives the reference's index form leaf
    for leaf: the ``w`` and ``table`` leaves of at least 4096 values, the
    LoRA's down and up matrices among them; the lut fan-in the engine
    would take is the embedding's rows (512), as the reference's."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.models.model_zoo import build
    from repro_torch.bridge import from_jax_state
    from repro_torch.core import quantizer as TQ
    from repro_torch.serving import compress as TS

    tree = np_tree(build(C.get("rwkv6-7b").reduced().replace(
        dtype="bfloat16")).init(jax.random.PRNGKey(0)))
    want, got = dict(leaves(tree)), dict(leaves(to_numpy_tree(
        from_jax_params(tree, "cpu"))))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a.astype(np.float32), path)

    ns = reference_model("rwkv6-7b", levels=32, n_weights=256)
    wq = TQ.WeightQuantConfig(num_weights=256, method=ns.wq.method)
    pq, state = TQ.cluster_params(ns.tparams, wq, TQ.init_state(wq),
                                  ns.wq.interval)
    book = np.asarray(ns.state.codebooks[""])
    np.testing.assert_allclose(state.codebooks[""].numpy(), book,
                               rtol=1e-6, atol=1e-9)
    for path, t in leaves(pq):
        assert torch.isin(t, state.codebooks[""]).all(), path
    cp = TS.to_codebook_params(from_jax_params(np_tree(ns.clustered), "cpu"),
                               wq, from_jax_state({"": book}, device="cpu"))
    tm = cp["blocks"]["tm"]
    assert {"w_idx", "codebook"} <= set(tm["w_lora_a"]) \
        and {"w_idx", "codebook"} <= set(tm["w_lora_b"])
    assert "w_idx" in cp["embed"] and torch.is_tensor(tm["mix"])
    assert_tree_close(cp, ns.index, 0.0, "index form")
    jspec, tspec = lut_specs(ns)
    assert dataclasses.astuple(tspec) == dataclasses.astuple(jspec)


@pytest.fixture(scope="module")
def compressed():
    pytest.importorskip("jax")
    return reference_model("rwkv6-7b", levels=32, n_weights=256)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compressed_greedy_tokens_match_reference(backend, compressed,
                                                  monkeypatch):
    """The compressed model at the working point's activations (|A| 32,
    |W| 256): a 16-token prefill (the scans' streams held to the
    reference's) and 4 greedy decodes through the model handle give the
    reference's tokens on ``backend``."""
    from repro.models import rwkv as JR
    lock_streams(JR, TR, monkeypatch)
    ns = compressed
    toks = np.random.default_rng(17).integers(1, ns.cfg.vocab, (2, 16)
                                              ).astype(np.int32)
    jspec, tspec = lut_specs(ns)
    want = greedy_reference(ns, toks, 4, backend, jspec)
    got = greedy_port(ns, toks, 4, backend, tspec)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_compressed_greedy_tokens_unlocked_match_reference(backend,
                                                           compressed):
    """The greedy tokens of ``test_compressed_greedy_tokens_match_reference``
    on the port's own scan streams (no ``lock_streams``): still the
    reference's on ``backend``."""
    ns = compressed
    toks = np.random.default_rng(17).integers(1, ns.cfg.vocab, (2, 16)
                                              ).astype(np.int32)
    jspec, tspec = lut_specs(ns)
    want = greedy_reference(ns, toks, 4, backend, jspec)
    got = greedy_port(ns, toks, 4, backend, tspec)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_forward_of_the_kv_families_matches_reference(name):
    """``forward``, new in the port with the recurrent families, runs the
    dense and MoE trunks too: the reduced models' logits at every position
    within 1e-4 of the reference's, the last ones equal to prefill's."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    ns = reference_model(name)
    toks = np.random.default_rng(18).integers(1, ns.cfg.vocab, (2, 12)
                                              ).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    want = ns.model.forward(ns.params, {"tokens": jnp.asarray(toks)})
    got = ns.tmodel.forward(ns.tparams, {"tokens": tt})
    assert got.shape == (2, 12, ns.cfg.padded_vocab)
    _close(got, want, 1e-4, "forward logits")
    tl, _ = ns.tmodel.prefill(ns.tparams, {"tokens": tt})
    _close(got[:, -1:], tl.numpy(), 1e-6, "forward's last logits")
    del jax


# --- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("name", REFUSALS)
def test_refusals_match_reference(name, rwkv_models):
    from repro.serving import ServeEngine as JEngine
    from repro_torch.serving import ServeEngine as TEngine
    ns = rwkv_models[0]
    if name == "engine":
        want = refusal(lambda: JEngine(ns.model, ns.params, max_len=16))
        got = refusal(lambda: TEngine(ns.tmodel, ns.tparams, max_len=16,
                                      device="cpu"))
    else:
        want = refusal(refusal_calls(ns.model, ns.params, "jax")[name])
        got = refusal(refusal_calls(ns.tmodel, ns.tparams, "torch")[name])
    assert got == want
    assert want[0] == "NotImplementedError"
