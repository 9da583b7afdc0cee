"""The port's mixture-of-experts FFN (``repro_torch/models/moe.py``) and the
``moe`` family's model against the JAX package's, computed live in this
process.

* ``moe_apply`` on seeded inputs: the routing decisions (top-k ids, the
  dispatch's slots and keep flags) exact, the buffer and the output within
  ``atol 1e-5`` in f32, for a capacity factor of 1.25 with pairs dropped,
  a case with no drop, ``token_chunks=2`` and ``act_levels`` 0 and 32;
  top-k's order on exact ties equals ``lax.top_k``'s;
* ``moe_init``'s shapes, dtypes and standard deviations;
* the reduced qwen3-moe-30b-a3b and grok-1-314b (``kv_quant``; token
  chunks 1 and 2): the bridge carries the trees both ways, the port's
  clustering and index form of the tree equal the reference's (experts
  clustered but dense, the router dense under the size limit), and
  prefill, decode and verify logits and caches agree within 1e-4;
* the router fault the port reproduces: at ``d_model=512`` the compressed
  router is in index form and both packages raise ``KeyError`` at the
  router's read; ``exclude="router"`` serves on both, token for token.

The serving paths are held to the reference in ``test_torch_moe_serve.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-5


def reference_moe_model(name="qwen3-moe-30b-a3b", n_weights=1000,
                        exclude="", **over):
    """A reduced registry MoE model in both packages, compressed as the
    launcher's ``--compress`` does it (laplacian_l1, ``min_size`` 4096):
    the reference's model, its clustered and index-form params, and the
    port's, carried by the bridge."""
    jax = pytest.importorskip("jax")
    import dataclasses

    import repro.configs as C
    from repro.core.quantizer import cluster_params, init_state
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig, to_codebook_params

    cfg = C.get(name).reduced().replace(**over)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    wq = dataclasses.replace(cfg.quantized(n_weights=n_weights).wq,
                             exclude=exclude)
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        jax=jax, Engine=ServeEngine, Spec=SpecConfig, cfg=cfg, model=m,
        wq=wq, book=np.array(state.codebooks[""]),
        tmodel=tbuild(TCfg.get(name).reduced().replace(**over)),
        np_params={"raw": np_tree(params), "dense": np_tree(pq),
                   "index": np_tree(cp)},
        params={"dense": pq, "index": cp},
        tparams={"dense": from_jax_params(np_tree(pq), "cpu"),
                 "index": from_jax_params(np_tree(cp), "cpu")})


@pytest.fixture(scope="module")
def qmoe():
    return reference_moe_model()


# --- moe_apply ---------------------------------------------------------------

def _inputs(seed, T, d, f, E, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, d)).astype(dtype)
    p = {"router": {"w": (rng.standard_normal((d, E))
                          / np.sqrt(d)).astype(np.float32)},
         "w1": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(dtype),
         "w3": (rng.standard_normal((E, d, f)) / np.sqrt(d)).astype(dtype),
         "w2": (rng.standard_normal((E, f, d)) / np.sqrt(f)).astype(dtype)}
    return x, p


# (T, capacity factor, token chunks, act_levels, experts, top_k, drops)
APPLY_CASES = {
    "cf1.25_drops": (16, 1.25, 1, 0, 8, 2, True),
    "no_drop": (16, 8.0, 1, 0, 8, 2, False),
    "chunks2": (32, 1.25, 2, 0, 8, 2, True),
    "act32": (16, 1.25, 1, 32, 8, 2, True),
    "act32_chunks2": (32, 1.25, 2, 32, 8, 2, True),
    "e16_top4": (12, 1.25, 1, 0, 16, 4, True),
    "decode_cap1": (4, 1.25, 1, 0, 128, 8, True),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_moe_apply_matches_reference(case):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import moe as JM

    T, cf, chunks, levels, E, k, drops = APPLY_CASES[case]
    d, f = 32, 48
    x, p = _inputs(7, T, d, f, E)
    kw = dict(d_model=d, d_ff=f, n_experts=E, top_k=k, capacity_factor=cf,
              token_chunks=chunks, act_levels=levels)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(torch.from_numpy, p)

    # the routing decisions of every chunk, exact
    Tc = T // chunks
    cap = max(1, int(Tc * k * cf / E))
    for xc in x.reshape(chunks, Tc, d):
        jprobs = jax.nn.softmax(jnp.asarray(xc) @ jp["router"]["w"], -1)
        jg, jids = jax.lax.top_k(jprobs, k)
        jbuf, jslot, jkeep = JM._dispatch_local(jnp.asarray(xc), jids, jg,
                                                0, E, cap)
        tprobs = torch.softmax(torch.from_numpy(xc) @ tp["router"]["w"], -1)
        tg, tids = TM._top_k(tprobs, k)
        tbuf, tslot, tkeep = TM._dispatch_local(torch.from_numpy(xc), tids,
                                                0, E, cap)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)
        np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
        np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), atol=0)
        assert (not np.asarray(jkeep).all()) == drops, "weak case"

    want = np.asarray(JM.moe_apply(jp, jnp.asarray(x), jcfg))
    got = TM.moe_apply(tp, torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_top_k_breaks_ties_as_lax_top_k():
    """Rows with exactly equal probabilities: the lower expert index first,
    as ``lax.top_k``; ``torch.topk`` makes no such promise."""
    jax = pytest.importorskip("jax")
    rng = np.random.default_rng(3)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    probs[0] = 0.25
    probs[1, ::2] = 0.5
    for k in (1, 2, 5, 16):
        jv, ji = jax.lax.top_k(probs, k)
        tv, ti = TM._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_init_shapes_dtypes_and_stds():
    cfg = TM.MoEConfig(d_model=64, d_ff=256, n_experts=8, top_k=2)
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, cfg, torch.bfloat16, "cpu", layers=(3,))
    assert p["router"]["w"].shape == (3, 64, 8)
    assert p["router"]["w"].dtype == torch.float32
    assert p["w1"].shape == p["w3"].shape == (3, 8, 64, 256)
    assert p["w2"].shape == (3, 8, 256, 64)
    assert {p[k].dtype for k in ("w1", "w2", "w3")} == {torch.bfloat16}
    for w, fan_in in ((p["router"]["w"], 64), (p["w1"], 64), (p["w3"], 64),
                      (p["w2"], 256)):
        std = w.to(torch.float32).std().item()
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05


# --- the model ---------------------------------------------------------------

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_moe_tree_both_ways(dtype):
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.models.model_zoo import build

    cfg = C.get("grok-1-314b").reduced().replace(dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, build(cfg).init(jax.random.PRNGKey(0)))
    tp = from_jax_params(tree, "cpu")
    assert tp["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    assert tp["blocks"]["moe"]["w1"].dtype == getattr(torch, dtype)
    assert tp["blocks"]["moe"]["w1"].shape == (2, 8, 128, 256)
    want, got = dict(_leaves(tree)), dict(_leaves(to_numpy_tree(tp)))
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a.astype(got[path].dtype),
                                      err_msg=path)
    # the port's own init: the same tree layout, shapes and dtypes
    own = tbuild(TCfg.get("grok-1-314b").reduced().replace(dtype=dtype)) \
        .init(torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(t.shape), str(t.dtype)) for p, t in _leaves(own)} \
        == {p: (tuple(t.shape), str(t.dtype)) for p, t in _leaves(tp)}


def test_compression_of_moe_tree_equals_reference(qmoe):
    """The port's cluster_params on the bridged raw tree finds the
    reference's codebook (within f32 rounding) and snaps the 4-D expert
    leaves onto it; given the reference's codebook, to_codebook_params
    gives the reference's tree leaf for leaf: the experts clustered but
    dense, the router below the size limit dense, the attention, embedding
    and head in index form."""
    from repro_torch.bridge import from_jax_state
    from repro_torch.core import quantizer as TQ
    from repro_torch.serving import compress as TS

    raw = from_jax_params(qmoe.np_params["raw"], "cpu")
    wq = TQ.WeightQuantConfig(num_weights=qmoe.wq.num_weights,
                              method=qmoe.wq.method)
    pq, state = TQ.cluster_params(raw, wq, TQ.init_state(wq),
                                  qmoe.wq.interval)
    np.testing.assert_allclose(state.codebooks[""].numpy(), qmoe.book,
                               rtol=1e-6, atol=1e-9)
    w1 = pq["blocks"]["moe"]["w1"]
    assert w1.ndim == 4 and torch.isin(w1, state.codebooks[""]).all()
    np.testing.assert_allclose(
        w1.numpy(), qmoe.np_params["dense"]["blocks"]["moe"]["w1"],
        rtol=1e-6, atol=1e-9)
    ref_state = from_jax_state({"": qmoe.book}, device="cpu")
    cp = TS.to_codebook_params(qmoe.tparams["dense"], wq, ref_state)
    moe = cp["blocks"]["moe"]
    assert set(moe) == {"router", "w1", "w2", "w3"}
    assert set(moe["router"]) == {"w"}
    assert "w_idx" in cp["blocks"]["attn"]["wq"] and "w_idx" in cp["embed"]
    want = dict(_leaves(qmoe.np_params["index"]))
    got = dict(_leaves(to_numpy_tree(cp)))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)


MODELS = {"qwen3_moe": ("qwen3-moe-30b-a3b", {}),
          "grok": ("grok-1-314b", {}),
          "grok_chunks2": ("grok-1-314b", {"moe_token_chunks": 2})}


@pytest.mark.parametrize("which", list(MODELS))
def test_forwards_match_reference(which):
    """Prefill (right-padded prompts), a decode step and a verify step on
    the reference's own prefill cache: logits within 1e-4, int8 cache codes
    of grok's ``kv_quant`` cache equal."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.configs as C
    from repro.models.model_zoo import build

    name, over = MODELS[which]
    cfg = C.get(name).reduced().replace(**over)
    jm = build(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(TCfg.get(name).reduced().replace(**over))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab, (4, 16)).astype(np.int32)
    lens = np.array([16, 9, 3, 12], np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                             "lengths": torch.from_numpy(lens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for name_ in jc["kv"]:
        a, b = np.asarray(jc["kv"][name_]), to_numpy_tree(tc["kv"][name_])
        if a.dtype == np.int8:
            assert (a != b).mean() < 1e-3, name_
        else:
            np.testing.assert_allclose(b, a.astype(b.dtype), atol=1e-4)

    def grown(c, S):
        kv = {k: np.pad(np.asarray(v), [(0, 0), (0, 0), (0, S - v.shape[2])]
                        + [(0, 0)] * (v.ndim - 3))
              for k, v in c["kv"].items()}
        return kv, np.asarray(c["pos"])

    kv, pos = grown(jc, 24)
    nxt = rng.integers(1, cfg.vocab, (4, 1)).astype(np.int32)
    vt = rng.integers(1, cfg.vocab, (4, 3)).astype(np.int32)
    jd, _ = jm.decode(params, jnp.asarray(nxt),
                      {"kv": {k: jnp.asarray(v) for k, v in kv.items()},
                       "pos": jnp.asarray(pos)})
    td, _ = tm.decode(tp, torch.from_numpy(nxt).long(),
                      {"kv": from_jax_params(kv, "cpu"),
                       "pos": torch.from_numpy(pos.copy())})
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4)
    jv, _ = jm.verify(params, jnp.asarray(vt),
                      {"kv": {k: jnp.asarray(v) for k, v in kv.items()},
                       "pos": jnp.asarray(pos)})
    tv, _ = tm.verify(tp, torch.from_numpy(vt).long(),
                      {"kv": from_jax_params(kv, "cpu"),
                       "pos": torch.from_numpy(pos.copy())})
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


# --- the router fault ----------------------------------------------------------

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10]]


@pytest.mark.parametrize("backend", ["dense", "codebook"])
def test_compressed_router_raises_on_both_sides(backend):
    """At d_model 512 the router (2 · 512 · 8 values) passes the index
    form's size limit: the reference's ``moe_apply`` raises ``KeyError:
    'w'`` reading it, and so does the port's; neither serves."""
    m = reference_moe_model(d_model=512, n_layers=1)
    assert set(m.np_params["index"]["blocks"]["moe"]["router"]) \
        == {"w_idx", "codebook"}
    with pytest.raises(KeyError, match="'w'"):
        m.Engine(m.model, m.params["index"], max_len=32,
                 backend=backend).generate(PROMPTS, max_new=2)
    with pytest.raises(KeyError, match="'w'"):
        TEngine(m.tmodel, m.tparams["index"], max_len=32, backend=backend,
                device="cpu").generate(PROMPTS, max_new=2)


def test_router_excluded_serves_on_both_sides():
    """The reference's own way around the fault, ``exclude="router"``: the
    router stays dense, and dense, codebook and lut serve the same tokens
    on both packages."""
    m = reference_moe_model(d_model=512, n_layers=1, exclude="router")
    assert set(m.np_params["index"]["blocks"]["moe"]["router"]) == {"w"}
    outs = []
    for be in ("dense", "codebook", "lut"):
        want = m.Engine(m.model, m.params["index"], max_len=32,
                        backend=be).generate(PROMPTS, max_new=4)
        got = TEngine(m.tmodel, m.tparams["index"], max_len=32, backend=be,
                      device="cpu").generate(PROMPTS, max_new=4)
        assert [list(map(int, r)) for r in got] \
            == [list(map(int, r)) for r in want], be
        outs.append(got)
    assert outs[0] == outs[1]


def test_experts_never_take_the_gated_launch(monkeypatch):
    """At ``act_levels`` 32 on the codebook backend a dense model's FFN is
    one gated launch (``ops.codebook_swiglu``); the experts are dense and
    take ``ffn_act`` on their whole (E, C, f) buffer instead, as the
    reference's einsums do."""
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.serving import to_codebook_params

    cfg = TCfg.get("qwen3-moe-30b-a3b").reduced().replace(act_levels=32)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    wq = WeightQuantConfig(num_weights=1000)
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, state)

    def refuse(*a, **k):
        raise AssertionError("codebook_swiglu on a MoE layer")
    shapes = []
    ffn_act = layers.ffn_act

    def record(x, *a, **k):
        shapes.append(tuple(x.shape))
        return ffn_act(x, *a, **k)
    monkeypatch.setattr(ops, "codebook_swiglu", refuse)
    monkeypatch.setattr(TM, "ffn_act", record)
    out = TEngine(model, cp, max_len=32, backend="codebook",
                  device="cpu").generate(PROMPTS, max_new=3)
    assert [len(o) for o in out] == [6, 8, 5]
    assert shapes and all(len(s) == 3 and s[0] == cfg.n_experts
                          and s[2] == cfg.d_ff for s in shapes)
