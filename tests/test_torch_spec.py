"""Speculative decoding on the contiguous cache: the port's
``serving/spec.py``, ``attention.attn_verify_cached``,
``transformer.verify_step`` and ``ServeEngine(spec=...)`` against the JAX
package's, computed live in this process.

Models: qwen3-1.7b reduced to 2 layers in f32 (k-means |W| = 256, as
``test_torch_engine.py``), codeqwen1.5-7b reduced with its int8 contiguous
cache (``kv_quant``), and the reduced qwen3 at the paper's working point
(``quantized(levels=32, n_weights=1000, method="kmeans")``, the reference
run op by op under ``jax.disable_jit``, as ``test_torch_quantized_serve.py``
does).  Params cross through the bridge; inputs are seeded through numpy.

* ``ngram_propose`` (tensor ops) and ``ngram_propose_host`` equal the
  reference's on random and repetitive contexts; ``spec_accept`` at
  temperature 0 equals it (acceptance counts and tokens);
* ``attn_verify_cached`` and ``verify_step``: logits and written K/V
  within 1e-3 (the bound of ``tests/test_golden_decode.py``), int8 codes
  one apart at most where the two packages' f32 K/V sit at a rounding tie
  (counted), ``pos`` unchanged; row i of a verify equals i + 1 sequential
  decode steps within 1e-3;
* greedy spec ``serve`` equals the reference's spec serve and the port's
  baseline serve token for token, with all four ``SpecStats`` counters
  equal to the reference's: n-gram on every backend, a lut draft for a
  codebook target, a dense draft, the int8 cache, the working point,
  stops of 1 and 2 and mixed stops;
* temperature > 0: one seed gives equal tokens twice and another seed
  others, ``top_k = 1`` (and a tiny nucleus) equals greedy, and
  ``spec_accept``'s first emitted token follows the target's distribution
  (a chi-square test over 20,000 draws at a fixed seed, point-mass and
  model drafts alike);
* validation, and ``paged=True`` with ``spec`` accepted (held against
  the reference in ``test_torch_paged_spec.py``).

The ``cuda`` tests need the card (``pytest -m cuda``): the graph route
against the eager route on qwen3-1.7b at full width (2 layers) and
codeqwen1.5-7b (2 layers, int8 cache) — tokens and counters over serves at
temperature 0 and above it, and one round's logits bit for bit; and
profiler sessions taken after a lut-draft spec serve on the graph route
hold the decode step's kernels.  JAX is imported only through fixtures:
the card's machine has none.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import SpecConfig as TSpec  # noqa: E402
from repro_torch.serving import spec as TS  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-3
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14],
           [7, 8, 9] * 4, [5] * 6]
STOPS = [6, 3, 5, 1, 9, 4]
MAX_LEN = 64


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    from repro.serving import spec as JS
    return SimpleNamespace(jax=jax, jnp=jax.numpy, JS=JS)


def _reference_model(name, quantized=False, **kw):
    """A reduced registry model in both packages: the reference's model,
    dense and index-form params, and the port's, carried by the bridge."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.core.quantizer import (WeightQuantConfig, cluster_params,
                                      init_state)
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig, to_codebook_params
    from repro_torch.bridge import from_jax_params

    def cfg_of(mod):
        c = mod.get(name).reduced().replace(**kw)
        return c.quantized(levels=32, n_weights=1000,
                           method="kmeans") if quantized else c
    cfg = cfg_of(C)
    m = build(cfg)
    params = m.init(jax.random.PRNGKey(0))
    if quantized:
        wq = cfg.wq
        pq, state = cluster_params(params, wq, init_state(wq), wq.interval,
                                   jax.random.PRNGKey(1))
        cp = to_codebook_params(pq, wq, state)
    else:
        wq = WeightQuantConfig(num_weights=256, method="kmeans")
        pq, state = cluster_params(params, wq, init_state(wq), 1000,
                                   jax.random.PRNGKey(1))
        cp = to_codebook_params(pq, wq, state, min_size=1024)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        jax=jax, Engine=ServeEngine, Spec=SpecConfig, cfg=cfg, model=m,
        tmodel=tbuild(cfg_of(TCfg)),
        params={"dense": params, "index": cp},
        tparams={"dense": from_jax_params(np_tree(params), "cpu"),
                 "index": from_jax_params(np_tree(cp), "cpu")})


@pytest.fixture(scope="module")
def qwen():
    return _reference_model("qwen3-1.7b", n_layers=2, dtype="float32")


@pytest.fixture(scope="module")
def codeqwen():
    m = _reference_model("codeqwen1.5-7b")
    assert m.cfg.kv_quant and m.tmodel.cfg.kv_quant
    return m


@pytest.fixture(scope="module")
def point():
    return _reference_model("qwen3-1.7b", quantized=True, n_layers=2,
                            dtype="float32")


# --- the pieces ----------------------------------------------------------------

def _contexts(seed: int):
    """(ctx (B, C) int32, lengths (B,)): random rows over a small vocabulary
    (matches of every length occur), periodic rows, a row of one repeated
    token, and rows too short to match."""
    rng = np.random.default_rng(seed)
    C = 40
    ctx = rng.integers(0, 4, (8, C)).astype(np.int32)
    ctx[4] = np.resize([7, 8, 9], C)
    ctx[5] = np.resize([3, 1, 4, 1, 5], C)
    ctx[6] = 2
    lens = rng.integers(1, C + 1, 8)
    lens[4], lens[5], lens[6], lens[7] = 13, 31, 9, 2
    return ctx, lens.astype(np.int32)


@pytest.mark.parametrize("k,n", [(1, 1), (3, 2), (4, 2), (4, 3), (6, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_ngram_propose_equals_reference(jx, seed, k, n):
    ctx, lens = _contexts(seed)
    want = np.asarray(jx.JS.ngram_propose(jx.jnp.asarray(ctx),
                                          jx.jnp.asarray(lens), k=k, n=n))
    got = TS.ngram_propose(torch.from_numpy(ctx).long(),
                           torch.from_numpy(lens), k=k, n=n)
    np.testing.assert_array_equal(got.numpy(), want)
    for row, L in zip(ctx, lens):
        hist = row[:L].tolist()
        assert TS.ngram_propose_host(hist, k=k, n=n) == \
            jx.JS.ngram_propose_host(hist, k=k, n=n)


def test_ngram_propose_repeats_pattern():
    """A periodic context proposes its own continuation, on device and on
    host alike; no match repeats the last token."""
    hist = [7, 8, 9] * 4
    ctx = torch.zeros((1, 32), dtype=torch.int64)
    ctx[0, :len(hist)] = torch.tensor(hist)
    dev = TS.ngram_propose(ctx, torch.tensor([len(hist)]), k=4, n=2)
    assert dev[0].tolist() == TS.ngram_propose_host(hist, k=4, n=2) \
        == [7, 8, 9, 7]
    ctx[0, :4] = torch.tensor([1, 2, 3, 4])
    assert TS.ngram_propose(ctx, torch.tensor([4]), k=3, n=2)[0].tolist() \
        == TS.ngram_propose_host([1, 2, 3, 4], k=3, n=2) == [4, 4, 4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_accept_greedy_equals_reference(jx, seed):
    """Random logits; proposals equal to the target's argmax for a random
    prefix of each row, then random."""
    rng = np.random.default_rng(seed)
    B, K, V = 6, 4, 16
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    draft = rng.integers(0, V, (B, K))
    for b in range(B):
        keep = rng.integers(0, K + 1)
        draft[b, :keep] = tgt[b, :keep]
    draft = draft.astype(np.int32)
    jn, jt = jx.JS.spec_accept(jx.jnp.asarray(logits), jx.jnp.asarray(draft),
                               None, jx.jax.random.PRNGKey(0),
                               temperature=0.0)
    tn, tt = TS.spec_accept(torch.from_numpy(logits),
                            torch.from_numpy(draft).long(), None,
                            temperature=0.0)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_spec_accept_greedy_prefix():
    """Temperature 0: accept while draft == target argmax; the emission is
    the argmax row, so a round emits what k + 1 greedy steps would."""
    logits = torch.full((1, 4, 8), -5.0)
    for i, t in enumerate((3, 1, 4, 2)):
        logits[0, i, t] = 5.0
    n_acc, toks = TS.spec_accept(logits, torch.tensor([[3, 1, 7]]), None,
                                 temperature=0.0)
    assert int(n_acc[0]) == 2 and toks[0, :3].tolist() == [3, 1, 4]
    n_acc, toks = TS.spec_accept(logits, torch.tensor([[3, 1, 4]]), None,
                                 temperature=0.0)
    assert int(n_acc[0]) == 3 and toks[0].tolist() == [3, 1, 4, 2]


def test_spec_accept_certain_target_always_accepts():
    """Temperature > 0 with a near-certain target: proposals matching its
    mode are accepted, a mismatch is rejected and corrected."""
    logits = torch.full((1, 3, 8), -30.0)
    for i, t in enumerate((5, 2, 6)):
        logits[0, i, t] = 30.0
    for seed in range(5):
        g = torch.Generator().manual_seed(seed)
        n_acc, toks = TS.spec_accept(logits, torch.tensor([[5, 2]]), None,
                                     temperature=1.0, generator=g)
        assert int(n_acc[0]) == 2 and toks[0].tolist() == [5, 2, 6]
        n_acc, toks = TS.spec_accept(logits, torch.tensor([[5, 0]]), None,
                                     temperature=1.0, generator=g)
        assert int(n_acc[0]) == 1 and toks[0, :2].tolist() == [5, 2]


def test_filter_logits_topk_topp():
    lg = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    assert (TS.filter_logits(lg, top_k=2)[0] > -1e29).tolist() == [
        False, False, True, True]
    p = torch.softmax(lg, -1)[0]
    pp = TS.filter_logits(lg, top_p=float(p[3]) + 1e-3)
    assert (pp[0] > -1e29).tolist() == [False, False, True, True]
    assert int(torch.argmax(TS.filter_logits(lg, top_k=1, top_p=0.01))) == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_accept_counts_given_uniforms(seed):
    """The acceptance counts for fixed uniforms: proposal i survives when
    u_i·q_i < p_i, and the prefix stops at the first rejection — counted
    here by a loop over the rule, against ``spec_accept`` given the same
    uniforms."""
    rng = np.random.default_rng(seed)
    B, K, V = 64, 4, 8
    logits = torch.from_numpy(rng.standard_normal((B, K + 1, V)) * 2)
    q = torch.softmax(torch.from_numpy(rng.standard_normal((B, K, V))), -1)
    draft = torch.multinomial(q.reshape(-1, V), 1).reshape(B, K)
    u = torch.from_numpy(rng.random((B, K)))
    n_acc, toks = TS.spec_accept(logits, draft, q, temperature=0.7, u=u,
                                 generator=torch.Generator().manual_seed(0))
    p = TS.target_dist(logits, 0.7)
    for b in range(B):
        n = 0
        while n < K and u[b, n] * q[b, n, draft[b, n]] < p[b, n, draft[b, n]]:
            n += 1
        assert int(n_acc[b]) == n
        assert toks[b, :n].tolist() == draft[b, :n].tolist()
    assert 0 < int(n_acc.sum()) < B * K


# the 0.999 quantile of the chi-square law with 5 degrees of freedom
CHI2_5_999 = 20.515


@pytest.mark.parametrize("draft", ["point_mass", "model"])
def test_spec_accept_emits_the_target_distribution(draft):
    """Over a vocabulary of 8, 20,000 rounds of one row each (batched),
    k = 2, temperature 0.9 with top-k 6: the first emitted token follows
    the filtered target distribution.  Point mass: every proposal the
    target's second most likely token (the n-gram draft's form); model:
    proposals drawn from a distribution q far from p.  The chi-square
    statistic over the six tokens the filter keeps lies below the 0.999
    quantile of its law (5 degrees of freedom: 20.515), at a fixed
    seed."""
    N, K, V, T = 20000, 2, 8, 0.9
    rng = np.random.default_rng(3)
    row = torch.from_numpy(rng.standard_normal((K + 1, V)).astype(np.float32)
                           * 1.5)
    logits = row[None].expand(N, K + 1, V).contiguous()
    p0 = TS.target_dist(row[0], T, top_k=6)
    gen = torch.Generator().manual_seed(11)
    if draft == "point_mass":
        second = int(torch.argsort(p0, descending=True)[1])
        d_toks = torch.full((N, K), second, dtype=torch.int64)
        q = None
    else:
        qrow = torch.softmax(-row[:K] * 0.8, -1)
        q = qrow[None].expand(N, K, V).contiguous()
        d_toks = torch.multinomial(q.reshape(-1, V), 1, generator=gen
                                   ).reshape(N, K)
    n_acc, toks = TS.spec_accept(logits, d_toks, q, temperature=T, top_k=6,
                                 generator=gen)
    counts = torch.bincount(toks[:, 0], minlength=V).double()
    expect = p0.double() * N
    live = expect > 0
    assert counts[~live].sum() == 0          # filtered tokens never emitted
    chi2 = float(((counts[live] - expect[live]) ** 2 / expect[live]).sum())
    dof = int(live.sum()) - 1
    assert dof == 5                          # top-k 6 keeps six tokens
    assert chi2 < CHI2_5_999, chi2
    assert 0 < int(n_acc.sum()) < N * K


# --- verify ----------------------------------------------------------------------

def _layer0(tree):
    return {k: _layer0(v) if isinstance(v, dict) else v[0]
            for k, v in tree.items()}


@pytest.mark.parametrize("cache", ["float", "int8"])
def test_attn_verify_cached_equals_reference(qwen, codeqwen, cache):
    """One layer's verify on a random cache (3 slots of 16 rows; positions
    0, 5 and 14, the last clamped to S − K1 = 12): the attention output
    within 1e-3, the written rows within 1e-3 (float) or one int8 code
    (int8, counted), every other row and scale unchanged."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import transformer as JT
    m = qwen if cache == "float" else codeqwen
    cfg = m.cfg
    rng = np.random.default_rng(4)
    B, K1, S, nL = 3, 4, 16, 2
    KV, hd = cfg.n_kv, cfg.hd
    x = rng.standard_normal((B, K1, cfg.d_model)).astype(np.float32)
    pos_v = np.array([0, 5, 14], np.int32)
    ppos = pos_v[:, None] + np.arange(K1)[None]
    kv_shape = (nL, B, S, KV, hd)
    if cache == "float":
        k_all = rng.standard_normal(kv_shape).astype(np.float32)
        v_all = rng.standard_normal(kv_shape).astype(np.float32)
        scales = None
    else:
        k_all = rng.integers(-127, 128, kv_shape).astype(np.int8)
        v_all = rng.integers(-127, 128, kv_shape).astype(np.int8)
        scales = tuple(
            (rng.random(kv_shape[:-1]) * 0.02 + 1e-3).astype(np.float32)
            for _ in range(2))
    jp = m.jax.tree_util.tree_map(lambda a: a[0],
                                  m.params["dense"]["blocks"]["attn"])
    jsc = None if scales is None else tuple(
        jnp.asarray(s).astype(jnp.bfloat16) for s in scales)
    jout, jk, jv, jnsc = JA.attn_verify_cached(
        jp, jnp.asarray(x), JT.attn_cfg(cfg), pos=jnp.asarray(ppos),
        insert_at=jnp.asarray(pos_v), valid_len=jnp.asarray(pos_v),
        k_all=jnp.asarray(k_all), v_all=jnp.asarray(v_all), layer=1,
        scales=jsc)
    tk, tv = torch.from_numpy(k_all.copy()), torch.from_numpy(v_all.copy())
    tsc = None if scales is None else tuple(
        torch.from_numpy(s).to(torch.bfloat16) for s in scales)
    tsc0 = None if tsc is None else tuple(s.clone() for s in tsc)
    tout = TA.attn_verify_cached(
        _layer0(m.tparams["dense"]["blocks"]["attn"]), torch.from_numpy(x),
        TT.attn_cfg(m.tmodel.cfg), pos=torch.from_numpy(ppos),
        insert_at=torch.from_numpy(pos_v), valid_len=torch.from_numpy(pos_v),
        k_all=tk, v_all=tv, layer=1, scales=tsc)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    written = np.zeros((B, S), bool)
    for b, r in enumerate(np.minimum(pos_v, S - K1)):
        written[b, r:r + K1] = True
    for got, want, orig in ((tk, jk, k_all), (tv, jv, v_all)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got[0], orig[0])       # other layer
        np.testing.assert_array_equal(got[1][~written], orig[1][~written])
        d = np.abs(got[1][written].astype(np.float64)
                   - want[1][written].astype(np.float64))
        if cache == "float":
            assert d.max() <= ATOL
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 1e-2, (d.max(),
                                                            (d > 0).mean())
    if cache == "int8":
        for got, want, orig in zip(tsc, jnsc, tsc0):
            g = got.float().numpy()
            w = np.asarray(want.astype(jnp.float32))
            np.testing.assert_array_equal(g[0], orig[0].float().numpy())
            np.testing.assert_allclose(g[1], w[1], rtol=2 ** -8, atol=0)


def _prefilled(m, be, prompts, S):
    """(reference engine, its cache grown to S; port engine, the same cache
    carried across by the bridge) after the reference's batched prefill of
    ``prompts``: a verify is held against the reference's on equal
    caches (a lut prefill's K/V may already differ by an activation level
    at a rounding tie).  The reference engine has a spec config so that
    its jitted ``_verify`` exists."""
    from repro_torch.bridge import from_jax_params
    which = "dense" if be == "dense" else "index"
    je = m.Engine(m.model, m.params[which], max_len=S, backend=be,
                  spec=m.Spec(draft="ngram", k=3))
    te = TEngine(m.tmodel, m.tparams[which], max_len=S, backend=be,
                 device="cpu")
    toks, lens = je._pad_prompts(prompts)
    _, jc = je._prefill(je.params, toks, lens)
    jc = je._grow(jc)
    tc = from_jax_params({"kv": _np_cache(jc, keep_bf16=True),
                          "pos": np.asarray(jc["pos"])}, "cpu")
    return je, jc, te, tc


def _np_cache(c, keep_bf16=False):
    import jax.numpy as jnp
    return {k: np.asarray(v if keep_bf16 or v.dtype != jnp.bfloat16
                          else v.astype(jnp.float32))
            for k, v in c["kv"].items()}


@pytest.mark.parametrize("be", ["dense", "codebook", "lut"])
@pytest.mark.parametrize("cache", ["float", "int8"])
def test_verify_step_equals_reference(qwen, codeqwen, cache, be):
    """``verify_step`` on the cache of a prefill of three prompts, 4 tokens
    a slot: logits within 1e-3, every cache leaf within 1e-3 (float) or one
    code (int8 planes, counted; scales within a bf16 rounding), ``pos``
    unchanged on both sides."""
    m = qwen if cache == "float" else codeqwen
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]
    je, jc, te, tc = _prefilled(m, be, prompts, 32)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, m.cfg.vocab, (3, 4)).astype(np.int32)
    pos0 = tc["pos"].clone()
    jl, jc2 = je._verify(je.params, jc, m.jax.numpy.asarray(tokens))
    tl, tc2 = te.model.verify(te.params, torch.from_numpy(tokens).long(),
                              tc, te.bk)
    V = m.cfg.vocab
    np.testing.assert_allclose(tl[..., :V].numpy(),
                               np.asarray(jl)[..., :V], atol=ATOL, rtol=0)
    assert torch.equal(tc2["pos"], pos0)
    np.testing.assert_array_equal(np.asarray(jc2["pos"]), pos0.numpy())
    want = _np_cache(jc2)
    for name, leaf in tc2["kv"].items():
        got = leaf.float().numpy()
        d = np.abs(got - want[name])
        if cache == "float":
            assert d.max() <= ATOL, name
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want[name], rtol=2 ** -8, atol=0)
        else:
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (name, d.max())


@pytest.mark.parametrize("be", ["dense", "codebook", "lut"])
@pytest.mark.parametrize("cache", ["float", "int8"])
def test_verify_rows_equal_sequential_decode(qwen, codeqwen, cache, be):
    """Row i of a verify of K1 = 4 tokens against the (i + 1)-th of four
    sequential ``decode_step`` calls fed the same tokens, within 1e-3.  On
    the int8 cache only row 0: a decode step reads the earlier fresh tokens
    back quantized, while a verify attends to them in float (as the
    reference's), so rows i > 0 differ by the int8 rounding."""
    m = qwen if cache == "float" else codeqwen
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]
    _, _, te, tc = _prefilled(m, be, prompts, 32)
    dc = {"kv": {k: v.clone() for k, v in tc["kv"].items()},
          "pos": tc["pos"].clone()}
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, m.cfg.vocab, (3, 4)))
    vl, _ = te.model.verify(te.params, tokens, tc, te.bk)
    V = m.cfg.vocab
    rows = 4 if cache == "float" else 1
    for i in range(rows):
        dl, dc = te.model.decode(te.params, tokens[:, i:i + 1], dc, te.bk)
        np.testing.assert_allclose(vl[:, i, :V].numpy(), dl[:, 0, :V].numpy(),
                                   atol=ATOL, rtol=0)


# --- spec serve -------------------------------------------------------------------

SERVE_CASES = {
    "ngram-dense": ("qwen", "dense", dict(draft="ngram", k=3), STOPS),
    "ngram-codebook": ("qwen", "codebook", dict(draft="ngram", k=3), STOPS),
    "ngram-lut": ("qwen", "lut", dict(draft="ngram", k=3), STOPS),
    "lut_draft-codebook": ("qwen", "codebook",
                           dict(draft="model", k=3, draft_backend="lut",
                                lut_levels=512), STOPS),
    "dense_draft-dense": ("qwen", "dense",
                          dict(draft="model", k=3, draft_backend="dense"),
                          STOPS),
    "ngram-kv_quant-codebook": ("codeqwen", "codebook",
                                dict(draft="ngram", k=3), STOPS),
    "lut_draft-kv_quant-dense": ("codeqwen", "dense",
                                 dict(draft="model", k=2,
                                      draft_backend="lut"), STOPS),
    "ngram-point-lut": ("point", "lut", dict(draft="ngram", k=3),
                        [6, 3, 5, 1, 4, 2]),
    "stops_1": ("qwen", "codebook", dict(draft="ngram", k=3), 1),
    "stops_2": ("qwen", "codebook", dict(draft="ngram", k=4), 2),
    "stops_2-lut_draft": ("qwen", "dense",
                          dict(draft="model", k=4, draft_backend="lut"), 2),
}


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_spec_serve_equals_reference_and_baseline(request, case):
    """Six requests over two slots (two with repetitive prompts), greedy:
    the port's spec serve equals the reference's spec serve and the port's
    baseline serve token for token, and its four counters equal the
    reference's.  A model draft serves the target's own params (index
    form through its own backend, or dense)."""
    name, be, kw, stops = SERVE_CASES[case]
    m = request.getfixturevalue(name)
    which = "dense" if be == "dense" else "index"
    dwhich = "dense" if kw.get("draft_backend") == "dense" else "index"
    if kw["draft"] == "model":
        jkw = dict(kw, draft_params=m.params[dwhich])
        tkw = dict(kw, draft_params=m.tparams[dwhich])
    else:
        jkw = tkw = kw
    eng = dict(max_len=MAX_LEN, max_batch=2, backend=be)
    je = m.Engine(m.model, m.params[which], spec=m.Spec(**jkw), **eng)
    te = TEngine(m.tmodel, m.tparams[which], spec=TSpec(**tkw),
                 device="cpu", **eng)
    if name == "point":
        with m.jax.disable_jit():
            want = je.serve(PROMPTS, max_new=stops)
    else:
        want = je.serve(PROMPTS, max_new=stops)
    got = te.serve(PROMPTS, max_new=stops)
    assert got == want
    base = TEngine(m.tmodel, m.tparams[which], device="cpu", **eng)
    assert got == base.serve(PROMPTS, max_new=stops)
    assert _counts(te.spec_stats) == _counts(je.spec_stats)
    assert (te.spec_stats.rounds > 0) == (stops != 1)   # 1: done on arrival
    assert te.n_captures == te.n_replays == te.n_draft_replays == 0
    if kw["draft"] == "model":
        # a draft prefill per request, k + 1 draft steps a round
        assert te.n_draft_forwards == len(PROMPTS) + (
            kw["k"] + 1) * te.spec_stats.rounds
    else:
        assert te.n_draft_forwards == 0


def test_spec_serve_twice_and_counters_accumulate(qwen):
    """A second serve on one engine reuses its static state (zeroed), gives
    the same tokens, and doubles the counters."""
    e = TEngine(qwen.tmodel, qwen.tparams["index"], max_len=MAX_LEN,
                max_batch=2, backend="codebook", device="cpu",
                spec=TSpec(draft="ngram", k=3))
    first = e.serve(PROMPTS, max_new=STOPS)
    s1 = (e.spec_stats.rounds, e.spec_stats.proposed, e.spec_stats.accepted,
          e.spec_stats.emitted)
    assert e.serve(PROMPTS, max_new=STOPS) == first
    assert (e.spec_stats.rounds, e.spec_stats.proposed,
            e.spec_stats.accepted, e.spec_stats.emitted) == tuple(
        2 * v for v in s1)
    assert list(e._slot_sets) == [(2, False, "spec")]
    # generate is the baseline decode loop on its own state
    base = TEngine(qwen.tmodel, qwen.tparams["index"], max_len=MAX_LEN,
                   backend="codebook", device="cpu")
    assert e.generate(PROMPTS[:2], max_new=5) == base.generate(PROMPTS[:2],
                                                               max_new=5)


def test_model_draft_equal_to_target_accepts_everything(qwen):
    """Draft == target (dense): every proposal survives up to the stop
    clamp, so a round emits k + 1 tokens."""
    e = TEngine(qwen.tmodel, qwen.tparams["dense"], max_len=96, max_batch=2,
                device="cpu",
                spec=TSpec(draft="model", k=4,
                           draft_params=qwen.tparams["dense"],
                           draft_backend="dense"))
    e.serve(PROMPTS[:2], max_new=24)
    st = e.spec_stats
    assert st.acceptance_rate > 0.9 and st.tokens_per_round > 3.0


def test_draft_lut_grid_is_its_own(qwen, monkeypatch):
    """A lut draft (|A| 512) for a lut target (|A| 4096): two LutSpecs, two
    cached grid steps of different values, and each matmul of a serve runs
    under its model's spec — 7 × 2 a forward, draft prefills and steps
    under the draft's, target prefills and verifies under the target's."""
    calls, orig = [], dispatch.lut_acc

    def spy(x2, w_idx, codebook, spec, table=None):
        calls.append(spec)
        return orig(x2, w_idx, codebook, spec, table)
    monkeypatch.setattr(dispatch, "lut_acc", spy)
    e = TEngine(qwen.tmodel, qwen.tparams["index"], max_len=MAX_LEN,
                max_batch=2, backend="lut", device="cpu",
                spec=TSpec(draft="model", k=3,
                           draft_params=qwen.tparams["index"],
                           draft_backend="lut", lut_levels=512))
    e.serve(PROMPTS[:3], max_new=5)
    t_spec, d_spec = e.bk.lut_spec, e._draft_bk.lut_spec
    assert t_spec != d_spec and t_spec.levels == 4096 and d_spec.levels == 512
    dev = torch.device("cpu")
    gt, gd = dispatch._grid_step(t_spec, dev), dispatch._grid_step(d_spec, dev)
    assert gt is not gd and float(gt) != float(gd)
    assert calls.count(t_spec) == 7 * 2 * e.n_forwards
    assert calls.count(d_spec) == 7 * 2 * e.n_draft_forwards
    assert len(calls) == 7 * 2 * (e.n_forwards + e.n_draft_forwards)
    # the draft's tables are its own grid's, not the target's
    dt = e.spec.draft_params["blocks"]["mlp"]["w1"]["lut_table"]
    tt = e.params["blocks"]["mlp"]["w1"]["lut_table"]
    assert dt.shape[-2] == 512 and tt.shape[-2] == 4096


@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_sampling_seeded(qwen, draft):
    """Temperature 0.8, top-k 50, top-p 0.9: two engines of seed 7 give
    equal tokens, an engine of seed 8 others; every id in the vocabulary."""
    def serve(seed):
        kw = dict(draft="ngram", k=3) if draft == "ngram" else dict(
            draft="model", k=3, draft_params=qwen.tparams["index"],
            draft_backend="lut", lut_levels=512)
        e = TEngine(qwen.tmodel, qwen.tparams["index"], max_len=MAX_LEN,
                    max_batch=2, backend="codebook", temperature=0.8,
                    top_k=50, top_p=0.9, seed=seed, device="cpu",
                    spec=TSpec(**kw))
        return e.serve(PROMPTS, max_new=STOPS), e
    o1, e1 = serve(7)
    o2, _ = serve(7)
    o3, _ = serve(8)
    assert o1 == o2
    assert o1 != o3, "spec sampling ignored the seed"
    assert all(0 <= t < qwen.cfg.vocab for o in o1 for t in o)
    assert [len(o) - len(p) for o, p in zip(o1, PROMPTS)] == STOPS
    assert e1.spec_stats.rounds > 0


@pytest.mark.parametrize("filt", [dict(top_k=1), dict(top_p=1e-6)])
@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_top1_sampling_equals_greedy(qwen, draft, filt):
    """A filter that keeps only the top token collapses sampling to the
    argmax: spec at temperature 0.7 equals greedy baseline serve."""
    kw = dict(draft="ngram", k=3) if draft == "ngram" else dict(
        draft="model", k=3, draft_params=qwen.tparams["index"],
        draft_backend="lut", lut_levels=512)
    eng = dict(max_len=MAX_LEN, max_batch=2, backend="codebook",
               device="cpu")
    want = TEngine(qwen.tmodel, qwen.tparams["index"], **eng).serve(
        PROMPTS, max_new=STOPS)
    got = TEngine(qwen.tmodel, qwen.tparams["index"], temperature=0.7,
                  spec=TSpec(**kw), **filt, **eng).serve(PROMPTS,
                                                         max_new=STOPS)
    assert got == want


# --- guards -----------------------------------------------------------------------

def test_spec_config_validation(qwen):
    m, p = qwen.tmodel, qwen.tparams["dense"]
    kw = dict(device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        TEngine(m, p, spec=TSpec(draft="model"), **kw)
    with pytest.raises(ValueError, match="draft"):
        TEngine(m, p, spec=TSpec(draft="nope"), **kw)
    with pytest.raises(ValueError, match="spec.k"):
        TEngine(m, p, spec=TSpec(k=0), **kw)
    with pytest.raises(ValueError, match="top_p"):
        TEngine(m, p, top_p=0.0, **kw)
    with pytest.raises(ValueError, match="draft backend"):
        TEngine(m, p, spec=TSpec(draft="model", draft_params=p,
                                 draft_backend="int4"), **kw)
    with pytest.raises(ValueError, match="codebook-index draft_params"):
        TEngine(m, p, spec=TSpec(draft="model", draft_params=p,
                                 draft_backend="codebook"), **kw)
    e = TEngine(m, p, max_len=16, spec=TSpec(draft="ngram", k=4), **kw)
    with pytest.raises(ValueError, match="headroom"):
        e.serve([[1, 2, 3, 4]], max_new=10)       # 4 + 10 + 4 > 16


def test_paged_spec_is_accepted(qwen):
    """``paged=True`` with ``spec`` serves (``tests/test_torch_paged_spec.py``
    holds it against the reference), and ``verify_step`` takes a page pool:
    logits for every token, ``pos`` unchanged, the K1 tokens written into
    the slot's page."""
    e = TEngine(qwen.tmodel, qwen.tparams["dense"], paged=True, page_size=4,
                max_len=32, max_batch=2, device="cpu",
                spec=TSpec(draft="ngram", k=3))
    assert e.serve(PROMPTS[:2], max_new=4) == TEngine(
        qwen.tmodel, qwen.tparams["dense"], max_len=32, max_batch=2,
        device="cpu").serve(PROMPTS[:2], max_new=4)
    cache = {**qwen.tmodel.init_paged_cache(4, 4, torch.float32, "cpu"),
             "page_table": torch.tensor([[1, 2]], dtype=torch.int32),
             "pos": torch.tensor([2], dtype=torch.int32)}
    logits, out = TT.verify_step(qwen.tparams["dense"], qwen.tmodel.cfg,
                                 torch.tensor([[5, 6, 7, 8]]), cache)
    assert logits.shape[:2] == (1, 4) and out["pos"].tolist() == [2]
    written = cache["k"].abs().sum(dim=(0, 3, 4))       # (page, offset)
    assert (written[1, 2:] > 0).all() and (written[2, :2] > 0).all()
    assert written[1, :2].sum() == 0 and written[3].sum() == 0


# --- on the card -------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """qwen3-1.7b at full width, 2 of its layers, bf16, and codeqwen1.5-7b
    at full width, 2 layers, with its int8 contiguous cache; random weights
    from a seeded generator, compressed to |W| = 1000 (laplacian_l1,
    global)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph route runs only on the card")
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.serving import to_codebook_params
    dev = torch.device("cuda")

    def model(cfg):
        m = tbuild(cfg)
        params = m.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        wq = cfg.quantized(n_weights=1000).wq
        pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
        return m, to_codebook_params(pq, wq, state)
    return {"qwen": model(TCfg.get("qwen3-1.7b").replace(n_layers=2)),
            "codeqwen": model(TCfg.get("codeqwen1.5-7b").replace(
                n_layers=2))}


CARD_CASES = [("qwen", "codebook", "ngram", 0.0),
              ("qwen", "codebook", "lut", 0.0),
              ("qwen", "lut", "ngram", 0.0),
              ("codeqwen", "codebook", "ngram", 0.0),
              ("qwen", "codebook", "lut", 0.8),
              ("qwen", "codebook", "ngram", 0.8)]
CARD_PROMPTS = [[(7 * i + 3 * j) % 5000 + 11 for j in range(5 + 3 * i)]
                for i in range(4)] + [[101, 202, 303] * 5, [17] * 9]
CARD_MAX_NEW = [6, 1, 9, 4, 12, 7]


def _counts(s):
    return (s.rounds, s.proposed, s.accepted, s.emitted)


def _card_engine(card, name, be, draft, temperature):
    model, cp = card[name]
    sp = TSpec(draft="ngram", k=4) if draft == "ngram" else TSpec(
        draft="model", k=4, draft_params=cp, draft_backend=draft)
    return TEngine(model, cp, backend=be, max_len=128, max_batch=4,
                   temperature=temperature, top_k=40, seed=5, device="cuda",
                   spec=sp)


def _round_logits(e, st, graphs: bool):
    """Logits of one round of ``st`` on the chosen route from the same
    state (the engine's generator reseeded), the state put back after."""
    saved = {k: t.clone() for k, t in st.state().items()}
    e._graphs = graphs
    e._gen.manual_seed(e.seed)
    e._spec_step(st)
    logits = st.logits.clone()
    for k, t in st.state().items():
        t.copy_(saved[k])
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("name,be,draft,temp", CARD_CASES,
                         ids=[f"{n}-{b}-{d}-T{t}" for n, b, d, t in CARD_CASES])
def test_cuda_spec_graph_route_equals_eager(card, name, be, draft, temp):
    """One engine served in turns (eager, graph, graph, eager), its
    generator reseeded before each: tokens and counters equal, the second
    graph serve captures nothing; then one round on a state of its own,
    replayed against eager, logits bit for bit."""
    e = _card_engine(card, name, be, draft, temp)
    outs, stats = [], []
    for graphs in (False, True, True, False):
        e._graphs = graphs
        e._gen.manual_seed(e.seed)
        before = e.n_captures + e.n_draft_captures
        e.spec_stats.reset()
        outs.append(e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW))
        stats.append(_counts(e.spec_stats))
        if len(outs) == 3:
            assert e.n_captures + e.n_draft_captures == before
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert stats[0] == stats[1] == stats[2] == stats[3]
    assert e.n_replays > 0
    if draft != "ngram" and temp > 0:
        assert e.n_draft_replays > 0
    # one round from a state of its own: 4 live slots at 40 with a history
    st = e._new_spec_slots(4)
    st.cache["pos"].fill_(40)
    st.ctx[:, :41] = torch.arange(41, device=e.device) % 7 + 100
    st.ctx_len.fill_(41)
    st.last.fill_(100 + 40 % 7)
    if st.dcache is not None:
        st.dcache["pos"].fill_(40)
    st.active.fill_(True)
    st.stops.fill_(1 << 20)
    _round_logits(e, st, graphs=True)                     # the capture
    eager = _round_logits(e, st, graphs=False)
    graph = _round_logits(e, st, graphs=True)
    assert torch.equal(graph, eager)
    assert bool(torch.isfinite(eager[..., :e.model.cfg.vocab]).all())



@pytest.mark.cuda
def test_cuda_profiler_sees_kernels_after_spec_serve(card):
    """A spec serve on the graph route (temperature 0, lut draft: the
    round's graph holds the draft's k + 1 forwards and the verify), then
    three profiler sessions in a row, each around one eager decode step of
    a baseline engine: every session holds the step's kernels, the 7 × 2
    codebook matmuls by name.  Each session first launches 1024 one-cycle
    sleep kernels: the profiler drops a prefix of a session's device
    records, the more the longer the process has run, spec or not
    (``tools/profiler_after_spec.py``), and ``chip_smoke.py`` opens its
    sessions the same way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    model, cp = card["qwen"]
    e = _card_engine(card, "qwen", "codebook", "lut", 0.0)
    e._graphs = True
    e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW)
    assert e.n_replays > 0
    base = TEngine(model, cp, backend="codebook", max_len=128, max_batch=4,
                   device="cuda")
    base._graphs = False
    st = base._slots(4)
    st.active.fill_(True)
    st.stops.fill_(1 << 20)
    base._step(st)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(1024):
                torch.cuda._sleep(1)
            base._step(st)
            torch.cuda.synchronize()
        found = sum(ev.count for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA
                    and "StoreSum" in ev.key)
        assert found == 7 * model.cfg.n_layers
