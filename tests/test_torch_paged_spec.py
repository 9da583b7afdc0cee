"""Speculative decoding on the paged KV cache: the port's
``attention.attn_verify_paged``, ``transformer.verify_step`` on a page
pool and ``ServeEngine(paged=True, spec=...)`` against the JAX package's,
computed live in this process.

Models: qwen3-1.7b reduced to 2 layers in f32 (k-means |W| = 256, as
``test_torch_spec.py``), and the same model at the paper's working point
(``quantized(levels=32, n_weights=1000, method="kmeans")``, the reference
run op by op under ``jax.disable_jit``).  Params cross through the bridge;
inputs are seeded through numpy.

* ``attn_verify_paged``: the attention output within 1e-5 and the pages
  written equal to the reference's (int8 values and bf16 scales exactly,
  f32 K/V within 1e-5), for float and int8 pages, with K1 tokens that
  straddle a page boundary and an overshoot routed to the trash page;
* ``verify_step`` on a pool filled by the reference's own admissions:
  logits within 1e-3, pages within 1e-3 (float) or one int8 code
  (counted), ``pos`` unchanged, positions past the slot's pages (a trash
  row entry, and past the page table) routed to the trash page;
* greedy paged spec ``serve``: tokens, the four ``SpecStats`` counters,
  the pool's statistics, free list and prefix table equal to the
  reference's ``_serve_paged_spec``, and ``reserved_extra == 0``, for the
  n-gram draft on every backend, dense and lut model drafts, bf16 and
  int8 pages, the prefix cache off, a tight pool, stops 1, 2 and mixed,
  and the working point with int8 pages; tokens equal to the port's
  paged baseline serve and (float pages) its contiguous spec serve;
* the device ``ngram_propose`` proposes what ``ngram_propose_host`` does
  on every prefix of the served histories;
* temperature > 0: a seed gives equal tokens twice and another seed
  others; ``top_k = 1`` equals greedy.

The ``cuda`` tests need the card (``pytest -m cuda``): a paged round
replayed against the eager round at temperature 0, with the page table
edited in place between replays, and serves in turns at temperature 0.8.
JAX is imported only through fixtures: the card's machine has none.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import SpecConfig as TSpec  # noqa: E402
from repro_torch.serving import spec as TS  # noqa: E402
from test_torch_spec import (PROMPTS, STOPS, _counts,  # noqa: E402,F401
                             _reference_model, point, qwen)

torch.set_num_threads(2)

ATOL = 1e-3
PAGE = 4
MAX_LEN = 64
NGRAM3 = dict(draft="ngram", k=3)


def _bits(a):
    """Comparable integer view of a numpy/JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _torch_tree(tree):
    from repro_torch.bridge import from_jax_params
    return from_jax_params({k: np.asarray(v) for k, v in tree.items()},
                           "cpu")


# --- one layer ------------------------------------------------------------------

D, H, KV, HD, NP, NL = 32, 4, 2, 8, 7, 2


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_attn_verify_paged_matches(int8, layer):
    """Three slots, K1 = 4 tokens each: slot 0 at position 2 straddles the
    boundary of its pages 0 and 1; slot 1 at 5 overshoots its two pages
    (position 8 routed to the trash page, as the engine routes a row's
    trash entry); slot 2 at 0 fills one page.  The pool's other
    pages, and the other layer, keep their bytes."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.models import attention as JA
    from repro_torch.bridge import from_jax_params
    rng = np.random.default_rng(30 + layer + 2 * int8)
    jcfg = JA.AttnConfig(d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                         qk_norm=True)
    tcfg = TA.AttnConfig(d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                         qk_norm=True)
    p = JA.attn_init(jax.random.PRNGKey(layer), jcfg)
    tparams = from_jax_params(jax.tree_util.tree_map(np.asarray, p), "cpu")
    shape = (NL, NP, PAGE, KV, HD)
    if int8:
        jp = {"k": jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
              "v": jnp.asarray(rng.integers(-127, 128, shape), jnp.int8),
              "ks": jnp.asarray(rng.random(shape[:-1]) * 0.05,
                                jnp.bfloat16),
              "vs": jnp.asarray(rng.random(shape[:-1]) * 0.05,
                                jnp.bfloat16)}
    else:
        jp = {"k": jnp.asarray(rng.standard_normal(shape), jnp.float32),
              "v": jnp.asarray(rng.standard_normal(shape), jnp.float32)}
    tp = _torch_tree(jp)
    B, K1 = 3, 4
    x = rng.standard_normal((B, K1, D)).astype(np.float32)
    pt = np.array([[1, 2, 0], [3, 4, 0], [5, 0, 0]], np.int32)
    pos = np.array([2, 5, 0], np.int32)
    ppos = pos[:, None] + np.arange(K1)[None]
    pidx = ppos // PAGE
    wpid = np.where(pidx < pt.shape[1],
                    pt[np.arange(B)[:, None], np.minimum(pidx, 2)], 0)
    woff = ppos % PAGE
    assert wpid.tolist() == [[1, 1, 2, 2], [4, 4, 4, 0], [5, 5, 5, 5]]
    js = (jp["ks"], jp["vs"]) if int8 else None
    out_j, k_j, v_j, sc_j = JA.attn_verify_paged(
        p, jnp.asarray(x), jcfg, pos=jnp.asarray(ppos),
        page_table=jnp.asarray(pt), write_pid=jnp.asarray(wpid),
        write_off=jnp.asarray(woff), valid_len=jnp.asarray(pos),
        k_pool=jp["k"], v_pool=jp["v"], layer=layer, scales=js)
    ts = (tp["ks"], tp["vs"]) if int8 else None
    out_t = TA.attn_verify_paged(
        tparams, torch.from_numpy(x), tcfg, pos=torch.from_numpy(ppos),
        page_table=torch.from_numpy(pt), write_pid=torch.from_numpy(wpid),
        write_off=torch.from_numpy(woff), valid_len=torch.from_numpy(pos),
        k_pool=tp["k"], v_pool=tp["v"], layer=layer, scales=ts)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    got = {"k": tp["k"], "v": tp["v"]}
    want = {"k": k_j, "v": v_j}
    if int8:
        got.update(ks=tp["ks"], vs=tp["vs"])
        want.update(ks=sc_j[0], vs=sc_j[1])
    for name, w in want.items():
        g, w = got[name], np.asarray(w)
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w))
        before = _bits(jp[name])
        np.testing.assert_array_equal(_bits(g)[1 - layer], before[1 - layer])
        # pages 6 (nobody's) and the trash page's untouched offset 3
        np.testing.assert_array_equal(_bits(g)[layer, 6], before[layer, 6])
        np.testing.assert_array_equal(_bits(g)[layer, 0, 3],
                                      before[layer, 0, 3])


# --- the model's verify step ------------------------------------------------------

def _specs(m, spec_kw):
    """(the reference's SpecConfig, the port's) for ``spec_kw``: a model
    draft serves the target's own params (dense, or index form through
    its own backend)."""
    jkw = tkw = spec_kw
    if spec_kw.get("draft") == "model":
        dwhich = "dense" if spec_kw["draft_backend"] == "dense" else "index"
        jkw = dict(spec_kw, draft_params=m.params[dwhich])
        tkw = dict(spec_kw, draft_params=m.tparams[dwhich])
    return m.Spec(**jkw), TSpec(**tkw)


def _paged_pair(m, be, kv, spec_kw=None, **kw):
    """The reference's and the port's paged engines of one shape; with
    ``spec_kw`` None the port's has no spec and the reference's the n-gram
    draft (so that its jitted ``_verify`` exists)."""
    which = "dense" if be == "dense" else "index"
    kw = {**dict(max_len=MAX_LEN, max_batch=2, backend=be, paged=True,
                 page_size=PAGE, kv_dtype=kv), **kw}
    jsp, tsp = _specs(m, spec_kw or NGRAM3)
    je = m.Engine(m.model, m.params[which], spec=jsp, **kw)
    te = TEngine(m.tmodel, m.tparams[which], device="cpu",
                 spec=None if spec_kw is None else tsp, **kw)
    return je, te


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("be", ["dense", "codebook", "lut"])
def test_verify_step_paged_equals_reference(qwen, be, kv):
    """max_len 16, page 4 (4 pages a slot), three requests admitted by the
    reference: at 3 (K1 = 4 tokens across pages 0 and 1), at 7 with two
    pages (positions 8..10 on the row's trash entries) and at 14 with
    four (positions 16, 17 past the page table).  Logits within 1e-3; the
    pool's pages, the trash page aside, within 1e-3 or one int8 code
    (counted); ``pos`` unchanged."""
    import jax.numpy as jnp
    je, te = _paged_pair(qwen, be, kv, max_len=16, max_batch=3)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], list(range(20, 34))]
    stops = [8, 2, 2]
    key = qwen.jax.random.PRNGKey(0)
    P = je.pool.pages_per_slot
    pt = np.zeros((3, P), np.int32)
    for b, (p, s) in enumerate(zip(prompts, stops)):
        adm, _, key = je._paged_admit(p, s, key)
        pt[b, :len(adm.pids)] = adm.pids
    assert (pt != 0).sum(1).tolist() == [3, 2, 4]
    pos = np.array([len(p) for p in prompts], np.int32)
    tokens = np.random.default_rng(7).integers(0, qwen.cfg.vocab, (3, 4))
    before = {k: np.asarray(v) for k, v in je.pool.cache.items()}
    before_t = _torch_tree(before)
    tc = {**_torch_tree(before), "page_table": torch.from_numpy(pt),
          "pos": torch.from_numpy(pos)}
    jl, jc = je._verify(je.params, {**je.pool.cache,
                                    "page_table": jnp.asarray(pt),
                                    "pos": jnp.asarray(pos)},
                        jnp.asarray(tokens, jnp.int32))
    tl, tc2 = te.model.verify(te.params, torch.from_numpy(tokens), tc,
                              te.bk)
    V = qwen.cfg.vocab
    np.testing.assert_allclose(tl[..., :V].numpy(), np.asarray(jl)[..., :V],
                               atol=ATOL, rtol=0)
    assert tc2["pos"].tolist() == pos.tolist()
    assert np.asarray(jc["pos"]).tolist() == pos.tolist()
    for name in before:
        got = tc2[name][:, 1:]
        want = np.asarray(jc[name])[:, 1:]
        if name.endswith("scale"):
            np.testing.assert_array_equal(_bits(got), _bits(want))
        elif got.dtype == torch.int8:
            d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (name, d.max())
        else:
            assert np.abs(got.numpy() - want).max() <= ATOL, name
        # where the writes landed: slot 0's positions 3..6 on its pages 0
        # and 1, not its page 2; slot 1's 7 on its page 1; slot 2's 14, 15
        # on its page 3; nothing on the pages of nobody
        changed = np.any(_bits(tc2[name]) != _bits(before_t[name]),
                         axis=tuple(range(2, before[name].ndim)))
        for b, c in ((0, 0), (0, 1), (1, 1), (2, 3)):
            assert changed[:, pt[b, c]].all(), (name, b, c)
        owned = set(pt.ravel().tolist())
        idle = [q for q in range(1, je.pool.n_pages)
                if q not in owned] + [pt[0, 2]]
        assert not changed[:, idle].any(), name


# --- paged spec serve -------------------------------------------------------------

CASES = {
    "ngram-dense-bf16": ("qwen", "dense", "bf16", NGRAM3, STOPS, {}),
    "ngram-dense-int8": ("qwen", "dense", "int8", NGRAM3, STOPS, {}),
    "ngram-codebook-bf16": ("qwen", "codebook", "bf16", NGRAM3, STOPS, {}),
    "ngram-codebook-int8": ("qwen", "codebook", "int8", NGRAM3, STOPS, {}),
    "ngram-lut-bf16": ("qwen", "lut", "bf16", NGRAM3, STOPS, {}),
    "ngram-lut-int8": ("qwen", "lut", "int8", NGRAM3, STOPS, {}),
    "lut_draft-codebook-bf16": ("qwen", "codebook", "bf16",
                                dict(draft="model", k=3, draft_backend="lut",
                                     lut_levels=512), STOPS, {}),
    "lut_draft-lut-int8": ("qwen", "lut", "int8",
                           dict(draft="model", k=2, draft_backend="lut",
                                lut_levels=512), STOPS, {}),
    "dense_draft-dense-int8": ("qwen", "dense", "int8",
                               dict(draft="model", k=3,
                                    draft_backend="dense"), STOPS, {}),
    "no_prefix-codebook-int8": ("qwen", "codebook", "int8", NGRAM3, STOPS,
                                dict(prefix_cache=False)),
    "tight-dense-bf16": ("qwen", "dense", "bf16", NGRAM3, STOPS,
                         dict(n_pages=7, max_batch=3)),
    "tight-lut_draft-codebook-int8": ("qwen", "codebook", "int8",
                                      dict(draft="model", k=3,
                                           draft_backend="lut",
                                           lut_levels=512), STOPS,
                                      dict(n_pages=7, max_batch=3)),
    "stops_1": ("qwen", "codebook", "bf16", NGRAM3, 1, {}),
    "stops_2": ("qwen", "codebook", "int8", dict(draft="ngram", k=4), 2, {}),
    "stops_2-lut_draft": ("qwen", "dense", "bf16",
                          dict(draft="model", k=4, draft_backend="lut"), 2,
                          {}),
    "point-codebook-int8": ("point", "codebook", "int8", NGRAM3,
                            [6, 3, 5, 1, 4, 2], {}),
}


def _pool_state(pool):
    return (dataclasses.asdict(pool.stats), list(pool.free),
            list(pool.table.items()), pool.reserved_extra)


@pytest.mark.parametrize("case", list(CASES))
def test_paged_spec_serve_equals_reference(request, case):
    """Six requests over two slots (three on the tight pool of 6 pages,
    where admission waits on pages), page 4, greedy, served twice (the
    second hits the prefix cache): the port's tokens, counters and pool
    (statistics, free list, prefix table, ``reserved_extra == 0``) equal
    the reference's after each serve; the tokens equal the port's paged
    baseline of the same pages and, on float pages, its contiguous spec
    serve."""
    name, be, kv, skw, stops, kw = CASES[case]
    m = request.getfixturevalue(name)
    je, te = _paged_pair(m, be, kv, skw, **kw)
    for _ in range(2):
        if name == "point":
            with m.jax.disable_jit():
                want = je.serve(PROMPTS, max_new=stops)
        else:
            want = je.serve(PROMPTS, max_new=stops)
        got = te.serve(PROMPTS, max_new=stops)
        assert got == want
        assert _counts(te.spec_stats) == _counts(je.spec_stats)
        assert _pool_state(te.pool) == _pool_state(je.pool)
        assert te.pool.reserved_extra == 0
    assert (te.spec_stats.rounds > 0) == (stops != 1)
    assert te.n_captures == te.n_replays == 0
    assert list(te._slot_sets) == [(te.max_batch, True, "spec")]
    which = "dense" if be == "dense" else "index"
    ekw = dict(max_len=MAX_LEN, max_batch=kw.get("max_batch", 2),
               backend=be, device="cpu")
    base = TEngine(m.tmodel, m.tparams[which], paged=True, page_size=PAGE,
                   kv_dtype=kv, **{**kw, **ekw})
    assert got == base.serve(PROMPTS, max_new=stops)
    if kv == "bf16":
        contig = TEngine(m.tmodel, m.tparams[which], spec=_specs(m, skw)[1],
                         **ekw)
        assert got == contig.serve(PROMPTS, max_new=stops)


def test_paged_spec_admission_fit_checks(qwen):
    """A request whose pages can never fit the pool raises, as the
    reference's; ``max_len`` must hold the k rows of speculative
    headroom."""
    _, te = _paged_pair(qwen, "dense", "bf16", NGRAM3, n_pages=4)
    with pytest.raises(ValueError, match="never fit"):
        te.serve([[1] * 13], max_new=4)
    with pytest.raises(ValueError, match="headroom"):
        te.serve([[1] * 50], max_new=12)


def test_ngram_device_equals_host_on_served_histories(qwen):
    """The histories a paged spec serve produced: at every prefix from the
    prompt's end on, the device ``ngram_propose`` (what the round's graph
    runs) proposes what ``ngram_propose_host`` (the reference's paged
    path's draft) does, in both packages."""
    from repro.serving import spec as JS
    _, te = _paged_pair(qwen, "codebook", "int8", dict(draft="ngram", k=4))
    hists = te.serve(PROMPTS, max_new=[12, 9, 14, 6, 16, 10])
    ctxs, lens = [], []
    for h, p in zip(hists, PROMPTS):
        for L in range(len(p), len(h) + 1):
            row = np.zeros((MAX_LEN,), np.int64)
            row[:L] = h[:L]
            ctxs.append(row)
            lens.append(L)
    for n in (1, 2, 3):
        dev = TS.ngram_propose(torch.from_numpy(np.stack(ctxs)),
                               torch.tensor(lens), k=4, n=n)
        for row, L, got in zip(ctxs, lens, dev.tolist()):
            hist = row[:L].tolist()
            assert got == TS.ngram_propose_host(hist, k=4, n=n) \
                == JS.ngram_propose_host(hist, k=4, n=n)


@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_paged_spec_sampling_seeded(qwen, draft):
    """Temperature 0.8, top-k 50, top-p 0.9 on int8 pages: two engines of
    seed 7 give equal tokens, an engine of seed 8 others; the pool is
    clean after each serve."""
    def serve(seed):
        kw = NGRAM3 if draft == "ngram" else dict(
            draft="model", k=3, draft_params=qwen.tparams["index"],
            draft_backend="lut", lut_levels=512)
        e = TEngine(qwen.tmodel, qwen.tparams["index"], max_len=MAX_LEN,
                    max_batch=2, backend="codebook", temperature=0.8,
                    top_k=50, top_p=0.9, seed=seed, paged=True,
                    page_size=PAGE, kv_dtype="int8", device="cpu",
                    spec=TSpec(**kw))
        out = e.serve(PROMPTS, max_new=STOPS)
        assert e.pool.reserved_extra == 0
        assert all(int(e.pool.ref[p]) == (1 if p in e.pool.key_of else 0)
                   for p in range(e.pool.n_pages))
        return out, e
    o1, e1 = serve(7)
    o2, _ = serve(7)
    o3, _ = serve(8)
    assert o1 == o2
    assert o1 != o3, "paged spec sampling ignored the seed"
    assert [len(o) - len(p) for o, p in zip(o1, PROMPTS)] == STOPS
    assert e1.spec_stats.rounds > 0


@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_paged_top1_sampling_equals_greedy(qwen, draft):
    kw = NGRAM3 if draft == "ngram" else dict(
        draft="model", k=3, draft_params=qwen.tparams["index"],
        draft_backend="lut", lut_levels=512)
    eng = dict(max_len=MAX_LEN, max_batch=2, backend="codebook",
               paged=True, page_size=PAGE, device="cpu")
    want = TEngine(qwen.tmodel, qwen.tparams["index"], **eng).serve(
        PROMPTS, max_new=STOPS)
    got = TEngine(qwen.tmodel, qwen.tparams["index"], temperature=0.7,
                  top_k=1, spec=TSpec(**kw), **eng).serve(PROMPTS,
                                                         max_new=STOPS)
    assert got == want


# --- on the card -------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """qwen3-1.7b at full width, 2 of its layers, bf16, random weights from
    a seeded generator, compressed to |W| = 1000 (laplacian_l1,
    global)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph route runs only on the card")
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.serving import to_codebook_params
    dev = torch.device("cuda")
    m = tbuild(TCfg.get("qwen3-1.7b").replace(n_layers=2))
    params = m.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    wq = m.cfg.quantized(n_weights=1000).wq
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    return SimpleNamespace(model=m, cp=to_codebook_params(pq, wq, state))


CARD_PROMPTS = [[(7 * i + 3 * j) % 5000 + 11 for j in range(5 + 3 * i)]
                for i in range(4)] + [[101, 202, 303] * 5, [17] * 9]
CARD_MAX_NEW = [6, 1, 9, 4, 12, 7]


def _card_engine(card, draft, temperature, kv):
    sp = TSpec(draft="ngram", k=4) if draft == "ngram" else TSpec(
        draft="model", k=4, draft_params=card.cp, draft_backend=draft)
    return TEngine(card.model, card.cp, backend="codebook", max_len=128,
                   max_batch=4, temperature=temperature, top_k=40, seed=5,
                   paged=True, page_size=16, kv_dtype=kv, device="cuda",
                   spec=sp)


def _turns(e):
    """Serves in turns (eager, graph, graph, eager), the generator
    reseeded before each: tokens, counters and the pool equal, the second
    graph serve capturing nothing."""
    outs = []
    for i, graphs in enumerate((False, True, True, False)):
        e._graphs = graphs
        e._gen.manual_seed(e.seed)
        before = e.n_captures + e.n_draft_captures
        e.spec_stats.reset()
        toks = e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW)
        outs.append((toks, _counts(e.spec_stats), e.pool.reserved_extra,
                     len(e.pool.free)))
        if i == 2:
            assert e.n_captures + e.n_draft_captures == before
    assert outs[0] == outs[1] == outs[2] == outs[3]
    assert outs[0][2] == 0
    assert e.n_replays > 0


def _round(e, st, graphs: bool):
    """One round of ``st`` on the chosen route, the state put back after
    (the pool's writes land above every slot's valid length)."""
    saved = {k: t.clone() for k, t in st.state().items()}
    e._graphs = graphs
    e._gen.manual_seed(e.seed)
    e._spec_step(st)
    logits = st.logits.clone()
    for k, t in st.state().items():
        t.copy_(saved[k])
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_cuda_paged_round_graph_equals_eager(card, draft):
    """Temperature 0, int8 pages: serves in turns equal; then a round on a
    state of its own (4 slots at 40 on random pages, each owning its 8
    pages) replayed against eager bit for bit; then the page table
    rewritten in place (each slot given the next slot's pages) and the
    replay against eager again: equal, and other logits than before, so
    the replay read the edited table."""
    e = _card_engine(card, draft, 0.0, "int8")
    _turns(e)
    st = e._new_spec_slots(4, paged=True)
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, plane in e.pool.cache.items():
        if plane.dtype == torch.int8:
            plane.copy_(torch.randint(-127, 128, plane.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
        else:
            plane.copy_(torch.rand(plane.shape, generator=g, device="cuda")
                        * 0.02)
    pt = st.cache["page_table"]
    P = pt.shape[1]
    pt.copy_(1 + torch.arange(4 * P, device="cuda",
                              dtype=torch.int32).reshape(4, P))
    st.cache["pos"].fill_(40)
    st.ctx[:, :41] = torch.arange(41, device="cuda") % 7 + 100
    st.ctx_len.fill_(41)
    st.last.fill_(100 + 40 % 7)
    if st.dcache is not None:
        st.dcache["pos"].fill_(40)
    st.active.fill_(True)
    st.stops.fill_(1 << 20)
    _round(e, st, graphs=True)                         # the capture
    eager = _round(e, st, graphs=False)
    assert torch.equal(_round(e, st, graphs=True), eager)
    pt.copy_(torch.roll(pt.clone(), 1, dims=0))
    eager2 = _round(e, st, graphs=False)
    assert torch.equal(_round(e, st, graphs=True), eager2)
    assert not torch.equal(eager2, eager)
    assert bool(torch.isfinite(eager2[..., :e.model.cfg.vocab]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["ngram", "lut"])
def test_cuda_paged_spec_sampling_graph_equals_eager(card, draft):
    """Temperature 0.8, bf16 pages: serves in turns (the draft step and
    the verify forward replays, sampling eager) give equal tokens,
    counters and pool."""
    e = _card_engine(card, draft, 0.8, "bf16")
    _turns(e)
    if draft != "ngram":
        assert e.n_draft_replays > 0
