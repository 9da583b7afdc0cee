"""The decode loop as static device state, one step a token: the port's
counterpart of the reference's jitted ``_loop_fn`` (``ServeEngine``'s
``_Slots``, ``_step`` and ``_decode_loop``).

On the CPU the step runs eagerly on its static buffers, and greedy tokens
must equal the JAX engine's, computed live in this process, on the reduced
qwen3 of ``test_torch_engine.py`` (2 layers, f32, k-means |W| = 256) with
the contiguous float cache and int8 pages (held against the reference's own
paged int8 run, as ``test_torch_paged.py`` does), and on the reduced
codeqwen1.5-7b of ``test_torch_kvquant.py`` with its int8 contiguous cache
(``kv_quant``), for dense, codebook and lut: a stop of 1 on arrival, mixed
stops with slots reused after harvest, a loop that reaches its cap, retired
paged slots writing the trash page, two ``generate`` calls at one batch size
and one at another.  At temperature > 0 two engines of one seed give equal
tokens.  Also the two repairs the graph route needs: ``dispatch.lut_acc``'s
cached grid step (accumulators bit-equal to a fresh constant's) and
``_common.scratch`` keeping every buffer it has handed out.

The ``cuda`` tests need the card (``pytest -m cuda``): the graph route
against the eager route (one step's logits bit-equal, tokens equal over a
serve and a generate, a second call at the same shape captures nothing),
and the lut scratch-growth sequence.  JAX is imported only through a
fixture: the card's machine has none.
"""

import gc
import weakref
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.kernels import _common, dispatch, ops  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402

torch.set_num_threads(2)

BACKENDS = ("dense", "codebook", "lut")
CACHES = ("float", "kv_quant", "int8_pages")
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12, [300, 2, 5, 7, 1],
           [7, 7, 8]]
MAX_NEW = [6, 1, 5, 7, 4, 3]        # a stop of 1 arrives done
MAX_LEN = 64


@pytest.fixture(scope="module")
def ref():
    """The JAX package's engine and the two reduced models, their params
    carried to the port through the bridge."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.core.quantizer import (WeightQuantConfig, cluster_params,
                                      init_state)
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, to_codebook_params
    from repro_torch.bridge import from_jax_params

    def model(name, **kw):
        cfg = C.get(name).reduced().replace(**kw)
        m = build(cfg)
        params = m.init(jax.random.PRNGKey(0))
        wq = WeightQuantConfig(num_weights=256, method="kmeans")
        pq, state = cluster_params(params, wq, init_state(wq), 1000,
                                   jax.random.PRNGKey(1))
        cp = to_codebook_params(pq, wq, state, min_size=1024)
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        return SimpleNamespace(
            model=m, tmodel=tbuild(TCfg.get(name).reduced().replace(**kw)),
            params={"dense": params, "index": cp},
            tparams={"dense": from_jax_params(np_tree(params), "cpu"),
                     "index": from_jax_params(np_tree(cp), "cpu")})

    return SimpleNamespace(
        jax=jax, Engine=ServeEngine,
        qwen=model("qwen3-1.7b", n_layers=2, dtype="float32"),
        codeqwen=model("codeqwen1.5-7b"))


def _pair(ref, be, cache, **kw):
    """(reference engine, port engine) for ``cache`` in CACHES."""
    m = ref.codeqwen if cache == "kv_quant" else ref.qwen
    assert m.tmodel.cfg.kv_quant == (cache == "kv_quant")
    if cache == "int8_pages":
        kw = dict(paged=True, page_size=4, kv_dtype="int8", **kw)
    kw = dict(max_len=MAX_LEN, backend=be, **kw)
    which = "dense" if be == "dense" else "index"
    return (ref.Engine(m.model, m.params[which], **kw),
            TEngine(m.tmodel, m.tparams[which], device="cpu", **kw))


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("be", BACKENDS)
def test_serve_mixed_stops_equal_reference(ref, be, cache):
    """Six requests over two slots, stops 1 to 7: a stop of 1 is done on
    arrival, slots are harvested and reused; the CPU takes no graph."""
    je, te = _pair(ref, be, cache, max_batch=2)
    got = te.serve(PROMPTS, max_new=MAX_NEW)
    assert got == je.serve(PROMPTS, max_new=MAX_NEW)
    assert [len(g) - len(p) for g, p in zip(got, PROMPTS)] == MAX_NEW
    assert te.n_captures == te.n_replays == 0
    assert te.serve(PROMPTS[:2], max_new=1) == je.serve(PROMPTS[:2],
                                                        max_new=1)


@pytest.mark.parametrize("cache", ("float", "kv_quant"))
@pytest.mark.parametrize("be", BACKENDS)
def test_generate_twice_and_at_another_batch(ref, be, cache):
    """Two ``generate`` calls at batch 2 reuse one static state; a third at
    batch 3 gets its own.  Each call's tokens equal the reference's."""
    je, te = _pair(ref, be, cache)
    for prompts in (PROMPTS[:2], PROMPTS[2:4], PROMPTS[3:]):
        assert te.generate(prompts, max_new=5) == je.generate(prompts,
                                                              max_new=5)
    assert sorted(te._slot_sets) == [(2, False), (3, False)]


@pytest.mark.parametrize("be", BACKENDS)
def test_loop_exits_at_cap(ref, be):
    """Stops beyond the cap: the loop stops after ``cap`` steps, and the
    out buffer's last column takes every later token, as the reference's
    buffer of width ``cap`` does; last, active and counts equal its."""
    jnp = ref.jax.numpy
    je, te = _pair(ref, be, "float")
    cap, stops = 4, [10, 3]
    toks, lens = je._pad_prompts(PROMPTS[:2])
    jl, jc = je._prefill(je.params, toks, lens)
    jfirst = jnp.argmax(jl[:, -1, :je.model.cfg.vocab], -1).astype(jnp.int32)
    out = jnp.zeros((2, cap), jnp.int32).at[:, 0].set(jfirst)
    _, jlast, jactive, jn, jout, _ = je._decode_loop(
        je.params, je._grow(jc), jfirst, jnp.ones((2,), bool),
        jnp.ones((2,), jnp.int32), jnp.asarray(stops, jnp.int32), out,
        ref.jax.random.PRNGKey(0), stop_on_event=False)

    tt, tl = te._pad_prompts(PROMPTS[:2])
    logits, cache = te._prefill(tt, tl)
    te._grow(cache)
    st = te._slots(2)
    st.start(te._sample(logits), stops)
    te._decode_loop(st, cap, stop_on_event=False)
    assert te.n_forwards == 1 + cap
    np.testing.assert_array_equal(st.out[:, :cap].numpy(), np.asarray(jout))
    assert not st.out[:, cap:].any()
    np.testing.assert_array_equal(st.last.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(st.active.numpy(), np.asarray(jactive))
    np.testing.assert_array_equal(st.n_gen.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(st.h_n_gen, np.asarray(jn))


@pytest.mark.parametrize("be", BACKENDS)
def test_retired_paged_slots_write_the_trash_page(ref, be):
    """Stops 2 and 9 in two slots: the first retires after one step and,
    with the queue empty, decodes on into the trash page while the other
    runs to its stop.  Tokens equal the reference's, and every page but the
    trash page holds the reference's bytes (int8 values and bf16 scales)."""
    je, te = _pair(ref, be, "int8_pages", max_batch=2)
    reqs, stops = [PROMPTS[1], PROMPTS[3]], [2, 9]
    assert te.serve(reqs, max_new=stops) == je.serve(reqs, max_new=stops)
    for name, arr in te.pool.cache.items():
        got = arr[:, 1:]
        want = np.asarray(je.pool.cache[name])[:, 1:]
        if got.dtype == torch.bfloat16:
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)
    assert bool(te.pool.cache["k"][:, 0].any())
    assert not te._slot_sets[2, True].cache["page_table"].any()


@pytest.mark.parametrize("cache", ("float", "int8_pages"))
def test_sampling_one_seed_equal_tokens(ref, cache):
    """Temperature 0.8, top-k 5: two engines of one seed give equal tokens
    through serve and generate, every one inside the vocabulary."""
    m = ref.qwen
    kw = dict(paged=True, page_size=4, kv_dtype="int8") \
        if cache == "int8_pages" else {}
    engines = [TEngine(m.tmodel, m.tparams["index"], backend="codebook",
                       max_len=MAX_LEN, max_batch=2, temperature=0.8,
                       top_k=5, seed=3, device="cpu", **kw)
               for _ in range(2)]
    got = [(e.serve(PROMPTS, max_new=MAX_NEW),
            e.generate(PROMPTS[:3], max_new=6)) for e in engines]
    assert got[0] == got[1]
    vocab = engines[0].model.cfg.vocab
    assert all(0 <= t < vocab for seqs in got[0] for s in seqs for t in s)


def test_lut_acc_grid_step_is_cached_and_bit_equal(ref, monkeypatch):
    """``lut_acc`` takes Δa from a tensor made once per spec and device; on
    the reduced lut engine's own inputs its accumulators equal those of the
    constant made afresh each call, bit for bit."""
    calls, orig = [], dispatch.lut_acc

    def spy(x2, w_idx, codebook, spec, table=None):
        calls.append((x2, w_idx, codebook, spec, table))
        return orig(x2, w_idx, codebook, spec, table)
    monkeypatch.setattr(dispatch, "lut_acc", spy)
    te = _pair(ref, "lut", "float", max_batch=2)[1]
    te.serve(PROMPTS[:3], max_new=4)
    assert len(calls) == 7 * 2 * te.n_forwards
    for x2, w_idx, book, spec, table in calls[::5]:
        da = torch.tensor(spec.da, dtype=torch.float32)
        a_idx = torch.clamp(torch.round((x2.float() - spec.a_min) / da), 0,
                            spec.levels - 1).to(torch.int32)
        want = ops.lut_matmul(a_idx, w_idx.contiguous(), table.contiguous())
        assert torch.equal(orig(x2, w_idx, book, spec, table), want)
    spec, dev = calls[0][3], calls[0][0].device
    assert dispatch._grid_step(spec, dev) is dispatch._grid_step(spec, dev)


def test_scratch_keeps_an_outgrown_buffer():
    """A buffer handed out stays allocated, and zeroed, after a larger
    request replaces it: a captured graph holds its address."""
    dev = torch.device("cpu")
    small = _common.scratch("test.outgrown", dev, 2000, torch.int32)
    ptr, ref_small = small.data_ptr(), weakref.ref(small)
    del small
    big = _common.scratch("test.outgrown", dev, 10 ** 5, torch.int32)
    gc.collect()
    kept = ref_small()
    assert kept is not None and kept.data_ptr() == ptr
    assert big.numel() >= 10 ** 5 and big.data_ptr() != ptr
    assert not kept.any() and not big.any()
    assert _common.scratch("test.outgrown", dev, 10, torch.int32) is big


# --- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """qwen3-1.7b at full width, 2 of its layers, bf16, and the same at
    the working point (|A| = 32), compressed to |W| = 1000 (laplacian_l1,
    global); codeqwen1.5-7b at full width, 2 layers, with its int8
    contiguous cache.  Random weights from a seeded generator."""
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
    qwen = TCfg.get("qwen3-1.7b").replace(n_layers=2)
    return {"qwen": model(qwen),
            "point": model(qwen.replace(act_levels=32)),
            "codeqwen": model(TCfg.get("codeqwen1.5-7b").replace(n_layers=2))}


CARD_CASES = [("qwen", be, {}) for be in BACKENDS] + [
    ("qwen", be, dict(paged=True, kv_dtype="int8")) for be in BACKENDS] + [
    ("qwen", "codebook", dict(paged=True, kv_dtype="bf16"))] + [
    ("point", be, {}) for be in BACKENDS] + [
    ("codeqwen", be, {}) for be in BACKENDS]
CARD_PROMPTS = [[(7 * i + 3 * j) % 5000 + 11 for j in range(5 + 3 * i)]
                for i in range(6)]
CARD_MAX_NEW = [6, 1, 9, 4, 7, 5]


def _step_state(e, pos: int):
    """A loop state of its own for engine ``e``: four live slots at
    ``pos`` on a zeroed cache, each slot's pages its own on the paged
    path (the trash page, which retired slots share, takes no write)."""
    from repro_torch.serving.engine import _Slots
    if e.paged:
        pps = e.max_len // e.page_size
        dtype = torch.int8 if e.kv_dtype == "int8" else e._cache_dtype
        cache = {**e.model.init_paged_cache(1 + 4 * pps, e.page_size, dtype,
                                            device=e.device),
                 "page_table": torch.arange(1, 1 + 4 * pps, dtype=torch.int32,
                                            device=e.device).reshape(4, pps)}
        cache["pos"] = torch.full((4,), pos, dtype=torch.int32,
                                  device=e.device)
    else:
        cache = e.model.init_cache(4, e.max_len, dtype=e._cache_dtype,
                                   device=e.device)
        cache["pos"].fill_(pos)
    st = _Slots(cache, e.max_len)
    st.active.fill_(True)
    st.stops.fill_(1 << 30)
    return st


def _one_step_logits(e, st, graphs: bool):
    """Logits of one step of ``st`` on the chosen route, the state put back
    as it was (the step rewrites the K/V at the same positions with the
    same values)."""
    saved = {k: t.clone() for k, t in st.state().items()}
    e._graphs = graphs
    e._step(st)
    logits = st.logits.clone()
    for k, t in st.state().items():
        t.copy_(saved[k])
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("name,be,kw", CARD_CASES,
                         ids=[f"{n}-{b}-{k.get('kv_dtype', 'contig')}"
                              for n, b, k in CARD_CASES])
def test_cuda_graph_route_equals_eager(card, name, be, kw):
    """Graph route against eager route on one engine: tokens over a serve
    and a generate equal; one replayed step's logits equal the eager
    step's bit for bit; a second serve and generate capture nothing."""
    model, cp = card[name]
    e = TEngine(model, cp, backend=be, max_len=128, max_batch=4,
                page_size=16, device="cuda", **kw)
    assert e._graphs
    e._graphs = False
    want = (e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW),
            e.generate(CARD_PROMPTS[:3], max_new=6))
    assert e.n_captures == 0
    e._graphs = True
    got = (e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW),
           e.generate(CARD_PROMPTS[:3], max_new=6))
    assert got == want
    captured = e.n_captures
    assert captured == 2 and e.n_replays > 0
    assert (e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW),
            e.generate(CARD_PROMPTS[:3], max_new=6)) == want
    assert e.n_captures == captured
    st = _step_state(e, pos=40)
    _one_step_logits(e, st, graphs=True)                  # the capture
    eager = _one_step_logits(e, st, graphs=False)
    graph = _one_step_logits(e, st, graphs=True)
    assert torch.equal(graph, eager)
    assert e.n_captures == captured + 1


@pytest.mark.cuda
def test_cuda_lut_scratch_growth_keeps_graph_memory(card):
    """Capture a lut decode step on a fresh scratch buffer (4 rows), grow
    the buffer with an eager prefill of 256 rows, then serve again: the
    graph's split-K sums still land in its own buffer, and the tokens equal
    the eager route's."""
    model, cp = card["qwen"]
    e = TEngine(model, cp, backend="lut", max_len=128, max_batch=4,
                device="cuda")
    e._graphs = False
    want = e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW)
    e._graphs = True
    _common._SCRATCH.clear()             # the buffers handed out stay kept
    assert e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW) == want
    small = dict(_common._SCRATCH)
    toks, lens = e._pad_prompts([p[:5] * 12 for p in CARD_PROMPTS[:4]])
    assert toks.shape == (4, 64)
    e._prefill(toks, lens)
    torch.cuda.synchronize()
    assert any(_common._SCRATCH[k] is not v for k, v in small.items())
    assert e.serve(CARD_PROMPTS, max_new=CARD_MAX_NEW) == want
    assert e.n_captures == 1
