"""The port's paged KV cache vs the JAX package's, computed live in this
process: the page gather (plain version vs the Pallas kernel in interpret
mode and ``jnp.take``), int8 K/V quantization, chunked-prefill and paged
decode attention, and paged ``serve`` on the golden-decode model
(qwen3-1.7b reduced to 2 layers, f32, k-means |W|=256, ``min_size=1024``).

Gathers, int8 values, bf16 scales, greedy tokens and pool statistics must be
equal; attention outputs in f32 agree within 1e-5 (two orders of f32 sums
over at most a few dozen terms).  Paged int8 is held against the
reference's own paged int8 run, never against float output: on this model
int8 pages move a near-tie (ROADMAP Queue 3).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core.quantizer import (WeightQuantConfig, cluster_params,  # noqa: E402
                                  init_state)
from repro.kernels.page_gather import page_gather_pallas  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import ServeEngine, to_codebook_params  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import page_gather as pg  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12, [300, 2, 5, 7, 1]]
MAX_NEW = [6, 3, 5, 7, 4]
BACKENDS = ("dense", "codebook", "lut")
KV_DTYPES = ("bf16", "int8")          # 'bf16' stores f32 pages for f32 models
ATOL = 1e-5


def _bits(a):
    """Comparable integer view of a numpy/JAX array or a torch tensor."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy()
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _to_torch(a):
    return from_jax_params({"a": np.asarray(a)}, "cpu")["a"]


# --- page gather -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("page_shape", [(4, 2, 8), (4, 2), (3, 5)])
def test_page_gather_plain_matches_pallas_and_take(dtype, page_shape):
    """K/V pages (page, KV, hd), scale pages (page, KV) and a page of 15
    elements; the table holds 0, negatives and ids ≥ n_pages, which both
    sides clamp into the pool."""
    rng = np.random.default_rng(len(page_shape) * 7 + len(dtype))
    n_pages = 9
    vals = rng.integers(-100, 100, (n_pages,) + page_shape)
    pool_j = jnp.asarray(vals).astype(getattr(jnp, dtype))
    pool_t = _to_torch(pool_j)
    pt = rng.integers(-3, n_pages + 4, (3, 5)).astype(np.int32)
    pt[0, :3] = [0, -1, n_pages]
    want = page_gather_pallas(pool_j, jnp.asarray(pt), interpret=True)
    take = jnp.take(pool_j, jnp.asarray(pt), axis=0, mode="clip")
    np.testing.assert_array_equal(_bits(want), _bits(take))
    for ids in (torch.from_numpy(pt), torch.from_numpy(pt.astype(np.int64))):
        got = pg.page_gather_plain(pool_t, ids)
        assert got.dtype == pool_t.dtype
        assert tuple(got.shape) == (3, 5) + page_shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(_bits(ops.gather_pages(pool_t, ids)),
                                      _bits(want))


def test_page_gather_of_a_layer_view():
    """The engine gathers from ``pool[layer]``, a view at an offset."""
    rng = np.random.default_rng(5)
    pool = torch.from_numpy(rng.integers(-128, 128, (3, 6, 4, 2, 8))
                            .astype(np.int8))
    pt = torch.from_numpy(rng.integers(0, 6, (2, 3)).astype(np.int32))
    want = jnp.take(jnp.asarray(pool.numpy()[2]), jnp.asarray(pt.numpy()),
                    axis=0, mode="clip")
    np.testing.assert_array_equal(ops.gather_pages(pool[2], pt).numpy(),
                                  np.asarray(want))


def test_page_gather_cuda_refuses_cpu_and_cpu_is_no_launch():
    pool = torch.zeros((4, 2, 3), dtype=torch.int8)
    pt = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        pg.page_gather_cuda(pool, pt)
    ops.reset_launch_counts()
    ops.gather_pages(pool, pt)
    assert ops.launch_counts()["page_gather"] == 0
    with pytest.raises(ValueError):
        ops.gather_pages(pool, pt.float())


# --- int8 K/V quantization ---------------------------------------------------

def _kv_case():
    """(2, 3, 2, 8) f32 with .5 ties under an f32 scale that bf16 cannot
    hold, an all-zero row, and random rows."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((2, 3, 2, 8)).astype(np.float32) * 3
    s = np.float32(1 + 2 ** -10)                       # amax / 127
    ties = np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, 100.5, -126.5],
                    np.float32)
    t[0, 0, 0] = ties * s                              # exact in f32
    t[1, 2, 1] = 0.0
    return t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    t = _kv_case()
    tj = jnp.asarray(t).astype(getattr(jnp, dtype))
    tt = _to_torch(tj)
    qj, sj = JA.quantize_kv(tj)
    qt, st = TA.quantize_kv(tt)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    np.testing.assert_array_equal(TA.dequantize_kv(qt, st).numpy(),
                                  np.asarray(JA.dequantize_kv(qj, sj)))
    if dtype == "float32":
        # ties round half to even under the f32 scale; dividing by the
        # stored bf16 scale instead moves them, which this input catches
        assert qt[0, 0, 0].tolist() == [127, 2, -4, 0, 0, 2, 100, -126]
        assert qt[1, 2, 1].abs().sum() == 0
        wrong = torch.round(tt / st.float()[..., None]).clamp(-127, 127)
        assert not torch.equal(wrong.to(torch.int8), qt)


# --- paged attention ----------------------------------------------------------

D, H, KV, HD, PAGE, NP, NL = 32, 4, 2, 8, 4, 7, 2


def _attn_setup(seed, int8):
    rng = np.random.default_rng(seed)
    jcfg = JA.AttnConfig(d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                         qk_norm=True)
    tcfg = TA.AttnConfig(d_model=D, n_heads=H, n_kv=KV, head_dim=HD,
                         qk_norm=True)
    p = JA.attn_init(jax.random.PRNGKey(seed), jcfg)
    shape = (NL, NP, PAGE, KV, HD)
    if int8:
        pools = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                 "v": rng.integers(-127, 128, shape).astype(np.int8),
                 "ks": (rng.random(shape[:-1]) * 0.05).astype(np.float32),
                 "vs": (rng.random(shape[:-1]) * 0.05).astype(np.float32)}
        jp = {k: jnp.asarray(v) for k, v in pools.items()}
        jp["ks"] = jp["ks"].astype(jnp.bfloat16)
        jp["vs"] = jp["vs"].astype(jnp.bfloat16)
    else:
        jp = {"k": jnp.asarray(rng.standard_normal(shape), jnp.float32),
              "v": jnp.asarray(rng.standard_normal(shape), jnp.float32)}
    tp = {k: _to_torch(v) for k, v in jp.items()}
    return rng, jcfg, tcfg, p, from_jax_params(
        jax.tree_util.tree_map(np.asarray, p), "cpu"), jp, tp


def _scales(pools):
    return (pools["ks"], pools["vs"]) if "ks" in pools else None


def _assert_pools(jk, jv, jsc, tp):
    for name, want in (("k", jk), ("v", jv)):
        if tp[name].dtype == torch.int8:
            np.testing.assert_array_equal(tp[name].numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(want),
                                       atol=ATOL, rtol=0)
    if jsc is not None:
        np.testing.assert_array_equal(_bits(tp["ks"]), _bits(jsc[0]))
        np.testing.assert_array_equal(_bits(tp["vs"]), _bits(jsc[1]))


def test_chunk_attention_matches():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, PAGE, KV, H // KV, HD)).astype(np.float32)
    kp, vp = (rng.standard_normal((2, 12, KV, HD)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((2, PAGE, KV, HD)).astype(np.float32)
              for _ in range(2))
    for past in (0, 5, np.array([3, 12], np.int32)):
        want = JA.chunk_attention(*(jnp.asarray(a) for a in (q, kp, vp)),
                                  jnp.asarray(past),
                                  jnp.asarray(kn), jnp.asarray(vn))
        got = TA.chunk_attention(
            *(torch.from_numpy(a) for a in (q, kp, vp)),
            torch.from_numpy(np.asarray(past)) if np.ndim(past) else past,
            torch.from_numpy(kn), torch.from_numpy(vn))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_attn_decode_paged_matches(int8, layer):
    """Gather, attend with the fresh token through extra_kv, then write it
    at (layer, write_pid, write_off); page tables hold out-of-range ids."""
    rng, jcfg, tcfg, p, tparams, jp, tp = _attn_setup(10 + layer, int8)
    B = 3
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    pt = np.array([[1, 2, 3], [4, 5, -2], [6, 9, 1]], np.int32)
    pos = np.array([5, 9, 0], np.int32)
    wpid = np.array([2, 5, 6], np.int32)
    woff = pos % PAGE
    out_j, k_j, v_j, sc_j = JA.attn_decode_paged(
        p, jnp.asarray(x), jcfg, pos=jnp.asarray(pos[:, None]),
        page_table=jnp.asarray(pt), write_pid=jnp.asarray(wpid),
        write_off=jnp.asarray(woff), valid_len=jnp.asarray(pos),
        k_pool=jp["k"], v_pool=jp["v"], layer=layer, scales=_scales(jp))
    out_t = TA.attn_decode_paged(
        tparams, torch.from_numpy(x), tcfg,
        pos=torch.from_numpy(pos[:, None]), page_table=torch.from_numpy(pt),
        write_pid=torch.from_numpy(wpid), write_off=torch.from_numpy(woff),
        valid_len=torch.from_numpy(pos), k_pool=tp["k"], v_pool=tp["v"],
        layer=layer, scales=_scales(tp))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    _assert_pools(k_j, v_j, sc_j, tp)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("start,wpid", [(0, 3), (8, 5), (4, 0)])
def test_attn_prefill_chunk_matches(int8, start, wpid):
    """One page-sized chunk at a page-aligned start; write_pid 0 sends a
    recomputed shared chunk to the trash page."""
    rng, jcfg, tcfg, p, tparams, jp, tp = _attn_setup(20 + start, int8)
    x = rng.standard_normal((1, PAGE, D)).astype(np.float32)
    row = np.array([2, 4, 5, 0, 0], np.int32)
    pos = (start + np.arange(PAGE, dtype=np.int32))[None]
    out_j, k_j, v_j, sc_j = JA.attn_prefill_chunk(
        p, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
        page_table=jnp.asarray(row[None]), write_pid=jnp.int32(wpid),
        past_len=jnp.int32(start), k_pool=jp["k"], v_pool=jp["v"], layer=1,
        scales=_scales(jp))
    out_t = TA.attn_prefill_chunk(
        tparams, torch.from_numpy(x), tcfg, pos=torch.from_numpy(pos),
        page_table=torch.from_numpy(row[None]), write_pid=wpid,
        past_len=start, k_pool=tp["k"], v_pool=tp["v"], layer=1,
        scales=_scales(tp))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=0)
    _assert_pools(k_j, v_j, sc_j, tp)


# --- paged serve on the golden-decode model -----------------------------------

@pytest.fixture(scope="module")
def models():
    cfg = C.get("qwen3-1.7b").reduced().replace(n_layers=2, dtype="float32")
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    tmodel = tbuild(TCfg.get("qwen3-1.7b").reduced().replace(
        n_layers=2, dtype="float32"))
    tcp = from_jax_params(jax.tree_util.tree_map(np.asarray, cp), "cpu")
    return model, cp, tmodel, tcp


def _pair(models, be, kv, **kw):
    model, cp, tmodel, tcp = models
    kw = {**dict(max_len=64, max_batch=2, backend=be, paged=True,
                 page_size=4, kv_dtype=kv), **kw}
    return ServeEngine(model, cp, **kw), TEngine(tmodel, tcp, device="cpu",
                                                 **kw)


def _stats(pool):
    return dataclasses.asdict(pool.stats)


@pytest.mark.parametrize("kv", KV_DTYPES)
@pytest.mark.parametrize("be", BACKENDS)
def test_paged_serve_tokens_equal(models, be, kv):
    """page 4, max_batch 2: multi-chunk prompts, decode across page
    boundaries, slots harvested and reused; then a second serve on the same
    engines hits the prefix cache with the same tokens and statistics."""
    je, te = _pair(models, be, kv)
    want = je.serve(PROMPTS, max_new=MAX_NEW)
    got = te.serve(PROMPTS, max_new=MAX_NEW)
    assert got == want
    assert [len(g) - len(p) for g, p in zip(got, PROMPTS)] == MAX_NEW
    assert _stats(te.pool) == _stats(je.pool)
    hits = te.pool.stats.hit_pages
    assert te.serve(PROMPTS, max_new=MAX_NEW) == got
    assert je.serve(PROMPTS, max_new=MAX_NEW) == want
    assert te.pool.stats.hit_pages > hits
    assert _stats(te.pool) == _stats(je.pool)
    assert list(te.pool.free) == list(je.pool.free)
    assert list(te.pool.table.items()) == list(je.pool.table.items())


@pytest.mark.parametrize("kv", KV_DTYPES)
def test_paged_pool_contents_equal(models, kv):
    """After a serve, every page of the pool holds the reference's bytes
    (int8 values and bf16 scales exactly, f32 K/V within 1e-5)."""
    je, te = _pair(models, "codebook", kv)
    assert te.serve(PROMPTS[:3], max_new=4) == je.serve(PROMPTS[:3],
                                                        max_new=4)
    for name, arr in te.pool.cache.items():
        want = je.pool.cache[name]
        if arr.dtype == torch.float32:
            np.testing.assert_allclose(arr[:, 1:].numpy(),
                                       np.asarray(want)[:, 1:], atol=ATOL,
                                       rtol=0)
        else:                         # page 0 is trash: skip its races
            np.testing.assert_array_equal(_bits(arr)[:, 1:],
                                          _bits(want)[:, 1:])


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("kv", KV_DTYPES)
def test_tight_pool_admission(models, kv, prefix):
    """A 4-page pool: admission waits on pages (never two requests in
    flight), a repeated prompt falls back from unaffordable sharing, and a
    request that can never fit raises."""
    je, te = _pair(models, "dense", kv, n_pages=4, prefix_cache=prefix,
                   max_batch=4)
    reqs = PROMPTS[:3] + [[7, 8, 9, 10, 11, 12]] * 2
    want = je.serve(reqs, max_new=[6, 6, 6, 5, 5])
    assert te.serve(reqs, max_new=[6, 6, 6, 5, 5]) == want
    assert _stats(te.pool) == _stats(je.pool)
    assert te.pool.stats.peak_pages_in_use <= 3
    with pytest.raises(ValueError, match="never fit"):
        te.serve([[1] * 13], max_new=4)


@pytest.mark.parametrize("be", BACKENDS)
def test_paged_f32_matches_contiguous(models, be):
    """The port's paged engine with f32 pages against its own contiguous
    engine, token for token."""
    _, _, tmodel, tcp = models
    kw = dict(max_len=64, max_batch=2, backend=be, device="cpu")
    want = TEngine(tmodel, tcp, **kw).serve(PROMPTS, max_new=MAX_NEW)
    got = TEngine(tmodel, tcp, paged=True, page_size=4, **kw).serve(
        PROMPTS, max_new=MAX_NEW)
    assert got == want


def test_pool_and_slab_bytes_match_reference(models):
    for kv in KV_DTYPES:
        je, te = _pair(models, "dense", kv)
        assert te.pool.bytes_total() == je.pool.bytes_total()
        assert te.pool.bytes_per_page() == je.pool.bytes_per_page()
        assert te.dense_cache_bytes() == je.dense_cache_bytes()
    with pytest.raises(ValueError, match="kv_dtype"):
        TEngine(models[2], models[3], kv_dtype="fp8", device="cpu")
