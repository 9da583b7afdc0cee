"""The contiguous int8 KV cache (``cfg.kv_quant``) of the port vs the JAX
package's, computed live, on ``codeqwen1.5-7b`` reduced (2 layers, d 128,
4/4 heads, f32; the one registry config with ``kv_quant=True``).  Params
come from JAX through the bridge; the index form is the reference's k-means
|W| = 256 compression (``min_size=1024``).

The cache holds int8 K/V with per-token-per-head bf16 scales: leaves,
shapes, dtypes and bytes equal the reference's; the prefill's int8 planes
equal the reference's but for codes one apart where a value sits at a
rounding tie of the two packages' f32 K/V (counted and bounded); prefill
logits and greedy tokens equal the reference's for dense,
codebook and lut (the untied head through the backend) through
``generate`` (prefill planes grown to ``max_len``) and ``serve`` (one
request's planes spliced into a slot of the pooled cache).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core.quantizer import (WeightQuantConfig, cluster_params,  # noqa: E402
                                  init_state)
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import ServeEngine, to_codebook_params  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12, [300, 2, 5, 7, 1]]
MAX_NEW = 12
BACKENDS = ("dense", "codebook", "lut")
MAX_BATCH, MAX_LEN = 4, 64


def _cfg(mod):
    return mod.get("codeqwen1.5-7b").reduced()


@pytest.fixture(scope="module")
def models():
    cfg = _cfg(C)
    assert cfg.kv_quant and _cfg(TCfg).kv_quant
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"model": model, "tmodel": tbuild(_cfg(TCfg)),
            "dense": (params, from_jax_params(np_tree(params), "cpu")),
            "index": (cp, from_jax_params(np_tree(cp), "cpu"))}


def _pair(m, be, **kw):
    jp, tp = m["dense" if be == "dense" else "index"]
    return (ServeEngine(m["model"], jp, backend=be, **kw),
            TEngine(m["tmodel"], tp, backend=be, device="cpu", **kw))


def test_cache_leaves_and_bytes_equal_reference(models):
    je, te = _pair(models, "dense", max_len=MAX_LEN, max_batch=MAX_BATCH)
    jc = je.model.init_cache(MAX_BATCH, MAX_LEN)["kv"]
    tc = te.model.init_cache(MAX_BATCH, MAX_LEN, device="cpu")["kv"]
    assert sorted(jc) == sorted(tc) == ["k", "k_scale", "v", "v_scale"]
    for name, leaf in jc.items():
        assert tuple(tc[name].shape) == leaf.shape
        assert str(tc[name].dtype).split(".")[-1] == str(leaf.dtype)
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].dtype == torch.bfloat16
    assert te.dense_cache_bytes() == je.dense_cache_bytes() == 139264


def test_prefill_int8_planes_equal_reference(models):
    """Codes and scales of every layer's prefill planes.  The two packages'
    f32 K/V differ in the last bits (summation order), so a value at a
    rounding tie of ``round(k / scale)`` may take the neighbouring code,
    and a token's max |k| its neighbouring bf16 scale; both are counted and
    bounded, and nothing else may differ."""
    je, te = _pair(models, "dense", max_len=MAX_LEN)
    toks, lens = je._pad_prompts(PROMPTS)
    _, jc = je._prefill(je.params, toks, lens)
    tt, tl = te._pad_prompts(PROMPTS)
    _, tc = te._prefill(tt, tl)
    n_codes = n_scales = 0
    for name in ("k", "v"):
        want = np.asarray(jc["kv"][name]).astype(np.int32)
        got = tc["kv"][name].numpy().astype(np.int32)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        n_codes += int((got != want).sum())
        ws = np.asarray(jc["kv"][name + "_scale"].astype(np.float32))
        gs = tc["kv"][name + "_scale"].float().numpy()
        np.testing.assert_allclose(gs, ws, rtol=2 ** -8, atol=0)
        n_scales += int((gs != ws).sum())
    total = 2 * tc["kv"]["k"].numel()
    assert n_codes <= 1e-3 * total, (n_codes, total)
    assert n_scales <= 1e-3 * 2 * tc["kv"]["k_scale"].numel()


@pytest.mark.parametrize("be", BACKENDS)
def test_prefill_logits_equal_reference(models, be):
    """Last-position prefill logits within 1e-3 (the bound of
    tests/test_golden_decode.py), argmax equal.  The config's head is
    untied, so the logits come from ``lm_head`` through the backend, as in
    the reference (a lut head computed by the dense backend instead is off
    by some 7e-3 here)."""
    je, te = _pair(models, be, max_len=MAX_LEN)
    toks, lens = je._pad_prompts(PROMPTS)
    jl, _ = je._prefill(je.params, toks, lens)
    tt, tl = te._pad_prompts(PROMPTS)
    tlg, _ = te._prefill(tt, tl)
    V = je.model.cfg.vocab
    want = np.asarray(jl[:, -1, :V], np.float64)
    got = tlg[:, -1, :V].to(torch.float64).numpy()
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("be", BACKENDS)
def test_generate_and_serve_tokens_equal_reference(models, be):
    je, te = _pair(models, be, max_len=MAX_LEN, max_batch=2)
    assert te.generate(PROMPTS, max_new=MAX_NEW) == je.generate(
        PROMPTS, max_new=MAX_NEW)
    assert te.serve(PROMPTS, max_new=MAX_NEW) == je.serve(
        PROMPTS, max_new=MAX_NEW)


def test_decode_writes_quantized_token_in_place(models):
    """One decode step stores the fresh token's codes and scale at each
    slot's position, in the planes the cache already holds; the float
    cache of the same model (``kv_quant`` off) stores its K/V plain."""
    te = _pair(models, "dense", max_len=MAX_LEN, max_batch=2)[1]
    tt, tl = te._pad_prompts(PROMPTS[:2])
    _, cache = te._prefill(tt, tl)
    cache = te._grow(cache)
    planes = dict(cache["kv"])
    pos = cache["pos"].clone()
    _, cache = te._decode(np.array([7, 9]), cache)
    for name, t in planes.items():
        assert cache["kv"][name] is t
    rows = torch.arange(2)
    assert bool((cache["kv"]["k_scale"][:, rows, pos.long()] > 0).all())
    assert bool((cache["kv"]["k"][:, rows, pos.long()] != 0).any())
    float_model = tbuild(_cfg(TCfg).replace(kv_quant=False))
    fc = float_model.init_cache(2, MAX_LEN, dtype=torch.float32,
                                device="cpu")["kv"]
    assert sorted(fc) == ["k", "v"] and fc["k"].dtype == torch.float32
