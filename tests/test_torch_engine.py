"""The port's ``ServeEngine`` vs the JAX package's on the golden-decode model
(qwen3-1.7b reduced to 2 layers, f32, k-means |W|=256, ``min_size=1024``,
as tests/test_golden_decode.py builds it), for each of dense, codebook and
lut.  Reference values are computed live in this process.

Greedy tokens (``generate`` and ``serve``) and prefill argmax must be equal;
logsumexp and the probe logits agree within 1e-3, the bound of
tests/test_golden_decode.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core.quantizer import (WeightQuantConfig, cluster_params,  # noqa: E402
                                  init_state)
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import ServeEngine, to_codebook_params  # noqa: E402
from repro.serving.spec import filter_logits as j_filter  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import filter_logits as t_filter  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8]]
SERVE_PROMPTS = PROMPTS + [[9, 10], [11] * 12, [300, 2, 5, 7, 1]]
SERVE_MAX_NEW = [6, 3, 5, 7, 4]
MAX_NEW = 6
PROBE_IDS = [0, 17, 63, 111, 256, 301, 449, 511]
ATOL = 1e-3
BACKENDS = ("dense", "codebook", "lut")


@pytest.fixture(scope="module")
def engines():
    cfg = C.get("qwen3-1.7b").reduced().replace(n_layers=2, dtype="float32")
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    tmodel = tbuild(TCfg.get("qwen3-1.7b").reduced().replace(
        n_layers=2, dtype="float32"))
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tcp = from_jax_params(jax.tree_util.tree_map(np.asarray, cp), "cpu")
    out = {}
    for be in BACKENDS:
        jp, ttp = (params, tp) if be == "dense" else (cp, tcp)
        out[be] = {
            "jax": ServeEngine(model, jp, max_len=64, backend=be),
            "torch": TEngine(tmodel, ttp, max_len=64, backend=be,
                             device="cpu"),
            "jax_serve": ServeEngine(model, jp, max_len=64, backend=be,
                                     max_batch=2),
            "torch_serve": TEngine(tmodel, ttp, max_len=64, backend=be,
                                   max_batch=2, device="cpu"),
        }
    return out


def _prefill_logits(pair):
    je, te = pair["jax"], pair["torch"]
    toks, lens = je._pad_prompts(PROMPTS)
    jl, _ = je._prefill(je.params, toks, lens)
    tt, tl = te._pad_prompts(PROMPTS)
    tlg, _ = te._prefill(tt, tl)
    V = je.model.cfg.vocab
    return (np.asarray(jl[:, -1, :V], np.float64),
            tlg[:, -1, :V].to(torch.float64).numpy())


def _lse(lg):
    m = lg.max(-1, keepdims=True)
    return np.log(np.sum(np.exp(lg - m), -1)) + m[:, 0]


@pytest.mark.parametrize("be", BACKENDS)
def test_prefill_argmax_lse_probes(engines, be):
    jl, tl = _prefill_logits(engines[be])
    np.testing.assert_array_equal(np.argmax(tl, -1), np.argmax(jl, -1))
    np.testing.assert_allclose(_lse(tl), _lse(jl), atol=ATOL)
    np.testing.assert_allclose(tl[:, PROBE_IDS], jl[:, PROBE_IDS], atol=ATOL)


@pytest.mark.parametrize("be", BACKENDS)
def test_generate_greedy_tokens_equal(engines, be):
    pair = engines[be]
    assert pair["torch"].generate(PROMPTS, max_new=MAX_NEW) == \
        pair["jax"].generate(PROMPTS, max_new=MAX_NEW)


@pytest.mark.parametrize("be", BACKENDS)
def test_serve_continuous_batching_equal(engines, be):
    """max_batch=2 with five requests: slots are harvested and reused."""
    pair = engines[be]
    want = pair["jax_serve"].serve(SERVE_PROMPTS, max_new=SERVE_MAX_NEW)
    got = pair["torch_serve"].serve(SERVE_PROMPTS, max_new=SERVE_MAX_NEW)
    assert got == want
    assert [len(g) - len(p) for g, p in zip(got, SERVE_PROMPTS)] == \
        SERVE_MAX_NEW


def test_lut_spec_matches_reference(engines):
    """The lut scale comes from the embedding's fan-in (padded vocab 512 at
    this size), as in the reference."""
    js = engines["lut"]["jax"]._lut_spec
    ts = engines["lut"]["torch"].lut_spec
    assert (ts.a_min, ts.a_max, ts.levels, ts.s) == \
        (js.a_min, js.a_max, js.levels, js.s)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9),
                                         (40, 0.5), (1, 0.3)])
def test_filter_logits_masks_equal(top_k, top_p):
    rng = np.random.default_rng(top_k + int(10 * top_p))
    lg = (rng.standard_normal((3, 512)) * 3).astype(np.float32)
    want = np.asarray(j_filter(jnp.asarray(lg), top_k, top_p)) <= -1e29
    got = t_filter(torch.from_numpy(lg), top_k, top_p).numpy() <= -1e29
    np.testing.assert_array_equal(got, want)


def test_sampling_stays_in_filter(engines):
    """T > 0 draws from a torch.Generator (jax.random's stream cannot be
    reproduced): every sampled token must survive top-k."""
    te = engines["codebook"]["torch"]
    eng = TEngine(te.model, te.params, max_len=64, backend="codebook",
                  temperature=0.8, top_k=3, device="cpu", seed=1)
    toks, lens = eng._pad_prompts(PROMPTS)
    logits, _ = eng._prefill(toks, lens)
    top3 = torch.topk(logits[:, -1, :eng.model.cfg.vocab], 3).indices
    for _ in range(10):
        s = eng._sample(logits)
        assert all(int(s[b]) in top3[b].tolist() for b in range(len(s)))
