"""The paper's working point served by the port vs the JAX package, computed
live: qwen3-1.7b reduced to 2 layers (f32) at ``quantized(levels=32,
n_weights=1000, method="kmeans")`` — |A| = 32 quantized activations at every
FFN (silu becomes relu6, then ``act_apply``) and a k-means |W| = 1000 global
codebook.  The reference clusters and compresses; the bridge carries the
index form and the codebook state across.

Greedy tokens must be equal for dense, codebook and lut, contiguous
(``generate`` and ``serve``) and paged with int8 pages; prefill logits
agree within 1e-3 (the bound of tests/test_golden_decode.py) with the same
argmax.  The quantized sites change the output: the same index-form
params served with ``act_levels = 0`` give other tokens.

The reference is run op by op (``jax.disable_jit``): that is the arithmetic
its functions are written in, and the one the port reproduces.  Under jit
XLA rewrites it (a division by the constant step becomes a product with
its reciprocal, multiply-adds fuse), so the reference's jitted forward
moves an FFN element near a level boundary to the next level now and then,
and disagrees with its own eager forward by a whole level's effect on the
logits: ``test_reference_jit_differs_from_its_eager_forward`` shows one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core.quantizer import cluster_params, init_state  # noqa: E402
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import ServeEngine, to_codebook_params  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params, from_jax_state  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import to_codebook_params as t_to_codebook  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12, [300, 2, 5, 7, 1]]
MAX_NEW = [6, 3, 5, 7, 4]
BACKENDS = ("dense", "codebook", "lut")
ATOL = 1e-3


def _working_point(mod):
    return mod.get("qwen3-1.7b").reduced().replace(
        n_layers=2, dtype="float32").quantized(levels=32, n_weights=1000,
                                               method="kmeans")


@pytest.fixture(scope="module")
def models():
    cfg = _working_point(C)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    pq, state = cluster_params(params, cfg.wq, init_state(cfg.wq),
                               cfg.wq.interval, jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, cfg.wq, state)
    tcfg = _working_point(TCfg)
    assert (tcfg.act_levels, tcfg.act_kind, tcfg.wq.method,
            tcfg.wq.num_weights, tcfg.wq.scope) == (
        32, cfg.act_kind, "kmeans", 1000, "global")
    return {"cfg": cfg, "model": model, "cp": cp, "state": state,
            "pq": jax.tree_util.tree_map(np.asarray, pq),
            "tmodel": tbuild(tcfg),
            "tcp": from_jax_params(jax.tree_util.tree_map(np.asarray, cp),
                                   "cpu")}


def _pair(m, be, **kw):
    return (ServeEngine(m["model"], m["cp"], backend=be, **kw),
            TEngine(m["tmodel"], m["tcp"], backend=be, device="cpu", **kw))


def _last_logits(je, te, prompts, eager=True):
    """(reference, port) last-position prefill logits, f64 numpy."""
    toks, lens = je._pad_prompts(prompts)
    if eager:
        with jax.disable_jit():
            jl, _ = je._prefill(je.params, toks, lens)
    else:
        jl, _ = je._prefill(je.params, toks, lens)
    tt, tl = te._pad_prompts(prompts)
    tlg, _ = te._prefill(tt, tl)
    V = je.model.cfg.vocab
    return (np.asarray(jl[:, -1, :V], np.float64),
            tlg[:, -1, :V].to(torch.float64).numpy())


@pytest.mark.parametrize("be", BACKENDS)
def test_prefill_logits_and_generate(models, be):
    je, te = _pair(models, be, max_len=64)
    jl, tl = _last_logits(je, te, PROMPTS[:2])
    np.testing.assert_array_equal(np.argmax(tl, -1), np.argmax(jl, -1))
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    with jax.disable_jit():
        want = je.generate(PROMPTS[:2], max_new=6)
    assert te.generate(PROMPTS[:2], max_new=6) == want


@pytest.mark.parametrize("be", BACKENDS)
def test_serve_contiguous_tokens_equal(models, be):
    je, te = _pair(models, be, max_len=64, max_batch=2)
    with jax.disable_jit():
        want = je.serve(PROMPTS, max_new=MAX_NEW)
    ops.reset_launch_counts()
    assert te.serve(PROMPTS, max_new=MAX_NEW) == want
    assert ops.launch_counts()["act_quant"] == 0      # the CPU path


@pytest.mark.parametrize("be", BACKENDS)
def test_serve_paged_int8_tokens_equal(models, be):
    kw = dict(max_len=64, max_batch=2, paged=True, page_size=4,
              kv_dtype="int8")
    je, te = _pair(models, be, **kw)
    with jax.disable_jit():
        want = je.serve(PROMPTS, max_new=MAX_NEW)
    assert te.serve(PROMPTS, max_new=MAX_NEW) == want


def test_reference_jit_differs_from_its_eager_forward(models):
    """The second prompt's continuation after 4 new tokens: one FFN element
    sits at a level boundary, the reference's jitted forward puts it on
    the next level and its logits move by about 0.02 against its own
    eager forward, enough to change the greedy token.  The port equals the
    eager forward."""
    je, te = _pair(models, "dense", max_len=64)
    seq = [[4, 5, 6, 7, 8, 105, 428, 74, 305]]
    eager, port = _last_logits(je, te, seq)
    jitted, _ = _last_logits(je, te, seq, eager=False)
    np.testing.assert_allclose(port, eager, atol=ATOL, rtol=0)
    assert np.abs(jitted - eager).max() > 10 * ATOL
    assert np.argmax(port) == np.argmax(eager) != np.argmax(jitted)


def test_quantized_sites_change_the_output(models):
    """The same params served with act_levels 0 give other tokens: the
    |A| = 32 sites are on the path, not cosmetic."""
    m = models
    cont = TEngine(tbuild(_working_point(TCfg).replace(act_levels=0)),
                   m["tcp"], backend="codebook", max_len=64, device="cpu")
    quant = TEngine(m["tmodel"], m["tcp"], backend="codebook", max_len=64,
                    device="cpu")
    prompts = PROMPTS[:4]
    assert cont.generate(prompts, max_new=8) != quant.generate(prompts,
                                                                max_new=8)


def test_port_compresses_the_working_point_like_the_reference(models):
    """The port's own k-means clustering of the reference's weights, from
    the bridge: its codebook matches the reference's (within the k-means
    tolerance of tests/test_torch_kmeans.py, here simply 1e-5 of the
    largest center), and compressing with the reference's state gives the
    reference's index form bit for bit."""
    from repro_torch.core.quantizer import cluster_params as t_cluster
    from repro_torch.core.quantizer import init_state as t_init
    m = models
    tcfg = _working_point(TCfg)
    params = jax.tree_util.tree_map(
        np.asarray, m["model"].init(jax.random.PRNGKey(0)))
    _, tst = t_cluster(from_jax_params(params, "cpu"), tcfg.wq,
                       t_init(tcfg.wq), tcfg.wq.interval)
    want = np.asarray(m["state"].codebooks[""])
    np.testing.assert_allclose(tst.codebooks[""].numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    state = from_jax_state({"": want}, device="cpu")
    tcp = t_to_codebook(from_jax_params(m["pq"], "cpu"), tcfg.wq, state)
    flat_t = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), tcp))
    flat_j = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, m["cp"]))
    assert len(flat_t) == len(flat_j)
    for a, b in zip(flat_t, flat_j):
        assert a.dtype == b.dtype and np.array_equal(a, b)
