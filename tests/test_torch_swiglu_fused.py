"""The gated codebook launch (``ops.codebook_swiglu``) and ``act_quant`` with
a multiplier: a SwiGLU FFN's gate and up products with the quantized
activation as their epilogue, ``h = T(act_q(T(x @ W1)) * T(x @ W3))``.

On the CPU: the plain version equals the unfused chain (two codebook
products, their casts, ``act_apply`` and the product) bit for bit; its
epilogue equals the JAX package's ``act_apply(g) * u`` bit for bit on the
same f32 sums; ``act_quant`` with ``mul`` equals ``act_quant`` times
``mul``; ``layers.swiglu`` takes the gated route exactly where it should,
and the paper's working point served through it gives the reference's
greedy tokens.  On the card (``cuda``): the kernel equals the unfused chain
of CUDA launches bit for bit, and the plain epilogue of its own
accumulators; two runs are bit-identical.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _common, ops  # noqa: E402
from repro_torch.kernels import act_quant as aq  # noqa: E402
from repro_torch.kernels import codebook_matmul as cm  # noqa: E402

torch.set_num_threads(2)

ROWS = (1, 4, 17, 32)
LEVELS = (2, 32, 256)
KINDS = aq.KINDS


def _case(seed, m, k, n, W=1000, idt=np.int16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w1 = rng.integers(0, W, (k, n)).astype(idt)
    w3 = rng.integers(0, W, (k, n)).astype(idt)
    b1 = (rng.standard_normal(W) * 0.1).astype(np.float32)
    b3 = (rng.standard_normal(W) * 0.1).astype(np.float32)
    return [torch.from_numpy(v) for v in (x, w1, b1, w3, b3)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", LEVELS)
def test_plain_equals_unfused_chain(m, xdt, levels):
    x, w1, b1, w3, b3 = _case(m * 7 + levels, m, 256, 96)
    x = x.to(getattr(torch, xdt))
    for kind in KINDS:
        got = ops.codebook_swiglu(x, w1, b1, w3, b3, kind, levels)
        g = ops.codebook_matmul(x, w1, b1).to(x.dtype)
        u = ops.codebook_matmul(x, w3, b3).to(x.dtype)
        want = ops.act_apply_quant(g, kind, levels)[0] * u
        assert got.dtype == x.dtype and got.shape == (m, 96)
        assert torch.equal(_bits(got), _bits(want)), (kind, xdt, levels)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("levels", LEVELS)
def test_epilogue_equals_jax_act_apply(xdt, levels):
    """The same f32 sums through the port's epilogue and the reference's
    ``act_apply(ActQuantConfig(kind, L), T(g)) * T(u)``, run op by op
    (``jax.disable_jit``): bit-equal."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.core.activations import ActQuantConfig, act_apply
    rng = np.random.default_rng(levels)
    g = (rng.standard_normal((17, 300)) * 4).astype(np.float32)
    u = rng.standard_normal((17, 300)).astype(np.float32)
    jdt = getattr(jnp, xdt)
    for kind in KINDS:
        with jax.disable_jit():
            want = np.asarray(act_apply(ActQuantConfig(kind, levels),
                                        jnp.asarray(g).astype(jdt))
                              * jnp.asarray(u).astype(jdt)).astype(np.float32)
        got = cm.swiglu_epilogue_plain(torch.from_numpy(g),
                                       torch.from_numpy(u),
                                       getattr(torch, xdt), kind, levels)
        np.testing.assert_array_equal(got.float().numpy(), want, err_msg=kind)


@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", aq.FORMS)
def test_act_quant_mul_equals_product(xdt, form):
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((9, 257)) * 3).astype(
        np.float32)).to(getattr(torch, xdt))
    u = torch.from_numpy(rng.standard_normal((9, 257)).astype(
        np.float32)).to(x.dtype)
    for kind in KINDS:
        for levels in LEVELS:
            y, idx = aq.act_quant_plain(x, kind, levels, form=form)
            ym, idxm = aq.act_quant_plain(x, kind, levels, form=form, mul=u)
            assert torch.equal(idx, idxm)
            assert torch.equal(_bits(ym), _bits(y * u))
            assert aq.parity_ties(ym, idxm, y * u, idx, kind, levels,
                                  mul=u) == 0


def test_parity_ties_with_mul():
    """A tie, with a multiplier, is held to its level times the
    multiplier; an output off that product raises."""
    x = torch.linspace(-3, 3, 1001)
    u = torch.linspace(0.5, 2.0, 1001)
    y, i = aq.act_quant_plain(x, "tanh", 32, mul=u)
    i2, y2 = i.clone(), y.clone()
    i2[500] += 1
    y2[500] = (-1.0 + float(i2[500]) * (2.0 / 31)) * float(u[500])
    assert aq.parity_ties(y2, i2, y, i, "tanh", 32, mul=u) == 1
    y2[500] += 1e-3
    with pytest.raises(AssertionError):
        aq.parity_ties(y2, i2, y, i, "tanh", 32, mul=u)


def test_swiglu_plan_is_the_single_products_and_books_must_fit():
    for M in (1, 4, 17, 32, 256):
        for bf16, vec_ok in ((True, True), (False, True), (True, False)):
            kw = dict(bf16=bf16, vec_ok=vec_ok, sms=132)
            assert (_common.swiglu_plan(M, 2048, 6144, n_books=2000, **kw)
                    == _common.codebook_plan(M, 2048, 6144, **kw))
    # both routes hold two books of cm.MAX_BOOK entries
    for kw in (dict(bf16=True, vec_ok=True), dict(bf16=False, vec_ok=True)):
        _common.swiglu_plan(64, 2048, 6144, sms=132, n_books=2 * cm.MAX_BOOK,
                            **kw)
        with pytest.raises(ValueError, match="shared memory"):
            _common.swiglu_plan(64, 2048, 6144, sms=132, n_books=200_000,
                                **kw)


def test_cuda_wrapper_refuses_cpu_and_mismatched_operands():
    x, w1, b1, w3, b3 = _case(0, 2, 64, 32)
    with pytest.raises(ValueError):
        cm.codebook_swiglu_cuda(x, w1, b1, w3, b3, "relu6", 32)
    with pytest.raises(ValueError):
        aq.act_quant_cuda(x, "relu6", 32, mul=x)
    ops.reset_launch_counts()
    ops.codebook_swiglu(x, w1, b1, w3, b3, "relu6", 32)
    assert ops.launch_counts()["codebook_swiglu"] == 0     # plain: no launch


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        calls.append(kw.get("mul") is not None)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.fixture(scope="module")
def point():
    """qwen3-1.7b reduced (2 layers, f32) at the paper's working point, the
    reference's k-means compression bridged to the port."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.core.quantizer import cluster_params, init_state
    from repro.models.model_zoo import build
    from repro.serving import to_codebook_params
    from repro_torch import configs as TCfg
    from repro_torch.bridge import from_jax_params
    from repro_torch.models.model_zoo import build as tbuild

    def cfg_of(mod):
        return mod.get("qwen3-1.7b").reduced().replace(
            n_layers=2, dtype="float32").quantized(levels=32, n_weights=1000,
                                                   method="kmeans")
    cfg = cfg_of(C)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    pq, state = cluster_params(params, cfg.wq, init_state(cfg.wq),
                               cfg.wq.interval, jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, cfg.wq, state)
    return {"model": model, "cp": cp, "tmodel": tbuild(cfg_of(TCfg)),
            "tcp": from_jax_params(jax.tree_util.tree_map(np.asarray, cp),
                                   "cpu")}


PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11] * 12, [300, 2, 5, 7, 1]]
MAX_NEW = [6, 3, 5, 7, 4]


@pytest.mark.parametrize("be", ["dense", "codebook", "lut"])
def test_working_point_tokens_through_the_gated_route(point, be, monkeypatch):
    """Served at the working point, the codebook backend takes the gated
    route at every FFN (one call a layer a forward) and the dense and lut
    backends the activation with its multiplier; greedy tokens equal the
    reference's, run op by op."""
    import jax
    from repro.serving import ServeEngine
    from repro_torch.serving import ServeEngine as TEngine
    gated = _spy(monkeypatch, cm, "codebook_swiglu_plain")
    act = _spy(monkeypatch, aq, "act_quant_plain")
    te = TEngine(point["tmodel"], point["tcp"], backend=be, max_len=64,
                 max_batch=2, device="cpu")
    got = te.serve(PROMPTS, max_new=MAX_NEW)
    n_l = point["tmodel"].cfg.n_layers
    if be == "codebook":
        assert len(gated) == n_l * te.n_forwards
        assert act == [True] * len(gated)        # the gated route's epilogue
    else:
        assert not gated and act == [True] * (n_l * te.n_forwards)
    with jax.disable_jit():
        want = ServeEngine(point["model"], point["cp"], backend=be,
                           max_len=64, max_batch=2).serve(PROMPTS,
                                                          max_new=MAX_NEW)
    assert got == want


def test_continuous_activation_keeps_the_separate_product(point, monkeypatch):
    """At act_levels 0 (the main path's silu) nothing is fused."""
    from repro_torch.models.model_zoo import build as tbuild
    from repro_torch.serving import ServeEngine as TEngine
    gated = _spy(monkeypatch, cm, "codebook_swiglu_plain")
    act = _spy(monkeypatch, aq, "act_quant_plain")
    model = tbuild(point["tmodel"].cfg.replace(act_levels=0))
    TEngine(model, point["tcp"], backend="codebook", max_len=64,
            device="cpu").generate(PROMPTS[:2], max_new=3)
    assert not gated and not act


# --- on the card ------------------------------------------------------------

# every FFN row count of the serving paths (decode at 4 slots, prefill
# buckets 8..64, four 64-token prefills, a paged chunk of 16) and 17, at the
# w1/w3 site of qwen3-1.7b, and an odd N (the FMA tile)
CUDA_SHAPES = [(m, 2048, 6144) for m in (1, 4, 8, 16, 17, 32, 64, 256)] + [
    (3, 100, 131), (40, 100, 131)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES)
def test_cuda_codebook_swiglu_matches_chain(m, k, n):
    """Needs a GPU and nvcc: the gated launch against the unfused chain of
    CUDA launches (two codebook_matmul with the same plan, the casts,
    act_quant with its multiplier) bit for bit, every kind, |A| 2/32/256,
    f32 and bf16 x, int8/int16/int32 ids, the planned route and (bf16) the
    FMA tile; and against the plain epilogue of its own accumulators
    (bit-equal for relu6, ties counted for the transcendental kinds on the
    chain's act_quant); a second run bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for idt, W in ((np.int8, 256), (np.int16, 1000), (np.int32, 5000)):
        x, w1, b1, w3, b3 = (t.to(dev) for t in _case(m + n, m, k, n, W=W,
                                                      idt=idt))
        for xdt in (torch.float32, torch.bfloat16):
            xx = x.to(xdt)
            plans = [None]
            if xdt == torch.bfloat16:
                plans.append(_common.codebook_plan(
                    m, k, n, bf16=True, vec_ok=False,
                    sms=_common.sm_count(dev)))
            for plan in plans:
                g = cm.codebook_matmul_cuda(xx, w1, b1, plan=plan)
                u = cm.codebook_matmul_cuda(xx, w3, b3, plan=plan)
                for kind in KINDS:
                    for levels in LEVELS:
                        got = cm.codebook_swiglu_cuda(xx, w1, b1, w3, b3,
                                                      kind, levels, plan=plan)
                        again = cm.codebook_swiglu_cuda(
                            xx, w1, b1, w3, b3, kind, levels, plan=plan)
                        chain = aq.act_quant_cuda(
                            g.to(xdt), kind, levels, form="act_apply",
                            with_index=False, mul=u.to(xdt))[0]
                        torch.cuda.synchronize()
                        assert torch.equal(_bits(got), _bits(chain))
                        assert torch.equal(_bits(got), _bits(again))
                        if kind == "relu6":
                            want = cm.swiglu_epilogue_plain(g, u, xdt, kind,
                                                            levels)
                            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 6144), (32, 6144), (3, 257),
                                   (1000003,)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_cuda_act_quant_mul_matches_plain(shape, xdt):
    """Needs a GPU and nvcc: act_quant with a multiplier against its plain
    version, both forms, every kind, |A| 2/32/256: bit-equal but for
    counted ties (relu6 bit-equal), and equal to the kernel without the
    multiplier times it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    g = torch.Generator(device="cuda").manual_seed(shape[0])
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(
        getattr(torch, xdt))
    u = torch.randn(shape, generator=g, device="cuda").to(x.dtype)
    for kind in KINDS:
        for levels in LEVELS:
            for form in aq.FORMS:
                got = aq.act_quant_cuda(x, kind, levels, form=form, mul=u)
                want = aq.act_quant_plain(x, kind, levels, form=form, mul=u)
                alone = aq.act_quant_cuda(x, kind, levels, form=form)[0]
                torch.cuda.synchronize()
                assert torch.equal(_bits(got[0]), _bits(alone * u))
                aq.parity_ties(*got, *want, kind, levels, mul=u)
