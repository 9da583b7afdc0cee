"""The port's quantized activations vs the JAX package's, computed live:
``core.activations`` (``act_apply``, ``act_index``, ``act_levels``,
``act_input_boundaries``, ``quantize_input``), ``ops.act_quant`` (the Pallas
kernel in interpret mode on the JAX side) with its gradient, and the FFN
site ``layers.ffn_act`` at ``levels > 0``.

Inputs come from numpy seeds.  Outputs and level indices must be bit-equal,
except where the two sides' ``tanh``/``exp`` round to different sides of a
level boundary: those ties are counted, and each must be exactly one level
apart, with the output on the level its own index names.  relu6 has no
transcendental and must be bit-equal everywhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import activations as JA  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.kernels import act_quant as aq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

KINDS = ("tanh", "relu6", "sigmoid", "rtanh")
LEVELS = (2, 16, 32, 255)
DTYPES = ("float32", "bfloat16")
N_RANDOM = 8192
MAX_TIE_SHARE = 1e-3        # among random inputs ties are rare accidents


def _inputs(seed, dtype, kind, levels, n=N_RANDOM):
    """N(0, 9) values plus the input-space level boundaries and their f32
    neighbours, where a tie is most likely."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 3).astype(np.float32)
    b = TA.act_input_boundaries(TA.ActQuantConfig(kind, levels))
    b = b[np.isfinite(b)].astype(np.float32)
    edge = np.concatenate([b, np.nextafter(b, np.float32(np.inf)),
                           np.nextafter(b, np.float32(-np.inf))])
    x = np.concatenate([x, edge, [0.0, 6.0, -0.0, 1e-30]]).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else
             a.view(torch.int32) if a.dtype == torch.float32 else a)
        return a.numpy().astype(np.int64)
    a = np.asarray(a)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else
            a.view(np.int32) if a.dtype == np.float32 else a).astype(np.int64)


def _ties(kind, got_y, got_idx, want_y, want_idx, level_of):
    """Number of tie elements; raises on any other disagreement.

    got_idx/want_idx: int32 levels; level_of(idx) → the bits each side's
    output must hold at a tie."""
    gi = np.asarray(got_idx, np.int64).reshape(-1)
    wi = np.asarray(want_idx, np.int64).reshape(-1)
    tie = gi != wi
    assert np.all(np.abs(gi - wi)[tie] == 1), "a level differs by more than 1"
    gy, wy = _bits(got_y).reshape(-1), _bits(want_y).reshape(-1)
    np.testing.assert_array_equal(gy[~tie], wy[~tie])
    if kind == "relu6":
        assert not tie.any(), "relu6 must be bit-equal everywhere"
    if tie.any():
        np.testing.assert_array_equal(gy[tie], level_of(gi[tie]))
        np.testing.assert_array_equal(wy[tie], level_of(wi[tie]))
    assert tie[:N_RANDOM].sum() <= MAX_TIE_SHARE * N_RANDOM
    return int(tie.sum())


def _level_bits(kind, levels, dtype, form):
    """idx → the output's bits on that level, in the form's arithmetic."""
    def f(idx):
        q = torch.from_numpy(idx.astype(np.float32))
        lo, step, _, _ = aq._scalars(kind, levels, form,
                                     getattr(torch, dtype))
        if form == "kernel":
            v = (q.double() * step + lo).float()
        else:
            r = lambda t: t.to(getattr(torch, dtype)).float()   # noqa: E731
            v = r(lo + r(q * step))
        return _bits(v.to(getattr(torch, dtype)))
    return f


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_act_apply_and_index_match_reference(kind, levels, dtype):
    """act_apply and act_index: op by op in x's dtype on both sides."""
    jx, tx = _inputs(levels * 7 + len(kind), dtype, kind, levels)
    jcfg, tcfg = JA.ActQuantConfig(kind, levels), TA.ActQuantConfig(kind,
                                                                     levels)
    got_y, got_i = TA.act_apply(tcfg, tx), TA.act_index(tcfg, tx)
    assert got_y.dtype == tx.dtype and got_i.dtype == torch.int32
    _ties(kind, got_y, got_i, JA.act_apply(jcfg, jx), JA.act_index(jcfg, jx),
          _level_bits(kind, levels, dtype, "act_apply"))
    # the port's oracle is act_apply, as the reference's is
    assert torch.equal(tref.act_quant_ref(tx, kind, levels), got_y)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", LEVELS)
@pytest.mark.parametrize("kind", KINDS)
def test_ops_act_quant_matches_pallas(kind, levels, dtype):
    """ops.act_quant / act_quant_index: the Pallas kernel's f32 arithmetic
    (interpret mode on the JAX side)."""
    jx, tx = _inputs(levels * 11 + len(kind), dtype, kind, levels)
    got_y = ops.act_quant(tx, kind, levels)
    got_i = ops.act_quant_index(tx, kind, levels)
    assert got_y.dtype == tx.dtype and got_i.dtype == torch.int32
    n = _ties(kind, got_y, got_i, JO.act_quant(jx, kind, levels),
              JO.act_quant_index(jx, kind, levels),
              _level_bits(kind, levels, dtype, "kernel"))
    print(f"{kind} L={levels} {dtype}: {n} ties")


def test_the_two_forms_differ_in_bf16():
    """The reason the port keeps both forms: at bf16 the reference's
    act_apply and its Pallas kernel put some elements on other levels,
    and each port form reproduces its own side."""
    jx, tx = _inputs(5, "bfloat16", "relu6", 32, n=65536)
    apply_i = TA.act_index(TA.ActQuantConfig("relu6", 32), tx)
    kernel_i = ops.act_quant_index(tx, "relu6", 32)
    assert (apply_i != kernel_i).sum() > 0
    np.testing.assert_array_equal(
        apply_i.numpy(), np.asarray(JA.act_index(JA.ActQuantConfig("relu6",
                                                                   32), jx)))
    np.testing.assert_array_equal(
        kernel_i.numpy(), np.asarray(JO.act_quant_index(jx, "relu6", 32)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("levels", (2, 32))
def test_act_quant_gradient_matches_jax_grad(kind, levels):
    """The underlying function's derivative (paper §2.1), away from the
    kinks of relu6 (0, 6) and rtanh (0)."""
    rng = np.random.default_rng(levels + len(kind))
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x = x[(np.abs(x) > 1e-3) & (np.abs(x - 6.0) > 1e-3)]
    g = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JO.act_quant(a, kind, levels)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (ops.act_quant(tx, kind, levels) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("levels", LEVELS)
def test_act_levels_and_input_boundaries(kind, levels):
    jcfg, tcfg = JA.ActQuantConfig(kind, levels), TA.ActQuantConfig(kind,
                                                                     levels)
    # jnp.linspace runs under jit, where XLA folds the constants with its
    # own reassociations and FMAs: the port's levels (the formula of
    # jnp.linspace's source) may differ in the last bit
    lo, hi = jcfg.out_range
    np.testing.assert_allclose(TA.act_levels(tcfg).numpy(),
                               np.asarray(JA.act_levels(jcfg)), rtol=0,
                               atol=2.0 ** -23 * max(abs(lo), abs(hi)))
    np.testing.assert_array_equal(TA.act_input_boundaries(tcfg),
                                  JA.act_input_boundaries(jcfg))
    assert tcfg.step == jcfg.step and tcfg.out_range == jcfg.out_range


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels,lo,hi", [(32, 0.0, 1.0), (16, -1.0, 1.0),
                                          (255, -2.5, 4.0), (2, 0.0, 6.0)])
def test_quantize_input_matches(levels, lo, hi, dtype):
    jx, tx = _inputs(levels, dtype, "relu6", 16)
    np.testing.assert_array_equal(
        _bits(TA.quantize_input(tx, levels, lo, hi)),
        _bits(JA.quantize_input(jx, levels, lo, hi)))


def test_config_checks_and_continuous_path():
    with pytest.raises(ValueError, match="unbounded"):
        TA.ActQuantConfig("silu", 32)
    with pytest.raises(ValueError, match="levels"):
        TA.ActQuantConfig("tanh", 1)
    with pytest.raises(ValueError):
        TA.act_index(TA.ActQuantConfig("tanh", 0), torch.zeros(3))
    x = torch.linspace(-4, 8, 97)
    for kind in ("tanh", "relu6", "sigmoid", "rtanh", "relu", "silu"):
        got = TA.act_apply(TA.ActQuantConfig(kind, 0), x).numpy()
        want = np.asarray(JA.act_apply(JA.ActQuantConfig(kind, 0),
                                       jnp.asarray(x.numpy())))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_act_apply_refuses_grad_until_the_training_slice():
    x = torch.randn(8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="gradient"):
        TA.act_apply(TA.ActQuantConfig("relu6", 32), x)
    with torch.no_grad():
        TA.act_apply(TA.ActQuantConfig("relu6", 32), x * 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["silu", "gelu", "relu", "tanh", "sigmoid"])
def test_ffn_act_quantized_site_matches(kind, dtype):
    """The FFN site at levels 32: unbounded kinds become relu6, then
    act_apply — the arithmetic of the JAX model's forward."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 96)) * 4).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    want = JL.ffn_act(jx, kind, 32)
    got = TL.ffn_act(tx, kind, 32)
    bounded = {"silu": "relu6", "gelu": "relu6", "relu": "relu6"}.get(kind,
                                                                      kind)
    cfg = TA.ActQuantConfig(bounded, 32)
    _ties(bounded, got, TA.act_index(cfg, tx).reshape(-1).numpy(), want,
          np.asarray(JA.act_index(JA.ActQuantConfig(bounded, 32),
                                  jx)).reshape(-1),
          _level_bits(bounded, 32, dtype, "act_apply"))


def test_ffn_act_launch_counts_only_on_the_card():
    ops.reset_launch_counts()
    TL.ffn_act(torch.randn(4, 8), "silu", 32)
    ops.act_quant(torch.randn(5), "tanh", 32)
    assert ops.launch_counts()["act_quant"] == 0     # the plain CPU path


def test_act_quant_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        aq.act_quant_cuda(torch.zeros(4), "relu6", 32)
    with pytest.raises(ValueError):
        aq.act_quant_plain(torch.zeros(4), "silu", 32)
    with pytest.raises(ValueError):
        aq.act_quant_plain(torch.zeros(4), "relu6", 1)
