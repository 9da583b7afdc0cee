"""The port's gradients against ``jax.grad`` of the JAX package, computed
live from numpy seeds: ``act_apply`` (every kind at |A| 2 and 32, f32 and
bf16, at the ties of ``clip`` and ``maximum`` too), ``act_apply`` with its
multiplier, ``ops.act_quant`` (``_aq_bwd``: 0 at the corners),
``codebook_matmul`` (``_cm_bwd``), ``flash_attention`` (the reference's
flash backward, causal and windowed), ``quantize_input`` (straight
through); and the kernels the reference gives no gradient refuse an
operand that requires one.

relu6's derivative is a piecewise constant and must be equal, 0.5 at
``act_apply``'s ties included; rtanh's is 0 below 0 and 0.5 at 0 exactly
(and 1 − tanh² above).  tanh's, sigmoid's and rtanh's run through each
side's own ``tanh``/``exp``, an ulp apart: within 1e-6 in f32 (for a
gradient of 1 an element) and one bf16 ulp of 1 (2⁻⁸) in bf16, where
XLA's bf16 ``tanh`` sits up to an ulp from the correctly rounded value
that PyTorch's gives (tanh(−0.2139) = −0.2129 against −0.2109).  The rest
within 1e-5 of each leaf's largest |g|.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import activations as JA  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro.models import attention as JAT  # noqa: E402
from repro_torch.core import activations as TA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TAT  # noqa: E402

torch.set_num_threads(2)

KINDS = ("tanh", "relu6", "sigmoid", "rtanh")
DTYPES = ("float32", "bfloat16")
TIES = [0.0, -0.0, 6.0, 7.0, -1.0, 1e-30, 3.0]


def _x(seed, dtype, n=4096):
    """N(0, 9) values, the level boundaries of |A| = 32 and the corners."""
    rng = np.random.default_rng(seed)
    b = TA.act_input_boundaries(TA.ActQuantConfig("tanh", 32))
    x = np.concatenate([rng.standard_normal(n) * 3, b[np.isfinite(b)],
                        TIES]).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


BF16_ULP_OF_1 = 2.0 ** -8


def _assert_smooth(got, want, dtype, scale=1.0):
    """Within 1e-6 (f32) or one bf16 ulp of 1 (bf16), times ``scale``
    (the multiplier's magnitude where the gradient carries one)."""
    got, want = _f32(got), _f32(want)
    tol = (1e-6 if dtype == "float32" else BF16_ULP_OF_1) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("levels", (2, 32))
@pytest.mark.parametrize("kind", KINDS)
def test_act_apply_gradient_matches_jax_grad(kind, levels, dtype):
    jx, tx = _x(len(kind) + levels, dtype)
    cfg_j, cfg_t = JA.ActQuantConfig(kind, levels), TA.ActQuantConfig(kind,
                                                                      levels)
    want = jax.grad(lambda a: jnp.sum(JA.act_apply(cfg_j, a)))(jx)
    tx.requires_grad_(True)
    TA.act_apply(cfg_t, tx).sum().backward()
    assert tx.grad.dtype == tx.dtype
    if kind == "relu6":
        np.testing.assert_array_equal(_f32(tx.grad), _f32(want))
    else:
        _assert_smooth(tx.grad, want, dtype)
    at = {v: _f32(tx.grad)[i - len(TIES)] for i, v in enumerate(TIES)}
    if kind == "relu6":      # half the gradient at the corners of clip
        assert at[0.0] == at[-0.0] == at[6.0] == 0.5 and at[7.0] == 0.0
    if kind == "rtanh":      # and of maximum(tanh(x), 0)
        assert at[0.0] == 0.5 and at[-1.0] == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_act_apply_with_mul_gradients_match(kind, dtype):
    """act_apply(x, mul=up) against the reference's ``act_apply(x) * up``:
    d up is the emitted level (equal but where the two sides' forwards
    part at a level-boundary tie: one level apart, at an input within
    1e-6 of a boundary, counted), d x the underlying derivative times up
    (in bf16 within two ulps of up: f′ an ulp of 1 apart, as above, and
    g·up rounded first)."""
    jx, tx = _x(7 + len(kind), dtype)
    rng = np.random.default_rng(11)
    up = rng.standard_normal(tx.shape).astype(np.float32)
    ju = jnp.asarray(up).astype(getattr(jnp, dtype))
    tu = torch.from_numpy(np.array(ju.astype(jnp.float32))).to(tx.dtype)
    cfg_j, cfg_t = JA.ActQuantConfig(kind, 32), TA.ActQuantConfig(kind, 32)
    want_x, want_u = jax.grad(
        lambda a, u: jnp.sum(JA.act_apply(cfg_j, a) * u), argnums=(0, 1))(
            jx, ju)
    tx.requires_grad_(True)
    tu.requires_grad_(True)
    TA.act_apply(cfg_t, tx, mul=tu).sum().backward()
    du_got, du_want = _f32(tu.grad), _f32(want_u)
    ties = du_got != du_want
    if kind == "relu6":
        assert not ties.any()
    assert (np.abs(du_got - du_want)[ties]
            <= cfg_t.step * 1.01).all()    # one level apart
    edges = TA.act_input_boundaries(cfg_t)
    xs = _f32(tx)[ties]
    assert (np.abs(xs[:, None] - edges[None]).min(axis=1)
            <= 1e-6 * np.maximum(1.0, np.abs(xs))).all()
    print(f"{kind} {dtype}: {int(ties.sum())} level-boundary ties")
    if kind == "relu6":
        np.testing.assert_array_equal(_f32(tx.grad), _f32(want_x))
    elif dtype == "float32":
        _assert_smooth(tx.grad, want_x, dtype, scale=np.abs(up).max())
    else:
        np.testing.assert_array_less(
            np.abs(_f32(tx.grad) - _f32(want_x)),
            2.0 ** -6 * np.abs(_f32(tu)) + 1e-30)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_act_quant_gradient_is_aq_bwd_at_the_corners(kind, dtype):
    """``ops.act_quant`` keeps ``_aq_bwd``'s gradient: 0 at relu6's 0 and
    6 and at rtanh's 0, where ``act_apply``'s is 0.5."""
    x = np.array([0.0, -0.0, 6.0, 7.0, -1.0, 0.5, 2.0, -3.0], np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    want = jax.grad(lambda a: jnp.sum(JO.act_quant(a, kind, 32)))(jx)
    ops.act_quant(tx, kind, 32).sum().backward()
    if kind == "relu6":
        np.testing.assert_array_equal(_f32(tx.grad), _f32(want))
    else:
        _assert_smooth(tx.grad, want, dtype)
    if kind in ("relu6", "rtanh"):
        assert _f32(tx.grad)[0] == _f32(tx.grad)[1] == 0.0


@pytest.mark.parametrize("ids", ["int32", "int8"])
def test_codebook_matmul_gradients_match_cm_bwd(ids):
    """The twin of ``tests/test_kernels.py::test_codebook_matmul_grads``
    against the reference's ``_cm_bwd``; int8 ids of a 200-entry book
    store ids ≥ 128 as negatives, which the forward and dx wrap and the
    codebook's segment sum drops, on both sides."""
    rng = np.random.default_rng(5)
    n_book = 32 if ids == "int32" else 200
    x = rng.standard_normal((8, 16)).astype(np.float32)
    wi = rng.integers(0, n_book, (16, 12)).astype(getattr(np, ids))
    book = rng.standard_normal(n_book).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(JO.codebook_matmul(
        a, jnp.asarray(wi), b) ** 2), argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(book))
    tx = torch.from_numpy(x).requires_grad_(True)
    tb = torch.from_numpy(book).requires_grad_(True)
    (ops.codebook_matmul(tx, torch.from_numpy(wi), tb) ** 2).sum().backward()
    for got, w in zip((tx.grad, tb.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    if ids == "int8":
        dropped = np.setdiff1d(np.arange(128, n_book),
                               (wi.astype(np.int64) % 256)[wi >= 0])
        assert (tb.grad.numpy()[dropped] == 0).all()


@pytest.mark.parametrize("case", ["causal", "window", "ragged"])
def test_flash_attention_gradients_match(case):
    """The reference's custom-vjp flash backward: dq, dk, dv within 1e-5 of
    each's largest |g|; ``ragged`` ends on a short KV block."""
    rng = np.random.default_rng(len(case))
    B, Lq, KV, G, hd = 2, 40, 2, 2, 16
    window = 12 if case == "window" else 0
    blk = 16 if case != "ragged" else 24
    q = rng.standard_normal((B, Lq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Lq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Lq, KV, hd)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)

    def jfn(a, b, c):
        return jnp.sum(JAT.flash_attention(a, b, c, causal=True,
                                           window=window, kv_block=blk)
                       * jnp.asarray(g))
    want = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = TAT.flash_attention(tq, tk, tv, causal=True, window=window,
                              kv_block=blk)
    (out * torch.from_numpy(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    with torch.no_grad():     # the forward is the same with or without grad
        torch.testing.assert_close(
            TAT.flash_attention(tq, tk, tv, causal=True, window=window,
                                kv_block=blk), out.detach(), rtol=0, atol=0)


def test_quantize_input_is_straight_through():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(1000) * 2).astype(np.float32)
    g = rng.standard_normal(1000).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(JA.quantize_input(a, 32, -1.0, 1.0)
                                      * jnp.asarray(g)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = TA.quantize_input(tx, 32, -1.0, 1.0)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        y.detach().numpy(),
        np.asarray(JA.quantize_input(jnp.asarray(x), 32, -1.0, 1.0)))


def test_kernels_without_a_gradient_refuse_one():
    """codebook_swiglu, lut_matmul, the page gathers and the k-means ops
    have no gradient in the reference: an operand that requires one is
    refused, and the same call runs under ``torch.no_grad``."""
    x = torch.randn(4, 8, requires_grad=True)
    ids = torch.randint(0, 16, (8, 6), dtype=torch.int32)
    book = torch.randn(16, requires_grad=True)
    table = torch.randn(3, 5, requires_grad=True)
    calls = {
        "codebook_swiglu": lambda: ops.codebook_swiglu(x, ids, book, ids,
                                                       book, "relu6", 32),
        "lut_matmul": lambda: ops.lut_matmul(
            torch.zeros(2, 3, dtype=torch.int32),
            torch.zeros(3, 4, dtype=torch.int32), table),
        "gather_pages": lambda: ops.gather_pages(
            table.reshape(3, 5, 1), torch.zeros(1, 2, dtype=torch.int32)),
        "kmeans_assign": lambda: ops.kmeans_assign(x, torch.sort(
            torch.randn(4)).values),
        "kmeans_stats": lambda: ops.kmeans_stats(x, torch.sort(
            torch.randn(4)).values),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no gradient"):
            call()
        with torch.no_grad():
            call()
