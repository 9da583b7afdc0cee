"""The port's §4 integer engine (``repro_torch.core.lut``,
``repro_torch.core.fixedpoint``) against the JAX package's, computed live
in the same process: tables, scale, input indices, accumulators, the shift
and activation-table lookup and a whole MLP, all exact.  The contracts are
those of ``tests/test_lut_engine.py`` and
``tests/test_papernets_integration.py::test_integer_engine_end_to_end``.

The JAX side is imported through the ``R`` fixture only, so that the
``cuda`` test at the end also runs on a GPU machine without JAX.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import from_jax_lut_tables  # noqa: E402
from repro_torch.core import fixedpoint as TF  # noqa: E402
from repro_torch.core import lut as TL  # noqa: E402
from repro_torch.core.activations import ActQuantConfig as TA  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import _common  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def R():
    """The reference side: jax, jnp and the JAX package's modules."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import clustering, fixedpoint, lut
    from repro.core.activations import ActQuantConfig
    from repro.data import synthetic
    return SimpleNamespace(jax=jax, jnp=jnp, lut=lut, fp=fixedpoint,
                           clustering=clustering, A=ActQuantConfig,
                           data=synthetic)


def _book(seed: int, n: int = 1000, scale: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.standard_normal(n) * scale)


def _tables(R, kind, levels, entries=4096, acc_bits=32, fan_in=785,
            book=None):
    """(reference LutTables, the port's LutTables built the same way)."""
    book = _book(1) if book is None else book
    jt = R.lut.build_tables(book, R.lut.LutConfig(
        R.A(kind, levels), table_entries=entries, acc_bits=acc_bits),
        fan_in=fan_in)
    tt = TL.build_tables(book, TL.LutConfig(
        TA(kind, levels), table_entries=entries, acc_bits=acc_bits),
        fan_in=fan_in)
    return jt, tt


def _assert_tables_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, (f.name, a, b)


@pytest.mark.parametrize("fan_in", [4, 785, 100000])
@pytest.mark.parametrize("acc_bits", [32, 64])
@pytest.mark.parametrize("entries", [0, 128, 4096])
@pytest.mark.parametrize("levels", [8, 16, 32])
@pytest.mark.parametrize("kind", ["tanh", "relu6", "sigmoid"])
def test_build_tables_equal(R, kind, levels, entries, acc_bits, fan_in):
    """Every field equal (arrays exact, with their dtypes), or the same
    ValueError from both."""
    book = _book(levels + entries + fan_in)
    jcfg = R.lut.LutConfig(R.A(kind, levels), table_entries=entries,
                           acc_bits=acc_bits)
    tcfg = TL.LutConfig(TA(kind, levels), table_entries=entries,
                        acc_bits=acc_bits)
    try:
        want = R.lut.build_tables(book, jcfg, fan_in)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TL.build_tables(book, tcfg, fan_in)
        assert str(got.value) == str(e)
        return
    got = TL.build_tables(book, tcfg, fan_in)
    _assert_tables_equal(got, want)
    assert got.n_levels == want.n_levels and got.n_weights == want.n_weights
    acc = np.array([-(7 << got.s) - 3, -1, 0, 5, 1 << 30], np.int64)
    np.testing.assert_array_equal(got.decode(acc), want.decode(acc))
    assert got.decode(acc).dtype == np.float64
    np.testing.assert_array_equal(got.decode(torch.from_numpy(acc)),
                                  want.decode(acc))


@pytest.mark.parametrize("case", [
    (np.linspace(-2, 2, 1000), 1.0, 6.0 / 31, 50177, 32),
    (np.linspace(-1, 1, 16), 1.0, 0.05, 4, 32),
    (np.array([0.3]), 6.0, 0.2, 100000, 64),
    (np.array([]), 1.0, 0.01, 10, 32),
    (np.array([1e5]), 1.0, 1e-6, 10 ** 9, 32),       # raises on both sides
])
def test_choose_scale_equal(R, case):
    book, lv, dx, fan_in, bits = case
    try:
        want = R.lut.choose_scale(book, lv, dx, fan_in, bits)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            TL.choose_scale(book, lv, dx, fan_in, bits)
        assert str(got.value) == str(e)
        return
    assert TL.choose_scale(book, lv, dx, fan_in, bits) == want


@pytest.mark.parametrize("kind,levels", [("tanh", 32), ("tanh", 8),
                                         ("relu6", 32), ("sigmoid", 16)])
def test_input_to_indices_exact(R, kind, levels):
    """Values on every half-step (round half to even), near them, and
    outside the range."""
    act = TA(kind, levels)
    lo, hi = act.out_range
    halves = lo + (np.arange(-3, levels + 3) + 0.5) * act.step
    rng = np.random.default_rng(levels)
    x = np.concatenate([halves, np.nextafter(halves, np.inf),
                        np.nextafter(halves, -np.inf),
                        rng.uniform(lo - 2, hi + 2, 500),
                        [lo, hi, lo - 100, hi + 100]]).astype(np.float32)
    want = np.asarray(R.fp.input_to_indices(R.jnp.asarray(x),
                                            R.A(kind, levels)))
    got = TF.input_to_indices(torch.from_numpy(x), act)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _operands(seed, batch, K, N, tabs, bias):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, tabs.bias_row + 1, batch + (K,)).astype(np.int32)
    w = rng.integers(0, tabs.identity_col + 1, (K, N)).astype(np.int32)
    b = rng.integers(0, tabs.identity_col, (N,)).astype(np.int32) \
        if bias else None
    return a, w, b


@pytest.mark.parametrize("wdt", [torch.int16, torch.int32])
@pytest.mark.parametrize("batch", [(5,), (2, 3)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("K", [10, 785, 1000])
def test_int_linear_int32_exact(R, K, bias, batch, wdt):
    """K not a multiple of the reference's 512-deep chunks, batch dims,
    int16 and int32 ids; the sums near the int32 bound so that some wrap."""
    jt, _ = _tables(R, "tanh", 32)
    # the reference's table with its entries scaled up: sums of a few
    # thousand terms pass 2^31, and both packages must wrap alike
    big = dataclasses.replace(jt, mult=(jt.mult.astype(np.int64) << 12)
                              .astype(np.int32)) if K == 1000 else jt
    a, w, b = _operands(K + len(batch), batch, K, 7, big, bias)
    jb = None if b is None else R.jnp.asarray(b)
    want = np.asarray(R.fp.int_linear(R.jnp.asarray(a), R.jnp.asarray(w), jb,
                                      big))
    tt = from_jax_lut_tables(dataclasses.asdict(big))
    tb = None if b is None else torch.from_numpy(b)
    got = TF.int_linear(torch.from_numpy(a), torch.from_numpy(w).to(wdt), tb,
                        tt)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("K", [10, 785])
def test_int_linear_int64_exact(R, K, bias):
    """acc_bits=64: the plain int64 gather, against the reference under
    ``jax.enable_x64``, and against an exact numpy sum."""
    jt, tt = _tables(R, "tanh", 32, acc_bits=64)
    a, w, b = _operands(K, (4,), K, 10, jt, bias)
    with R.jax.enable_x64(True):
        want = np.asarray(R.fp.int_linear(
            R.jnp.asarray(a), R.jnp.asarray(w),
            None if b is None else R.jnp.asarray(b), jt))
    got = TF.int_linear(torch.from_numpy(a), torch.from_numpy(w),
                        None if b is None else torch.from_numpy(b), tt)
    assert want.dtype == np.int64 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    exact = jt.mult[a[:, :, None], w[None]].sum(1)
    if b is not None:
        exact = exact + jt.mult[jt.bias_row, b]
    np.testing.assert_array_equal(got.numpy(), exact)


def test_acc_to_act_index_exact(R):
    """``test_shift_equals_floor_division``'s accumulators, random int32
    accumulators (negatives included) on a tanh table, and random int64
    accumulators, whose shifted bins wrap in the cast to int32."""
    jt = R.lut.build_tables(np.linspace(-1, 1, 16),
                            R.lut.LutConfig(act=R.A("tanh", 8)), fan_in=4)
    tt = from_jax_lut_tables(dataclasses.asdict(jt))
    s = jt.s
    accs = np.array([-(5 << s) - 3, -1, 0, 7, (3 << s) + 1], np.int32)
    rng = np.random.default_rng(3)
    cases = [accs, rng.integers(-(1 << 31), 1 << 31, 4000).astype(np.int32),
             (rng.integers(-64, 64, 1000) << s).astype(np.int32)]
    j32, _ = _tables(R, "tanh", 32)
    t32 = from_jax_lut_tables(dataclasses.asdict(j32))
    for tabs_j, tabs_t in ((jt, tt), (j32, t32)):
        for acc in cases:
            want = np.asarray(R.fp.acc_to_act_index(R.jnp.asarray(acc),
                                                    tabs_j))
            got = TF.acc_to_act_index(torch.from_numpy(acc), tabs_t)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    j64, t64 = _tables(R, "tanh", 32, acc_bits=64)
    acc = np.concatenate([
        rng.integers(-(1 << 62), 1 << 62, 4000),
        (rng.integers(-4096, 4096, 1000) << j64.s),
        np.array([-1, 0, 1, (1 << 63) - 1, -(1 << 63)])]).astype(np.int64)
    with R.jax.enable_x64(True):
        want = np.asarray(R.fp.acc_to_act_index(R.jnp.asarray(acc), j64))
    np.testing.assert_array_equal(
        TF.acc_to_act_index(torch.from_numpy(acc), t64).numpy(), want)


@pytest.fixture(scope="module")
def mlp_case(R):
    """A 784→[24]→10 tanh net with numpy weights from a seed, snapped by
    the reference's clustering to a k-means |W| = 128 codebook; the tanh
    |A| = 32 tables at fan-in 785; pseudo-MNIST inputs through tanh and
    ``input_to_indices``."""
    rng = np.random.default_rng(11)
    W1 = (rng.standard_normal((784, 24)) * 784 ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(24) * 0.1).astype(np.float32)
    W2 = (rng.standard_normal((24, 10)) * 24 ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(10) * 0.1).astype(np.float32)
    jnp = R.jnp
    book = R.clustering.kmeans1d(jnp.concatenate(
        [jnp.asarray(t).ravel() for t in (W1, b1, W2, b2)]), 128)
    idx = [np.array(R.clustering.assign_to_centers(jnp.asarray(t), book))
           for t in (W1, b1, W2, b2)]
    act = R.A("tanh", 32)
    jt = R.lut.build_tables(np.asarray(book), R.lut.LutConfig(
        act=act, table_entries=4096), fan_in=785)
    # tanh is the reference's (XLA's tanh and torch's may differ in the
    # last bit, and a half-step tie then rounds apart): both packages'
    # input_to_indices see the same values
    xt = jnp.tanh(R.data.pseudo_mnist_batch(2000, 64)["x"])
    xi = np.asarray(R.fp.input_to_indices(xt, act))
    return SimpleNamespace(idx=idx, jt=jt, xi=xi, xt=np.array(xt), act=act)


@pytest.mark.parametrize("final_linear", [True, False])
def test_int_mlp_forward_exact(R, mlp_case, final_linear):
    c = mlp_case
    jl = [(R.jnp.asarray(c.idx[0]), R.jnp.asarray(c.idx[1])),
          (R.jnp.asarray(c.idx[2]), R.jnp.asarray(c.idx[3]))]
    want = np.asarray(R.fp.int_mlp_forward(jl, R.jnp.asarray(c.xi), c.jt,
                                           final_linear))
    tt = from_jax_lut_tables(dataclasses.asdict(c.jt))
    xi = TF.input_to_indices(torch.from_numpy(c.xt), TA("tanh", 32))
    np.testing.assert_array_equal(xi.numpy(), c.xi)
    tl = [(torch.from_numpy(c.idx[0]).to(torch.int16),
           torch.from_numpy(c.idx[1])),
          (torch.from_numpy(c.idx[2]), torch.from_numpy(c.idx[3]))]
    got = TF.int_mlp_forward(tl, xi, tt, final_linear)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if final_linear:
        np.testing.assert_array_equal(tt.decode(got), c.jt.decode(want))


def test_bridge_lut_tables_round_trip(R):
    for acc_bits in (32, 64):
        jt, tt = _tables(R, "relu6", 32, acc_bits=acc_bits, fan_in=50177)
        got = from_jax_lut_tables(dataclasses.asdict(jt))
        _assert_tables_equal(got, jt)
        _assert_tables_equal(tt, jt)
        assert got.mult.shape == (33, 1001) and got.s == jt.s
        back = from_jax_lut_tables(dataclasses.asdict(got))
        _assert_tables_equal(back, jt)


def test_section4_table_rows_are_unaligned():
    """The §4 table of |A| = 32, |W| = 1000 has rows of 1001 int32 (4004
    bytes), off 16-byte boundaries: the lut kernel plans the L2 route for
    it (its smem route would copy the rows word by word), and either route
    can be forced."""
    tabs = TL.build_tables(_book(2), TL.LutConfig(TA("tanh", 32),
                                                  table_entries=4096), 785)
    mult = torch.from_numpy(tabs.mult)
    assert tuple(mult.shape) == (33, 1001) and tabs.s == 11
    assert tabs.zero_offset == 2048 and tabs.act_table.shape == (4097,)
    assert not _common.is_aligned(mult, mult.shape[1])
    for M, K, N in ((256, 784, 128), (32, 50176, 1024), (32, 1024, 1000)):
        kw = dict(n_cols=1001, idx_bytes=2, sms=132)
        assert _common.lut_plan(M, K, N, **kw).route == "l2"
        assert _common.lut_plan(M, K, N, **{**kw, "n_cols": 1000}
                                ).route == "smem"
        for route in ("smem", "l2"):
            plan = _common.lut_plan(M, K, N, **kw, route=route)
            assert plan.route == route
            _common.check_plan(plan, K, {route: True}, 1 << 30)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(256, 784, 128), (256, 128, 10),
                                   (32, 4096, 1024), (5, 1001, 1000)])
def test_cuda_int_linear_matches_plain(M, K, N):
    """Needs a GPU and nvcc: ``int_linear`` on the §4 table (33 × 1001,
    unaligned rows) on the card, on its planned route (L2), against the
    same call on CPU tensors, and ``lut_matmul`` on that table on each
    route forced against its plain version, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    tabs = TL.build_tables(_book(3), TL.LutConfig(TA("tanh", 32),
                                                  table_entries=4096), K + 1)
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(0, 33, (M, K)).astype(np.int32))
    w = torch.from_numpy(rng.integers(0, 1000, (K, N)).astype(np.int16))
    b = torch.from_numpy(rng.integers(0, 1000, (N,)).astype(np.int32))
    want = TF.int_linear(a, w, b, tabs)
    lm.lut_matmul_cuda.launches = 0
    got = TF.int_linear(a.to(dev), w.to(dev), b.to(dev), tabs)
    assert lm.lut_matmul_cuda.launches == 1
    assert torch.equal(got.cpu(), want)
    mult = torch.from_numpy(tabs.mult).to(dev)
    ad, wd = a.to(dev), w.to(dev)
    assert lm.plan_for(ad, wd, mult).route == "l2"
    plain = lm.lut_matmul_plain(ad, wd, mult)
    for route in ("smem", "l2"):
        plan = _common.lut_plan(M, K, N, n_cols=1001, idx_bytes=2,
                                sms=_common.sm_count(dev), route=route)
        assert torch.equal(lm.lut_matmul_cuda(ad, wd, mult, plan=plan), plain)
