"""Port kernels (plain PyTorch versions) vs the JAX oracles and the Pallas
kernels in interpret mode; the CUDA kernels vs their plain versions on a GPU.

Inputs come from numpy seeds and go to both packages as numpy arrays.
lut accumulators must be bit-exact; codebook results agree within an f32
summation-order tolerance.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref as tref  # noqa: E402
from repro_torch.kernels import act_quant as aq  # noqa: E402
from repro_torch.kernels import codebook_matmul as cm  # noqa: E402
from repro_torch.kernels import kmeans1d as km  # noqa: E402
from repro_torch.kernels import lut_matmul as lm  # noqa: E402
from repro_torch.kernels import page_gather as pg  # noqa: E402
from repro_torch.kernels._common import canonical_idx  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def J():
    """The JAX side, imported here so that the CUDA test below also runs
    on a GPU machine without JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    from repro.kernels.codebook_matmul import codebook_matmul_pallas
    from repro.kernels.lut_matmul import lut_matmul_pallas
    return SimpleNamespace(jnp=jnp, ref=ref,
                           codebook_matmul_pallas=codebook_matmul_pallas,
                           lut_matmul_pallas=lut_matmul_pallas)


# the shapes of benchmarks/BENCH_kernels.json
BENCH = [(m, k, n) for m in (1, 8, 64) for k in (128, 256) for n in (128, 256)]
RAGGED = [(5, 37, 9), (130, 200, 260), (1, 512, 7)]


def _codebook_case(seed, m, k, n, W=256, idt=np.int8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    if idt == np.int8:            # ids ≥ 128 stored as negatives
        wi = rng.integers(-128, 128, (k, n)).astype(np.int8)
    else:
        wi = rng.integers(0, W, (k, n)).astype(idt)
    book = rng.standard_normal(W).astype(np.float32)
    return x, wi, book


def _cb_tol(k):
    # f32 sums of k terms in two orders: the repo's own bound
    # (tests/test_kernels.py) of 2e-5 relative, 2e-5·k absolute
    return dict(rtol=2e-5, atol=2e-5 * k)


def _canon(wi, W):
    w = wi.astype(np.int32)
    return np.where(w < 0, w + W, w)


@pytest.mark.parametrize("m,k,n", BENCH + RAGGED)
def test_codebook_plain_matches_pallas_and_ref(J, m, k, n):
    x, wi, book = _codebook_case(m * 1000 + k + n, m, k, n)
    got = ops.codebook_matmul(torch.from_numpy(x), torch.from_numpy(wi),
                              torch.from_numpy(book)).numpy()
    jx, jw, jb = (J.jnp.asarray(v) for v in (x, wi, book))
    pallas = np.asarray(J.codebook_matmul_pallas(jx, jw, jb, interpret=True))
    oracle = np.asarray(J.ref.codebook_matmul_ref(jx, jw, jb))
    np.testing.assert_allclose(got, pallas, **_cb_tol(k))
    np.testing.assert_allclose(got, oracle, **_cb_tol(k))


@pytest.mark.parametrize("idt,W", [(np.int16, 1000), (np.int32, 5000)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_codebook_id_and_x_dtypes(J, idt, W, xdt):
    x, wi, book = _codebook_case(7, 8, 256, 128, W=W, idt=idt)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    got = ops.codebook_matmul(tx, torch.from_numpy(wi),
                              torch.from_numpy(book)).numpy()
    jx = J.jnp.asarray(x).astype(getattr(J.jnp, xdt))
    want = np.asarray(J.ref.codebook_matmul_ref(jx, J.jnp.asarray(wi),
                                               J.jnp.asarray(book)))
    # bf16 x: the weights are rounded to bf16 first in both; products of
    # two bf16 values are exact in f32, so the f32 tolerance holds too
    np.testing.assert_allclose(got, want, **_cb_tol(256))


def test_torch_ref_matches_jax_ref(J):
    x, wi, book = _codebook_case(3, 8, 128, 256)
    np.testing.assert_allclose(
        tref.codebook_matmul_ref(torch.from_numpy(x), torch.from_numpy(wi),
                                 torch.from_numpy(book)).numpy(),
        np.asarray(J.ref.codebook_matmul_ref(
            *(J.jnp.asarray(v) for v in (x, wi, book)))),
        **_cb_tol(128))
    rng = np.random.default_rng(4)
    a = rng.integers(0, 33, (8, 128)).astype(np.int32)
    w = rng.integers(0, 257, (128, 64)).astype(np.int32)
    t = rng.integers(-(1 << 25), 1 << 25, (33, 257)).astype(np.int32)
    np.testing.assert_array_equal(
        tref.lut_matmul_ref(torch.from_numpy(a), torch.from_numpy(w),
                            torch.from_numpy(t)).numpy(),
        np.asarray(J.ref.lut_matmul_ref(
            *(J.jnp.asarray(v) for v in (a, w, t)))))


def _lut_case(seed, m, k, n, R=4096, C=256, mag=1000, idt=np.int8):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, R, (m, k)).astype(np.int32)
    if idt == np.int8:
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    else:
        w = rng.integers(0, C, (k, n)).astype(idt)
    t = rng.integers(-mag, mag, (R, C)).astype(np.int32)
    return a, w, t


@pytest.mark.parametrize("m,k,n", BENCH + RAGGED)
def test_lut_plain_bit_exact_vs_pallas_and_ref(J, m, k, n):
    a, w, t = _lut_case(m * 1000 + k + n, m, k, n)
    got = ops.lut_matmul(torch.from_numpy(a), torch.from_numpy(w),
                         torch.from_numpy(t)).numpy()
    ja, jw, jt = (J.jnp.asarray(v) for v in (a, w, t))
    pallas = np.asarray(J.lut_matmul_pallas(ja, jw, jt, interpret=True))
    # the oracle does raw flat addressing: hand it canonical ids
    oracle = np.asarray(J.ref.lut_matmul_ref(
        ja, J.jnp.asarray(_canon(w, t.shape[1])), jt))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("k", [40, 257])
def test_lut_overflow_adjacent(J, k):
    """|T| up to 1 << 25: k = 40 stays inside int32 (as in
    tests/test_kernels.py), k = 257 wraps — both must match bit for bit."""
    a, w, t = _lut_case(11 + k, 9, k, 33, R=9, C=65, mag=1 << 25,
                        idt=np.int32)
    got = lm.lut_matmul_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(t)).numpy()
    ja, jw, jt = (J.jnp.asarray(v) for v in (a, w, t))
    pallas = np.asarray(J.lut_matmul_pallas(ja, jw, jt, bm=8, bn=16, bk=16,
                                            interpret=True))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(
        got, np.asarray(J.ref.lut_matmul_ref(ja, jw, jt)))


def test_cuda_wrappers_refuse_cpu_tensors():
    x, wi, book = _codebook_case(0, 2, 16, 8)
    with pytest.raises(ValueError):
        cm.codebook_matmul_cuda(torch.from_numpy(x), torch.from_numpy(wi),
                                torch.from_numpy(book))
    a, w, t = _lut_case(0, 2, 16, 8, R=5, C=7, idt=np.int32)
    with pytest.raises(ValueError):
        lm.lut_matmul_cuda(torch.from_numpy(a), torch.from_numpy(w),
                           torch.from_numpy(t))


def test_launch_counters_start_and_reset():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"codebook_matmul": 0, "lut_matmul": 0,
                                   "page_gather": 0, "act_quant": 0,
                                   "kmeans_assign": 0}
    x, wi, book = _codebook_case(0, 2, 16, 8)
    ops.codebook_matmul(torch.from_numpy(x), torch.from_numpy(wi),
                        torch.from_numpy(book))
    # the plain CPU path is not a launch
    assert ops.launch_counts()["codebook_matmul"] == 0


@pytest.mark.parametrize("k", [100, 2048, 6144])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_codebook_parity_tolerance(k, xdt):
    """The limit the CUDA kernel is held to holds two f32 summation orders
    together (the plain matmul and a sequential f32 loop) and fails the
    plain version that skips rounding weights to x's dtype."""
    x, wi, book = _codebook_case(k, 8, k, 256, W=1000, idt=np.int16)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    twi, tbook = torch.from_numpy(wi), torch.from_numpy(book * 0.05)
    plain = cm.codebook_matmul_plain(tx, twi, tbook)
    tol = cm.parity_tolerance(tx, twi, tbook)
    w = tbook[twi.long()].to(tx.dtype).float()
    seq = torch.zeros_like(plain)
    for kk in range(k):
        seq = torch.addcmul(seq, tx[:, kk, None].float(), w[None, kk, :])
    assert bool(((seq - plain).abs() <= tol).all())
    if xdt == "bfloat16":
        no_cast = tx.float() @ tbook[twi.long()]
        assert not bool(((no_cast - plain).abs() <= tol).all())


# every row count the serving path gives the kernels (decode at 4 slots,
# one-request prefills at buckets 8..64, four-request prefills of 4 × 64)
# at the four (K, N) sites of qwen3-1.7b, and a ragged shape
CUDA_SHAPES = [(m, k, n) for m in (1, 4, 8, 16, 32, 64, 256)
               for k, n in ((2048, 2048), (2048, 1024), (2048, 6144),
                            (6144, 2048))] + [(3, 100, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES)
def test_cuda_kernels_match_plain(m, k, n):
    """Needs a GPU and nvcc: the hand-written kernels against their plain
    versions on the card (run by ``pytest -m cuda`` on the GPU machine)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for idt, W in ((np.int8, 256), (np.int16, 1000)):
        x, wi, book = _codebook_case(1, m, k, n, W=W, idt=idt)
        twi, tbook = (torch.from_numpy(v).to(dev) for v in (wi, book))
        for xdt in (torch.float32, torch.bfloat16):
            tx = torch.from_numpy(x).to(dev, xdt)
            got = cm.codebook_matmul_cuda(tx, twi, tbook)
            want = cm.codebook_matmul_plain(tx, twi, tbook)
            tol = cm.parity_tolerance(tx, twi, tbook)
            assert bool(((got - want).abs() <= tol).all())
            if xdt == torch.bfloat16:     # the limit catches a missing cast
                no_cast = tx.float() @ tbook[canonical_idx(twi, W).long()]
                assert not bool(((no_cast - want).abs() <= tol).all())
        a, w, t = _lut_case(2, m, k, n, C=W, idt=idt)
        args = [torch.from_numpy(v).to(dev) for v in (a, w, t)]
        assert torch.equal(lm.lut_matmul_cuda(*args),
                           lm.lut_matmul_plain(*args))


# the page shapes of the paged serving path (int8 and bf16 K/V pages of
# qwen3-1.7b, bf16 scale pages, f32 pages) and one of 15 bytes, at the
# decode (4 slots × 32 pages) and prefill-chunk (1 × 32) page tables
PAGE_CASES = [((16, 8, 128), "int8"), ((16, 8, 128), "bfloat16"),
              ((16, 8), "bfloat16"), ((16, 8, 128), "float32"),
              ((3, 5), "int8")]


@pytest.mark.cuda
@pytest.mark.parametrize("page_shape,dtype", PAGE_CASES)
@pytest.mark.parametrize("B,P", [(4, 32), (1, 32)])
def test_cuda_page_gather_matches_plain(page_shape, dtype, B, P):
    """Needs a GPU and nvcc: the page gather against its plain version,
    bit for bit, on one layer's view of a pool, with ids that include 0,
    negatives and ids ≥ n_pages."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    n_pages = 129
    g = torch.Generator(device=dev).manual_seed(B * 1000 + P)
    full = torch.randint(-128, 128, (3, n_pages) + page_shape, generator=g,
                         device=dev).to(getattr(torch, dtype))
    pool = full[1]
    pt = torch.randint(-4, n_pages + 5, (B, P), generator=g, device=dev,
                       dtype=torch.int32)
    pt[0, :3] = torch.tensor([0, -1, n_pages], device=dev)
    for ids in (pt, pt.long()):
        got = pg.page_gather_cuda(pool, ids)
        want = pg.page_gather_plain(pool, ids)
        torch.cuda.synchronize()
        assert got.dtype == pool.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def test_act_quant_parity_ties_rules():
    """The rule the CUDA act_quant is held to: ties one level apart are
    counted; two levels apart, a relu6 tie or an output off the ties
    raises."""
    x = torch.linspace(-3, 3, 1001)
    y, i = aq.act_quant_plain(x, "tanh", 32)
    assert aq.parity_ties(y, i, y.clone(), i.clone(), "tanh", 32) == 0
    i2, y2 = i.clone(), y.clone()
    i2[500] += 1
    y2[500] = -1.0 + float(i2[500]) * (2.0 / 31)     # on its own level
    assert aq.parity_ties(y2, i2, y, i, "tanh", 32) == 1
    i2[500] += 1
    with pytest.raises(AssertionError):
        aq.parity_ties(y2, i2, y, i, "tanh", 32)
    y3 = y.clone()
    y3[10] = float(y3[10]) + 1e-3
    with pytest.raises(AssertionError):
        aq.parity_ties(y3, i, y, i, "tanh", 32)
    yr, ir = aq.act_quant_plain(x, "relu6", 32)
    ir2 = ir.clone()
    ir2[900] -= 1
    with pytest.raises(AssertionError):
        aq.parity_ties(yr, ir2, yr, ir, "relu6", 32)


# act_quant at every FFN row count the serving paths give it (× 6144),
# plus odd sizes: 1 element and sizes that are no multiple of a block
ACT_SHAPES = [(m, 6144) for m in (1, 4, 8, 16, 32, 64, 128, 256)] + [
    (1,), (1000003,), (3, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ACT_SHAPES)
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_cuda_act_quant_matches_plain(shape, xdt):
    """Needs a GPU and nvcc: both forms, every kind, |A| 2/32/256, against
    the plain version on the card — bit-equal but for counted ties."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    g = torch.Generator(device="cuda").manual_seed(len(shape) + shape[0])
    x = (torch.randn(shape, generator=g, device="cuda") * 3).to(
        getattr(torch, xdt))
    for kind in aq.KINDS:
        for levels in (2, 32, 256):
            for form in aq.FORMS:
                got = aq.act_quant_cuda(x, kind, levels, form=form)
                want = aq.act_quant_plain(x, kind, levels, form=form)
                torch.cuda.synchronize()
                assert got[0].dtype == x.dtype and got[0].shape == x.shape
                aq.parity_ties(*got, *want, kind, levels)
                y_only, none = aq.act_quant_cuda(x, kind, levels, form=form,
                                                 with_index=False)
                assert none is None and torch.equal(y_only, got[0])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 1000, 4096])
@pytest.mark.parametrize("n", [1, 4097, 10 ** 7])
def test_cuda_kmeans_assign_matches_plain(k, n):
    """Needs a GPU and nvcc: indices and counts exact, each version's sums
    of the f64 sums within their limit (the kernel's ``sums_tolerance``,
    the plain version's worst-case ``sums_bound``), values
    on midpoints and a duplicate center pair included, and two runs
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    rng = np.random.default_rng(k + n)
    c = np.sort(rng.laplace(0, 0.05, k)).astype(np.float32)
    if k > 3:
        c[2] = c[1]
    v = rng.laplace(0, 0.05, n).astype(np.float32)
    special = np.concatenate([(c[:-1] + c[1:]) / np.float32(2), c])
    v[:min(n // 4, special.size)] = special[:min(n // 4, special.size)]
    tv, tc = torch.from_numpy(v).cuda(), torch.from_numpy(c).cuda()
    got = km.kmeans_assign_cuda(tv, tc)
    again = km.kmeans_assign_cuda(tv, tc)
    want = km.kmeans_assign_plain(tv, tc)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    exact, abs_sum, n_c = km.exact_sums(tv, want[0], k)
    for sums, limit in ((got[1], km.sums_tolerance(abs_sum, n_c, n)),
                        (want[1], km.sums_bound(abs_sum, n_c))):
        assert bool(((sums.double() - exact).abs() <= limit).all())
