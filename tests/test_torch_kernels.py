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
from repro_torch.kernels import _common  # noqa: E402
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


def _lut_out_of_range_case(seed, m=6, k=300, n=40, R=9, C=65):
    """Ids the flat address a·C + w must carry through: int16 w ≥ C (the
    next row) and w < −C (still negative after canonicalization), row ids
    ≥ R and < −R, and rows near 2³¹/C whose scaled id wraps int32; table
    entries near 2²⁵, so that 300 terms wrap the int32 sums too."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, R, (m, k)).astype(np.int64)
    a[0, ::3] = rng.integers(R, 4 * R, a[0, ::3].shape)            # a ≥ R
    a[1, ::5] = rng.integers(-4 * R, -R, a[1, ::5].shape)          # a < −R
    a[2, ::7] = (1 << 31) // C + rng.integers(-2, 3, a[2, ::7].shape)
    w = rng.integers(0, C, (k, n)).astype(np.int64)
    w[::4, 0::3] = rng.integers(C, 3 * C, w[::4, 0::3].shape)      # w ≥ C
    w[1::4, 1::3] = rng.integers(-3 * C, -C, w[1::4, 1::3].shape)  # w < −C
    w[2::4, 2::3] = rng.integers(-C, 0, w[2::4, 2::3].shape)       # stored negative
    t = rng.integers(-(1 << 25), 1 << 25, (R, C)).astype(np.int32)
    return a.astype(np.int32), w.astype(np.int16), t


def test_lut_out_of_range_ids_match_pallas(J):
    """The flat-address semantics a shared-memory row must keep: terms whose
    w lies outside [0, C) or whose row lies outside the table, and int32
    wrap of the scaled row id, bit for bit against the Pallas kernel."""
    a, w, t = _lut_out_of_range_case(21)
    got = lm.lut_matmul_plain(torch.from_numpy(a), torch.from_numpy(w),
                              torch.from_numpy(t)).numpy()
    ja, jw, jt = (J.jnp.asarray(v) for v in (a, w, t))
    pallas = np.asarray(J.lut_matmul_pallas(ja, jw, jt, bm=8, bn=16, bk=16,
                                            interpret=True))
    np.testing.assert_array_equal(got, pallas)
    # the case reaches every kind of address: clamped low and high, another
    # row than a's, and a wrapped row offset
    aa = a.astype(np.int64)
    ac = np.where(aa < 0, aa + t.shape[0], aa) * t.shape[1]
    wc = np.where(w < 0, w.astype(np.int64) + t.shape[1], w)
    flat = ((ac[:, :, None] + wc[None]) + (1 << 31)) % (1 << 32) - (1 << 31)
    assert (flat < 0).any() and (flat >= t.size).any()
    assert ((wc >= t.shape[1]) | (wc < 0)).any()
    assert (ac >= 1 << 31).any()


SERVE_ROWS = (1, 4, 8, 16, 32, 64, 256)
SERVE_SITES = ((2048, 2048), (2048, 1024), (2048, 6144), (6144, 2048))


@pytest.mark.parametrize("M", SERVE_ROWS)
@pytest.mark.parametrize("idx_bytes", [1, 2, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_codebook_plan_routes(M, idx_bytes, bf16):
    """Each row count the serving path gives maps to its route: tensor
    cores for bf16 x with 16-byte aligned rows (16 rows a block at M ≤ 16,
    64 beyond), the FMA tile for the rest (f32 x, or rows of ids or of x
    that are not 16-byte aligned: int8 ids at N = 130); every split is a
    whole number of stages, the splits cover K once and are at most the 8
    blocks of one cluster, and the grid puts a block on nearly every one of
    the 132 SMs, unless the limit of 8 splits binds first; the mma route
    splits K as far as one wave of blocks allows (two an SM at 16 rows, one
    at 64)."""
    for K, N in SERVE_SITES + ((100, 130),):
        x_bytes = 2 if bf16 else 4
        aligned = (N * idx_bytes) % 16 == 0 and (K * x_bytes) % 16 == 0
        for vec_ok in {aligned, False}:
            p = _common.codebook_plan(M, K, N, bf16=bf16, vec_ok=vec_ok,
                                      sms=132)
            want = "mma" if bf16 and vec_ok and K % 8 == 0 else "fma"
            assert p.route == want, (M, K, N, p)
            assert p.bm == (64 if p.route == "fma" or M > 16 else 16)
            assert 1 <= p.splits <= _common.MAX_CLUSTER
            assert p.k_chunk % p.stage == 0 and p.stage == _common.STAGE
            assert (p.splits - 1) * p.k_chunk < K <= p.splits * p.k_chunk
            if (K, N) != (100, 130):
                blocks = p.tiles * p.splits
                if p.route == "mma":   # one wave of 2 (16 rows) or 1 blocks an SM
                    per_sm = 2 if p.bm == 16 else 1
                    assert p.splits == 1 or blocks <= per_sm * 132, p
                    assert p.splits == 8 or (p.splits + 1) * p.tiles > per_sm * 132, p
                else:
                    assert blocks >= min(128, 8 * p.tiles), p


@pytest.mark.parametrize("M", SERVE_ROWS)
@pytest.mark.parametrize("idx_bytes", [1, 2, 4])
def test_lut_plan_routes(M, idx_bytes):
    """Tables of the serving path (|W| 256 and 1000) stage their rows in
    shared memory, in a ring of at least two stages that fits a block and
    with the rows a block stages used by at least 512 columns at the serving
    sites, except at M ≤ 4 on sites of at most 1024 columns, which look up
    through L2; rows too long for two stages take the L2 route.  Splits as
    for codebook."""
    for K, N in SERVE_SITES + ((100, 130),):
        for C in (256, 1000):
            planned = _common.lut_plan(M, K, N, n_cols=C,
                                       idx_bytes=idx_bytes, sms=132)
            narrow = M <= 4 and N <= _common.LUT_L2_MAX_N
            assert planned.route == ("l2" if narrow else "smem"), \
                (M, K, N, C, planned)
            p = _common.lut_plan(M, K, N, n_cols=C, idx_bytes=idx_bytes,
                                 sms=132, route="smem")
            assert p.route == "smem" and (narrow or p == planned)
            assert p.bm >= min(M, 16) and 2 <= p.stages <= _common.LUT_MAX_STAGES
            assert p.threads % 32 == 0 and p.threads <= \
                _common.lut_max_threads(p.bm, idx_bytes)
            vec = min(16 // idx_bytes, 128 // p.bm)
            stage = _common.lut_stage_bytes(p.bm, C)
            assert max(p.stages * stage, p.bm * p.threads * vec * 4) \
                <= _common.SMEM_BUDGET
            if (K, N) != (100, 130):
                assert p.threads * vec >= min(N, 512)
            assert p.k_chunk % p.stage == 0
            assert (p.splits - 1) * p.k_chunk < K <= p.splits * p.k_chunk
            forced = _common.lut_plan(M, K, N, n_cols=C, idx_bytes=idx_bytes,
                                      sms=132, route="l2")
            assert forced.route == "l2" and forced.bm >= min(M, 64)
            assert forced.k_chunk % forced.stage == 0
            assert (forced.splits - 1) * forced.k_chunk < K \
                <= forced.splits * forced.k_chunk
        p = _common.lut_plan(M, 2048, 2048, n_cols=65536,
                             idx_bytes=idx_bytes, sms=132)
        assert p.route == "l2" and p.k_chunk % p.stage == 0
        with pytest.raises(ValueError, match="too long"):
            _common.lut_plan(M, 2048, 2048, n_cols=65536,
                             idx_bytes=idx_bytes, sms=132, route="smem")


def test_check_plan_refuses_what_operands_cannot_take():
    """A plan passed in by a caller is held to what the route takes before
    any launch: mma only where the operands allow it, at most 8 splits (one
    cluster) for codebook, every split whole stages covering K once."""
    p = _common.codebook_plan(4, 2048, 6144, bf16=True, vec_ok=True, sms=132)
    takes = {"mma": True, "fma": True}
    _common.check_plan(p, 2048, takes, _common.MAX_CLUSTER)
    with pytest.raises(ValueError, match="route"):
        _common.check_plan(p, 2048, {"mma": False, "fma": True}, 8)
    for bad in (p._replace(k_chunk=p.k_chunk + 8),      # not whole stages
                p._replace(k_chunk=p.k_chunk // 2),     # K not covered
                p._replace(splits=p.splits + 1),        # a split past K
                p._replace(splits=16, k_chunk=128)):    # more than a cluster
        with pytest.raises(ValueError, match="split"):
            _common.check_plan(bad, 2048, takes, _common.MAX_CLUSTER)
    q = _common.lut_plan(4, 2048, 6144, n_cols=1000, idx_bytes=2, sms=132,
                         route="l2")
    _common.check_plan(q, 2048, {"l2": True}, 1 << 30)
    with pytest.raises(ValueError, match="split"):
        _common.check_plan(q._replace(k_chunk=q.k_chunk - 1), 2048,
                           {"l2": True}, 1 << 30)


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
# and both sides of the mma route's 16-row tile boundary (16, 17) at the four
# (K, N) sites of qwen3-1.7b, and a ragged shape
CUDA_SHAPES = [(m, k, n) for m in (1, 4, 8, 16, 17, 32, 64, 256)
               for k, n in ((2048, 2048), (2048, 1024), (2048, 6144),
                            (6144, 2048))] + [(3, 100, 130), (40, 100, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES)
def test_cuda_kernels_match_plain(m, k, n):
    """Needs a GPU and nvcc: the hand-written kernels against their plain
    versions on the card (run by ``pytest -m cuda`` on the GPU machine),
    int8, int16 and int32 ids, every route of both kernels (codebook: mma,
    fma; lut: staged rows, L2); a second run bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    for idt, W in ((np.int8, 256), (np.int16, 1000), (np.int32, 5000)):
        x, wi, book = _codebook_case(1, m, k, n, W=W, idt=idt)
        twi, tbook = (torch.from_numpy(v).to(dev) for v in (wi, book))
        for xdt in (torch.float32, torch.bfloat16):
            tx = torch.from_numpy(x).to(dev, xdt)
            want = cm.codebook_matmul_plain(tx, twi, tbook)
            tol = cm.parity_tolerance(tx, twi, tbook)
            # the planned route, and for bf16 x the route it takes without
            # 16-byte aligned rows (the FMA tile)
            plans = [None]
            if xdt == torch.bfloat16:
                plans.append(_common.codebook_plan(
                    m, k, n, bf16=True, vec_ok=False,
                    sms=_common.sm_count(dev)))
            for plan in plans:
                got = cm.codebook_matmul_cuda(tx, twi, tbook, plan=plan)
                assert bool(((got - want).abs() <= tol).all())
                assert torch.equal(
                    got, cm.codebook_matmul_cuda(tx, twi, tbook, plan=plan))
            if xdt == torch.bfloat16:     # the limit catches a missing cast
                no_cast = tx.float() @ tbook[canonical_idx(twi, W).long()]
                assert not bool(((no_cast - want).abs() <= tol).all())
        a, w, t = _lut_case(2, m, k, n, C=min(W, 1000), idt=idt)
        args = [torch.from_numpy(v).to(dev) for v in (a, w, t)]
        want = lm.lut_matmul_plain(*args)
        for plan in _lut_plans(*args):
            got = lm.lut_matmul_cuda(*args, plan=plan)
            assert torch.equal(got, want)
            assert torch.equal(got, lm.lut_matmul_cuda(*args, plan=plan))


def _lut_plans(a, w, t):
    """The planned lut route, then each route forced (smem where the rows
    fit a ring)."""
    args = (a.shape[0], a.shape[1], w.shape[1])
    kw = dict(n_cols=t.shape[1], idx_bytes=w.element_size(),
              sms=_common.sm_count(a.device))
    plans = [None, _common.lut_plan(*args, **kw, route="l2")]
    try:
        plans.append(_common.lut_plan(*args, **kw, route="smem"))
    except ValueError:               # rows too long to stage
        pass
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,R,C", [(6, 300, 40, 9, 65),
                                       (4, 2048, 1024, 4096, 1000),
                                       (32, 2048, 1024, 4096, 1000)])
def test_cuda_lut_out_of_range_ids(m, k, n, R, C):
    """Needs a GPU and nvcc: the out-of-range case of
    ``test_lut_out_of_range_ids_match_pallas`` (and at a serving site's
    width) through the kernel, bit for bit against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    args = [torch.from_numpy(v).cuda()
            for v in _lut_out_of_range_case(22, m, k, n, R, C)]
    want = lm.lut_matmul_plain(*args)
    for plan in _lut_plans(*args):
        got = lm.lut_matmul_cuda(*args, plan=plan)
        assert torch.equal(got, want)
        assert torch.equal(got, lm.lut_matmul_cuda(*args, plan=plan))


# the page shapes of the paged serving path (int8 and bf16 K/V pages of
# qwen3-1.7b, bf16 scale pages, f32 pages) and one of 15 bytes, at the
# decode (4 slots × 32 pages) and prefill-chunk (1 × 32) page tables
PAGE_CASES = [((16, 8, 128), "int8"), ((16, 8, 128), "bfloat16"),
              ((16, 8), "bfloat16"), ((16, 8, 128), "float32"),
              ((3, 5), "int8")]


def _page_case(rng, page_shape, dtype, n_pages, B, P):
    """A (3, n_pages, *page) pool (the kernel reads its middle layer) and a
    (B, P) table holding 0, negatives and ids ≥ n_pages."""
    full = torch.from_numpy(rng.integers(-100, 100, (3, n_pages) + page_shape)
                            ).to(getattr(torch, dtype))
    pt = rng.integers(-3, n_pages + 4, (B, P)).astype(np.int32)
    pt[0, :3] = [0, -1, n_pages]
    return full, torch.from_numpy(pt)


@pytest.fixture(scope="module")
def page_gather_pallas():
    pytest.importorskip("jax")
    from repro.kernels.page_gather import page_gather_pallas
    return page_gather_pallas


@pytest.mark.parametrize("page_shape,dtype", PAGE_CASES)
def test_page_gather_many_plain_matches_single_and_pallas(
        page_gather_pallas, page_shape, dtype):
    """Four pools under one table (K/V pages, their scale pages, a page of
    15 bytes, f32 pages) equal one ``page_gather_plain`` a pool and the
    Pallas kernel in interpret mode, bit for bit."""
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(len(page_shape) * 11 + len(dtype))
    shapes = [page_shape, page_shape, (16, 8), (3, 5)]
    pools = [_page_case(rng, s_, dtype, 9, 3, 5)[0][1] for s_ in shapes]
    _, pt = _page_case(rng, page_shape, dtype, 9, 3, 5)
    for ids in (pt, pt.long()):
        many = pg.page_gather_many_plain(pools, ids)
        assert len(many) == 4
        for pool, got in zip(pools, many):
            want = pg.page_gather_plain(pool, ids)
            assert got.dtype == pool.dtype and got.shape == want.shape
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
            jpool = jnp.asarray(pool.float().numpy()).astype(
                jnp.bfloat16 if dtype == "bfloat16" else getattr(jnp, dtype))
            ref = page_gather_pallas(jpool, jnp.asarray(pt.numpy()),
                                     interpret=True)
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(ref).astype(np.float32))
        via_ops = ops.gather_pages_many(pools, ids)
        assert all(torch.equal(a, b) for a, b in zip(via_ops, many))


def test_page_gather_many_refusals_and_cpu_is_no_launch():
    rng = np.random.default_rng(0)
    pool, pt = _page_case(rng, (4, 2), "int8", 5, 2, 3)
    ops.reset_launch_counts()
    assert len(ops.gather_pages_many([pool[1]] * 4, pt)) == 4
    assert ops.launch_counts()["page_gather"] == 0
    with pytest.raises(ValueError):
        pg.page_gather_many_cuda([pool[1]], pt)
    with pytest.raises(ValueError):
        ops.gather_pages_many([pool[1]], pt.float())


@pytest.mark.cuda
@pytest.mark.parametrize("page_shape,dtype", PAGE_CASES)
@pytest.mark.parametrize("B,P", [(4, 32), (1, 32)])
def test_cuda_page_gather_matches_plain(page_shape, dtype, B, P):
    """Needs a GPU and nvcc: the page gather against its plain version,
    bit for bit, on one layer's view of a pool, with ids that include 0,
    negatives and ids ≥ n_pages: bulk copies for pages of whole 16-byte
    vectors, byte copies for the 15-byte page."""
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
        want = pg.page_gather_plain(pool, ids)
        got = pg.page_gather_cuda(pool, ids)
        torch.cuda.synchronize()
        assert got.dtype == pool.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("B,P", [(4, 32), (1, 32)])
def test_cuda_page_gather_many_matches_single(dtype, B, P):
    """Needs a GPU and nvcc: one launch over four pools under one table
    (K and V pages, their bf16 scale pages; then with a 15-byte page among
    them) bit-identical to one single-pool launch a pool; one launch
    counted."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    dev = torch.device("cuda")
    n_pages = 129
    g = torch.Generator(device=dev).manual_seed(B * 7 + P)

    def pool_of(shape, dt):
        return torch.randint(-128, 128, (3, n_pages) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))[1]
    kv = [pool_of((16, 8, 128), dtype) for _ in range(2)]
    sc = [pool_of((16, 8), "bfloat16") for _ in range(2)]
    pt = torch.randint(-4, n_pages + 5, (B, P), generator=g, device=dev,
                       dtype=torch.int32)
    pt[0, :3] = torch.tensor([0, -1, n_pages], device=dev)
    for pools in (kv + sc, kv, kv[:1] + [pool_of((3, 5), "int8")] + sc):
        for ids in (pt, pt.long()):
            ops.reset_launch_counts()
            many = pg.page_gather_many_cuda(pools, ids)
            assert ops.launch_counts()["page_gather"] == 1
            for pool, got in zip(pools, many):
                want = pg.page_gather_cuda(pool, ids)
                torch.cuda.synchronize()
                assert got.dtype == pool.dtype
                assert got.shape == want.shape
                assert torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8))


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
    of the f64 sums within their limit (the kernel's ``sums_tolerance``
    and ``fixed_point_bound``, the plain version's worst-case
    ``sums_bound``), values
    on midpoints and a duplicate center pair included, and two runs
    bit-identical.  The sums-only form gives the full form's sums and
    counts bit for bit, both equal the torch mirror of the kernel's
    fixed-point sums, and the search alone its indices."""
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
    ext = (float(tv.min()), float(tv.max()))
    own = km.fixed_point_bound(exact, abs_sum, n_c, tc, ext, n)
    assert bool(((got[1].double() - exact).abs() <= own).all())
    stats = km.kmeans_stats_cuda(tv, tc, ext)
    assert torch.equal(stats[0], got[1]) and torch.equal(stats[1], got[2])
    assert torch.equal(km.kmeans_stats_cuda(tv, tc, torch.tensor(
        ext, device="cuda"))[0], got[1])
    assert torch.equal(got[1], km.fixed_point_sums(tv, want[0], tc, ext))
    assert torch.equal(km.kmeans_search_cuda(tv, tc), want[0])


@pytest.mark.cuda
def test_cuda_kmeans_stats_flags_values_beyond_extremes():
    """Needs a GPU and nvcc: a finite value beyond the extremes the sums
    were scaled for, far enough to overflow its center's fixed-point sum,
    makes the call raise; with the wrapper's own extremes, or where that
    center holds an infinity (its sum is the infinity), it does not."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    c = torch.tensor([-1.0, 0.0, 1.0], device="cuda")
    v = torch.tensor([0.1, -0.3, 0.7, 1e30, -0.9], device="cuda")
    with pytest.raises(ValueError, match="overflow"):
        km.kmeans_stats_cuda(v, c, (-1.0, 1.0))
    sums, counts = km.kmeans_stats_cuda(v, c)
    want = km.kmeans_assign_plain(v, c)
    assert torch.equal(counts, want[2])
    assert torch.equal(sums, km.fixed_point_sums(v, want[0], c,
                                                 km.finite_extremes(v)))
    v_inf = torch.cat([v, torch.tensor([float("inf")], device="cuda")])
    sums, _ = km.kmeans_stats_cuda(v_inf, c, (-1.0, 1.0))
    assert float(sums[2]) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 7, 1000, 4096])
def test_cuda_kmeans_search_adversarial(k):
    """Needs a GPU and nvcc: the kernel's bucketed search on ±0, midpoints
    and their f32 neighbours, subnormals, ±inf and values beyond the
    extreme midpoints, centers at ±0 and duplicates, equals
    torch.searchsorted(right); and on an unaligned view of the values.
    The full form's counts equal the plain version's and its sums the
    torch mirror of its arithmetic bit for bit, infinities and NaN (a
    center holding both infinities) included."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    rng = np.random.default_rng(k)
    c = np.sort(rng.laplace(0, 0.05, k)).astype(np.float32)
    if k > 3:
        c[1], c[k // 2], c[k // 2 + 1] = c[2], -0.0, 0.0
        c = np.sort(c)
    mids = ((c[:-1] + c[1:]) / np.float32(2)).astype(np.float32)
    big = np.float32(np.finfo(np.float32).max)
    v = np.concatenate([
        np.array([0.0, -0.0, big, -big, np.inf, -np.inf, 1e-38, -1e-38,
                  1e-45, -1e-45], np.float32),
        mids, np.nextafter(mids, np.float32(np.inf)),
        np.nextafter(mids, np.float32(-np.inf)), c,
        rng.laplace(0, 0.05, 100003).astype(np.float32)])
    tv, tc = torch.from_numpy(v).cuda(), torch.from_numpy(c).cuda()
    bounds = ((tc[:-1] + tc[1:]) / 2.0).contiguous()
    for x in (tv, tv[1:]):
        want = torch.searchsorted(bounds, x, right=True, out_int32=True)
        assert torch.equal(km.kmeans_search_cuda(x, tc), want)
        idx, sums, counts = km.kmeans_assign_cuda(x, tc)
        assert torch.equal(idx, want)
        assert torch.equal(counts, km.kmeans_assign_plain(x, tc)[2])
        torch.testing.assert_close(
            sums, km.fixed_point_sums(x, want, tc, km.finite_extremes(x)),
            rtol=0, atol=0, equal_nan=True)
