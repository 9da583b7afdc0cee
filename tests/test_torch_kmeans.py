"""The port's k-means clustering vs the JAX package's, computed live:
``kmeans_assign`` (plain version vs the Pallas kernel in interpret mode and
``kmeans_assign_ref``), ``kmeans1d`` and ``uniform_centers``, and the
clustering event (``cluster_params``, ``codebook_indices``,
``to_codebook_params``) for kmeans/uniform × global/per_layer.

Inputs come from numpy seeds or the reduced qwen3's JAX init.  Assignment
indices and counts must be equal.  Sums add in other orders: each side
within the worst-case bound of its order (``sums_bound``: γ_{n_c}·Σ|v| for
a running sum) of the f64 sum, so the two within the sum of their
bounds.  Centers come out of 25 Lloyd steps whose sums round
differently: within 1e-5 of the largest center.  A weight within rounding
distance of a midpoint may fall on the other side in some step; each such
flip moves a center, the mean of its n_c weights, by at most one
neighbouring gap over n_c, and a flip can move a midpoint enough for one
or two more: such centers may differ by up to 4 gaps over n_c (at most
1 % of them), the
quantization MSE must agree within 1e-4, and every weight whose index
differs must sit within the tolerance of a midpoint of either codebook.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core import clustering as JC  # noqa: E402
from repro.core import quantizer as JQ  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.kmeans1d import kmeans_assign_pallas  # noqa: E402
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import to_codebook_params  # noqa: E402
from repro_torch.bridge import (from_jax_params, from_jax_state,  # noqa: E402
                                to_numpy_tree)
from repro_torch.core import clustering as TC  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.kernels import kmeans1d as km  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serving import compress as TS  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-5


def _centers(seed, k, dup=False):
    rng = np.random.default_rng(seed)
    c = np.sort(rng.laplace(0, 0.05, k)).astype(np.float32)
    if dup and k > 3:
        c[1] = c[2]                                   # duplicate neighbours
    return c


def _values(seed, n, centers):
    """Laplace values, with midpoints and centers themselves mixed in."""
    rng = np.random.default_rng(seed + 1)
    v = rng.laplace(0, 0.05, n).astype(np.float32)
    mids = ((centers[:-1] + centers[1:]) / np.float32(2)).astype(np.float32)
    special = np.concatenate([mids, centers])[: max(n // 4, 1)]
    v[:special.size] = special
    return v[rng.permutation(n)]


ASSIGN_CASES = [(2, 1), (2, 4097), (1000, 1), (1000, 4097), (1000, 20000),
                (64, 9000)]


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("k,n", ASSIGN_CASES)
def test_kmeans_assign_plain_matches_pallas_and_ref(k, n, dup):
    c = _centers(k + n, k, dup)
    v = _values(k * n, n, c)
    idx, sums, counts = ops.kmeans_assign(torch.from_numpy(v),
                                          torch.from_numpy(c))
    jv, jc = jnp.asarray(v), jnp.asarray(c)
    for want in (kmeans_assign_pallas(jv, jc, interpret=True),
                 jref.kmeans_assign_ref(jv, jc)):
        w_idx, w_sums, w_counts = (np.asarray(a) for a in want)
        np.testing.assert_array_equal(idx.numpy(), w_idx)
        np.testing.assert_array_equal(counts.numpy(), w_counts)
        exact, abs_sum, n_c = km.exact_sums(torch.from_numpy(v), idx, k)
        bound = km.sums_bound(abs_sum, n_c).numpy()
        assert np.all(np.abs(sums.numpy() - exact.numpy()) <= bound)
        assert np.all(np.abs(w_sums - exact.numpy()) <= bound)
    assert tref.kmeans_assign_ref is km.kmeans_assign_plain


def test_sums_bounds():
    """The worst-case bound holds for an f32 running sum; the kernel's
    tolerance (16 × its tree's random-walk estimate) is never looser than
    it and far tighter at the full model's n (a misplaced value would
    stand out)."""
    c = _centers(1, 1000)
    v = torch.from_numpy(_values(1, 20000, c))
    idx, sums, _ = km.kmeans_assign_plain(v, torch.from_numpy(c))
    exact, abs_sum, n_c = km.exact_sums(v, idx, 1000)
    seq = km.sums_bound(abs_sum, n_c)
    assert bool(((sums.double() - exact).abs() <= seq).all())
    tree = km.sums_tolerance(abs_sum, n_c, v.numel())
    assert bool((tree <= seq).all())
    big = torch.full((5,), 1e7, dtype=torch.float64)
    wide = km.sums_tolerance(big, big, 1_720_837_120)
    assert float(wide[0] / big[0]) < 7e-5           # 16·√5226 ulps
    assert float(wide[0]) < float(km.sums_bound(big, big)[0]) / 4000
    assert float((tree / (abs_sum / n_c.clamp(min=1))).max()) < 1e-3


def test_kmeans_assign_launches_and_refusals():
    ops.reset_launch_counts()
    ops.kmeans_assign(torch.randn(100), torch.sort(torch.randn(5)).values)
    assert ops.launch_counts()["kmeans_assign"] == 0    # the plain CPU path
    with pytest.raises(ValueError):
        km.kmeans_assign_cuda(torch.randn(10), torch.randn(3))
    with pytest.raises(TypeError):
        km.kmeans_assign_plain(torch.randn(10).double(), torch.randn(3))


def _adversarial(c):
    """Values the bucketed search must place as a full search does: ±0,
    every midpoint and its two f32 neighbours, every center, values far
    beyond the extreme midpoints (±inf included), and Laplace draws."""
    mids = ((c[:-1] + c[1:]) / np.float32(2)).astype(np.float32)
    big = np.float32(np.finfo(np.float32).max)
    v = np.concatenate([
        np.array([0.0, -0.0, big, -big, np.inf, -np.inf, 1e-38, -1e-38,
                  1e-45, -1e-45], np.float32),
        mids, np.nextafter(mids, np.float32(np.inf)),
        np.nextafter(mids, np.float32(-np.inf)), c,
        np.random.default_rng(c.size).laplace(0, 0.05, 5000)
        .astype(np.float32)])
    return v


SEARCH_CASES = [(1, False), (2, False), (2, True), (7, True), (1000, False),
                (1000, True), (4096, False), (4096, True)]


@pytest.mark.parametrize("k,dup", SEARCH_CASES)
def test_bucketed_search_matches_searchsorted_and_ref(k, dup):
    """The kernel's search, mirrored in torch (bucket table, then a search
    over the value's bucket range alone), equals torch.searchsorted(right)
    and the JAX reference on adversarial values, centers at ±0 and
    duplicate centers included.  Against JAX only finite values that are
    not subnormal: XLA on the CPU flushes subnormal inputs to zero, where
    torch and the kernel compare them as they are."""
    c = _centers(k * 3 + dup, k, dup)
    if k > 3:
        c[k // 2], c[k // 2 + 1] = np.float32(-0.0), np.float32(0.0)
        c = np.sort(c)
    v = _adversarial(c)
    tv, tc = torch.from_numpy(v), torch.from_numpy(c)
    got = km.bucketed_search(tv, tc)
    bounds = ((tc[:-1] + tc[1:]) / 2.0).contiguous()
    want = torch.searchsorted(bounds, tv, right=True, out_int32=True)
    assert torch.equal(got, want)
    finite = np.isfinite(v) & ((v == 0) | (np.abs(v) >= np.finfo(
        np.float32).tiny))
    w_idx = np.asarray(jref.kmeans_assign_ref(jnp.asarray(v[finite]),
                                              jnp.asarray(c))[0])
    np.testing.assert_array_equal(got.numpy()[finite], w_idx)
    table = km.bucket_table(tc)
    assert table.numel() == km.BUCKETS + 1
    assert int(table[0]) == 0 and int(table[-1]) == k - 1
    assert bool((table[1:] >= table[:-1]).all())


@pytest.mark.parametrize("k,n", ASSIGN_CASES)
def test_fixed_point_sums_within_tolerance(k, n):
    """The kernel's fixed-point sums, mirrored in torch, sit within the
    unchanged ``sums_tolerance`` of the f64 sums and within the bound of
    their own arithmetic (``fixed_point_bound``), with the exact extremes
    or looser ones; bf16 values sum exactly but for the final f32
    rounding."""
    c = _centers(k + n, k, True)
    v = torch.from_numpy(_values(k * n, n, c))
    tc = torch.from_numpy(c)
    idx = km.bucketed_search(v, tc)
    exact, abs_sum, n_c = km.exact_sums(v, idx, k)
    limit = km.sums_tolerance(abs_sum, n_c, n)
    lo, hi = float(v.min()), float(v.max())
    for ext in ((lo, hi), (4 * lo, 4 * hi)):
        sums = km.fixed_point_sums(v, idx, tc, ext)
        err = (sums.double() - exact).abs()
        assert bool((err <= limit).all())
        own = km.fixed_point_bound(exact, abs_sum, n_c, tc, ext, n)
        assert bool((err <= own).all())
    vb = v.to(torch.bfloat16).float()
    idx_b = km.bucketed_search(vb, tc)
    exact_b, _, _ = km.exact_sums(vb, idx_b, k)
    sums_b = km.fixed_point_sums(vb, idx_b, tc, (vb.min(), vb.max()))
    assert torch.equal(sums_b, exact_b.float())


def test_fixed_point_sums_non_finite():
    """Infinities and NaNs are flagged, not summed: a center holding +inf
    sums to +inf, one holding −inf to −inf, one holding both or a NaN to
    NaN, as the plain version's f32 sums; the others are unchanged."""
    c = _centers(4, 64)
    v = torch.from_numpy(_values(4, 9000, c))
    v[:5] = torch.tensor([float("inf"), -float("inf"), float("inf"),
                          -float("inf"), float("nan")])
    tc = torch.from_numpy(c)
    idx = km.bucketed_search(v, tc)
    assert idx[0] == 63 and idx[1] == 0 and idx[2] == 63
    v[3] = float(tc[0]) - 1.0          # finite, on center 0 with the −inf
    idx = km.bucketed_search(v, tc)
    _, want, _ = km.kmeans_assign_plain(v, tc)
    got = km.fixed_point_sums(v, idx, tc, (-float("inf"), float("inf")))
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got)) and bool(nan.any())
    assert bool(torch.isinf(got).any())
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin, finite = torch.isfinite(want), torch.isfinite(v)
    clean = km.fixed_point_sums(v[finite], idx[finite], tc,
                                (float(v[finite].min()),
                                 float(v[finite].max())))
    assert torch.equal(got[fin], clean[fin])


def test_fixed_point_bound_tighter_than_the_tolerance_at_full_n():
    """At the full model's n the fixed-point bound of a center's sums is
    nearly 10³ times tighter than ``sums_tolerance``: the final f32 rounding
    (2⁻²⁴·|sum|) and 2⁻³² of the center's largest |v| a value."""
    n = 1_720_837_120
    c = torch.tensor([-0.1, 0.0, 0.1])
    n_c = torch.full((3,), 1e7, dtype=torch.float64)
    abs_sum = n_c * 0.05
    exact = abs_sum * torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64)
    own = km.fixed_point_bound(exact, abs_sum, n_c, c, (-1.0, 1.0), n)
    tol = km.sums_tolerance(abs_sum, n_c, n)
    assert bool((own < tol / 900).all())
    assert float(own[0] / abs_sum[0]) < 2 * 2.0 ** -24


def test_finite_extremes_skip_non_finite():
    """The extremes the kernel scales its sums for: the smallest and
    largest finite value, whatever infinities or NaNs are among them."""
    v = torch.tensor([0.5, -2.0, float("inf"), 3.0, float("nan"),
                      -float("inf")])
    assert km.finite_extremes(v).tolist() == [-2.0, 3.0]
    assert km.finite_extremes(v[:2]).tolist() == [-2.0, 0.5]
    assert km.finite_extremes(v[2:3]).tolist() == [0.0, 0.0]
    assert km.finite_extremes(torch.empty(0)).tolist() == [0.0, 0.0]


def test_kmeans_stats_plain_is_assign_sums_and_counts():
    c = _centers(3, 1000)
    v = torch.from_numpy(_values(3, 20000, c))
    _, sums, counts = ops.kmeans_assign(v, torch.from_numpy(c))
    ops.reset_launch_counts()
    s2, c2 = ops.kmeans_stats(v, torch.from_numpy(c))
    assert torch.equal(sums, s2) and torch.equal(counts, c2)
    assert ops.launch_counts()["kmeans_assign"] == 0
    with pytest.raises(ValueError):
        km.kmeans_stats_cuda(v, torch.from_numpy(c))


@pytest.mark.parametrize("n", [1, 255, 4097, 10 ** 7, 1_720_837_120])
def test_launch_grid_covers_every_value(n):
    blocks, chunk = km.launch_grid(n)
    assert chunk % 256 == 0 and blocks * chunk >= n
    assert (blocks - 1) * chunk < max(n, 1) and blocks <= km._MAX_BLOCKS


@pytest.fixture(scope="module")
def reduced():
    """The reduced qwen3's JAX init (2 layers, f32), as numpy."""
    cfg = C.get("qwen3-1.7b").reduced().replace(n_layers=2, dtype="float32")
    params = build(cfg).init(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def _flat(tree):
    return np.concatenate([np.asarray(a).reshape(-1) for a in
                           jax.tree_util.tree_leaves(tree)]).astype(np.float32)


def _near_midpoint(v, book_a, book_b, dist):
    """True where v lies within dist of a midpoint of either codebook."""
    out = np.zeros(v.shape, bool)
    for b in (book_a, book_b):
        mids = (b[:-1] + b[1:]) / 2
        j = np.clip(np.searchsorted(mids, v), 1, mids.size - 1)
        out |= np.minimum(np.abs(v - mids[j - 1]), np.abs(v - mids[j])) <= dist
    return out


def _check_books(got, want, values):
    """Raises unless the codebooks agree as the module docstring says;
    returns the number of weights whose index differs."""
    scale = float(np.abs(want).max())
    gi = TC.assign_to_centers(torch.from_numpy(values),
                              torch.from_numpy(got)).numpy()
    wi = np.asarray(JC.assign_to_centers(jnp.asarray(values),
                                         jnp.asarray(want)))
    n_c = np.bincount(wi, minlength=want.size)
    gap = np.maximum(np.diff(want, prepend=want[:1]),
                     np.diff(want, append=want[-1:]))
    tol = RTOL * scale + 4 * gap / np.maximum(n_c, 1)
    d = np.abs(got - want)
    assert np.all(d <= tol), float((d / tol).max())
    assert (d > RTOL * scale).mean() <= 0.01
    mse = [np.mean((b[i] - values).astype(np.float64) ** 2)
           for b, i in ((got, gi), (want, wi))]
    assert abs(mse[0] - mse[1]) <= 1e-4 * mse[1]
    diff = gi != wi
    assert np.all(_near_midpoint(values[diff], got, want, tol.max()))
    return int(diff.sum())


@pytest.mark.parametrize("k", [7, 256, 1000])
def test_kmeans1d_matches(reduced, k):
    v = _flat(reduced)
    want = np.asarray(JC.kmeans1d(jnp.asarray(v), k, iters=25))
    got = TC.kmeans1d(torch.from_numpy(v), k, iters=25).numpy()
    assert got.dtype == np.float32 and np.all(np.diff(got) >= 0)
    _check_books(got, want, v)


@pytest.mark.parametrize("k", [2, 7, 256, 1000, 4096])
def test_uniform_centers_bit_equal(k):
    v = np.random.default_rng(k).laplace(0, 0.02, 50000).astype(np.float32)
    np.testing.assert_array_equal(
        TC.uniform_centers(torch.from_numpy(v), k).numpy(),
        np.asarray(JC.uniform_centers(jnp.asarray(v), k)))


def test_quantile_init_above_2_pow_24():
    """More than 2²⁴ values: JAX places the quantile at q·(n − 1) in f32,
    which rounds.  Sorted neighbours of log-uniform data differ by ~40 f32
    ulps, so a position off by one changes the quantile far beyond its
    rounding: the port's quantile must equal ``jnp.quantile`` bit for bit,
    where the exact f64 position does not.  kmeans1d's inits (iters 0)
    then agree as every codebook here does."""
    n = (1 << 24) + 4097
    rng = np.random.default_rng(0)
    v = (np.exp(rng.uniform(-40, 40, n)) * rng.choice([-1, 1], n)
         ).astype(np.float32)
    k = 100
    qs = ((np.arange(k, dtype=np.float32) + np.float32(0.5))
          * (np.float32(1) / np.float32(k)))
    want_q = np.asarray(jnp.quantile(jnp.asarray(v), jnp.asarray(qs)))
    s = np.sort(v)
    got_q = TC.quantile_f32(torch.from_numpy(s), torch.from_numpy(qs)).numpy()
    np.testing.assert_array_equal(got_q, want_q)
    pos = qs.astype(np.float64) * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    exact = (s[lo] * (1 - (pos - lo)) + s[np.minimum(lo + 1, n - 1)]
             * (pos - lo)).astype(np.float32)
    assert (exact != want_q).sum() > k // 10
    want = np.asarray(JC.kmeans1d(jnp.asarray(v), k, iters=0))
    got = TC.kmeans1d(torch.from_numpy(v), k, iters=0).numpy()
    _check_books(got, want, v)


def _tree_items(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tree_items(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("scope", ["global", "per_layer"])
@pytest.mark.parametrize("method", ["kmeans", "uniform"])
def test_cluster_params_and_codebook_indices_match(reduced, method, scope):
    kw = dict(num_weights=1000, method=method, scope=scope)
    jwq, twq = JQ.WeightQuantConfig(**kw), TQ.WeightQuantConfig(**kw)
    jp, jst = JQ.cluster_params(jax.tree_util.tree_map(jnp.asarray, reduced),
                                jwq, JQ.init_state(jwq), 1000,
                                jax.random.PRNGKey(1))
    tp, tst = TQ.cluster_params(from_jax_params(reduced, "cpu"), twq,
                                TQ.init_state(twq), 1000)
    assert set(tst.codebooks) == set(jst.codebooks) and tst.last_step == 1000
    leaves = dict(_tree_items(reduced))
    n_diff = 0
    for path, book in jst.codebooks.items():
        vals = (_flat(reduced) if path == "" else
                leaves["/" + path].reshape(-1).astype(np.float32))
        assert tst.codebooks[path].shape == book.shape, path
        n_diff += _check_books(tst.codebooks[path].numpy(), np.asarray(book),
                               vals)
    if method == "uniform":
        assert n_diff == 0
    # the snapped weights and the index form, given the reference's books
    jidx, jbooks = JQ.codebook_indices(jp, jwq, jst)
    books = {p: np.asarray(c) for p, c in jst.codebooks.items()}
    state = from_jax_state(books, jst.last_step, "cpu")
    tidx, tbooks = TQ.codebook_indices(from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"), twq, state)
    assert set(tbooks) == set(jbooks)
    got, want = dict(_tree_items(to_numpy_tree(tidx))), dict(_tree_items(
        jax.tree_util.tree_map(np.asarray, jidx)))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)
    # the port's own event snaps every weight onto its own codebook
    for path, leaf in _tree_items(to_numpy_tree(tp)):
        book = tst.codebooks["" if scope == "global" else path[1:]].numpy()
        assert np.isin(leaf.astype(np.float32), book).all(), path


@pytest.mark.parametrize("scope", ["global", "per_layer"])
def test_to_codebook_params_with_reference_books(reduced, scope):
    """Index form of stacked leaves with (L, |W|) codebooks, per-layer
    books included, from the reference's state carried by the bridge."""
    jwq = JQ.WeightQuantConfig(num_weights=1000, method="kmeans", scope=scope)
    twq = TQ.WeightQuantConfig(num_weights=1000, method="kmeans", scope=scope)
    jp, jst = JQ.cluster_params(jax.tree_util.tree_map(jnp.asarray, reduced),
                                jwq, JQ.init_state(jwq), 1000,
                                jax.random.PRNGKey(1))
    want = dict(_tree_items(jax.tree_util.tree_map(
        np.asarray, to_codebook_params(jp, jwq, jst, min_size=1024))))
    books = {p: np.asarray(c) for p, c in jst.codebooks.items()}
    state = from_jax_state(books, device="cpu")
    got = dict(_tree_items(to_numpy_tree(TS.to_codebook_params(
        from_jax_params(jax.tree_util.tree_map(np.asarray, jp), "cpu"), twq,
        state, min_size=1024))))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)
    books = [p for p in want if p.endswith("codebook")]
    assert books and all(want[p].shape[-1] == 1000 for p in books)
    if scope == "per_layer":        # one book per tensor: they differ
        assert len({want[p].tobytes() for p in books}) == len(books)


def test_subsample_waits_for_the_training_slice():
    wq = TQ.WeightQuantConfig(num_weights=16, method="kmeans",
                              subsample=0.02)
    small = {"w": torch.randn(64, 64)}
    TQ.cluster_params(small, wq, TQ.init_state(wq), 1000)    # not subsampled
    with pytest.raises(NotImplementedError, match="subsample"):
        TQ._centers(torch.randn(TQ._SUBSAMPLE_ABOVE + 1), wq, 16)
