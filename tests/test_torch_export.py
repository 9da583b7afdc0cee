"""The port's deployment export (``repro_torch/core/export.py``) against the
JAX package's ``repro.core.export``, computed live in this process:

* ``pack_indices``/``unpack_indices`` give the reference's bytes (seeded
  sizes at every width 1–16 and hypothesis sizes), round-trip, and raise
  the reference's error on an id past the width;
* ``bits_per_index``, ``entropy_bits`` and ``kv_cache_bytes`` are equal
  over a grid;
* ``memory_report`` is equal field for field (``dataclasses.asdict``) and
  its ``row()`` string for string on the reference's own trees (the
  ``tests/test_export_serving.py`` trees, with and without attached lut
  tables), the reduced qwen3's ``codebook_indices`` tree, int16 and int8
  id trees, and a tree whose per-leaf counts must add up to one
  concatenation; numpy leaves and tensors give one report, and a negative
  id raises in both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import export as TE  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:        # dev extras absent: skip only the property test
    given = None


@pytest.fixture(scope="module")
def RE():
    pytest.importorskip("jax")
    from repro.core import export
    return export


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _same_report(RE, tree, *args, **kw):
    """The reference's report of the numpy tree against the port's of both
    the numpy tree and the same tree as tensors: equal field for field
    and row for row."""
    want = RE.memory_report(tree, *args, **kw)
    for t in (tree, _torch(tree)):
        got = TE.memory_report(t, *args, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.row() == want.row()
        for p in ("savings_vs_fp32", "entropy_savings_vs_fp32",
                  "savings_vs_bf16", "deployed_fp_bytes",
                  "deployed_packed_bytes", "deployed_savings"):
            assert getattr(got, p) == getattr(want, p), p
    return want


# --- packing -----------------------------------------------------------------

@pytest.mark.parametrize("bits", range(1, 17))
def test_pack_bytes_equal_reference(RE, bits):
    rng = np.random.default_rng(bits)
    for n in (0, 1, 7, 8, 9, 1000, 4099):
        idx = rng.integers(0, 2 ** bits, n)
        want = RE.pack_indices(idx, bits)
        got = TE.pack_indices(torch.from_numpy(idx), bits)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(TE.pack_indices(idx, bits).numpy(),
                                      want)
        back = TE.unpack_indices(got, bits, n)
        assert back.dtype == torch.int64
        np.testing.assert_array_equal(back.numpy(),
                                      RE.unpack_indices(want, bits, n))
        np.testing.assert_array_equal(back.numpy(), idx)


@pytest.mark.parametrize("bits,bad", [(1, 2), (10, 1024), (16, 70000),
                                      (8, -1)])
def test_pack_overflow_raises_as_reference(RE, bits, bad):
    idx = np.array([0, 1, bad], np.int64)
    with pytest.raises(ValueError, match="index exceeds bit width"):
        RE.pack_indices(idx, bits)
    with pytest.raises(ValueError, match="index exceeds bit width"):
        TE.pack_indices(torch.from_numpy(idx), bits)


if given is not None:
    @settings(max_examples=30, deadline=None)
    @given(st.integers(1, 16), st.integers(0, 2000))
    def test_pack_hypothesis_sizes(bits, n):
        from repro.core.export import pack_indices
        rng = np.random.default_rng(bits * 1000 + n)
        idx = rng.integers(0, 2 ** bits, n)
        got = TE.pack_indices(torch.from_numpy(idx), bits)
        np.testing.assert_array_equal(got.numpy(), pack_indices(idx, bits))
        np.testing.assert_array_equal(
            TE.unpack_indices(got, bits, n).numpy(), idx)


# --- the scalar helpers ------------------------------------------------------

def test_bits_and_kv_bytes_grid(RE):
    for n in (0, 1, 2, 3, 255, 256, 257, 1000, 1024, 65536, 65537):
        assert TE.bits_per_index(n) == RE.bits_per_index(n)
    for L, kv, hd, tok, db, q, ps in [
            (2, 4, 32, 96, 4, False, 0), (2, 4, 32, 24, 2, True, 16),
            (28, 8, 128, 128, 2, False, 0), (28, 8, 128, 24, 2, True, 16),
            (32, 32, 128, 1, 2, True, 7), (1, 1, 1, 0, 2, True, 16),
            (4, 2, 64, 33, 4, True, 0), (4, 2, 64, 33, 4, False, 8)]:
        kw = dict(dtype_bytes=db, quant=q, page_size=ps)
        assert TE.kv_cache_bytes(L, kv, hd, tok, **kw) == \
            RE.kv_cache_bytes(L, kv, hd, tok, **kw)


def test_entropy_bits_grid(RE):
    rng = np.random.default_rng(0)
    for n_values in (2, 32, 1000, 1024):
        for draw in (rng.integers(0, n_values, 100_000),
                     np.minimum(rng.geometric(0.05, 50_000) - 1,
                                n_values - 1),
                     np.zeros(1000, np.int64),
                     rng.integers(0, n_values, 3).astype(np.int16)):
            want = RE.entropy_bits(draw, n_values)
            assert TE.entropy_bits(draw, n_values) == want
            assert TE.entropy_bits(torch.from_numpy(draw), n_values) == want
    # ids past n_values lengthen the counts, as np.bincount's do
    ids = np.array([0, 5, 5, 9], np.int32)
    assert TE.entropy_bits(ids, 4) == RE.entropy_bits(ids, 4)


# --- memory_report -----------------------------------------------------------

def test_memory_report_reference_bounds_tree(RE):
    """The tree of ``test_entropy_bounds``: one zero id leaf, with and
    without the KV fields."""
    idx = {"w": np.zeros((1_000_000,), np.int32)}
    rep = _same_report(RE, idx, 1000, 32, kv_fp_bytes=1_000_000,
                       kv_packed_bytes=100_000)
    assert "deployed" in rep.row()
    rep0 = _same_report(RE, idx, 1000, 32)
    assert "deployed" not in rep0.row()


def _lut_tree():
    import jax.numpy as jnp
    from repro.kernels.dispatch import attach_lut_tables, make_lut_spec

    n_w = 256
    rng = np.random.default_rng(7)
    cb = jnp.asarray(rng.normal(scale=0.05, size=n_w), jnp.float32)
    tree = {"blocks": {"proj": {
        "w_idx": jnp.asarray(rng.integers(0, n_w, (64, 128)), jnp.int32),
        "codebook": cb}}}
    spec = make_lut_spec(cb, fan_in=64, levels=64)
    return n_w, spec.levels, _np(tree), _np(attach_lut_tables(tree, spec))


def test_memory_report_lut_tables_as_reference(RE):
    """``test_memory_report_counts_lut_table_as_table_not_indices``'s
    trees: the attached table counts by its bytes, not as ids."""
    n_w, levels, tree, with_tables = _lut_tree()
    rep0 = _same_report(RE, tree, n_w, levels)
    rep = _same_report(RE, with_tables, n_w, levels)
    assert rep.n_params == rep0.n_params == 64 * 128
    assert rep.lut_table_bytes == with_tables["blocks"]["proj"][
        "lut_table"].nbytes
    assert rep0.lut_table_bytes == 0


def test_memory_report_port_tables(RE):
    """The port's own ``attach_lut_tables`` on the same tree: the report
    equals the reference's of the reference's tables."""
    from repro_torch.kernels import dispatch as TD

    n_w, levels, tree, with_tables = _lut_tree()
    t = _torch(tree)
    spec = TD.make_lut_spec(t["blocks"]["proj"]["codebook"], fan_in=64,
                            levels=64)
    got = TE.memory_report(TD.attach_lut_tables(t, spec), n_w, levels)
    want = RE.memory_report(with_tables, n_w, levels)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_memory_report_reduced_qwen3_indices(RE):
    """The reduced qwen3 clustered as the launcher's ``--compress`` does:
    its ``codebook_indices`` tree (the norms' ids included), once fed to
    each package, with the launcher's KV fields."""
    import jax
    import repro.configs as C
    from repro.core.quantizer import (cluster_params, codebook_indices,
                                      init_state)
    from repro.models.model_zoo import build

    cfg = C.get("qwen3-1.7b").reduced()
    params = build(cfg).init(jax.random.PRNGKey(0))
    wq = cfg.quantized(n_weights=1000).wq
    pq, st_ = cluster_params(params, wq, init_state(wq), wq.interval,
                             jax.random.PRNGKey(1))
    idx, _ = codebook_indices(pq, wq, st_)
    tree = _np(idx)
    rep = _same_report(RE, tree, 1000, 32, kv_fp_bytes=98_304,
                       kv_packed_bytes=8_192)
    assert rep.n_params == sum(a.size for a in jax.tree_util.tree_leaves(
        tree))


def test_memory_report_narrow_ids(RE):
    """int16 ids of |W| 1000 and int8 ids of |W| 256 (non-negative, as
    ``codebook_indices`` makes them), with a bool and a float leaf that
    are not ids."""
    rng = np.random.default_rng(11)
    t16 = {"a": {"w": rng.integers(0, 1000, (64, 96)).astype(np.int16)},
           "b": rng.integers(0, 1000, (300,)).astype(np.int16),
           "mask": rng.integers(0, 2, (50,)).astype(bool),
           "scale": rng.normal(size=(8,)).astype(np.float32)}
    rep = _same_report(RE, t16, 1000, 32)
    assert rep.n_params == 64 * 96 + 300
    t8 = {"x": rng.integers(0, 128, (4, 33)).astype(np.int8),
          "y": [rng.integers(0, 128, (7,)).astype(np.int8),
                rng.integers(0, 256, (5,)).astype(np.uint8)]}
    _same_report(RE, t8, 256, 64, kv_fp_bytes=4096, kv_packed_bytes=512)


def test_memory_report_per_leaf_counts_equal_concatenation(RE):
    """Leaves of four integer types, ids past |W| in one of them, and an
    empty leaf: the port's summed per-leaf counts give the entropy of the
    reference's one concatenation."""
    rng = np.random.default_rng(5)
    tree = {"a": rng.integers(0, 40, (17, 3)).astype(np.int32),
            "b": rng.integers(0, 1000, (999,)).astype(np.int64),
            "c": {"d": rng.integers(0, 1200, (64,)).astype(np.int16),
                  "e": np.zeros((0,), np.int32)},
            "f": rng.integers(0, 200, (77,)).astype(np.uint8)}
    rep = _same_report(RE, tree, 1000, 32)
    flat = np.concatenate([tree["a"].ravel(), tree["b"], tree["c"]["d"],
                           tree["f"]])
    assert rep.entropy_bits_per_w == RE.entropy_bits(flat, 1000)
    empty = {"w": np.zeros((0,), np.int32)}     # row() would divide by 0
    want = RE.memory_report(empty, 1000, 32)
    assert dataclasses.asdict(TE.memory_report(_torch(empty), 1000, 32)) \
        == dataclasses.asdict(want)
    assert want.n_params == 0 and want.entropy_bits_per_w == 0.0


def test_negative_ids_raise_in_both(RE):
    tree = {"w": np.array([[0, 3], [-2, 1]], np.int16)}
    with pytest.raises(ValueError):
        RE.memory_report(tree, 1000, 32)
    with pytest.raises(ValueError, match="negative"):
        TE.memory_report(_torch(tree), 1000, 32)
    with pytest.raises(ValueError):
        RE.entropy_bits(tree["w"], 1000)
    with pytest.raises(ValueError, match="negative"):
        TE.entropy_bits(tree["w"], 1000)
