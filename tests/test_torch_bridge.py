"""Parameter bridge and compression pipeline of the port vs the JAX package,
on the golden-decode model (qwen3-1.7b reduced to 2 layers, f32, k-means
|W|=256, ``min_size=1024``, as tests/test_golden_decode.py builds it)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as C  # noqa: E402
from repro.core import clustering as JC  # noqa: E402
from repro.core.quantizer import (WeightQuantConfig, cluster_params,  # noqa: E402
                                  init_state)
from repro.models.model_zoo import build  # noqa: E402
from repro.serving import to_codebook_params  # noqa: E402
from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.core import clustering as TC  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.serving import compress as TS  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    cfg = C.get("qwen3-1.7b").reduced().replace(n_layers=2, dtype="float32")
    params = build(cfg).init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    np_tree = jax.tree_util.tree_map(np.asarray, {"params": params,
                                                  "pq": pq, "cp": cp})
    return {**np_tree, "book": np.array(state.codebooks[""])}  # writable


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_compressed_params_round_trip_bit_identical(golden):
    back = to_numpy_tree(from_jax_params(golden["cp"], device="cpu"))
    want, got = dict(_leaves(golden["cp"])), dict(_leaves(back))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        assert got[path].tobytes() == a.tobytes(), path
    w_idx = golden["cp"]["blocks"]["attn"]["wq"]["w_idx"]
    assert w_idx.dtype == np.int8 and (w_idx < 0).any()   # negatives survive


def test_to_codebook_params_identical_given_reference_codebook(golden):
    wq = TQ.WeightQuantConfig(num_weights=256, method="kmeans")
    state = TQ.QuantizerState(codebooks={"": torch.from_numpy(golden["book"])})
    tcp = TS.to_codebook_params(from_jax_params(golden["pq"], device="cpu"),
                                wq, state, min_size=1024)
    got, want = dict(_leaves(to_numpy_tree(tcp))), dict(_leaves(golden["cp"]))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_assign_to_centers_identical(golden):
    vals = np.concatenate([v.reshape(-1) for _, v in
                           _leaves(golden["params"])]).astype(np.float32)
    book = golden["book"]
    want = np.asarray(JC.assign_to_centers(jnp.asarray(vals),
                                           jnp.asarray(book)))
    got = TC.assign_to_centers(torch.from_numpy(vals),
                               torch.from_numpy(book)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_centers", [256, 1000, 7])
def test_laplacian_l1_centers_match(golden, n_centers):
    vals = np.concatenate([v.reshape(-1) for _, v in
                           _leaves(golden["params"])]).astype(np.float32)
    want = np.asarray(JC.laplacian_l1_centers(jnp.asarray(vals), n_centers))
    got = TC.laplacian_l1_centers(torch.from_numpy(vals), n_centers).numpy()
    np.testing.assert_array_equal(TC.laplacian_l1_levels(n_centers),
                                  JC.laplacian_l1_levels(n_centers))
    # mean and max-deviation reductions sum in another order: f32 tolerance
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_global_laplacian_pipeline_matches(golden):
    """The serving compression of the launcher (laplacian_l1, |W|=1000,
    global, min_size 4096): port vs JAX, end to end."""
    cfg = C.get("qwen3-1.7b").reduced().replace(n_layers=2, dtype="float32")
    wq_j = cfg.quantized(n_weights=1000).wq
    pq, st = cluster_params(jax.tree_util.tree_map(jnp.asarray,
                                                   golden["params"]),
                            wq_j, init_state(wq_j), wq_j.interval,
                            jax.random.PRNGKey(1))
    cp = jax.tree_util.tree_map(np.asarray,
                                to_codebook_params(pq, wq_j, st))
    wq_t = TCfg.get("qwen3-1.7b").quantized(n_weights=1000).wq
    tpq, tst = TQ.cluster_params(from_jax_params(golden["params"], "cpu"),
                                 wq_t, TQ.init_state(wq_t), wq_t.interval)
    np.testing.assert_allclose(tst.codebooks[""].numpy(),
                               np.asarray(st.codebooks[""]),
                               rtol=1e-5, atol=1e-6)
    tcp = to_numpy_tree(TS.to_codebook_params(tpq, wq_t, tst))
    got, want = dict(_leaves(tcp)), dict(_leaves(cp))
    assert set(got) == set(want)
    for path, a in want.items():
        assert got[path].dtype == a.dtype, path
        if path.endswith("w_idx"):
            # ids may differ only where a weight sits on a midpoint that the
            # two codebooks (equal to f32 tolerance) place differently
            assert np.mean(got[path] != a) < 1e-4, path
            assert a.dtype == np.int16
        else:
            np.testing.assert_allclose(got[path], a, rtol=1e-5, atol=1e-6,
                                       err_msg=path)
