"""Port matmul backends (``repro_torch.kernels.dispatch``) vs the JAX
package's: lut grid and table bytes, int32 accumulators, and each backend's
contraction on the benchmark shapes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import dispatch as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

torch.set_num_threads(2)

BENCH = [(m, k, n) for m in (1, 8, 64) for k in (128, 256) for n in (128, 256)]


def _book(seed, W, scale=0.05):
    rng = np.random.default_rng(seed)
    return np.sort(rng.standard_normal(W).astype(np.float32) * scale)


@pytest.mark.parametrize("W,fan_in", [(256, 512), (1000, 6144),
                                      (1000, 152064), (17, 33)])
def test_lut_spec_and_table_bytes(W, fan_in):
    book = _book(W + fan_in, W)
    js, ts = JD.make_lut_spec(book, fan_in), TD.make_lut_spec(book, fan_in)
    assert (ts.a_min, ts.a_max, ts.levels, ts.s) == \
        (js.a_min, js.a_max, js.levels, js.s)
    jt = np.asarray(JD.build_lut_table(jnp.asarray(book), js))
    tt = TD.build_lut_table(torch.from_numpy(book), ts).numpy()
    assert tt.dtype == np.int32 and tt.shape == jt.shape
    assert tt.tobytes() == jt.tobytes()


def test_stacked_table_and_attach():
    book = _book(5, 256)
    spec = TD.make_lut_spec(book, 512)
    stacked = np.broadcast_to(book, (3, 256)).copy()
    jt = np.asarray(JD.build_lut_table(jnp.asarray(stacked),
                                       JD.make_lut_spec(book, 512)))
    tt = TD.build_lut_table(torch.from_numpy(stacked), spec).numpy()
    assert tt.shape == (3, spec.levels, 256)
    assert tt.tobytes() == jt.tobytes()
    params = {"embed": {"w_idx": torch.zeros((8, 4), dtype=torch.int8),
                        "codebook": torch.from_numpy(book)},
              "blocks": {"w1": {"w_idx": torch.zeros((3, 4, 4),
                                                     dtype=torch.int8),
                                "codebook": torch.from_numpy(stacked)}}}
    out = TD.attach_lut_tables(params, spec)
    assert "lut_table" not in out["embed"]
    assert tuple(out["blocks"]["w1"]["lut_table"].shape) == (3, 4096, 256)


def _x_w(seed, m, k, n, W=256):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    wi = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return x, wi, _book(seed, W)


@pytest.mark.parametrize("m,k,n", BENCH)
def test_lut_accumulators_identical(m, k, n):
    x, wi, book = _x_w(m + k + n, m, k, n)
    js, ts = JD.make_lut_spec(book, k), TD.make_lut_spec(book, k)
    want = np.asarray(JD._lut_acc(jnp.asarray(x), jnp.asarray(wi),
                                  jnp.asarray(book), js))
    got = TD.lut_acc(torch.from_numpy(x), torch.from_numpy(wi),
                     torch.from_numpy(book), ts).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["codebook", "lut"])
@pytest.mark.parametrize("m,k,n", BENCH)
def test_backend_matmul_matches(backend, m, k, n):
    x, wi, book = _x_w(7 * m + k + n, m, k, n)
    js = JD.make_lut_spec(book, k) if backend == "lut" else None
    ts = TD.make_lut_spec(book, k) if backend == "lut" else None
    with JD.use_backend(backend, js):
        want = np.asarray(JD.backend_matmul(jnp.asarray(x)[None],
                                            jnp.asarray(wi),
                                            jnp.asarray(book)))
    got = TD.backend_matmul(torch.from_numpy(x)[None], torch.from_numpy(wi),
                            torch.from_numpy(book),
                            TD.BackendSpec(backend, ts)).numpy()
    assert got.shape == want.shape == (1, m, n)
    if backend == "lut":        # identical accumulators, identical decode
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * k)


@pytest.mark.parametrize("m,k,n", [(1, 128, 128), (64, 256, 256)])
def test_dense_backend_matches(m, k, n):
    x, wi, book = _x_w(3 + m, m, k, n)
    p_j = {"w_idx": jnp.asarray(wi), "codebook": jnp.asarray(book)}
    p_t = {"w_idx": torch.from_numpy(wi), "codebook": torch.from_numpy(book)}
    want = np.asarray(JL.dense(p_j, jnp.asarray(x)))
    got = TL.dense(p_t, torch.from_numpy(x), TD.DENSE).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * k)


def test_backend_spec_validates():
    with pytest.raises(ValueError):
        TD.BackendSpec("lut")
    with pytest.raises(ValueError):
        TD.BackendSpec("pallas")
