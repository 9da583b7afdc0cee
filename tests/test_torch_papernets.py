"""The paper's own nets (``repro_torch.models.papernets``) and their inputs
(``repro_torch.data.synthetic``) against the JAX package's, computed live in
the same process.

Inits: the reference's tree (keys, shapes, dtypes, zero biases, each leaf's
std within sampling error).  Forwards on the reference's own parameters,
bridged: within 1e-5 of the output's range at ``act_levels`` 0 and 32.  At
32 every activation site is held to the reference's (``lock_acts``): a
level that differs must be a flip at a boundary tie, counted (at most one
in 1000 activations), and the port then goes on with the reference's
activations.  The conv padding traps (XLA's asymmetric "SAME" at stride 2,
``conv_transpose`` without a flipped kernel) are held exactly on their own.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as JC  # noqa: E402
from repro.core.activations import act_input_boundaries  # noqa: E402
from repro.data import synthetic as JS  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro.models import papernets as JP  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch import configs as TCF  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.core.activations import ActQuantConfig  # noqa: E402
from repro_torch.data import synthetic as TS  # noqa: E402
from repro_torch.kernels import dispatch as TD  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import papernets as TP  # noqa: E402

torch.set_num_threads(2)
CPU = "cpu"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


# (name, reference init, port init): the sizes of the apply tests, and
# AlexNet at full width on 64 × 64 images
INITS = {
    "mlp": (lambda k: JP.mlp_init(k, 784, [32], 10),
            lambda g: TP.mlp_init(g, 784, [32], 10, device=CPU)),
    "fc_autoencoder": (lambda k: JP.fc_autoencoder_init(k, 768, 0.5),
                       lambda g: TP.fc_autoencoder_init(g, 768, 0.5,
                                                        device=CPU)),
    "conv_autoencoder": (lambda k: JP.conv_autoencoder_init(k, 0.5),
                         lambda g: TP.conv_autoencoder_init(g, 0.5,
                                                            device=CPU)),
    "alexnet_w0.25_img32": (
        lambda k: JP.alexnet_init(k, n_classes=10, width=0.25, img=32),
        lambda g: TP.alexnet_init(g, n_classes=10, width=0.25, img=32,
                                  device=CPU)),
    "alexnet_w1_img64": (
        lambda k: JP.alexnet_init(k, width=1.0, img=64),
        lambda g: TP.alexnet_init(g, width=1.0, img=64, device=CPU)),
}


@pytest.mark.parametrize("name", list(INITS))
def test_init_tree_matches_reference(name):
    jinit, tinit = INITS[name]
    want = _leaves(_np(jinit(jax.random.PRNGKey(0))))
    got = _leaves(to_numpy_tree(tinit(torch.Generator().manual_seed(0))))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if path[-1] == "b":
            assert not g.any() and not w.any(), path
            continue
        n = g.size
        # the sample std of n normals errs by about std/√(2n) on each side
        assert abs(g.std() - w.std()) <= 6 * w.std() / np.sqrt(n), path
        assert abs(g.mean()) <= 6 * w.std() / np.sqrt(n), path


def lock_acts(monkeypatch, rel: float = 1e-5) -> dict:
    """Hold every activation site of the port to the reference's.

    Each reference ``ffn_act`` records its input and output; each port
    call, in the same order, checks its input within ``rel`` of the
    site's largest |x|, and its output: at ``levels`` 0 within the same
    bound, at ``levels`` > 0 equal but where a level flipped at a
    boundary tie (one level apart, both inputs within that bound of the
    boundary between the two levels), counted.  The port then goes on
    with the reference's output, so later layers compare equal streams.
    The reference must run first."""
    recorded = []
    stats = {"sites": 0, "acts": 0, "flips": 0}
    jact, tact = JP.ffn_act, TP.ffn_act

    def reference(x, kind, levels):
        y = jact(x, kind, levels)
        recorded.append((np.array(x, np.float32), np.array(y, np.float32)))
        return y

    def port(x, kind, levels):
        xw, yw = recorded.pop(0)
        y = tact(x, kind, levels)
        xp, yp = x.numpy(), y.numpy()
        tol = rel * max(1.0, float(np.abs(xw).max()))
        assert xp.shape == xw.shape and np.abs(xp - xw).max() <= tol
        if levels == 0:
            assert np.abs(yp - yw).max() <= tol
        else:
            cfg = ActQuantConfig(TL._bounded(kind), levels)
            lo, _ = cfg.out_range
            lp = np.rint((yp - lo) / cfg.step).astype(int)
            lw = np.rint((yw - lo) / cfg.step).astype(int)
            flip = lp != lw
            if flip.any():
                assert (np.abs(lp - lw)[flip] == 1).all(), "not one level"
                edge = act_input_boundaries(cfg)[np.minimum(lp, lw)[flip]]
                assert (np.abs(xp[flip] - edge) <= tol).all() and \
                    (np.abs(xw[flip] - edge) <= tol).all(), "not a tie"
            stats["flips"] += int(flip.sum())
        stats["sites"] += 1
        stats["acts"] += yw.size
        return torch.from_numpy(yw)

    monkeypatch.setattr(JP, "ffn_act", reference)
    monkeypatch.setattr(TP, "ffn_act", port)
    return stats


def _apply_case(name, kind):
    """(reference params, reference apply, port apply, input); the
    inputs copied out of JAX's read-only buffers."""
    key = jax.random.PRNGKey(3)
    if name == "mlp":
        x = np.array(JS.pseudo_mnist_batch(5, 16)["x"])
        return (JP.mlp_init(key, 784, [32], 10), JP.mlp_apply, TP.mlp_apply,
                x)
    if name == "fc_autoencoder":
        x = np.array(JS.smooth_images(5, 8, 16)["x"]).reshape(8, -1)
        return (JP.fc_autoencoder_init(key, 768, 0.5),
                JP.fc_autoencoder_apply, TP.fc_autoencoder_apply, x)
    if name == "conv_autoencoder":
        x = np.array(JS.smooth_images(5, 4, 16)["x"])
        return (JP.conv_autoencoder_init(key, 0.5), JP.conv_autoencoder_apply,
                TP.conv_autoencoder_apply, x)
    x = np.array(JS.class_images(5, 4, 32, n_classes=10)["x"])
    return (JP.alexnet_init(key, n_classes=10, width=0.25, img=32),
            JP.alexnet_apply, TP.alexnet_apply, x)


SITES = {"mlp": 1, "fc_autoencoder": 7, "conv_autoencoder": 8, "alexnet": 7}


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("name,kind", [
    ("mlp", "tanh"), ("fc_autoencoder", "tanh"),
    ("conv_autoencoder", "tanh"), ("alexnet", "relu6"), ("alexnet", "relu")])
def test_apply_matches_reference(monkeypatch, name, kind, levels):
    jp, japply, tapply, x = _apply_case(name, kind)
    tp = from_jax_params(_np(jp), CPU)
    stats = lock_acts(monkeypatch) if levels else None
    want = np.asarray(japply(jp, jnp.asarray(x), kind, levels))
    with torch.no_grad():
        got = tapply(tp, torch.from_numpy(x), kind, levels).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    rng_ = float(want.max() - want.min())
    assert np.abs(got - want).max() <= 1e-5 * rng_, (
        np.abs(got - want).max(), rng_)
    if stats is not None:
        assert stats["sites"] == SITES[name]
        assert stats["flips"] * 1000 <= stats["acts"]


@pytest.mark.parametrize("hw", [(16, 16), (15, 15), (17, 12)])
def test_conv_same_stride2_exact(hw):
    """k = 5, stride 2 (AlexNet's c1) on even and odd sides: XLA pads the
    low side by the smaller half (1, 2 on an even side)."""
    rng = np.random.default_rng(sum(hw))
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((5, 5, 3, 8)).astype(np.float32),
         "b": rng.standard_normal(8).astype(np.float32)}
    want = np.asarray(JP._conv(jax.tree_util.tree_map(jnp.asarray, p),
                               jnp.asarray(x), 2))
    got = TP._conv(from_jax_params(p, CPU), torch.from_numpy(x), 2).numpy()
    assert got.shape == want.shape == (2, -(-hw[0] // 2), -(-hw[1] // 2), 8)
    np.testing.assert_array_equal(got, want)
    assert TP._same_pads(hw[0], 5, 2) == ((1, 2) if hw[0] % 2 == 0
                                          else (2, 2))


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_conv_transpose_exact(hw):
    """``lax.conv_transpose`` (k 2, stride 2, "SAME"), the kernel not
    flipped there: the port flips it for ``F.conv_transpose2d``."""
    rng = np.random.default_rng(sum(hw))
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((2, 2, 3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    want = np.asarray(JP._conv_t(jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x), 2))
    got = TP._conv_t(from_jax_params(p, CPU), torch.from_numpy(x), 2).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    np.testing.assert_array_equal(got, want)


def test_maxpool_matches_reference():
    x = np.random.default_rng(4).standard_normal((2, 9, 8, 3)).astype(
        np.float32)
    want = np.asarray(JP._maxpool(jnp.asarray(x)))
    np.testing.assert_array_equal(TP._maxpool(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.fixture(scope="module")
def index_mlp():
    """784→[32]→10 with the reference's weights snapped to a k-means
    |W| = 256 codebook, in index form (int16 ids, f32 biases)."""
    p = _np(JP.mlp_init(jax.random.PRNGKey(7), 784, [32], 10))
    flat = jnp.concatenate([jnp.asarray(v).ravel() for _, v in _leaves(p)])
    book = JC.kmeans1d(flat, 256)
    idx = {k: {"w_idx": np.asarray(JC.assign_to_centers(
                   jnp.asarray(v["w"]), book)).astype(np.int16),
               "codebook": np.asarray(book),
               "b": np.asarray(JC.quantize_to_centers(jnp.asarray(v["b"]),
                                                      book))}
           for k, v in p.items()}
    x = np.array(JS.pseudo_mnist_batch(9, 32)["x"])
    return SimpleNamespace(idx=idx, book=np.asarray(book), x=x)


@pytest.mark.parametrize("levels", [0, 32])
@pytest.mark.parametrize("backend", ["dense", "codebook", "lut"])
def test_index_mlp_backends_match_reference(monkeypatch, index_mlp, backend,
                                            levels):
    """The index-form MLP through each backend against the reference under
    ``dispatch.use_backend``: lut exact (identical accumulators and
    decode), dense and codebook at the port's backend tolerance (rtol 2e-5,
    atol 2e-5 · K).  The hidden activation is locked to the reference's at
    both levels: torch's and XLA's tanh differ in the last bit, and the
    lut snap of a continuous activation would round such a tie apart."""
    c = index_mlp
    js = JD.make_lut_spec(c.book, 784) if backend == "lut" else None
    ts = TD.make_lut_spec(c.book, 784) if backend == "lut" else None
    stats = lock_acts(monkeypatch, 2e-5)
    jp = jax.tree_util.tree_map(jnp.asarray, c.idx)
    with JD.use_backend(backend, js):
        want = np.asarray(JP.mlp_apply(jp, jnp.asarray(c.x), "tanh", levels))
    with torch.no_grad():
        got = TP.mlp_apply(from_jax_params(c.idx, CPU), torch.from_numpy(c.x),
                           "tanh", levels, TD.BackendSpec(backend, ts)).numpy()
    if backend == "lut":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * 784)
    assert stats["sites"] == 1 and stats["flips"] * 1000 <= stats["acts"]


def test_dropout():
    """Rate 0 is no dropout; with a generator the result is deterministic,
    and the kept entries are scaled by 1/(1 − rate)."""
    p = TP.alexnet_init(torch.Generator().manual_seed(1), n_classes=10,
                        width=0.25, img=32, device=CPU)
    x = torch.from_numpy(np.array(JS.class_images(2, 2, 32,
                                                    n_classes=10)["x"]))
    with torch.no_grad():
        base = TP.alexnet_apply(p, x)
        assert torch.equal(TP.alexnet_apply(
            p, x, dropout_rate=0.0, generator=torch.Generator().manual_seed(0)),
            base)
        assert torch.equal(TP.alexnet_apply(p, x, dropout_rate=0.5), base)
        a = TP.alexnet_apply(p, x, dropout_rate=0.5,
                             generator=torch.Generator().manual_seed(5))
        b = TP.alexnet_apply(p, x, dropout_rate=0.5,
                             generator=torch.Generator().manual_seed(5))
        assert torch.equal(a, b) and not torch.equal(a, base)
    h = torch.rand((64, 512), generator=torch.Generator().manual_seed(2)) + 0.5
    d = TP._dropout(h, 0.25, torch.Generator().manual_seed(3))
    kept = d != 0
    assert torch.equal(d[kept], h[kept] / 0.75)
    assert abs(kept.float().mean().item() - 0.75) < 0.02


@pytest.mark.parametrize("levels", [0, 32])
def test_alexnet_head_of_features_is_apply(levels):
    """``alexnet_head`` of ``alexnet_features`` is ``alexnet_apply`` bit for
    bit, so a caller that needs the trunk's output runs the trunk once."""
    p = TP.alexnet_init(torch.Generator().manual_seed(4), n_classes=10,
                        width=0.25, img=32, device=CPU)
    x = torch.from_numpy(np.array(JS.class_images(3, 2, 32,
                                                    n_classes=10)["x"]))
    with torch.no_grad():
        feat = TP.alexnet_features(p, x, "relu6", levels)
        assert torch.equal(TP.alexnet_head(p, feat, "relu6", levels),
                           TP.alexnet_apply(p, x, "relu6", levels))


@pytest.mark.parametrize("step", [0, 7, 1234])
def test_synthetic_batches_byte_equal(step):
    cases = [
        (JS.TokenPipeline(1000, 4, 16, seed=3).batch_at(step),
         TS.TokenPipeline(1000, 4, 16, seed=3, device=CPU).batch_at(step)),
        (JS.pseudo_mnist_batch(step, 16), TS.pseudo_mnist_batch(
            step, 16, device=CPU)),
        (JS.smooth_images(step, 4, 16), TS.smooth_images(step, 4, 16,
                                                         device=CPU)),
        (JS.parabola_batch(step, 32), TS.parabola_batch(step, 32,
                                                        device=CPU)),
        (JS.class_images(step, 4, 32, n_classes=50),
         TS.class_images(step, 4, 32, n_classes=50, device=CPU)),
    ]
    for want, got in cases:
        assert sorted(got) == sorted(want)
        for k in want:
            w, g = np.asarray(want[k]), got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert g.tobytes() == w.tobytes(), k


def test_paper_family_refused_by_build():
    """Both packages build the paper nets through ``papernets``, never
    through the model handle."""
    with pytest.raises(ValueError) as want:
        JZ.build(JR.paper_alexnet())
    with pytest.raises(ValueError) as got:
        TZ.build(TCF.get("paper-alexnet"))
    assert "papernets" in str(got.value) and "papernets" in str(want.value)


def test_dense_init_bias_option():
    """``bias=True`` adds zero biases of the stacked shape; the default
    tree (every existing caller's) is unchanged."""
    g = torch.Generator().manual_seed(0)
    p = TL.dense_init(g, 4, 3, torch.float32, CPU)
    assert sorted(p) == ["w"]
    q = TL.dense_init(torch.Generator().manual_seed(0), 4, 3, torch.bfloat16,
                      CPU, layers=(2,), bias=True)
    assert sorted(q) == ["b", "w"] and q["b"].dtype == torch.bfloat16
    assert tuple(q["b"].shape) == (2, 3) and not q["b"].any()
    assert torch.equal(p["w"], TL.dense_init(torch.Generator().manual_seed(0),
                                             4, 3, torch.float32, CPU)["w"])
