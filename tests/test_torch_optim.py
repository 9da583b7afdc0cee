"""The port's optimizers and LR schedules (``repro_torch.optim``) against
the JAX package's, computed live from numpy seeds: one ``apply_updates``
of each of the five names, with and without global-norm clipping, f32 and
bf16 moments, within 1e-6; the state's layout; the schedules equal (warmup_cosine within two f32 ulps
of its value: each side's own ``cos`` rounds an ulp apart at a few
steps, and the scaled result rounds once more)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402

NAMES = ("sgd", "momentum", "rmsprop", "adam", "adamw")


def _trees(seed, dtype="float32"):
    rng = np.random.default_rng(seed)

    def tree(scale):
        return {"blocks": {"w": (rng.standard_normal((3, 5, 7)) * scale)
                           .astype(np.float32)},
                "embed": {"table": (rng.standard_normal((11, 5)) * scale)
                          .astype(np.float32)},
                "b": (rng.standard_normal(4) * scale).astype(np.float32)}
    p, g = tree(1.0), tree(3.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), p)
    jg = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), g)
    np_ = lambda t: jax.tree.map(np.asarray, t)            # noqa: E731
    return jp, jg, from_jax_params(np_(jp), "cpu"), from_jax_params(
        np_(jg), "cpu")


def _close(got, want, tol):
    g, w = to_numpy_tree(got), jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), want)
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("name", NAMES)
def test_apply_updates_matches(name, clip, moments):
    """Three steps (bias correction and the warm-up schedule move), params
    and every moment within 1e-6, the count and metrics equal."""
    jp, jg, tp, tg = _trees(len(name))
    kw = dict(name=name, lr=3e-3, grad_clip=clip, weight_decay=0.05,
              moments_dtype=moments)
    jc = JO.OptConfig(**kw, schedule=JO.warmup_cosine(2, 10))
    tc = TO.OptConfig(**kw, schedule=TO.warmup_cosine(2, 10))
    js, ts = JO.init_opt_state(jp, jc), TO.init_opt_state(tp, tc)
    for _ in range(3):
        jp, js, jm = JO.apply_updates(jp, jg, js, jc)
        tp, ts, tm = TO.apply_updates(tp, tg, ts, tc)
    _close(tp, jp, 1e-6)
    assert sorted(ts) == sorted(js)
    for k in js:
        if k == "count":
            assert ts[k].dtype == torch.int32 and int(ts[k]) == 3
        else:
            leaf = next(iter(jax.tree.leaves(ts[k])))
            assert str(leaf.dtype).endswith(moments)
            _close(ts[k], js[k], 1e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)
    assert float(tm["lr"]) == float(jm["lr"])


def test_bf16_params_update_in_f32_and_cast_back():
    jp, jg, tp, tg = _trees(9, "bfloat16")
    jc, tc = JO.OptConfig(name="adamw"), TO.OptConfig(name="adamw")
    jp, _, _ = JO.apply_updates(jp, jg, JO.init_opt_state(jp, jc), jc)
    tp, _, _ = TO.apply_updates(tp, tg, TO.init_opt_state(tp, tc), tc)
    assert tp["b"].dtype == torch.bfloat16
    g = jax.tree.leaves(to_numpy_tree(tp))
    w = jax.tree.leaves(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp))
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def test_unknown_name_refused():
    with pytest.raises(ValueError):
        TO.init_opt_state({"w": torch.zeros(2)}, TO.OptConfig(name="lion"))


@pytest.mark.parametrize("sched", ["constant", "warmup_cosine",
                                   "step_decay"])
def test_schedules_equal(sched):
    args = {"constant": (), "warmup_cosine": (20, 100),
            "step_decay": (7, 0.5)}[sched]
    jf, tf = getattr(JO, sched)(*args), getattr(TO, sched)(*args)
    ulps = 2 if sched == "warmup_cosine" else 0
    for step in list(range(0, 130, 3)) + [19, 20, 21, 99, 100]:
        want = np.float32(jf(jnp.int32(step)))
        for got in (tf(torch.tensor(step, dtype=torch.int32)), tf(step)):
            got = np.float32(got)
            assert abs(got - want) <= ulps * np.spacing(want), (step, got,
                                                                want)
