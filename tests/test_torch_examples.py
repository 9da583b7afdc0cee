"""The port's four examples (``examples/*_torch.py``) and what they call
first here, against the JAX package's, on the CPU:

* the serving example's ``main`` and the reference's
  ``examples/serve_quantized_lm.py`` on the same small argv, the port on
  the reference's ``PRNGKey(0)`` weights (through the bridge): stdout
  equal line for line with the wall-clock figures and the KV-error
  column masked and each package's kernels line dropped; every numerics
  field equal and the KV errors within ``serving/probes.py``'s sentinel
  slack both ways;
* the quickstart's functions at 6 steps (the event at 3): its memory row
  and 12 served tokens equal to the reference's functions applied to the
  port's trained params (the reference's engine op by op, as its
  arithmetic is written);
* ``launch/paper_loops.train_classifier`` in lockstep with the
  reference's for 3 steps from the same params (each step from the
  reference's state): losses within 1e-5, the update within
  ``train_rig``'s step bound; ``recall_at`` equal on the same params; the
  MNIST example's table at 20 steps;
* ``launch/steps.abstract_params``: the reference's shapes and dtypes leaf
  for leaf for the 100m config and the reduced qwen3, the printed count
  equal; the 100m example's functions on a 2-layer, d 64 config for 2
  steps with a checkpoint, then resumed to 3;
* the four examples and ``paper_loops`` import no JAX, ``repro`` or
  ``benchmarks``.
"""

import contextlib
import importlib.util
import io
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.bridge import from_jax_params, to_numpy_tree  # noqa: E402
from repro_torch.launch import paper_loops as PL  # noqa: E402
from repro_torch.launch.steps import abstract_params  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving.probes import (golden_entry,  # noqa: E402
                                        sentinel_check)
from repro_torch.tree import leaves  # noqa: E402
from train_rig import _leaves, _scaled, STEP_TOL  # noqa: E402

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("serve_quantized_lm", "quickstart", "train_mnist_quantized",
            "train_lm_100m")
SERVE_ARGV = ["--requests", "2", "--max-new", "4", "--lut-max-new", "2",
              "--spec-k", "2", "--page-size", "4"]
_WALL = re.compile(r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request")
_KV_COL = re.compile(r"(bits +)\d+\.\d+")


def _example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _masked(out: str) -> list:
    return [_KV_COL.sub(r"\1<kv>", _WALL.sub("<wall>", ln))
            for ln in out.splitlines()
            if not ln.startswith("[telemetry] kernels:")]


# --- the serving example -----------------------------------------------------

def test_serving_example_prints_the_reference_lines(monkeypatch):
    import repro.configs as C
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine as JEngine

    ref, port = _example("serve_quantized_lm"), _example(
        "serve_quantized_lm_torch")
    cfg = C.get("llama3.2-3b").reduced().replace(kv_quant=True,
                                                 dtype="float32")
    weights = jax.tree.map(np.asarray,
                           build(cfg).init(jax.random.PRNGKey(0)))
    seen, numerics = [], JEngine.numerics

    def spy(self):
        seen.append(numerics(self))
        return seen[-1]
    monkeypatch.setattr(JEngine, "numerics", spy)
    monkeypatch.setattr(sys, "argv", ["serve_quantized_lm.py"] + SERVE_ARGV)
    _, want = _stdout(ref.main)
    monkeypatch.setattr(port, "init_params",
                        lambda model, device: from_jax_params(weights,
                                                              device))
    res, got = _stdout(port.main, SERVE_ARGV + ["--device", "cpu"])
    assert _masked(got) == _masked(want)
    assert "identical tokens" in got and res["spec_identical"]
    assert len(seen) == 3
    for g, w in zip(res["numerics"].values(), seen):
        w = jax.tree.map(lambda v: v.tolist() if hasattr(v, "tolist")
                         else v, w)
        assert set(g) == set(w)
        for k in g:
            if not k.startswith("kv_err"):
                assert g[k] == w[k], k
        assert sentinel_check(g, golden_entry(w)) == []
        assert sentinel_check(w, golden_entry(g)) == []
    pool = res["paged"].pool       # only prefix-cache registrations held
    assert all(int(pool.ref[p]) == (1 if p in pool.key_of else 0)
               for p in range(pool.n_pages))


# --- the quickstart ----------------------------------------------------------

def test_quickstart_exports_and_serves_as_the_reference():
    import repro.configs as C
    from repro.core.export import memory_report
    from repro.core.quantizer import QuantizerState, codebook_indices
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, to_codebook_params

    qs = _example("quickstart_torch")
    cfg = qs.quickstart_config(interval=3)
    (params, qstate, hist), out = _stdout(qs.train_model, cfg, steps=6,
                                          device="cpu")
    assert qstate.last_step == 3 and len(hist) == 2
    assert out.splitlines()[0] == ("== training qwen3-1.7b (reduced) with "
                                   "|A|=16, |W|=256 ==")
    (report, cparams), _ = _stdout(qs.export, cfg, params, qstate)
    tokens, _ = _stdout(qs.serve, cfg, cparams, device="cpu")
    assert len(tokens) == 12

    jcfg = C.get("qwen3-1.7b").reduced().quantized(levels=16, n_weights=256)
    jcfg = jcfg.replace(wq=jcfg.wq.__class__(num_weights=256,
                                             method="laplacian_l1",
                                             interval=3))
    jparams = jax.tree.map(jnp.asarray, to_numpy_tree(params))
    jq = QuantizerState(codebooks={k: jnp.asarray(v.numpy()) for k, v in
                                   qstate.codebooks.items()},
                        last_step=qstate.last_step)
    idx, _ = codebook_indices(jparams, jcfg.wq, jq)
    assert report.row() == memory_report(idx, 256, 16).row()
    jc = to_codebook_params(jparams, jcfg.wq, jq, min_size=1024)
    with jax.disable_jit():
        want = ServeEngine(build(jcfg), jc, max_len=48).generate(
            [qs.PROMPT], max_new=12)[0][4:]
    assert tokens == want


# --- the paper loops and the MNIST example -----------------------------------

def _mlp_apply_j(p, x, act_levels, key):
    from repro.models import papernets as JPN
    return JPN.mlp_apply(p, x, "tanh", act_levels)


def _mnist_j(s):
    from repro.data.synthetic import pseudo_mnist_batch
    return pseudo_mnist_batch(s, 64)


def test_train_classifier_in_lockstep(monkeypatch):
    """3 steps at |A| 32 with a |W| 1000 event at step 2: the reference
    run op by op, its state before and after each update recorded; the
    port starts each step from the reference's state."""
    if ROOT not in sys.path:
        monkeypatch.syspath_prepend(ROOT)
    import benchmarks._common as JC
    from repro.models import papernets as JPN

    mnist = _example("train_mnist_quantized_torch")
    kw = dict(steps=3, act_levels=32, n_weights=1000, cluster_every=2)
    steps_j, cluster = [], JC.cluster_params

    def jitted(fn):              # what the steps do not reach runs jitted
        def run(*a):
            with jax.disable_jit(False):
                return fn(*a)
        return run
    init_j = jitted(lambda k: JPN.mlp_init(k, 784, [32, 32], 10))
    monkeypatch.setattr(JC, "cluster_params", jitted(cluster))

    update = jitted(jax.jit(JC.apply_updates, static_argnums=3))

    def jspy(p, g, st, cfg):
        out = update(p, g, st, cfg)
        steps_j.append((p, st, out[0], out[1]))
        return out
    monkeypatch.setattr(JC, "apply_updates", jspy)
    with jax.disable_jit():
        jparams, _, _ = JC.train_classifier(init_j, _mlp_apply_j, _mnist_j,
                                            **kw)
    assert len(steps_j) == 3

    def tree(t):
        return from_jax_params(jax.tree.map(np.asarray, t), "cpu")

    def data(s):
        from repro_torch.data.synthetic import pseudo_mnist_batch
        return pseudo_mnist_batch(s, 64, device="cpu")

    route_u, route_g = PL.apply_updates, PL.value_and_grad
    seen = []

    def tgrad(fn, p, x, y, gen):
        (loss, aux), g = route_g(fn, p, x, y, gen)
        seen.append({"loss": float(loss), "grads": g})
        return (loss, aux), g

    def tspy(p, g, st, cfg):
        s = len(seen) - 1
        newp, _, m = route_u(p, g, st, cfg)
        seen[s]["params"] = newp
        _, _, jp1, js1 = steps_j[s]         # the reference's state after it
        return tree(jp1), tree(js1), m
    monkeypatch.setattr(PL, "value_and_grad", tgrad)
    monkeypatch.setattr(PL, "apply_updates", tspy)
    init_t = lambda gen: tree(steps_j[0][0])                  # noqa: E731
    params, _, _ = PL.train_classifier(init_t, mnist.apply_fn, data,
                                       device="cpu", **kw)
    from repro.optim import OptConfig as JOpt
    lr, eps = 2e-3, 1e-8
    for s, (jp0, jst0, jp1, _) in enumerate(steps_j):
        x, y = _mnist_j(s)["x"], _mnist_j(s)["y"]
        logits = _mlp_apply_j(jp0, x, 32, None)
        jl = float(jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, y[:, None], -1)[:, 0]))
        assert abs(seen[s]["loss"] - jl) < 1e-5, s
        tg = to_numpy_tree(seen[s]["grads"])
        mine, _, _ = update(jp0, jax.tree.map(jnp.asarray, tg), jst0,
                            JOpt(name="adam", lr=lr))
        got = dict(_leaves(to_numpy_tree(seen[s]["params"])))
        for path, w in _leaves(jax.tree.map(np.asarray, mine)):
            np.testing.assert_allclose(got[path], w, rtol=0, atol=STEP_TOL)
        # against the reference's own step: adam's conditioning of a
        # gradient near eps, as ``train_rig.check_step`` bounds it
        jg = _grads_j(jp0, x, y)
        gj, gt = _scaled(jg, 1.0), _scaled(tg, 1.0)
        for path, w in _leaves(jax.tree.map(np.asarray, jp1)):
            d = np.abs(got[path].astype(np.float64) - w)
            far = d > STEP_TOL
            a, c = gj[path][far], gt[path][far]
            slope = np.where(np.sign(a) == np.sign(c),
                             eps / (np.minimum(np.abs(a), np.abs(c))
                                    + eps) ** 2, 1.0 / eps)
            assert (d[far] <= STEP_TOL + lr * slope * np.abs(a - c)).all()
    jr = JC.recall_at(_mlp_apply_j, _mnist_j, jparams, 32)
    tr = PL.recall_at(mnist.apply_fn, data, tree(jparams), 32)
    assert jr == tr


def _grads_j(p, x, y):
    def loss(q):
        logits = _mlp_apply_j(q, x, 32, None)
        return jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, y[:, None], -1)[:, 0])
    with jax.disable_jit():
        return jax.tree.map(np.asarray, jax.grad(loss)(p))


def test_mnist_example_runs_to_its_end():
    mnist = _example("train_mnist_quantized_torch")
    table, out = _stdout(mnist.accuracy_table, steps=20, device="cpu")
    lines = out.splitlines()
    assert lines[0] == f"{'variant':28s} accuracy"
    assert [ln[:28].rstrip() for ln in lines[1:]] == [
        v[0] for v in mnist.VARIANTS]
    assert list(table) == [v[0] for v in mnist.VARIANTS]
    assert all(0.0 <= a <= 1.0 for a in table.values())


# --- abstract params and the 100m example ------------------------------------

def _shapes_j(tree) -> dict:
    return {p: (tuple(v.shape), str(np.dtype(v.dtype)))
            for p, v in _leaves(tree)}


def _shapes_t(tree) -> dict:
    return {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in _leaves(tree)}


def test_abstract_params_match_the_reference():
    import repro.configs as C
    from repro.core.quantizer import WeightQuantConfig
    from repro.launch.steps import abstract_params as j_abstract
    from repro.models.model_zoo import build

    lm = _example("train_lm_100m_torch")
    over = dict(name="qwen3-100m", n_layers=10, d_model=640, d_ff=2560,
                n_heads=10, n_kv=5, head_dim=64, vocab=50048,
                dtype="float32", act_levels=32, microbatches=1,
                wq=WeightQuantConfig(num_weights=1000, method="laplacian_l1",
                                     interval=100))
    pairs = [(C.get("qwen3-1.7b").replace(**over), lm.lm_config()),
             (C.get("qwen3-1.7b").reduced(), TC.get("qwen3-1.7b").reduced())]
    for jcfg, tcfg in pairs:
        ja, ta = j_abstract(build(jcfg)), abstract_params(tbuild(tcfg))
        assert {t.device.type for t in leaves(ta)} == {"meta"}
        assert _shapes_t(ta) == _shapes_j(ja)
    n = sum(int(math.prod(x.shape)) for x in jax.tree.leaves(
        j_abstract(build(pairs[0][0]))))
    got, out = _stdout(lm.count_params, lm.lm_config())
    assert got == n
    assert out.strip() == (f"== qwen3-100m: {n / 1e6:.1f}M params, |A|=32, "
                           "|W|=1000, cluster every 100 steps ==")


def test_lm_example_checkpoints_and_resumes(tmp_path):
    lm = _example("train_lm_100m_torch")
    cfg = lm.lm_config(n_layers=2, d_model=64, d_ff=128, n_heads=2, n_kv=1,
                       head_dim=32, vocab=512, interval=2)
    kw = dict(batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=2,
              log_every=1, device="cpu")
    (_, q, hist), out = _stdout(lm.run, cfg, steps=2, **kw)
    assert [h["step"] for h in hist] == [0, 1]
    assert CKPT.latest_step(str(tmp_path)) == 2
    assert out.splitlines()[-1] == ("(no clustering event yet — fires every "
                                    "2 steps)")
    (params, q, hist), out = _stdout(lm.run, cfg, steps=3, **kw)
    assert out.splitlines()[0] == "[resume] from step 2"
    assert [h["step"] for h in hist] == [2] and q.last_step == 2
    assert out.splitlines()[-1] == ("codebook: 1000 unique weights (last "
                                    "clustered at step 2)")
    assert CKPT.latest_step(str(tmp_path)) == 3
    assert all(bool(torch.isfinite(t).all()) for t in leaves(params))


# --- imports -----------------------------------------------------------------

_PROBE = r"""
import importlib, importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
importlib.import_module("repro_torch.launch.paper_loops")
for name in {names!r}:
    path = {root!r} + "/examples/" + name + "_torch.py"
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro", "jaxlib", "benchmarks")
                  or m.startswith(("jax.", "jaxlib.", "repro.",
                                   "benchmarks."))))
print(bad)
"""


def test_examples_import_no_jax_repro_or_benchmarks():
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT,
                         names=EXAMPLES)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_refuse_to_run_without_gpu(name, monkeypatch):
    """Without ``--device`` each example runs on the GPU: with none, it
    raises before it trains or serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _stdout(_example(f"{name}_torch").main, [])
