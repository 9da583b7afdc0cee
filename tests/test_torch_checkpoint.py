"""The port's checkpointing and fault tolerance (``repro_torch.checkpoint``,
``repro_torch.distributed.fault_tolerance``, the trainer's resume): the
twins of ``tests/test_checkpoint_ft.py`` in the port alone (round trip,
an incomplete checkpoint ignored, a failure injected at step 12 then a
resume whose losses are within 1e-5 of an uninterrupted run, the
straggler monitor), and checkpoints across packages: one the JAX package
wrote (f32 and bf16 leaves) restores leaf for leaf into the port's tree,
and the port's f32 checkpoint restores into the reference's."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as CKPT  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    FailureInjector, SimulatedFailure, StragglerMonitor)
from repro_torch.launch.train import TrainLoopConfig, train  # noqa: E402


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "h": torch.linspace(-2, 2, 7).to(torch.bfloat16)},
            "count": torch.tensor(3, dtype=torch.int32),
            "codebooks": {"": torch.linspace(-1, 1, 9)}}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    CKPT.save(str(tmp_path), 7, tree, extra={"step": 7})
    assert CKPT.latest_step(str(tmp_path)) == 7
    like = {"a": torch.zeros(3, 4),
            "b": {"c": torch.zeros(5, dtype=torch.int32),
                  "h": torch.zeros(7, dtype=torch.bfloat16)},
            "count": torch.tensor(0, dtype=torch.int32),
            "codebooks": {"": torch.zeros(9)}}
    out, extra = CKPT.restore(str(tmp_path), 7, like)
    for (p, x), (q, y) in zip(_leaves(tree), _leaves(out)):
        assert p == q and x.dtype == y.dtype
        assert torch.equal(x, y), p
    assert extra["step"] == 7
    path = os.path.join(tmp_path, "step_00000007")
    names = sorted(os.listdir(path))
    assert names == ["00000_a.npy", "00001_b__c.npy", "00002_b__h.npy",
                     "00003_codebooks__.npy", "00004_count.npy",
                     "manifest.json"]
    assert np.load(os.path.join(path, "00002_b__h.npy")).dtype == np.uint16


def test_incomplete_checkpoint_ignored(tmp_path):
    CKPT.save(str(tmp_path), 5, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000009.tmp")       # crashed mid-save
    os.makedirs(tmp_path / "step_00000010")           # no manifest
    assert CKPT.latest_step(str(tmp_path)) == 5


def test_restore_refuses_a_wrong_shape_or_missing_leaf(tmp_path):
    CKPT.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        CKPT.restore(str(tmp_path), 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf b"):
        CKPT.restore(str(tmp_path), 1, {"b": torch.ones(2)})


def test_async_checkpointer_keeps_the_newest(tmp_path):
    ck = CKPT.AsyncCheckpointer(str(tmp_path), keep=2)
    t = {"w": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        t["w"] += 1                     # the snapshot is taken at save()
        ck.save(s, t, extra={"step": s})
    ck.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    out, _ = CKPT.restore(str(tmp_path), 4, {"w": torch.zeros(3)})
    assert torch.equal(out["w"], torch.full((3,), 4.0))


def test_injected_failure_then_resume_matches_uninterrupted(tmp_path):
    """Kill at step 12, restart, final losses must match an uninterrupted
    run within 1e-5 (params + opt + data cursor all restored)."""
    cfg = TC.get("qwen3-1.7b").reduced().replace(n_layers=1)
    loop = TrainLoopConfig(steps=20, batch=2, seq=16, ckpt_dir=str(tmp_path),
                           ckpt_every=5, log_every=1, device="cpu")
    with pytest.raises(SimulatedFailure):
        train(cfg, loop, injector=FailureInjector(fail_at_step=12),
              log=lambda *a: None)
    assert CKPT.latest_step(str(tmp_path)) == 10
    logs = []
    _, _, hist_resumed = train(cfg, loop, log=logs.append)
    assert logs[0] == "[resume] from step 10"

    loop2 = TrainLoopConfig(steps=20, batch=2, seq=16, ckpt_dir="",
                            log_every=1, device="cpu")
    _, _, hist_clean = train(cfg, loop2, log=lambda *a: None)
    resumed = {h["step"]: h["loss"] for h in hist_resumed}
    clean = {h["step"]: h["loss"] for h in hist_clean}
    for s in range(11, 20):
        assert abs(resumed[s] - clean[s]) < 1e-5, (s, resumed[s], clean[s])


def test_failure_injector_reads_the_environment(monkeypatch):
    monkeypatch.setenv("REPRO_FAIL_AT_STEP", "3")
    inj = FailureInjector()
    assert inj.fail_at_step == 3
    inj.maybe_fail(2)
    with pytest.raises(SimulatedFailure, match="step 3"):
        inj.maybe_fail(3)
    assert FailureInjector(fail_at_step=5).fail_at_step == 5


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0, warmup=2)
    for _ in range(4):
        assert not m.observe(1.0)
    assert m.observe(10.0)
    assert not m.observe(1.1)
    assert m.stragglers == 1
    ticks = iter([0.0, 2.5])
    with StragglerMonitor.timer(m, lambda: next(ticks)) as t:
        pass
    assert t.seconds == 2.5 and not t.straggler


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, dtype):
    """The JAX package's checkpointer writes (a bf16 leaf with numpy
    descr '<V2'); the port restores every leaf bit for bit."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import checkpoint as JCKPT
    rng = np.random.default_rng(4)
    tree = {"params": {"w": jnp.asarray(rng.standard_normal((4, 6)),
                                        dtype=dtype),
                       "b": jnp.asarray(rng.standard_normal(6), dtype=dtype)},
            "opt": {"m": {"w": jnp.zeros((4, 6)), "b": jnp.ones(6)},
                    "count": jnp.asarray(4, jnp.int32)},
            "codebooks": {"": jnp.linspace(-1, 1, 5)}}
    JCKPT.save(str(tmp_path), 3, tree, extra={"step": 3, "cluster_step": 2})
    tdt = getattr(torch, dtype)
    like = {"params": {"w": torch.zeros(4, 6, dtype=tdt),
                       "b": torch.zeros(6, dtype=tdt)},
            "opt": {"m": {"w": torch.zeros(4, 6), "b": torch.zeros(6)},
                    "count": torch.tensor(0, dtype=torch.int32)},
            "codebooks": {"": torch.zeros(5)}}
    out, extra = CKPT.restore(str(tmp_path), 3, like)
    assert extra == {"step": 3, "cluster_step": 2}
    for (p, got), (q, want) in zip(_leaves(out), _leaves(
            jax.tree.map(np.asarray, tree))):
        assert p == q
        g = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        w = want.view(np.int16) if want.dtype.name == "bfloat16" else want
        np.testing.assert_array_equal(g.numpy(), w)


def test_port_f32_checkpoint_restores_into_the_reference(tmp_path):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import checkpoint as JCKPT
    tree = {"w": torch.randn(3, 4), "count": torch.tensor(2,
                                                           dtype=torch.int32)}
    CKPT.save(str(tmp_path), 2, tree, extra={"step": 2})
    out, extra = JCKPT.restore(str(tmp_path), 2,
                               {"w": jnp.zeros((3, 4)),
                                "count": jnp.asarray(0, jnp.int32)})
    np.testing.assert_array_equal(np.asarray(out["w"]), tree["w"].numpy())
    assert int(out["count"]) == 2 and extra == {"step": 2}


_TRAIN_NO_JAX = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
from repro_torch.launch import train
train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "3", "--quant",
            "--cluster-every", "2", "--ckpt-dir", {ckpt!r}, "--ckpt-every",
            "2", "--device", "cpu"])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro", "jaxlib")
                  or m.startswith(("jax.", "jaxlib.", "repro."))))
print(bad)
"""


def test_trainer_runs_with_jax_blocked(tmp_path):
    """The launcher trains, clusters and checkpoints with ``jax`` blocked:
    nothing of JAX or of the reference package is loaded."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _TRAIN_NO_JAX.format(src=os.path.join(root, "src"),
                                ckpt=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]", r.stdout
    assert CKPT.latest_step(str(tmp_path)) == 3
