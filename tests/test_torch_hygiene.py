"""The port stands alone: it imports neither JAX nor the ``repro`` package,
and its entry points never fall back to the CPU on their own."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
importlib.import_module("chip_smoke")
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro", "jaxlib")
                  or m.startswith(("jax.", "jaxlib.", "repro."))))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_repro():
    code = _PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.strip().split(" ", 1)
    assert int(n) >= 15, r.stdout        # every module of the package
    assert bad == "[]", f"loaded {bad}"


def test_entry_points_refuse_to_run_without_gpu(monkeypatch):
    from repro_torch import configs
    from repro_torch.bridge import from_jax_params
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("qwen3-1.7b").reduced()
    model = build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_params({"w": np.zeros(2, np.float32)})
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, max_len=32, paged=True, kv_dtype="int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_paged_cache(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    # asked for explicitly, the CPU runs the plain versions
    eng = ServeEngine(model, params, max_len=32, device="cpu")
    assert len(eng.generate([[1, 2]], max_new=2)[0]) == 4
    eng = ServeEngine(model, params, max_len=32, device="cpu", paged=True,
                      page_size=4, kv_dtype="int8")
    assert len(eng.serve([[1, 2]], max_new=2)[0]) == 4


_MOE_SERVE = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
sys.path.insert(0, {src!r})
import torch
from repro_torch import configs
from repro_torch.models.model_zoo import build
from repro_torch.serving import ServeEngine, SpecConfig
model = build(configs.get("qwen3-moe-30b-a3b").reduced())
params = model.init(torch.Generator().manual_seed(0), "cpu")
kws = [dict(), dict(paged=True, page_size=8, kv_dtype="int8"),
       dict(spec=SpecConfig(k=2)), dict(probes=True)]
for kw in kws:
    eng = ServeEngine(model, params, max_len=32, max_batch=2, device="cpu",
                      **kw)
    out = eng.serve([[1, 2, 3], [4, 5], [6, 7, 8, 9]], max_new=3)
    assert [len(o) for o in out] == [6, 5, 7], out
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro", "jaxlib")
                  or m.startswith(("jax.", "jaxlib.", "repro."))))
print("repro_torch.models.moe" in sys.modules, bad)
"""


def test_moe_serving_paths_import_no_jax_and_no_repro():
    """The ``moe`` family served through the contiguous, paged int8,
    speculative and probed engine with ``jax`` blocked: nothing of JAX or
    of the reference package is loaded."""
    code = _MOE_SERVE.format(src=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ""})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "True []", r.stdout


def test_moe_entry_points_refuse_to_run_without_gpu(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(configs.get("grok-1-314b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced"])
