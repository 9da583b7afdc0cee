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
