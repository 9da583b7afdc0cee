"""Checkpointing: atomic and async-capable, the port's copy of
``repro/checkpoint/checkpointer.py``, in the reference's layout so that
either package restores the other's checkpoints.

Layout:  <dir>/step_<n>/   manifest.json  +  one .npy per leaf, named
``<i:05d>_<path>.npy`` with the path's keys joined by ``"__"`` (leaves in
sorted-key order, as JAX flattens a dict).  Atomicity: write into
``step_<n>.tmp`` then ``os.rename`` (a crash mid-save leaves only a .tmp
that restore ignores).

numpy has no bfloat16 of its own (the reference's comes from
``ml_dtypes``, which writes descr ``'<V2'``): a bf16 leaf is stored as its
uint16 bits, the manifest's ``dtype`` saying ``bfloat16``, and any 2-byte
leaf the manifest calls ``bfloat16`` is read back as those bits.  Leaves
are stored whole; ``restore`` places each on the device of the tree it
restores into (the reference's mesh re-shard has no counterpart on one
device).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.tree import tree_map

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_MANIFEST = "manifest.json"


def _paths_of(tree, prefix=()):
    """[(name, leaf)] in sorted-key order; a name is the path's keys
    joined by ``"__"`` (``"leaf"`` for a bare leaf)."""
    if not isinstance(tree, dict):
        return [("__".join(prefix) or "leaf", tree)]
    out = []
    for k in sorted(tree):
        out.extend(_paths_of(tree[k], prefix + (str(k),)))
    return out


def _host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype) of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Blocking atomic save.  ``extra``: small JSON metadata (data cursor,
    quantizer codebook step, rng seed...)."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(_paths_of(tree)):
        arr, dtype = _host(leaf)
        fn = f"{i:05d}_{name[:80]}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"name": name, "file": fn, "dtype": dtype,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, _MANIFEST))]
    return max(steps) if steps else None


def _load(path: str, entry: dict) -> torch.Tensor:
    arr = np.load(os.path.join(path, entry["file"])).copy(order="C")
    if entry["dtype"] == "bfloat16":      # uint16 bits, or ml_dtypes' '<V2'
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, like):
    """Restore into the structure of ``like`` (a nested dict of tensors):
    each leaf found by name, its shape checked, cast to the dtype of
    ``like``'s leaf and placed on its device.  Returns (tree, extra)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_name = {e["name"]: e for e in manifest["leaves"]}

    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in node.items()}
        name = "__".join(prefix) or "leaf"
        e = by_name.get(name)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = _load(path, e)
        if tuple(t.shape) != tuple(node.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(node.shape)}")
        return t.to(device=node.device, dtype=node.dtype)

    return walk(like, ()), manifest["extra"]


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training (one in flight)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree, extra=None):
        self.wait()
        # copied to the host on the calling thread (a consistent snapshot:
        # the trainer goes on to replace the tensors), written async
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True)
                             if isinstance(t, torch.Tensor) else t, tree)

        def run():
            save(self.directory, step, host_tree, extra)
            self._gc()
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

