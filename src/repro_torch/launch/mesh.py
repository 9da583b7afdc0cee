"""Meshes over ``torch.distributed`` (the port's copy of
``repro/launch/mesh.py``) and ``run_ranks``, which spawns the ranks of
one.

A ``Mesh`` is one rank's view of a ``('data', 'model')`` grid of ranks:
the axis sizes, this rank's coordinates, the process group of its
``model`` axis (the ranks it shares a tensor-parallel model with) and the
``CollectiveStats`` of ``distributed/collectives.py``.  Ranks are laid out
row-major: rank = data_index · model + model_index.

The process groups are gloo's in this slice, on the CPU and on the card
(where every rank may share one device); NCCL, with a card of its own per
rank, waits for a machine with more than one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import importlib.util
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing

from repro_torch.distributed.collectives import CollectiveStats

__all__ = ["Mesh", "MeshLayout", "make_local_mesh", "make_production_mesh",
           "run_ranks", "FileFunction"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axes and sizes, without ranks."""

    axis_names: tuple
    shape: dict


class Mesh:
    """This rank's view of a mesh: ``axis_names``, ``shape`` ({axis:
    size}), ``coords`` ({axis: this rank's index}), ``group`` (the
    ``model`` axis' process group; None on a one-rank axis) and ``stats``
    (its collectives' counts)."""

    def __init__(self, shape: dict, coords: dict, group=None):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.group = group
        self.stats = CollectiveStats()

    @property
    def tp(self) -> int:
        """The tensor-parallel degree: the ``model`` axis' size."""
        return self.shape.get("model", 1)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, coords={self.coords})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production layouts, single-pod (16, 16) = 256 ranks
    or multi-pod (2, 16, 16) = 512, as a layout only: building one takes
    as many ranks, which no machine of this port has."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"),
                          {"pod": 2, "data": 16, "model": 16})
    return MeshLayout(("data", "model"), {"data": 16, "model": 16})


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh over the initialized world (one rank when
    ``torch.distributed`` is not initialized).  As the reference's, a
    world too small for data · model gives (world, 1).  Every rank of the
    world calls it, in the same order (the groups are made collectively);
    a rank outside the mesh raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data * model > world:
        data, model = world, 1
    if rank >= data * model:
        raise ValueError(f"rank {rank} is outside the ({data}, {model}) "
                         f"mesh of a {world}-rank world")
    group = None
    if model > 1:
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)])
            if d == rank // model:
                group = g
    return Mesh({"data": data, "model": model},
                {"data": rank // model, "model": rank % model}, group)


# how long a rank waits in one collective before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


def _rank_main(rank: int, world: int, tmp: str, threads: int, fn, args):
    # the ranks share the host's cores: each its share of intra-op threads
    # (oversubscribed, they spin against each other's collectives)
    torch.set_num_threads(threads)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        world_size=world, rank=rank, timeout=_TIMEOUT)
    try:
        out = fn(rank, *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _load_file(path: str):
    """The Python file ``path`` loaded as a module of its own (once a
    process), under a name no importer uses."""
    name = "_file_" + "".join(c if c.isalnum() else "_" for c in path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class FileFunction:
    """The module-level function ``name`` of the Python file ``path``, a
    ``run_ranks`` function that a script can hand its ranks: it pickles as
    the path and the name, and each rank loads the file by its path, so
    the ranks do not depend on the name (if any) the script was imported
    under."""

    path: str
    name: str

    def __call__(self, *args):
        return getattr(_load_file(os.path.abspath(self.path)),
                       self.name)(*args)


def run_ranks(fn, world: int, args: tuple = (),
              tmp_dir: str | None = None) -> list:
    """Spawn ``world`` processes that join one gloo world (a ``file://``
    rendezvous in a fresh temporary directory under ``tmp_dir``, never a
    fixed port), run ``fn(rank, *args)`` in each and return their results
    in rank order.  ``fn`` and ``args`` are pickled, so ``fn`` is a
    module-level function of an importable module or a ``FileFunction``;
    results come back by ``torch.save``.  Each rank takes 1/world of this
    process' intra-op threads.  A rank that raises makes this raise; a
    collective that waits 600 s raises."""
    with tempfile.TemporaryDirectory(dir=tmp_dir) as tmp:
        threads = max(1, torch.get_num_threads() // world)
        torch.multiprocessing.spawn(
            _rank_main, args=(world, tmp, threads, fn, args),
            nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
