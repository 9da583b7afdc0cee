"""The collectives of tensor-parallel serving over a mesh's ``model`` group
(``launch/mesh.py``): ``psum`` and ``pmax`` (an all-reduce in place) and
``all_gather`` (a column-sharded activation made whole).  Every call is
counted in the mesh's ``CollectiveStats``: calls, bytes and the largest
payload an op moved, so a test or the smoke can bound what a step sends.

On a one-rank ``model`` axis every op is the identity.  The groups are
gloo's in this slice, on the CPU and on the card, where gloo takes CUDA
tensors for all three ops itself (it moves them through host memory), so
no op here stages a tensor through the host.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

__all__ = ["CollectiveStats", "psum", "pmax", "all_gather"]


class CollectiveStats:
    """What one mesh's collectives moved, by op: ``calls``, ``bytes`` (the
    payload: the reduced tensor, or the gathered output) and
    ``max_bytes`` (the largest payload of one call).  A caller that sets
    ``clock`` (a host clock; the package reads none of its own) also gets
    the ``seconds`` spent in them, each call bracketed by device
    synchronizations."""

    def __init__(self):
        self.clock = None
        self.reset()

    def reset(self) -> None:
        self.calls, self.bytes = Counter(), Counter()
        self.max_bytes, self.seconds = Counter(), Counter()

    def largest(self) -> int:
        """The largest payload of one call since the last reset."""
        return max(self.max_bytes.values(), default=0)


def _timed(mesh, op: str, t: torch.Tensor, nbytes: int, fn):
    st = mesh.stats
    st.calls[op] += 1
    st.bytes[op] += nbytes
    st.max_bytes[op] = max(st.max_bytes[op], nbytes)
    if st.clock is None:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = st.clock()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    st.seconds[op] += st.clock() - t0
    return out


def _reduce(t: torch.Tensor, mesh, op: str, red) -> torch.Tensor:
    if mesh.tp == 1:
        return t
    nbytes = t.numel() * t.element_size()
    _timed(mesh, op, t, nbytes,
           lambda: dist.all_reduce(t, op=red, group=mesh.group))
    return t


def psum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the ``model`` group, in place; returns ``t``.  An
    int32 sum wraps, as the lut kernel's does."""
    return _reduce(t, mesh, "psum", dist.ReduceOp.SUM)


def pmax(t: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise max of ``t`` over the ``model`` group, in place."""
    return _reduce(t, mesh, "pmax", dist.ReduceOp.MAX)


def all_gather(t: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim`` in rank
    order: a column-sharded activation made whole on every rank."""
    if mesh.tp == 1:
        return t

    def run():
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(mesh.tp)]
        dist.all_gather(parts, src, group=mesh.group)
        return torch.cat(parts, dim)

    return _timed(mesh, "all_gather", t, t.numel() * t.element_size()
                  * mesh.tp, run)
