"""Serving-time tensor-parallel placement (the port's copy of the serving
parts of ``repro/distributed/sharding.py``): parameter path → spec, the
decode cache's spec, and the slice of a tensor one rank keeps.

A spec is a tuple with one entry per dim: ``None`` (replicated), an axis
name (``'data'``, ``'model'``, ``'pod'``) or a tuple of axis names, as
``tuple(jax.sharding.PartitionSpec(...))`` gives it (a one-name tuple
collapses to the name, as PartitionSpec normalizes it).

Policy (TP over ``'model'``): column-parallel matrices (wq, wk, wv, w1,
w3, ...) shard their output dim, row-parallel ones (wo, w2, ...) their
input dim; ``serve_param_specs`` keeps that for the block matmuls only (a
float ``w`` or the integer ``w_idx``) and replicates everything else:
embeddings, codebooks, norm vectors and lut tables.  The contiguous decode
cache (L, B, S, KV, hd) shards its sequence dim over ``'model'``.

The MoE expert weights replicate here, as in the reference; their EP/TP
cut is ``models/moe.moe_param_specs``.  The training-time specs
(``param_specs``, ``moments_spec``) wait for the mesh-tooling slice;
``repro/distributed/compat.py`` only shims JAX versions and has no
counterpart here.
"""

from __future__ import annotations

import re

import torch

__all__ = ["dp_axes", "serve_param_specs", "cache_spec", "local_slice"]

_F = "data"
_M = "model"


def _spec(*parts) -> tuple:
    """A spec tuple with PartitionSpec's normalization: a one-name tuple
    entry is the name itself."""
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else p
                 for p in parts)


def dp_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _rule(path: str, shape: tuple, fsdp: bool = True) -> tuple:
    """The spec of the parameter at ``path`` ('blocks/attn/wq/w_idx'-style)
    with ``shape``; stacked (layer, group) leading dims get ``None``."""
    r = len(shape)
    tail = path.split("/")[-1]
    F = _F if fsdp else None

    def wrap(spec):
        return _spec(*([None] * (r - len(spec))), *spec)

    if re.search(r"(embed|lm_head|pos_embed)", path):
        if "pos_embed" in path:
            return wrap((None, None))
        if "lm_head" in path:
            return wrap((F, _M))       # (d, V)
        return wrap((_M, None))        # (V, d)
    if tail in ("scale", "bias", "A_log", "D", "dt_bias", "w0", "u", "mix",
                "b"):
        return _spec(*([None] * r))
    if "conv_w" in path:
        return wrap((None, _M))
    if tail in ("w", "w_idx") and re.search(
            r"(wq|wk|wv|w1|w3|wg|wr|in_proj|w_lora_a|up)", path):
        return wrap((F, _M))
    if tail in ("w", "w_idx") and re.search(
            r"(wo|w2|out_proj|w_lora_b|down)", path):
        return wrap((_M, F))
    if tail == "w" and re.search(r"router", path):
        return _spec(*([None] * r))
    if tail in ("w", "w_idx"):
        return wrap((F, None))
    return _spec(*([None] * r))


def serve_param_specs(params):
    """The serving placement of ``params`` (a nested dict of tensors, meta
    tensors included), as a nested dict of specs of the same structure:
    block matmuls (a float ``w`` or the integer ``w_idx``, at least 2-D,
    under ``blocks``, outside a MoE layer) keep their column/row ``model``
    sharding from ``_rule``; every other leaf replicates."""
    def visit(node, parts):
        if isinstance(node, dict):
            return {k: visit(v, parts + [k]) for k, v in node.items()}
        path = "/".join(parts)
        if (parts[-1] in ("w", "w_idx") and node.ndim >= 2
                and "blocks" in path and "moe" not in path):
            spec = _rule(path, tuple(node.shape), fsdp=False)
            if _M in spec:
                return spec
        return _spec(*([None] * node.ndim))

    return visit(params, [])


def cache_spec(mesh, kind: str = "kv") -> tuple:
    """Decode-cache layout: (L, B, S, KV, hd) batch over dp, S over
    ``model``; SSM states (L, B, H, N, P) heads over ``model``; (L, B,
    1/K, C) vectors channels over ``model``."""
    dp = dp_axes(mesh)
    if kind == "kv":
        return _spec(None, dp, _M, None, None)
    if kind == "ssm":
        return _spec(None, dp, _M, None, None)
    if kind == "vec":
        return _spec(None, dp, None, _M)
    raise ValueError(kind)


def local_slice(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The block of ``t`` that this rank of ``mesh`` keeps under ``spec``:
    each dim named by an axis (or a tuple of axes, major first) is cut
    into equal parts, and the rank's coordinate picks one.  A cut block
    is a contiguous copy, so the full tensor can be freed."""
    cut = False
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.shape[a], i * mesh.shape[a] + mesh.coords[a]
        if n == 1:
            continue
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not "
                             f"split over {axes} ({n} ways)")
        step = t.shape[dim] // n
        t, cut = t.narrow(dim, i * step, step), True
    return t.clone(memory_format=torch.contiguous_format) if cut else t
