"""Serving-side weight compression: dense params → codebook-index form
(the port's copy of ``repro/serving/compress.py``).

Every clustered matrix is replaced by ``{'w_idx': intN, 'codebook': f32}``;
``models.layers.dense`` and the embedding lookup dispatch on that structure.
"""

from __future__ import annotations

import torch

from repro_torch.core import clustering
from repro_torch.core.quantizer import (QuantizerState, WeightQuantConfig,
                                        param_filter)

__all__ = ["to_codebook_params", "index_dtype_for"]


def index_dtype_for(n_weights: int) -> torch.dtype:
    if n_weights <= 256:
        return torch.int8
    if n_weights <= 65536:
        return torch.int16
    return torch.int32


def to_codebook_params(params, cfg: WeightQuantConfig, state: QuantizerState,
                       min_size: int = 4096,
                       stacked_prefixes=("blocks", "enc_blocks")):
    """Convert every clustered ≥2-D tensor to index form.

    Tensors below ``min_size`` stay dense.  Ids at or above 2^(bits−1) of
    the narrow index type are stored as negatives (two's complement), as the
    JAX package stores them.  Leaves under ``stacked_prefixes`` carry a
    leading layer dim; their codebook is tiled to (L, |W|).
    """
    if not state.codebooks:
        raise ValueError("no codebook; run cluster_params first")
    keep = param_filter(cfg)
    idt = index_dtype_for(cfg.num_weights)

    def visit(path_parts, leaf):
        path = "/".join(path_parts)
        tail = path_parts[-1] if path_parts else ""
        if tail not in ("w", "table") or leaf.ndim < 2 \
                or leaf.numel() < min_size or not keep(path):
            return None  # unchanged
        book = state.codebooks.get("" if cfg.scope == "global" else path)
        if book is None:
            return None
        book = book.to(leaf.device)
        idx = clustering.assign_to_centers(
            leaf.to(torch.float32).reshape(-1), book).reshape(leaf.shape)
        if path_parts[0] in stacked_prefixes:
            book = book[None].expand((leaf.shape[0],) + book.shape)
        return {"w_idx": idx.to(idt), "codebook": book.contiguous()}

    def walk(node, parts):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(v, dict):
                    out[k] = walk(v, parts + [k])
                else:
                    rep = visit(parts + [k], v)
                    if rep is not None and k in ("w", "table"):
                        # replace the whole {'w': ...} entry with index form
                        return {**{kk: vv for kk, vv in node.items()
                                   if kk != k}, **rep}
                    out[k] = v
            return out
        return node

    return walk(params, [])
