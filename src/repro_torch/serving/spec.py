"""Sampling filters (the port's copy of ``filter_logits`` from
``repro/serving/spec.py``; speculative decoding comes later)."""

from __future__ import annotations

import torch

__all__ = ["filter_logits", "NEG_INF"]

NEG_INF = -1e30


def filter_logits(lg: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Top-k / nucleus filtering on (..., V) f32 logits (already divided by
    temperature).  Filtered entries drop to −1e30; ``top_k=0`` and
    ``top_p>=1`` are no-ops.  Ties at the top-p threshold are kept; the
    argmax always survives.
    """
    V = lg.shape[-1]
    if top_k and top_k < V:
        kth = torch.sort(lg, dim=-1).values[..., V - top_k, None]
        lg = torch.where(lg < kth, NEG_INF, lg)
    if top_p < 1.0:
        srt = torch.flip(torch.sort(lg, dim=-1).values, dims=(-1,))
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p          # mass BEFORE the token < p
        thr = torch.amin(torch.where(keep, srt, torch.inf), dim=-1,
                         keepdim=True)
        lg = torch.where(lg < thr, NEG_INF, lg)
    return lg
