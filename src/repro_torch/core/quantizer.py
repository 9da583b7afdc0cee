"""Weight clustering over parameter trees (paper §2.2), the port's copy of
``repro/core/quantizer.py``: one clustering event (``cluster_params``) and
the index form of a clustered network (``codebook_indices``).

Scopes: ``global`` (one codebook for the whole network, the paper's
default) and ``per_layer`` (one codebook per parameter tensor, of
``min(|W|, size)`` centers).  Methods: ``kmeans`` (``clustering.kmeans1d``),
``laplacian_l1`` and ``uniform``; none needs a random key, so
``cluster_params`` takes none.  The reference's key feeds only k-means'
``subsample``, which comes with the training slice: a config that would
subsample raises.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core import clustering

__all__ = ["WeightQuantConfig", "QuantizerState", "init_state",
           "cluster_params", "codebook_indices", "num_weights_at",
           "param_filter"]

_SUBSAMPLE_ABOVE = 1_000_000       # the reference subsamples larger tensors


@dataclasses.dataclass(frozen=True)
class WeightQuantConfig:
    """Weight-clustering configuration (see ``repro.core.quantizer``).

    num_weights: |W| — number of unique weight values (0 disables).
    method:      'kmeans' | 'laplacian_l1' | 'uniform'.
    scope:       'global' (single codebook, paper default) | 'per_layer'.
    interval:    clustering cadence in steps (paper: 1000).
    """

    num_weights: int = 0
    method: str = "laplacian_l1"
    scope: str = "global"
    interval: int = 1000
    subsample: float = 1.0
    kmeans_iters: int = 25
    anneal_from: int = 0
    anneal_steps: int = 0
    exclude: str = ""

    def __post_init__(self):
        if self.num_weights and self.num_weights < 2:
            raise ValueError("num_weights must be >= 2 (or 0 to disable)")
        if self.method not in ("kmeans", "laplacian_l1", "uniform"):
            raise ValueError(f"unknown clustering method {self.method!r}")
        if self.scope not in ("global", "per_layer"):
            raise ValueError(f"unknown scope {self.scope!r}")

    @property
    def enabled(self) -> bool:
        return self.num_weights > 0

    def due(self, step: int) -> bool:
        """True on steps where the clustering event fires."""
        return self.enabled and step > 0 and step % self.interval == 0


@dataclasses.dataclass
class QuantizerState:
    """Codebook(s) from the most recent clustering event ({'': centers}
    for the global scope) and the step it ran at (-1 = never)."""

    codebooks: dict
    last_step: int = -1


def init_state(cfg: WeightQuantConfig) -> QuantizerState:
    del cfg
    return QuantizerState(codebooks={}, last_step=-1)


def num_weights_at(cfg: WeightQuantConfig, step: int) -> int:
    """|W| schedule: geometric decay anneal_from -> num_weights."""
    if not cfg.anneal_from or cfg.anneal_from <= cfg.num_weights:
        return cfg.num_weights
    if step >= cfg.anneal_steps:
        return cfg.num_weights
    frac = step / max(cfg.anneal_steps, 1)
    w = cfg.anneal_from * (cfg.num_weights / cfg.anneal_from) ** frac
    return max(cfg.num_weights, int(round(w)))


def param_filter(cfg: WeightQuantConfig):
    """Predicate(path) -> bool: True if this tensor is clustered."""
    if not cfg.exclude:
        return lambda path: True
    pat = re.compile(cfg.exclude)
    return lambda path: not pat.search(path)


def _flat_paths(params, prefix=()):
    """[(path tuple, leaf)] of a nested dict, keys in sorted order (the
    order JAX flattens a dict pytree in)."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out.extend(_flat_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _rebuild(params, new_leaves, prefix=()):
    return {k: (_rebuild(v, new_leaves, prefix + (k,)) if isinstance(v, dict)
                else new_leaves[prefix + (k,)])
            for k, v in params.items()}


def _centers(values: torch.Tensor, cfg: WeightQuantConfig,
             k: int) -> torch.Tensor:
    if cfg.method == "laplacian_l1":
        return clustering.laplacian_l1_centers(values, k)
    if cfg.method == "uniform":
        return clustering.uniform_centers(values, k)
    if cfg.subsample < 1.0 and values.numel() > _SUBSAMPLE_ABOVE:
        raise NotImplementedError(
            "k-means on a random subsample of the weights is not ported yet "
            f"(subsample={cfg.subsample} over {values.numel()} values)")
    return clustering.kmeans1d(values, k, iters=cfg.kmeans_iters)


def cluster_params(params, cfg: WeightQuantConfig, state: QuantizerState,
                   step: int) -> tuple[dict, QuantizerState]:
    """One clustering event: snap every (included) weight to its centroid.

    Pure function over a nested dict of tensors; callers decide the cadence
    (``cfg.due(step)``).  Codebooks are keyed ``''`` (global) or by the
    tensor's path, ``'blocks/mlp/w1/w'`` (per_layer), as the reference's.
    """
    if not cfg.enabled:
        return params, state
    k = num_weights_at(cfg, step)
    keep = param_filter(cfg)
    leaves = _flat_paths(params)
    if cfg.scope == "global":
        included = [v.reshape(-1).to(torch.float32)
                    for p, v in leaves if keep("/".join(p))]
        flat = torch.cat(included)
        del included
        centers = _centers(flat, cfg, k)
        del flat
        new = {p: clustering.quantize_to_centers(v, centers)
               if keep("/".join(p)) else v for p, v in leaves}
        books = {"": centers}
    else:
        books, new = {}, {}
        for p, v in leaves:
            path = "/".join(p)
            if keep(path) and v.numel() >= 2:
                books[path] = _centers(v.reshape(-1).to(torch.float32), cfg,
                                       min(k, v.numel()))
                new[p] = clustering.quantize_to_centers(v, books[path])
            else:
                new[p] = v
    return _rebuild(params, new), QuantizerState(codebooks=books,
                                                 last_step=step)


def codebook_indices(params, cfg: WeightQuantConfig,
                     state: QuantizerState) -> tuple[dict, dict]:
    """Index representation of a clustered network (paper §4 deployment):
    (nested dict of int32 index tensors mirroring params, codebooks dict).
    Unclustered tensors are kept verbatim.  Raises if clustering never
    ran."""
    if not state.codebooks:
        raise ValueError("no codebook yet — run cluster_params first")
    keep = param_filter(cfg)
    new = {}
    for p, v in _flat_paths(params):
        path = "/".join(p)
        book = state.codebooks.get("" if cfg.scope == "global" else path)
        if book is None or not keep(path):
            new[p] = v
            continue
        new[p] = clustering.assign_to_centers(
            v.to(torch.float32).reshape(-1),
            book.to(v.device)).reshape(v.shape)
    return _rebuild(params, new), dict(state.codebooks)
