"""Weight clustering over parameter trees (paper §2.2), the port's copy of
the parts of ``repro/core/quantizer.py`` that serving compression needs.

``WeightQuantConfig`` and ``param_filter`` are copied as they are.
``cluster_params`` implements the ``scope="global"`` branch for the
``laplacian_l1`` method, which needs no random key: one codebook for the
whole network, every included tensor snapped to its nearest center.  The
k-means and uniform methods and the per-layer scope come with the training
slice.
"""

from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core import clustering

__all__ = ["WeightQuantConfig", "QuantizerState", "init_state",
           "cluster_params", "num_weights_at", "param_filter"]


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


def cluster_params(params, cfg: WeightQuantConfig, state: QuantizerState,
                   step: int) -> tuple[dict, QuantizerState]:
    """One clustering event: snap every (included) weight to its centroid.

    Global scope, ``laplacian_l1`` only: the closed form needs the mean and
    the largest deviation of all included weights, and no random key.
    """
    if not cfg.enabled:
        return params, state
    if cfg.scope != "global" or cfg.method != "laplacian_l1":
        raise NotImplementedError(
            "the port clusters with scope='global', method='laplacian_l1' "
            f"only; got scope={cfg.scope!r}, method={cfg.method!r}")
    k = num_weights_at(cfg, step)
    keep = param_filter(cfg)
    leaves = _flat_paths(params)
    included = [v.reshape(-1).to(torch.float32)
                for p, v in leaves if keep("/".join(p))]
    flat = torch.cat(included)
    centers = clustering.laplacian_l1_centers(flat, k)
    del flat, included
    new = {p: clustering.quantize_to_centers(v, centers)
           if keep("/".join(p)) else v for p, v in leaves}
    return _rebuild(params, new), QuantizerState(codebooks={"": centers},
                                                 last_step=step)
