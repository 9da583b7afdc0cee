"""Training loops of the paper's own networks, the port's copy of
``train_classifier`` and ``recall_at`` from the JAX package's
``benchmarks/_common.py`` (which imports JAX, so the port keeps its own).

``apply_fn(params, x, act_levels, gen) -> logits`` takes a
``torch.Generator`` (or None) where the reference takes a PRNG key;
``data_fn(step) -> {'x', 'y'}`` gives each step's batch on the params'
device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantizer import (WeightQuantConfig, cluster_params,
                                        init_state)
from repro_torch.device import resolve_device
from repro_torch.launch.steps import value_and_grad
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

__all__ = ["train_classifier", "recall_at"]


def _gen(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def train_classifier(init_fn, apply_fn, data_fn, *, steps=300, lr=2e-3,
                     act_levels=0, n_weights=0, cluster_every=100,
                     opt="adam", seed=0, method="laplacian_l1",
                     subsample=1.0, device=None):
    """Classification under the paper's two quantizations: ``init_fn(gen)``
    on a generator seeded with ``seed`` (on ``device``, the GPU when
    None), then ``steps`` steps of ``opt`` on the mean of logsumexp minus
    the true logit, the clustering event whenever ``wq.due(s)`` (on a
    generator seeded ``1000 + s``), and a last snap on generator 99.
    Returns (params, qstate, wq)."""
    dev = resolve_device(device)
    params = init_fn(_gen(dev, seed))
    ocfg = OptConfig(name=opt, lr=lr)
    opt_state = init_opt_state(params, ocfg)
    wq = WeightQuantConfig(num_weights=n_weights, method=method,
                           interval=cluster_every, subsample=subsample) \
        if n_weights else WeightQuantConfig()
    qstate = init_state(wq)

    def loss_fn(p, x, y, gen):
        logits = apply_fn(p, x, act_levels, gen)
        true = torch.take_along_dim(logits, y[:, None].long(), -1)[:, 0]
        loss = torch.mean(torch.logsumexp(logits, -1) - true)
        return loss, loss

    for s in range(steps):
        if wq.due(s):
            params, qstate = cluster_params(params, wq, qstate, s,
                                            _gen(dev, 1000 + s))
        b = data_fn(s)
        _, g = value_and_grad(loss_fn, params, b["x"], b["y"], _gen(dev, s))
        params, opt_state, _ = apply_updates(params, g, opt_state, ocfg)
    if wq.enabled:
        params, qstate = cluster_params(params, wq, qstate, steps,
                                        _gen(dev, 99))
    return params, qstate, wq


@torch.no_grad()
def recall_at(apply_fn, data_fn, params, act_levels, ks=(1, 5), n_batches=4,
              start=5000):
    """Top-k recall over ``n_batches`` batches from step ``start``: the
    share of rows whose label is among the k largest logits."""
    hits = {k: 0 for k in ks}
    tot = 0
    for s in range(start, start + n_batches):
        b = data_fn(s)
        logits = apply_fn(params, b["x"], act_levels, None)
        order = np.argsort(-logits.float().cpu().numpy(), axis=-1)
        y = b["y"].cpu().numpy()
        for k in ks:
            hits[k] += (order[:, :k] == y[:, None]).any(-1).sum()
        tot += y.size
    return {k: hits[k] / tot for k in ks}
