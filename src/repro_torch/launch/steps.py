"""The training step, the port's copy of ``make_train_step`` from
``repro/launch/steps.py``, on one device, and ``abstract_params``: the
reference's mesh, its sharding specs and its other abstract-shape helpers
wait for tensor parallelism.
"""

from __future__ import annotations

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.optim import OptConfig, apply_updates, apply_updates_
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["make_train_step", "value_and_grad", "abstract_params"]

_ACC_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def abstract_params(model: Model):
    """The params' shapes and dtypes as a tree of ``meta`` tensors: the
    reference's ``jax.eval_shape`` of ``init``.  The meta device draws no
    random numbers and allocates nothing."""
    return model.init(torch.Generator(), "meta")


def value_and_grad(loss_fn, params, *args):
    """((loss, aux), grads): ``loss_fn(params, *args)`` returns (scalar
    loss, aux); its gradient is taken on detached copies of the params
    that require grad (the params themselves never do), a tree of their
    structure.  A leaf the loss does not read (the vlm's ``embed``, whose
    prompts come in as embeddings under an untied head) gets zeros in its
    dtype, as ``jax.grad`` gives it.  ``jax.value_and_grad(...,
    has_aux=True)``'s counterpart."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_fn(p, *args)
    ps = list(leaves(p))
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, ps)]
    return (loss.detach(), aux), unflatten(p, grads)


def _microbatch(batch: dict, nmb: int, i: int) -> dict:
    """Slice ``i`` of ``nmb`` of a batch, as the reference's ``split_mb``
    cuts it: every leaf on its first dim, the vlm's (3, B, L)
    ``positions`` on its batch dim."""
    out = {}
    for k, x in batch.items():
        if k == "positions":
            out[k] = x.reshape((3, nmb, x.shape[1] // nmb)
                               + x.shape[2:])[:, i]
        else:
            out[k] = x.reshape((nmb, x.shape[0] // nmb) + x.shape[1:])[i]
    return out


def make_train_step(model: Model, ocfg: OptConfig, donate: bool = False):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``model.loss``'s gradient (``value_and_grad``), then ``apply_updates``
    returns new trees, or with ``donate`` (the reference trainer's
    ``donate_argnums=(0, 1)``) ``apply_updates_`` writes them into
    ``params`` and ``opt_state`` and returns those same tensors.  With
    ``cfg.microbatches`` N > 1 the batch is processed in N sequential
    slices (``_microbatch``), bounding activation memory at 1/N while
    keeping the same update: the grads are averaged in the moments dtype,
    the metrics are the slices' mean."""
    cfg = model.cfg
    nmb = max(1, cfg.microbatches)

    def grad_fn(params, batch):
        (_, metrics), grads = value_and_grad(model.loss, params, batch)
        return metrics, grads

    def step(params, opt_state, batch):
        if nmb == 1:
            metrics, grads = grad_fn(params, batch)
        else:
            acc_dt = _ACC_DTYPES[cfg.moments_dtype]
            grads, ms = None, []
            for i in range(nmb):
                m_i, g = grad_fn(params, _microbatch(batch, nmb, i))
                div = torch.full((), nmb, dtype=acc_dt,
                                 device=next(leaves(params)).device)
                g = tree_map(lambda b: b.to(acc_dt) / div, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                ms.append(m_i)
            del g       # the last slice's gradients: not held over the update
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]), dim=0)
                       for k in ms[0]}
        update = apply_updates_ if donate else apply_updates
        params, opt_state, om = update(params, grads, opt_state, ocfg)
        return params, opt_state, {**metrics, **om}

    return step
