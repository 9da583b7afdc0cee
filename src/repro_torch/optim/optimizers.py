"""Optimizers over parameter trees, the port's copy of
``repro/optim/optimizers.py`` (the paper trains with ADAM and RMSProp;
SGD(+momentum) for the §2.1 claim that quantized activations train under
"all of the currently popular training algorithms").

Pure functions over nested dicts of tensors, so the state checkpoints
like the params: moments in ``moments_dtype``, an int32 0-d ``count`` on
the params' device.  Each update runs in f32 in the reference's order and
is cast back to the parameter's dtype.  ``torch.optim`` is not used: its
Adam orders the arithmetic differently.  ``apply_updates_`` is the one
update that writes its inputs, as the reference's donated step does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "apply_updates_",
           "global_norm"]

_MDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_MOMENTS = {"adam": ("m", "v"), "adamw": ("m", "v"), "rmsprop": ("v",),
            "momentum": ("m",), "sgd": ()}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # sgd | momentum | rmsprop | adam | adamw
    lr: float = 1e-3               # peak lr (schedules multiply this)
    schedule: Callable | None = None   # step -> multiplier
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    rms_decay: float = 0.9
    grad_clip: float = 1.0         # global-norm clip; 0 disables
    moments_dtype: str = "float32"

    def lr_at(self, step):
        mult = self.schedule(step) if self.schedule is not None else 1.0
        return self.lr * mult


def _device(tree) -> torch.device:
    return next(leaves(tree)).device


def init_opt_state(params, cfg: OptConfig):
    if cfg.name not in _MOMENTS:
        raise ValueError(cfg.name)
    dt = _MDT[cfg.moments_dtype]
    state = {k: tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                           device=p.device), params)
             for k in _MOMENTS[cfg.name]}
    state["count"] = torch.zeros((), dtype=torch.int32,
                                 device=_device(params))
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's sum of
    squares in f32."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _unaliased(*trees) -> None:
    """Raises when two leaves of ``trees`` overlap in memory: an in-place
    update would write such a leaf twice."""
    spans = []
    for x in (t for tree in trees for t in leaves(tree)):
        if x.numel():
            last = sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
            spans.append((str(x.device), x.data_ptr(),
                          x.data_ptr() + (last + 1) * x.element_size()))
    spans.sort()
    for a, b in zip(spans, spans[1:]):
        if a[0] == b[0] and b[1] < a[2]:
            raise ValueError("donated update: two leaves of the params and "
                             "optimizer state share memory")


def _consume(tree):
    """The leaves of ``tree`` in ``leaves`` order, each removed from its
    dict as it is handed out."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _consume(tree[k])
        else:
            yield tree.pop(k)


def _paths(tree, at=()) -> list:
    """The key paths of ``tree``'s leaves, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], at + (k,))]
    return [at]


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig):
    """One optimizer step.  Returns new (params, state, metrics); the
    inputs are not written."""
    return _update(params, grads, state, cfg, donate=False)


@torch.no_grad()
def apply_updates_(params, grads, state, cfg: OptConfig):
    """``apply_updates`` in place, the reference trainer's
    ``donate_argnums``: each leaf's new param and moments are written into
    the old ones, one leaf at a time, and ``count`` is incremented in
    place, so the returned trees are the inputs, bit-equal to
    ``apply_updates``'.  ``grads`` is consumed: each leaf is taken out of
    its dict once its update is written, so it can be freed."""
    return _update(params, grads, state, cfg, donate=True)


def _update(params, grads, state, cfg: OptConfig, donate: bool):
    step = state["count"]
    lr = cfg.lr_at(step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.grad_clip:
        # tensor / tensor: ``scalar / tensor`` is a reciprocal times the
        # scalar in PyTorch, not the reference's division
        clip = torch.full((), cfg.grad_clip, dtype=torch.float32,
                          device=gnorm.device)
        scale = torch.minimum(torch.ones_like(clip),
                              clip / torch.clamp(gnorm, min=1e-9))
    dt = _MDT[cfg.moments_dtype]
    f32 = torch.float32
    t1 = step.to(f32) + 1

    def upd(g, p, *moments):
        """(new p, *new moments in ``_MOMENTS`` order)."""
        # the clipped gradient is f32 whatever g's dtype: JAX promotes
        # g · scale (an f32 array) to f32
        g32 = g.to(f32) * scale if scale is not None else g.to(f32)
        p32 = p.to(f32)
        if cfg.name in ("adam", "adamw"):
            m, v = moments
            m32 = cfg.b1 * m.to(f32) + (1 - cfg.b1) * g32
            v32 = cfg.b2 * v.to(f32) + (1 - cfg.b2) * g32 * g32
            mh = m32 / (1 - torch.pow(torch.full_like(t1, cfg.b1), t1))
            vh = v32 / (1 - torch.pow(torch.full_like(t1, cfg.b2), t1))
            delta = mh / (torch.sqrt(vh) + cfg.eps)
            if cfg.name == "adamw" and cfg.weight_decay:
                delta = delta + cfg.weight_decay * p32
            new = (m32.to(dt), v32.to(dt))
        elif cfg.name == "rmsprop":
            v, = moments
            v32 = cfg.rms_decay * v.to(f32) + (1 - cfg.rms_decay) * g32 * g32
            delta = g32 / (torch.sqrt(v32) + cfg.eps)
            new = (v32.to(dt),)
        elif cfg.name == "momentum":
            m, = moments
            m32 = cfg.momentum * m.to(f32) + g32
            delta = m32
            new = (m32.to(dt),)
        else:  # sgd
            delta = g32
            new = ()
        return ((p32 - lr * delta).to(p.dtype),) + new

    names = _MOMENTS[cfg.name]
    trees = (params, *(state[k] for k in names))
    want = _paths(params)
    for tree in (grads,) + trees[1:]:
        if _paths(tree) != want:
            raise ValueError("apply_updates: the gradients and the moments "
                             "must have the params' tree structure")
    if donate:
        _unaliased(*trees, step)
    fresh = [[] for _ in trees]      # the new leaves, without donation
    for old, g in zip(zip(*map(leaves, trees)),
                      _consume(grads) if donate else leaves(grads)):
        for o, n, acc in zip(old, upd(g, *old), fresh):
            if donate:
                o.copy_(n)
            else:
                acc.append(n)
        del g, n
    metrics = {"grad_norm": gnorm, "lr": lr}
    if donate:
        step.add_(1)
        return params, state, metrics
    new_state = {k: unflatten(state[k], f) for k, f in zip(names, fresh[1:])}
    new_state["count"] = step + 1
    return unflatten(params, fresh[0]), new_state, metrics
