"""LR schedules: step -> multiplier (composed with OptConfig.lr), the port's
copy of ``repro/optim/schedules.py``.  ``step`` is an int or a 0-d tensor
(the optimizer's int32 ``count``); the multiplier is then an f32 tensor on
its device, computed in f32 as the reference computes it."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine", "step_decay"]


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b by a true division (CUDA divides by a Python scalar through
    its reciprocal, which is not the reference's division)."""
    return a / torch.full((), float(b), dtype=a.dtype, device=a.device)


def constant():
    return lambda step: 1.0


def warmup_cosine(warmup: int, total: int, floor: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = _div(s, max(warmup, 1))
        prog = torch.clamp(_div(s - warmup, max(total - warmup, 1)), 0, 1)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return f


def step_decay(every: int, rate: float = 0.5):
    """The paper's AlexNet 'stepwise decaying learning rate'."""
    def f(step):
        s = _f32(step)
        return torch.pow(torch.full((), rate, dtype=torch.float32,
                                    device=s.device),
                         torch.floor(_div(s, every)))
    return f
