"""Quantized activation functions (paper §2.1, Fig. 1), the port's copy of
``repro/core/activations.py``.

Forward: the underlying bounded nonlinearity's output is quantized to ``L``
levels equally spaced in *output* space, endpoints included (level 0 of
ReLU6 is exactly 0, ``dx = 6/(|A|−1)``).  The implied input-space bin
boundaries sit at ``f⁻¹`` of the midpoints of adjacent levels.

``act_apply`` and ``act_index`` run the ``act_quant`` kernel in its
``act_apply`` form (``kernels/act_quant.py``) for a CUDA tensor and its
plain version for a CPU tensor: op by op in x's dtype, as the reference
computes them.  Backward: the quantization is ignored and the derivative
of the *underlying* function is used (paper §2.1), what JAX takes through
the reference's ``y + stop_gradient(q(y) − y)``, half of it at the corners
of ``clip`` and ``maximum`` as JAX's rules give it
(``ops.act_apply_quant``).  ``act_index`` has no gradient, and refuses an
input that requires one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

__all__ = ["ActQuantConfig", "act_apply", "act_index", "act_levels",
           "act_input_boundaries", "quantize_input", "ACT_RANGES"]

# Output ranges of the supported bounded nonlinearities.
ACT_RANGES = {
    "tanh": (-1.0, 1.0),
    "relu6": (0.0, 6.0),
    "sigmoid": (0.0, 1.0),
    "rtanh": (0.0, 1.0),  # rectified tanh: max(0, tanh(x))
}


def _base_fn(kind: str):
    """The continuous nonlinearity (levels == 0), as the reference's."""
    if kind == "tanh":
        return torch.tanh
    if kind == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    if kind == "sigmoid":
        return torch.sigmoid
    if kind == "rtanh":
        return lambda x: torch.clamp(torch.tanh(x), min=0.0)
    if kind == "relu":
        return F.relu
    if kind in ("none", "identity"):
        return lambda x: x
    if kind == "silu":
        return F.silu
    if kind == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation kind: {kind}")


@dataclasses.dataclass(frozen=True)
class ActQuantConfig:
    """Activation-quantization configuration.

    kind:   underlying nonlinearity ('tanh', 'relu6', 'sigmoid', 'rtanh';
            'relu'/'silu'/'gelu'/'none' are allowed only with levels == 0).
    levels: |A|; 0 disables quantization (continuous baseline).
    """

    kind: str = "tanh"
    levels: int = 0

    def __post_init__(self):
        if self.levels:
            if self.kind not in ACT_RANGES:
                raise ValueError(
                    f"activation '{self.kind}' is unbounded; cannot quantize "
                    f"(paper §3.3 switches ReLU->ReLU6 for this reason)")
            if self.levels < 2:
                raise ValueError("levels must be >= 2 (or 0 to disable)")

    @property
    def enabled(self) -> bool:
        return self.levels > 0

    @property
    def out_range(self):
        return ACT_RANGES[self.kind]

    @property
    def step(self) -> float:
        lo, hi = self.out_range
        return (hi - lo) / (self.levels - 1)


def act_levels(cfg: ActQuantConfig) -> torch.Tensor:
    """The |A| quantized output values a_0 .. a_{L-1} (float32): the
    formula of ``jnp.linspace``, ``lo·(1 − s) + hi·s`` with ``s = i/(L −
    1)`` in f32 and the last exactly ``hi``.  (Under jit XLA folds it with
    its own reassociations: the reference's may differ in the last bit.)"""
    if not cfg.enabled:
        raise ValueError("continuous activation has no discrete levels")
    lo, hi = cfg.out_range
    f32 = torch.float32
    s = (torch.arange(cfg.levels - 1, dtype=f32)
         / torch.tensor(cfg.levels - 1, dtype=f32))
    out = lo * (1.0 - s) + hi * s
    return torch.cat([out, torch.full((1,), hi, dtype=f32)])


def act_apply(cfg: ActQuantConfig, x: torch.Tensor,
              mul: torch.Tensor | None = None) -> torch.Tensor:
    """Quantized activation with the underlying function's derivative as
    its gradient (see the module docstring).  ``mul`` (x's shape and
    dtype): return the activation times ``mul`` in x's dtype, in the same
    kernel launch (a SwiGLU's gate times its up product); its gradient is
    ``g·q(f(x))``."""
    if not cfg.enabled:
        y = _base_fn(cfg.kind)(x)
        return y if mul is None else y * mul
    return ops.act_apply_quant(x, cfg.kind, cfg.levels, mul=mul)[0]


def act_index(cfg: ActQuantConfig, x: torch.Tensor) -> torch.Tensor:
    """Level index j in [0, |A|) of the quantized activation (int32): the
    row index fed to the next layer's multiplication table in the §4
    engine (paper Fig. 8/9).  No gradient: an input that requires one is
    refused."""
    if not cfg.enabled:
        raise ValueError("continuous activation has no level index")
    return ops.act_apply_quant(x, cfg.kind, cfg.levels, with_index=True)[1]


def act_input_boundaries(cfg: ActQuantConfig) -> np.ndarray:
    """Input-space thresholds b_1..b_{L-1} between adjacent output levels,
    ``f⁻¹((a_{j-1}+a_j)/2)`` (numpy float64, as the reference)."""
    if not cfg.enabled:
        raise ValueError("continuous activation has no boundaries")
    lo, hi = cfg.out_range
    levels = np.linspace(lo, hi, cfg.levels)
    mids = (levels[:-1] + levels[1:]) / 2.0
    eps = 1e-9
    if cfg.kind == "tanh":
        return np.arctanh(np.clip(mids, -1 + eps, 1 - eps))
    if cfg.kind == "relu6":
        return mids  # identity in the non-saturating region
    if cfg.kind == "sigmoid":
        m = np.clip(mids, eps, 1 - eps)
        return np.log(m / (1 - m))
    if cfg.kind == "rtanh":
        m = np.clip(mids, eps, 1 - eps)
        return np.arctanh(m)
    raise ValueError(cfg.kind)


def quantize_input(x: torch.Tensor, levels: int, lo: float,
                   hi: float) -> torch.Tensor:
    """Quantize network inputs to ``levels`` uniform values in [lo, hi]
    (the paper's Table-1 "quantized inputs"), op by op in x's dtype as the
    reference computes ``x + stop_gradient(q − x)``, whose gradient is the
    identity (straight through)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _StraightThrough.apply(x, levels, lo, hi)
    return _quantized_input(x, levels, lo, hi)


def _quantized_input(x: torch.Tensor, levels: int, lo: float,
                     hi: float) -> torch.Tensor:
    step = (hi - lo) / (levels - 1)
    dt, f32 = x.dtype, torch.float32

    def t(v):                  # a Python float as JAX rounds it to x's dtype
        return torch.tensor(v, dtype=torch.float64).to(dt).to(f32).to(
            x.device)

    def r(v):                  # one operation's result rounded to x's dtype
        return v.to(dt).to(f32)

    xf = x.to(f32)
    q = r(torch.round(r(torch.div(r(xf - t(lo)), t(step)))))
    q = r(r(torch.clamp(q, 0.0, float(t(levels - 1))) * t(step)) + t(lo))
    return r(xf + r(q - xf)).to(dt)


class _StraightThrough(torch.autograd.Function):
    """``quantize_input``'s value; x's gradient is g unchanged."""

    @staticmethod
    def forward(ctx, x, levels, lo, hi):
        return _quantized_input(x, levels, lo, hi)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None
