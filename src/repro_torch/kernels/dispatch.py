"""Serving-time matmul backends: ``dense`` | ``codebook`` | ``lut`` (the
port's copy of ``repro/kernels/dispatch.py``, single device).

* ``dense``    — gather the codebook, then a plain matmul (in
                 ``models.layers.dense``).
* ``codebook`` — ``ops.codebook_matmul``: indices stay narrow in device
                 memory and are dequantized on chip.
* ``lut``      — ``ops.lut_matmul``: the paper's §4 engine.  Activations are
                 snapped to a uniform level grid, the table
                 M[a, w] = rint(a·w·2^s/Δa) is gathered and accumulated in
                 int32, and the accumulator is decoded once at the end.

In JAX the backend is trace-time global state (``use_backend``,
``bind_backend``) because of jit caching.  Here it is a ``BackendSpec``
value that the engine holds and passes down to every ``dense`` call.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels import ops, probes

__all__ = ["BACKENDS", "LutSpec", "BackendSpec", "make_lut_spec",
           "build_lut_table", "attach_lut_tables", "backend_matmul",
           "lut_acc", "DENSE"]

BACKENDS = ("dense", "codebook", "lut")


@dataclasses.dataclass(frozen=True)
class LutSpec:
    """Static description of the §4 integer emulation grid.

    a_min/a_max: activation clip range covered by the level grid.
    levels:      |A| — number of activation levels (grid resolution Δa).
    s:           fixed-point scale exponent chosen by ``make_lut_spec`` so
                 ``fan_in · max|M|`` fits an int32 accumulator.
    """

    a_min: float
    a_max: float
    levels: int
    s: int

    @property
    def da(self) -> float:
        return (self.a_max - self.a_min) / (self.levels - 1)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """How one model's index-form matmuls run: the backend name and, for
    ``lut``, its grid."""

    name: str = "dense"
    lut_spec: LutSpec | None = None

    def __post_init__(self):
        if self.name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; expected one "
                             f"of {BACKENDS}")
        if self.name == "lut" and self.lut_spec is None:
            raise ValueError("backend 'lut' needs a LutSpec (make_lut_spec)")


DENSE = BackendSpec()


def make_lut_spec(codebook, fan_in: int, *, levels: int = 4096,
                  a_range: tuple[float, float] = (-16.0, 16.0),
                  acc_bits: int = 32) -> LutSpec:
    """Pick the largest scale s with a static no-overflow guarantee:
    ``fan_in · max|a| · max|w| · 2^s / Δa < 2^(acc_bits−1)``."""
    a_min, a_max = a_range
    da = (a_max - a_min) / (levels - 1)
    wmax = float(np.max(np.abs(np.asarray(codebook, np.float64))))
    amax = max(abs(a_min), abs(a_max))
    headroom = 2.0 ** (acc_bits - 1) - 1
    s = int(np.floor(np.log2(headroom * da / max(fan_in * wmax * amax, 1e-30))))
    if s < 1:
        raise ValueError(
            f"no int{acc_bits} scale fits fan_in={fan_in}, max|w|={wmax:.3g}, "
            f"grid ±{amax}: coarsen the grid or widen the accumulator")
    return LutSpec(a_min=a_min, a_max=a_max, levels=levels, s=s)


def build_lut_table(codebook: torch.Tensor, spec: LutSpec) -> torch.Tensor:
    """The §4 multiplication table M[a, w] = rint(a·w·2^s/Δa) as int32.

    Accepts a (|W|,) codebook or a layer-stacked (L, |W|) one; the grid axis
    is appended second-to-last → (|A|, |W|) or (L, |A|, |W|).  The f32
    operation order is the reference's as its engine runs it (eagerly, at
    engine set-up): ``a_min + i·Δa`` as a rounded product then a rounded
    sum, ``avals·codebook``, ``·(2^s/Δa)`` with the scalar rounded to f32,
    half-to-even rint.  (Under ``jax.jit`` XLA on the CPU fuses the grid's
    multiply-add and rounds once, which moves some table entries.)
    """
    dev = codebook.device
    da = torch.tensor(spec.da, dtype=torch.float32, device=dev)
    avals = spec.a_min + torch.arange(spec.levels, dtype=torch.float32,
                                      device=dev) * da
    scale = torch.tensor((2.0 ** spec.s) / spec.da, dtype=torch.float32,
                         device=dev)
    prod = avals[:, None] * codebook.to(torch.float32)[..., None, :]
    return torch.round(prod * scale).to(torch.int32)


def attach_lut_tables(params, spec: LutSpec):
    """A ``lut_table`` leaf next to every index-form dict that ``dense``
    routes (the embedding's is skipped: its lookup and the tied logits
    dequantize through the codebook)."""
    def walk(node, parts):
        if not isinstance(node, dict):
            return node
        if "w_idx" in node and "codebook" in node \
                and "embed" not in parts and node["w_idx"].ndim >= 2:
            return {**node, "lut_table": build_lut_table(node["codebook"],
                                                         spec)}
        return {k: walk(v, parts + [k]) for k, v in node.items()}

    return walk(params, [])


def backend_matmul(x: torch.Tensor, w_idx: torch.Tensor,
                   codebook: torch.Tensor, backend: BackendSpec,
                   table: torch.Tensor | None = None) -> torch.Tensor:
    """``x @ codebook[w_idx]`` through a non-dense backend.

    x: (..., K) float; w_idx: (K, N) ids; codebook: (|W|,); table: the
    precomputed (|A|, |W|) lut table (rebuilt from the codebook when None).
    Returns (..., N) in x.dtype.  Under an open probes frame the call is
    counted (``probes.tap_matmul``).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if backend.name == "codebook":
        y = ops.codebook_matmul(x2, w_idx, codebook)
    elif backend.name == "lut":
        spec = backend.lut_spec
        acc = lut_acc(x2, w_idx, codebook, spec, table)
        y = acc.to(torch.float32) * (spec.da / (2.0 ** spec.s))
    else:
        raise ValueError(f"backend_matmul called with {backend.name!r}")
    # the numerics taps: the full activations and the f32 output, before
    # the cast (a no-op unless a probes frame is open)
    probes.tap_matmul(x2, y, backend.name, backend.lut_spec)
    return y.reshape(*lead, -1).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _grid_step(spec: LutSpec, device: torch.device) -> torch.Tensor:
    """Δa as an f32 tensor on ``device``, made once per spec and device:
    a call then copies no scalar to the card (a copy that a stream being
    captured into a CUDA graph refuses)."""
    return torch.tensor(spec.da, dtype=torch.float32, device=device)


def lut_acc(x2: torch.Tensor, w_idx: torch.Tensor, codebook: torch.Tensor,
            spec: LutSpec, table: torch.Tensor | None = None) -> torch.Tensor:
    """The §4 integer accumulator: snap activations to the level grid
    (half-to-even), gather M[a_idx·C + w_idx], sum in int32 (no decode)."""
    da = _grid_step(spec, x2.device)
    a_idx = torch.clamp(torch.round((x2.to(torch.float32) - spec.a_min) / da),
                        0, spec.levels - 1).to(torch.int32)
    if table is None:
        table = build_lut_table(codebook, spec)
    return ops.lut_matmul(a_idx, w_idx.contiguous(), table.contiguous())
