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

**Tensor parallelism**: a ``BackendSpec`` whose ``mesh``
(``launch/mesh.Mesh``) has a ``model`` axis of more than one rank runs
each contraction on this rank's shard (``_sharded_matmul``), by the
layer's ``kind``: ``'col'`` (wq/wk/wv/w1/w3) takes the rank's (K, N/tp)
ids and leaves the output N-sharded; ``'row'`` (wo/w2) takes the rank's
K/tp slice of x and its (K/tp, N) ids and sums the partial products over
the ``model`` group, on the lut backend the **int32 accumulators**
(exact: integer addition is associative), decoded once with the engine's
full-fan-in ``LutSpec``; anything else is the replicated product.  Only
the integer ids shard; codebooks and lut tables replicate.  ``ROUTES``
counts the contractions a route ran, as the reference's
``MATMUL_CALLS``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter

import numpy as np
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import ops, probes

__all__ = ["BACKENDS", "LutSpec", "BackendSpec", "make_lut_spec",
           "build_lut_table", "attach_lut_tables", "backend_matmul",
           "lut_acc", "DENSE", "ROUTES", "route_counts",
           "reset_route_counts", "tp_degree", "count_route"]

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
    """How one model's index-form matmuls run: the backend name, for
    ``lut`` its grid, and the tensor-parallel ``mesh`` (None: one
    device)."""

    name: str = "dense"
    lut_spec: LutSpec | None = None
    mesh: object = None

    def __post_init__(self):
        if self.name not in BACKENDS:
            raise ValueError(f"unknown backend {self.name!r}; expected one "
                             f"of {BACKENDS}")
        if self.name == "lut" and self.lut_spec is None:
            raise ValueError("backend 'lut' needs a LutSpec (make_lut_spec)")


DENSE = BackendSpec()

# "{backend}.{route}" -> contractions run through that route (local | col |
# row | replicated), process-wide like the kernels' launch counters.
ROUTES: Counter = Counter()


def count_route(backend: BackendSpec, route: str, n: int = 1) -> None:
    ROUTES[f"{backend.name}.{route}"] += n


def route_counts() -> dict:
    return dict(ROUTES)


def reset_route_counts() -> None:
    ROUTES.clear()


def tp_degree(backend: BackendSpec | None) -> int:
    """The ``model`` axis' size of ``backend``'s mesh (1 without one, and
    for no backend: a float weight's product takes none)."""
    mesh = getattr(backend, "mesh", None)
    return mesh.tp if mesh is not None else 1


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
                   table: torch.Tensor | None = None,
                   kind: str | None = None) -> torch.Tensor:
    """``x @ codebook[w_idx]`` through a non-dense backend.

    x: (..., K) float; w_idx: (K, N) ids; codebook: (|W|,); table: the
    precomputed (|A|, |W|) lut table (rebuilt from the codebook when None).
    kind: 'col' | 'row' | None, the layer's tensor-parallel role, read only
    when ``backend`` has a mesh of more than one rank (``_sharded_matmul``:
    w_idx is then this rank's shard).  Returns (..., N) in x.dtype (N
    this rank's columns on the 'col' route).  Under an open probes frame
    the call is counted (``probes.tap_matmul``; under a mesh each rank
    counts its part, which ``ServeEngine.numerics`` combines).
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if tp_degree(backend) > 1:
        y = _sharded_matmul(x2, w_idx, codebook, backend, kind, table)
    else:
        count_route(backend, "local")
        y = _local_matmul(x2, w_idx, codebook, backend, table)
    # the numerics taps: the activations and the f32 output, before the
    # cast (a no-op unless a probes frame is open).  Under a mesh a 'row'
    # x is this rank's K-slice, counted on every rank; any other x is
    # whole on every rank, counted on rank 0 only
    probes.tap_matmul(x2, y, backend.name, backend.lut_spec,
                      count_x=kind == "row" or tp_degree(backend) == 1
                      or backend.mesh.coords["model"] == 0)
    return y.reshape(*lead, -1).to(x.dtype)


def _lut_decode(acc: torch.Tensor, spec: LutSpec) -> torch.Tensor:
    return acc.to(torch.float32) * (spec.da / (2.0 ** spec.s))


def _local_matmul(x2, w_idx, codebook, backend: BackendSpec, table=None):
    """The f32 (M, N) product on this rank's operands."""
    if backend.name == "codebook":
        return ops.codebook_matmul(x2, w_idx, codebook)
    if backend.name == "lut":
        spec = backend.lut_spec
        return _lut_decode(lut_acc(x2, w_idx, codebook, spec, table), spec)
    raise ValueError(f"backend_matmul called with {backend.name!r}")


def _sharded_matmul(x2, w_idx, codebook, backend: BackendSpec, kind,
                    table=None):
    """The contraction on this rank's shard of the weights (the
    counterpart of the reference's shard_map over ``model``).

    col:  x replicated, w_idx the rank's (K, N/tp) → the local kernel, the
          output this rank's N/tp columns (no collective).
    row:  x this rank's K/tp slice (the caller's: the FFN's hidden is
          made so by the col-sharded w1/w3, the attention output is cut
          to it ahead of wo), w_idx the rank's (K/tp, N) → the
          local kernel, then one psum of the (M, N) output; on lut of the
          int32 accumulator, decoded once after the sum with the
          engine's full-fan-in spec (a spec sized for K/tp would change
          ``s``).
    else: the replicated product (w_idx whole on every rank).
    """
    mesh = backend.mesh
    if kind == "col":
        count_route(backend, "col")
        return _local_matmul(x2, w_idx, codebook, backend, table)
    if kind == "row":
        count_route(backend, "row")
        if backend.name == "lut":
            spec = backend.lut_spec
            acc = collectives.psum(lut_acc(x2, w_idx, codebook, spec, table),
                                   mesh)
            return _lut_decode(acc, spec)
        return collectives.psum(_local_matmul(x2, w_idx, codebook, backend),
                                mesh)
    count_route(backend, "replicated")
    return _local_matmul(x2, w_idx, codebook, backend, table)


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
