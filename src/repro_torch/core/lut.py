"""The paper's §4 inference engine: multiplication table + activation table,
the port's copy of ``repro/core/lut.py`` (numpy, as the reference is).

Construction (paper Figs. 8-9):

* ``mult table``  M[a, w] = round(a_val · w_val · 2^s / Δx), int — one row per
  activation level **plus one bias row** (activation ≡ 1.0), one column per
  codebook weight **plus one identity column** (w ≡ 1.0, used to decode the
  final layer's output, "looking into the column for w=1").
* accumulate looked-up entries in an integer register; the sum equals the
  pre-activation x scaled by 2^s/Δx (to table rounding).
* ``acc >> s`` (arithmetic shift ≡ floor(x/Δx)) + ``zero_offset`` indexes the
  **activation table**, which maps each Δx-wide input bin directly to the next
  layer's activation-level row index — no boundary scan, no non-linearity.

Boundary snapping: for non-uniform input-space boundaries (tanhD etc.) the
bin edges are snapped to multiples of Δx; more table entries ⇒ smaller Δx ⇒
less snapping error.  For ReLU6 the boundaries are already uniform,
Δx = 6/(|A|−1), and the table is an identity map (paper footnote 7).

Overflow is excluded statically: ``choose_scale`` picks the largest ``s``
such that ``fan_in · max|M|`` fits the accumulator width, and checks that
the accumulated *rounding* error stays ≪ one bin.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.activations import ActQuantConfig, act_input_boundaries

__all__ = ["LutConfig", "LutTables", "build_tables", "choose_scale"]


@dataclasses.dataclass(frozen=True)
class LutConfig:
    """act:        the activation-quantization config (gives |A| and ranges).
    table_entries: activation-table length T (≥ |A|); more entries = finer Δx.
                   Ignored for relu6 (identity table, Δx fixed by the level grid).
    acc_bits:      accumulator width (32 or 64).
    s_bits:        fixed-point scale exponent; None = choose automatically.
    x_pad:         fractional padding beyond the extreme boundary covered by
                   the table (inputs outside saturate to the end bins).
    """

    act: ActQuantConfig
    table_entries: int = 0
    acc_bits: int = 32
    s_bits: int | None = None
    x_pad: float = 0.25


@dataclasses.dataclass(frozen=True)
class LutTables:
    """The deployable artifact (all integers except the codebook metadata)."""

    mult: np.ndarray        # (|A|+1, |W|+1) int — rows: levels + bias; cols: weights + w≡1
    act_table: np.ndarray   # (T,) int32 — input bin -> activation level index
    levels: np.ndarray      # (|A|,) f32 — level values (for decode/inspection only)
    codebook: np.ndarray    # (|W|,) f32 — weight values (metadata; not used at inference)
    s: int                  # scale exponent
    dx: float               # activation-input sampling interval
    zero_offset: int        # index of the bin containing x = 0
    bias_row: int           # = |A| (row encoding activation ≡ 1.0)
    identity_col: int       # = |W| (column encoding w ≡ 1.0)
    acc_dtype: np.dtype     # accumulator dtype

    @property
    def n_levels(self) -> int:
        return int(self.levels.shape[0])

    @property
    def n_weights(self) -> int:
        return int(self.codebook.shape[0])

    def decode(self, acc) -> np.ndarray:
        """Float64 value of a final-layer accumulator (the single boundary-
        crossing scale; inference itself never computes this).  ``acc``:
        a numpy array or a tensor (read back to the host)."""
        if hasattr(acc, "detach"):
            acc = acc.detach().cpu().numpy()
        return np.asarray(acc, np.float64) * self.dx / (2.0 ** self.s)


def choose_scale(codebook: np.ndarray, levels_max: float, dx: float,
                 fan_in: int, acc_bits: int = 32,
                 err_bins_tol: float = 0.5) -> int:
    """Largest s with a static no-overflow guarantee (paper §4 last ¶).

    max|entry| = max(|w|·max(|a|,1)) · 2^s / Δx   (bias row uses a=1)
    need   fan_in · max|entry| < 2^(acc_bits−1)               (hard bound)
    and    RMS accumulated rounding error ≈ 0.29·√fan_in / 2^s
           < err_bins_tol bins   (independent ±0.5 roundings; the
           worst-case bound fan_in/2^{s+1} is unreachable in practice and
           would force 64-bit accumulators beyond fan-in ≈ 2·tol·2^{s_over}).
    """
    wmax = float(np.max(np.abs(codebook))) if codebook.size else 1.0
    wmax = max(wmax, 1.0)             # identity column encodes w ≡ 1.0
    amax = max(abs(levels_max), 1.0)  # bias row multiplies by 1.0
    headroom = 2.0 ** (acc_bits - 1) - 1
    # fan_in * wmax * amax * 2^s / dx  <  headroom
    s_over = int(np.floor(np.log2(headroom * dx / max(fan_in * wmax * amax, 1e-30))))
    s_err = int(np.ceil(np.log2(max(0.29 * fan_in ** 0.5 / err_bins_tol, 1.0))))
    if s_over < s_err:
        raise ValueError(
            f"no s satisfies both overflow (s<={s_over}) and rounding "
            f"(s>={s_err}) for fan_in={fan_in}, acc_bits={acc_bits}; "
            f"use acc_bits=64 or a larger dx")
    return s_over


def build_tables(codebook: np.ndarray, cfg: LutConfig,
                 fan_in: int) -> LutTables:
    """Build the §4 tables for one (codebook, activation, fan-in) triple."""
    act = cfg.act
    if not act.enabled:
        raise ValueError("LUT inference requires quantized activations")
    codebook = np.sort(np.asarray(codebook, np.float64).reshape(-1))
    lo, hi = act.out_range
    levels = np.linspace(lo, hi, act.levels)

    # --- activation table: input bin -> level index -------------------------
    if act.kind == "relu6":
        # Uniform boundaries (footnote 7): Δx = step, table = identity over
        # the bins whose centers are the levels; still materialised so the
        # engine is uniform across activation kinds.
        dx = act.step
        bounds = act_input_boundaries(act)          # at midpoints: (j-.5)*dx
        x_min, x_max = 0.0 - dx, 6.0 + dx
    else:
        bounds = act_input_boundaries(act)          # non-uniform (e.g. arctanh)
        span = max(abs(bounds[0]), abs(bounds[-1]))
        x_min = -span * (1.0 + cfg.x_pad)
        x_max = +span * (1.0 + cfg.x_pad)
        t = cfg.table_entries or 4 * act.levels
        dx = (x_max - x_min) / t

    zero_offset = int(np.ceil(-x_min / dx))          # bin index of x = 0
    n_bins = int(np.ceil(x_max / dx)) + zero_offset + 1
    # entry for bin b covers x ∈ [(b − zero_offset)·Δx, (b+1 − zero_offset)·Δx)
    bin_left = (np.arange(n_bins) - zero_offset) * dx
    bin_center = bin_left + dx / 2.0
    # level index whose (snapped) bin contains this center:
    act_table = np.searchsorted(bounds, bin_center, side="right").astype(np.int32)
    act_table = np.clip(act_table, 0, act.levels - 1)

    # --- scale + multiplication table ---------------------------------------
    s = cfg.s_bits if cfg.s_bits is not None else choose_scale(
        codebook, max(abs(lo), abs(hi)), dx, fan_in, cfg.acc_bits)
    scale = (2.0 ** s) / dx
    rows = np.concatenate([levels, [1.0]])          # + bias row (a ≡ 1)
    cols = np.concatenate([codebook, [1.0]])        # + identity column (w ≡ 1)
    mult = np.rint(np.outer(rows, cols) * scale)
    acc_dtype = np.dtype(np.int32 if cfg.acc_bits == 32 else np.int64)
    max_entry = np.max(np.abs(mult))
    if fan_in * max_entry >= 2.0 ** (cfg.acc_bits - 1):
        raise ValueError("overflow guarantee violated — lower s or widen acc")
    mult = mult.astype(acc_dtype)

    return LutTables(mult=mult, act_table=act_table,
                     levels=levels.astype(np.float32),
                     codebook=codebook.astype(np.float32),
                     s=s, dx=float(dx), zero_offset=zero_offset,
                     bias_row=act.levels, identity_col=int(codebook.shape[0]),
                     acc_dtype=acc_dtype)
