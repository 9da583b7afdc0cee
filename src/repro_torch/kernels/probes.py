"""In-graph numerics probes: the collector (the port's copy of
``repro/kernels/probes.py``).

The paper claims that discretization loses nothing; the probes measure it
while serving.  Every silent clip on the path gets a counter: activations
snapped to the lut's level grid or pinned to relu6's rails, the int8 KV
round trip, page-table ids the gather clamps.

* **State** is a flat dict of f32 device tensors (``init_state``): the
  (L,) per-layer counters ``PER_LAYER`` and the 0-d ``SCALARS``, each in
  its own buffer.  The reference threads it through ``lax.scan``
  carries; here the serving engine owns one state, made once before any
  CUDA graph is captured, and every forward adds into it in place.  A
  captured decode step therefore holds the updates, and each replay adds
  again.  The buffers are never rebound: a graph keeps writing into the
  tensors it was captured with (a reset is ``zero_()``).  An empty dict
  is the off state.
* **Recording** goes through a stack of frames.  A layer's body opens
  one (``layer(state, l)``), the taps (``tap_matmul`` in
  ``kernels.dispatch``, ``tap_kv`` in ``models.attention.quantize_kv``,
  ``tap_act`` in ``models.layers.ffn_act``) append to the innermost
  frame, and on exit the frame adds its records into ``state[name][l]``
  (or takes their max, for ``MAXES``).  With no frame open, or with an
  empty state, every tap returns before computing anything: a probes-off
  forward runs, and captures, exactly the ops it ran without them.
* **No host read.** Taps are device ops (boolean sums, ``amax``) and
  Python constants (element counts); a frame merges tensors with
  in-place adds and Python numbers as scalar arguments, so nothing is
  read back or copied to the card inside a forward.
* **Fence.**  The reference drops a tap fired from another JAX trace than
  its frame's (a ``shard_map`` body: the MoE dispatch and the
  tensor-parallel attention over a mesh).  Torch has no nested traces;
  the code that stands for those bodies opens ``fence()`` instead, and
  every tap inside it records nothing (``active()`` is False there).
* **Tensor parallelism.**  Each rank of a mesh records into its own
  state.  A tap on a replicated input counts its elements on the
  ``model`` axis' rank 0 only (``tap_matmul``'s ``count_x``), one on a
  rank's slice counts them on every rank, so that ``act_sat`` and
  ``act_total`` sum over the ranks to the whole input's counts;
  ``acc_max`` takes the max over the ranks (a column-sharded output's
  high-water mark is one rank's); the other counters are the same on
  every rank.  The engine combines them once, in ``numerics()``.

Counter semantics (f32, as in the reference; sums are exact below 2^24
events):

    act_sat / act_total  (L,)  elements outside the activation grid /
                               elements seen (lut a_min..a_max snapping,
                               and the relu6 act-quant rails)
    acc_max              (L,)  high-water max |int32 accumulator| of the
                               lut contraction, from the decoded output
                               (|y|·2^s/Δa)
    kv_err_max/_sum/_cnt (L,)  int8 KV round-trip |dequant − orig|
    matmul_calls         (L,)  routed backend_matmul calls
    page_oob             ()    page-table ids outside [0, n_pages)
    tokens               ()    token positions processed

Imports torch only: ``models/`` and ``kernels/`` import it, never
``serving/`` (the host-side summary lives in ``serving.probes``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["init_state", "layer", "bump", "active", "record", "fence",
           "tap_matmul", "tap_kv", "tap_act", "PER_LAYER", "MAXES",
           "SCALARS"]

PER_LAYER = ("act_sat", "act_total", "acc_max", "kv_err_max", "kv_err_sum",
             "kv_err_cnt", "matmul_calls")
MAXES = ("acc_max", "kv_err_max")
SCALARS = ("page_oob", "tokens")


def init_state(n_layers: int, device=None) -> dict:
    """Fresh all-zero probe state on ``device`` (None = the GPU): (L,)
    per-layer counters and 0-d scalars, each key in its own buffer."""
    dev = resolve_device(device)
    st = {k: torch.zeros((n_layers,), dtype=torch.float32, device=dev)
          for k in PER_LAYER}
    st.update({k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in SCALARS})
    return st


def _f32(v: float) -> float:
    """``v`` rounded to f32, as ``jnp.asarray(v, jnp.float32)`` rounds it."""
    return float(np.float32(v))


def _fold(vals: list, is_max: bool):
    """One frame's records of one name, folded in recording order in f32,
    as the reference folds them.  A name is recorded by one tap, so its
    records are all 0-d f32 device tensors (the fold is one too; the
    ``MAXES`` are always tensors) or all Python numbers, summed into a
    Python float, which adds into the state as a scalar argument: nothing
    is copied to the card."""
    if isinstance(vals[0], torch.Tensor):
        acc = vals[0]
        for v in vals[1:]:
            acc = torch.maximum(acc, v) if is_max else acc + v
        return acc
    acc = np.float32(vals[0])
    for v in vals[1:]:
        acc = np.float32(acc + np.float32(v))
    return float(acc)


class _Frame:
    """The collector of one layer's body: ``with layer(state, l): ...``
    adds the taps' records into ``state[name][l]`` on exit."""

    __slots__ = ("state", "l", "recs")

    def __init__(self, state: dict, l: int):
        self.state, self.l, self.recs = state, l, {}

    def __enter__(self):
        _FRAMES.append(self)
        return self.state

    def __exit__(self, exc_type, exc, tb):
        _FRAMES.pop()
        if exc_type is None:
            self._merge()
        return False

    def _merge(self) -> None:
        """In place: ``cur[l] += Σ records`` (sums) or ``cur[l] =
        max(cur[l], records)`` (``MAXES``), on a view of the (L,) buffer,
        which is never rebound."""
        for name, vals in self.recs.items():
            cur = self.state.get(name)
            if cur is None or cur.ndim != 1:
                continue
            is_max = name in MAXES
            acc = _fold(vals, is_max)
            view = cur.select(0, self.l)
            if is_max:
                view.copy_(torch.maximum(view, acc))
            else:
                view.add_(acc)


_OFF = contextlib.nullcontext({})     # the frame of an empty state
_FRAMES: list = []                    # _Frame, or None for a fence


def active() -> bool:
    """True while a collector frame is open and no fence stands above it:
    the gate every tap checks before computing anything."""
    return bool(_FRAMES) and _FRAMES[-1] is not None


def record(name: str, value) -> None:
    """Append one value (a device tensor or a Python number) to the
    innermost frame; a no-op with no frame open or under a fence."""
    if active():
        _FRAMES[-1].recs.setdefault(name, []).append(value)


@contextlib.contextmanager
def fence():
    """Within (or, as ``@fence()``, in the function it decorates): every
    tap records nothing, as the reference's taps record nothing inside a
    ``shard_map`` body."""
    _FRAMES.append(None)
    try:
        yield
    finally:
        _FRAMES.pop()


def layer(state: dict, l: int):
    """The collector frame of layer ``l``'s body.  An empty ``state`` is
    inert: no frame, no ops."""
    return _Frame(state, l) if state else _OFF


def bump(state: dict, name: str, v) -> dict:
    """A scalar counter's update, in place, with no frame: quantities known
    at the top of a forward (page tables, token counts).  ``v`` is a
    device tensor or a Python number.  No-op on the empty state.  Returns
    ``state``."""
    if state and name in state:
        state[name].add_(v.to(torch.float32) if isinstance(v, torch.Tensor)
                         else _f32(v))
    return state


# --- taps (call sites in dispatch, attention, layers) -------------------------

def tap_matmul(x2: torch.Tensor, y: torch.Tensor, backend_name: str,
               spec, count_x: bool = True) -> None:
    """One routed ``backend_matmul``: its call, and on lut the grid
    saturation of the activations ``x2`` and the int32 accumulator's
    high-water mark decoded from the f32 output ``y`` (|acc| =
    round(|y|·2^s/Δa): y is the accumulator times a power-of-two-scaled
    constant, so the round trip is exact up to y's own f32 resolution).
    ``count_x`` False: ``x2`` is a copy that another rank counts, and its
    saturation is not recorded here."""
    if not active():
        return
    record("matmul_calls", 1.0)
    if backend_name == "lut" and spec is not None:
        if count_x:
            xf = x2.to(torch.float32)
            record("act_sat", ((xf < spec.a_min) | (xf > spec.a_max)).sum()
                   .to(torch.float32))
            record("act_total", float(x2.numel()))
        scale = (2.0 ** spec.s) / spec.da
        record("acc_max", torch.round(y.to(torch.float32).abs().amax()
                                      * scale))


def tap_kv(t: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """int8 KV round-trip error at one ``quantize_kv`` call: the error the
    reader sees (``q`` dequantized through the stored bf16 ``scale``)
    against the float ``t``; max, sum and count."""
    if not active():
        return
    deq = q.to(torch.float32) * scale.to(torch.float32)[..., None]
    err = (deq - t.to(torch.float32)).abs()
    record("kv_err_max", err.amax())
    record("kv_err_sum", err.sum())
    record("kv_err_cnt", float(err.numel()))


def tap_act(x: torch.Tensor, lo: float, hi: float) -> None:
    """act_quant saturation: pre-activations outside the bounded kind's
    rails (relu6: [0, 6]), which the quantized nonlinearity pins to an
    end level."""
    if not active():
        return
    xf = x.to(torch.float32)
    record("act_sat", ((xf < lo) | (xf > hi)).sum().to(torch.float32))
    record("act_total", float(x.numel()))
