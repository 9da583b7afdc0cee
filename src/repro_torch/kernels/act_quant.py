"""act_quant: the paper's quantized activation (§2.1), ``f(x)`` snapped to L
levels equally spaced in output space, with the int32 level index.

Replaces ``repro/kernels/act_quant.py::act_quant_kernel`` (the Pallas TPU
kernel, reached through ``act_quant_pallas``).  The CUDA kernel is
``csrc/act_quant.cu``; its header says what bounds it on the card (bytes:
one read and one write an element) and why it is one thread an element.

One kernel, two forms of the same function, which differ in where they
round (they disagree in bf16 on a few elements in a thousand):

* ``form="kernel"``: what ``act_quant_pallas`` computes as XLA compiles it
  (the Pallas kernel runs under jit, also in interpret mode): f32
  arithmetic, the division by the constant ``step`` folded into a product
  with its f32 reciprocal, ``lo + q·step`` fused into one ``fma``, cast to
  x's dtype.  ``ops.act_quant`` and ``ops.act_quant_index`` use it.
* ``form="act_apply"``: what ``repro/core/activations.act_apply`` and
  ``act_index`` compute, op by op in x's dtype, with ``lo``, ``step`` and
  ``L − 1`` rounded to it and ``sigmoid`` as ``jax.nn.sigmoid`` rounds it.
  The port's ``core.activations.act_apply`` (and so the FFN of a model with
  ``act_levels > 0``) uses it, so that the port serves what the JAX package
  serves.

``act_quant_plain`` is the same function in plain PyTorch: the CPU path,
and what ``chip_smoke.py`` holds the kernel against on the card.  Scalar
operands are tensors on x's device: PyTorch's CUDA division by a Python
scalar multiplies by its reciprocal, which is not the reference's division.
``act_quant_cuda`` launches the kernel; it is never replaced by the plain
version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["act_quant_plain", "act_quant_cuda", "parity_ties", "FORMS",
           "KINDS"]

FORMS = ("kernel", "act_apply")
KINDS = ("tanh", "relu6", "sigmoid", "rtanh")     # the kernel's kind ids
_X_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _scalars(kind: str, levels: int, form: str, dtype: torch.dtype):
    """(lo, step, L − 1, 1/step) as the form computes with them: f32 for
    the kernel form (1/step the f32 reciprocal of the f32 step, as XLA
    folds it); rounded to x's dtype for the act_apply form, as JAX rounds a
    weakly typed Python float to the array's dtype."""
    from repro_torch.core.activations import ACT_RANGES
    if kind not in KINDS:
        raise ValueError(f"act_quant takes kinds {KINDS}; got {kind!r}")
    if form not in FORMS:
        raise ValueError(f"act_quant forms are {FORMS}; got {form!r}")
    if not 2 <= levels <= 65536:
        raise ValueError(f"levels {levels} outside 2..65536")
    if dtype not in _X_DTYPES:
        raise TypeError(f"x dtype {dtype} not in {_X_DTYPES}")
    lo, hi = ACT_RANGES[kind]
    step = (hi - lo) / (levels - 1)
    rounding = torch.float32 if form == "kernel" else dtype
    lo, step, qmax = (float(torch.tensor(v, dtype=torch.float64).to(rounding))
                      for v in (lo, step, float(levels - 1)))
    rcp = float(torch.tensor(1.0) / torch.tensor(step, dtype=torch.float32))
    return lo, step, qmax, rcp


@functools.lru_cache(maxsize=None)
def _scalar_tensors(kind: str, levels: int, form: str, dtype: torch.dtype,
                    device: torch.device):
    """(lo, step, 1/step, 1) as f32 tensors on ``device``, made once, so
    that a call copies no scalar to the card."""
    lo, step, _, rcp = _scalars(kind, levels, form, dtype)
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)
                 for v in (lo, step, rcp, 1.0))


def act_quant_plain(x: torch.Tensor, kind: str, levels: int,
                    form: str = "kernel", with_index: bool = True):
    """x: any shape, f32 or bf16.  Returns (y in x.dtype, int32 level index
    or None)."""
    lo, step, qmax, _ = _scalars(kind, levels, form, x.dtype)
    f32 = torch.float32
    lo_t, step_t, rcp_t, one = _scalar_tensors(kind, levels, form, x.dtype,
                                               x.device)
    xf = x.to(f32)
    if form == "kernel":
        r = lambda v: v                                          # noqa: E731
    else:
        r = lambda v: v.to(x.dtype).to(f32)                      # noqa: E731
    if kind == "tanh":
        y = r(torch.tanh(xf))
    elif kind == "relu6":
        y = torch.clamp(xf, 0.0, 6.0)
    elif kind == "sigmoid":
        y = r(torch.div(one, r(one + r(torch.exp(-xf)))))
    else:
        y = r(torch.clamp(torch.tanh(xf), min=0.0))
    if form == "kernel":
        u = (y - lo_t) * rcp_t
    else:
        u = r(torch.div(r(y - lo_t), step_t))
    q = torch.clamp(r(torch.round(u)), 0.0, qmax)
    if form == "kernel":
        # fma(q, step, lo) rounded once: q·step is exact in f64, and so is
        # its sum with lo, so one rounding to f32 gives the fused result
        out = (q.to(torch.float64) * step + lo).to(f32)
    else:
        v = r(lo_t + r(q * step_t))
        out = y + r(v - y)
    idx = q.to(torch.int32) if with_index else None
    return out.to(x.dtype), idx


def parity_ties(y: torch.Tensor, idx: torch.Tensor, y_ref: torch.Tensor,
                idx_ref: torch.Tensor, kind: str, levels: int) -> int:
    """How two runs of the same form disagree: the number of ties, where
    their ``tanh``/``exp`` (an ulp apart) put an element on the two sides
    of a level boundary.  Raises on anything else: levels more than one
    apart, any tie for relu6 (no transcendental), an output that differs
    off the ties, or a tie whose output is not (within two ulps) on the
    level its own index names."""
    from repro_torch.core.activations import ACT_RANGES
    gi, wi = idx.reshape(-1).long(), idx_ref.reshape(-1).long()
    tie = gi != wi
    if bool(((gi - wi).abs() > 1).any()):
        raise AssertionError(f"act_quant {kind}: a level differs by more "
                             "than one")
    if kind == "relu6" and bool(tie.any()):
        raise AssertionError("act_quant relu6: not bit-equal")
    bits = torch.int16 if y.dtype == torch.bfloat16 else torch.int32
    gy, wy = y.reshape(-1), y_ref.reshape(-1)
    if not torch.equal(gy[~tie].view(bits), wy[~tie].view(bits)):
        raise AssertionError(f"act_quant {kind}: outputs differ off the "
                             "level-boundary ties")
    lo, hi = ACT_RANGES[kind]
    eps = torch.finfo(y.dtype).eps
    for out, q in ((gy[tie], gi[tie]), (wy[tie], wi[tie])):
        level = lo + q.double() * ((hi - lo) / (levels - 1))
        if not torch.allclose(out.double(), level, rtol=2 * eps, atol=eps):
            raise AssertionError(f"act_quant {kind}: a tie's output is off "
                                 "its level")
    return int(tie.sum())


def _lib():
    lib = build.load("act_quant")
    fn = lib.act_quant_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, ci, vp, vp, ctypes.c_longlong, ci, ci, cf, cf, cf,
                       cf, vp]
        fn.restype = ci
    return fn


def act_quant_cuda(x: torch.Tensor, kind: str, levels: int,
                   form: str = "kernel", with_index: bool = True):
    """Launch the CUDA kernel on a CUDA tensor; (y, int32 index or None).

    Raises on anything the kernel does not take (device, dtype, kind,
    levels, form) and when the launch reports an error.  A non-contiguous
    x is copied to a contiguous one first.
    """
    if not x.is_cuda:
        raise ValueError("act_quant_cuda takes a CUDA tensor")
    lo, step, qmax, rcp = _scalars(kind, levels, form, x.dtype)
    xc = x.contiguous()
    y = torch.empty_like(xc)
    idx = (torch.empty(xc.shape, dtype=torch.int32, device=x.device)
           if with_index else None)
    if xc.numel() == 0:
        return y, idx
    err = _lib()(xc.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
                 idx.data_ptr() if idx is not None else None, xc.numel(),
                 KINDS.index(kind), FORMS.index(form), lo, step, qmax, rcp,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"act_quant kernel launch failed: cudaError {err}")
    act_quant_cuda.launches += 1
    return y, idx


act_quant_cuda.launches = 0
