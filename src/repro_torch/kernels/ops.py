"""Public ops of the kernels package, routed by the device of their operands.

A CUDA tensor goes to the hand-written kernel (``*_cuda``), which launches
or raises; a CPU tensor goes to the plain PyTorch version (``*_plain``).
There is no fallback from one to the other.  Each CUDA wrapper counts its
launches in a ``launches`` attribute (``launch_counts`` reads them all).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import codebook_matmul as _cm
from repro_torch.kernels import lut_matmul as _lm

__all__ = ["codebook_matmul", "lut_matmul", "launch_counts",
           "reset_launch_counts", "KERNELS"]

KERNELS = {"codebook_matmul": _cm.codebook_matmul_cuda,
           "lut_matmul": _lm.lut_matmul_cuda}


def _route(*tensors: torch.Tensor) -> str:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return "cuda"
    if kinds == {"cpu"}:
        return "cpu"
    raise ValueError(f"operands on mixed or unsupported devices: {kinds}")


def codebook_matmul(x, w_idx, codebook):
    """(M, N) f32 = x @ codebook[w_idx], each weight rounded to x.dtype."""
    if _route(x, w_idx, codebook) == "cuda":
        return _cm.codebook_matmul_cuda(x, w_idx, codebook)
    return _cm.codebook_matmul_plain(x, w_idx, codebook)


def lut_matmul(a_idx, w_idx, table):
    """(M, N) int32 accumulators of the §4 engine (wrapping adds)."""
    if _route(a_idx, w_idx, table) == "cuda":
        return _lm.lut_matmul_cuda(a_idx, w_idx, table)
    return _lm.lut_matmul_plain(a_idx, w_idx, table)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
