"""PyTorch/CUDA port of the ``repro`` serving stack.

The package mirrors ``src/repro/`` module for module (``configs``, ``core``,
``kernels``, ``models``, ``serving``) and imports neither JAX nor anything of
``repro``: it keeps its own copy of what it needs.  Plain tensor code is
PyTorch; the Pallas kernels of ``repro.kernels`` become CUDA C++ kernels for
Hopper under ``csrc/``, built at first use by ``kernels.build``.

Entry points take an explicit ``device``.  Left unset they run on ``cuda``
and raise when no GPU is present; they never fall back to the CPU.  Tests
pass ``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
