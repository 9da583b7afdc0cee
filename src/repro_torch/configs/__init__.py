"""Architecture configs, the port's copy of ``repro.configs``: the 10
assigned archs + the paper's own networks.

``get(name)`` returns the full production ModelConfig; ``get(name).reduced()``
the CPU-smoke-test variant of the same family.
"""

from repro_torch.configs.base import ModelConfig, SHAPES, ShapeSpec
from repro_torch.configs import registry as _registry


def get(name: str) -> ModelConfig:
    return _registry.CONFIGS[name]()


def names():
    return sorted(_registry.CONFIGS)
