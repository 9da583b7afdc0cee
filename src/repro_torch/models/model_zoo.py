"""Model handle over a config (the port's copy of the serving members of
``repro/models/model_zoo.py``).

    model.init(gen, device)                      -> params
    model.prefill(params, batch, backend)        -> (logits, cache)
    model.decode(params, tokens, cache, backend) -> (logits, cache)
    model.init_cache(batch, max_len, dtype, device) -> cache

How index-form matmuls run is the ``backend`` argument
(``kernels.dispatch.BackendSpec``); the params carry the representation.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import dispatch
from repro_torch.models import transformer as T

__all__ = ["Model", "build"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator, device=None):
        return T.init_params(gen, self.cfg, device)

    def prefill(self, params, batch, backend=dispatch.DENSE):
        return T.prefill(params, self.cfg, batch, backend)

    def decode(self, params, tokens, cache, backend=dispatch.DENSE):
        return T.decode_step(params, self.cfg, tokens, cache, backend)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        return T.init_cache(self.cfg, batch, max_len, dtype, device)


def build(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port builds dense-family models; got {cfg.family!r}")
    return Model(cfg)
