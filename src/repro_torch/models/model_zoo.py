"""Model handle over a config (the port's copy of the serving members of
``repro/models/model_zoo.py``).

    model.init(gen, device)                      -> params
    model.loss(params, batch, backend)           -> (loss, metrics)
    model.forward(params, batch, backend)        -> logits at every position
    model.prefill(params, batch, backend)        -> (logits, cache)
    model.decode(params, tokens, cache, backend) -> (logits, cache)
    model.verify(params, tokens, cache, backend) -> (logits, cache)
    model.init_cache(batch, max_len, dtype, device) -> cache
    model.init_paged_cache(n_pages, page_size, dtype, device, tp) -> page pool
    model.prefill_chunk(params, batch, pool, backend) -> (logits, pool)

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

    def loss(self, params, batch, backend=dispatch.DENSE):
        """Next-token CE and its metrics, every family; differentiable in
        the params (``launch/steps.value_and_grad``)."""
        return T.loss_fn(params, self.cfg, batch, backend)

    def forward(self, params, batch, backend=dispatch.DENSE):
        """The trunk over whole prompts, no cache: (B, L, V) f32 logits.
        batch: 'tokens'; the vlm's 'embeds' and 'positions' (optional);
        the encoder-decoder's 'frames'."""
        return T.forward(params, self.cfg, batch, backend)

    def prefill(self, params, batch, backend=dispatch.DENSE):
        return T.prefill(params, self.cfg, batch, backend)

    def decode(self, params, tokens, cache, backend=dispatch.DENSE):
        return T.decode_step(params, self.cfg, tokens, cache, backend)

    def verify(self, params, tokens, cache, backend=dispatch.DENSE):
        """Score K1 tokens per slot in one forward (speculative verify):
        logits at every position, K/V written at pos..pos+K1−1,
        ``cache['pos']`` left for the caller to advance."""
        return T.verify_step(params, self.cfg, tokens, cache, backend)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        return T.init_cache(self.cfg, batch, max_len, dtype, device)

    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=torch.bfloat16, device=None, tp: int = 1):
        """Page pool; dtype=int8 → quantized pages + bf16 scales; ``tp`` >
        1: one tensor-parallel rank's in-page slice of it."""
        return T.init_paged_cache(self.cfg, n_pages, page_size, dtype, device,
                                  tp)

    def prefill_chunk(self, params, batch, cache, backend=dispatch.DENSE):
        """One page-sized chunk of one request's prompt; writes the pool in
        place.  Returns (logits at its last real position, pool)."""
        return T.prefill_chunk(params, self.cfg, batch, cache, backend)


def build(cfg: ModelConfig) -> Model:
    """The model handle of a ``dense``, ``moe``, ``vlm``, ``audio``,
    ``ssm_rwkv`` or ``hybrid`` config.  The paper's own nets are built
    through ``models.papernets`` (ValueError, as the reference's ``build``
    refuses them)."""
    if cfg.family == "paper":
        raise ValueError("paper-family nets are built via repro_torch."
                         "models.papernets")
    return Model(cfg)
