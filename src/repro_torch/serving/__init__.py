"""Serving: weight compression to index form, the paged KV-cache allocator,
and the batched inference engine (contiguous or paged cache) with its
dense/codebook/lut matmul backends and speculative decoding."""

from repro_torch.serving.compress import index_dtype_for, to_codebook_params
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kvcache import (Admission, PagePool, PoolStats,
                                         SharedPrefixTier, chain_keys)
from repro_torch.serving.spec import SpecConfig, SpecStats, filter_logits
