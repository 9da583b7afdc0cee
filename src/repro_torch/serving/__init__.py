"""Serving: weight compression to index form and the contiguous batched
inference engine with its dense/codebook/lut matmul backends."""

from repro_torch.serving.compress import index_dtype_for, to_codebook_params
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.spec import filter_logits
