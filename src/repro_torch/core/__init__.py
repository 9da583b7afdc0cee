"""Core of the paper's contribution, as far as serving needs it:
``activations`` (§2.1 quantized activations), ``clustering`` (§2.2 k-means,
closed-form Laplacian-L1 and uniform centers, assignment) and ``quantizer``
(the clustering event over a parameter tree, and its index form), ``lut``
(§4 multiplication and activation tables) and ``fixedpoint`` (§4
integer-only inference)."""

from repro_torch.core.quantizer import (QuantizerState, WeightQuantConfig,
                                        cluster_params, codebook_indices,
                                        init_state)
from repro_torch.core.lut import LutConfig, LutTables, build_tables
