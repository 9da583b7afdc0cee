"""Core of the paper's contribution, as far as serving needs it:
``activations`` (§2.1 quantized activations), ``clustering`` (§2.2 k-means,
closed-form Laplacian-L1 and uniform centers, assignment) and ``quantizer``
(the clustering event over a parameter tree, and its index form)."""

from repro_torch.core.quantizer import (QuantizerState, WeightQuantConfig,
                                        cluster_params, codebook_indices,
                                        init_state)
