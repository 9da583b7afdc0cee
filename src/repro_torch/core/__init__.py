"""Core of the paper's contribution, as far as serving needs it:
``clustering`` (§2.2 closed-form Laplacian-L1 centers and assignment) and
``quantizer`` (the clustering event over a parameter tree)."""

from repro_torch.core.quantizer import (QuantizerState, WeightQuantConfig,
                                        cluster_params, init_state)
