"""Synthetic data: the paper nets' inputs and the LM token stream, made
from seeds (nothing is downloaded)."""

from repro_torch.data.synthetic import (TokenPipeline, class_images,
                                        parabola_batch, pseudo_mnist_batch,
                                        smooth_images)
