"""Hand-written Hopper kernels (``csrc/*.cu``) with their plain PyTorch
versions, the device-routed ops, and the serving matmul backends."""
