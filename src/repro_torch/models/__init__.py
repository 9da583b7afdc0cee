"""Models: the decoder LM of the dense and mixture-of-experts families, with
quant-aware dense layers that take weights either as floats ('w') or in
codebook-index form ('w_idx' + 'codebook'); and the paper's own networks
(``papernets``: MLP, auto-encoders, AlexNet-style)."""

from repro_torch.models import papernets
