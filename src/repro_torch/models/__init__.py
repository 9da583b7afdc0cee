"""Models: the dense-family decoder LM with quant-aware dense layers that
take weights either as floats ('w') or in codebook-index form
('w_idx' + 'codebook')."""
