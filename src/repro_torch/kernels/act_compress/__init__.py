"""K1/K2: the per-row int8 cut-layer codec."""
