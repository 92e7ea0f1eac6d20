"""K3 and K4: the fused int8 cut-layer roundtrip, and the same with the
cut-layer noise added in the same pass."""
