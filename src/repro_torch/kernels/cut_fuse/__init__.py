"""K3: the fused int8 cut-layer roundtrip."""
