"""K9: GroupNorm fused with the ReLU that follows it (the CNN segments)."""
