"""K5/K6: DP-SGD's per-example clip (squared norms, scaled batch sum)."""
