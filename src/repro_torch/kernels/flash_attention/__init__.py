"""K7: causal GQA flash attention (forward only)."""
