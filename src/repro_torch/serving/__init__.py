"""LM serving: batched prefill, single-token decode and greedy generation."""
