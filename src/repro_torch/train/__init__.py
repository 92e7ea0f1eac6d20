"""Evaluation metrics (numpy copy of the reference's)."""
