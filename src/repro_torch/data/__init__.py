"""Synthetic hospitals (numpy; byte-identical to the reference)."""
