"""Synthetic hospitals and LM token streams (numpy; byte-identical to the
reference)."""
