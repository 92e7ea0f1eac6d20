"""Model configurations of the paper."""
