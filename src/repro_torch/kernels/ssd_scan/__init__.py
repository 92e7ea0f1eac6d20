"""K8: the chunk-local part of Mamba2's SSD."""
