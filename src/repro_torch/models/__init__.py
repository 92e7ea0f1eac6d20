"""Model families: DenseNet (CNN), the dense transformer and Mamba2."""
