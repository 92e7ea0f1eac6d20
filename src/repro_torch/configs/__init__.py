"""Model configurations: the paper's CNNs and the LM architectures of this
slice (SmolLM-135M, Mamba2-130M)."""
