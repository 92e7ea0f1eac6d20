"""Model configurations: the paper's CNNs (``paper_models``) and the ten
LM architectures (``registry``)."""
