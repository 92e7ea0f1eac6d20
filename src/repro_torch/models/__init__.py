"""CNN model families (DenseNet in this slice)."""
