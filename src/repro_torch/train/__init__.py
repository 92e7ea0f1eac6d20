"""Evaluation metrics and pytree checkpoints (counterparts of the
reference's ``train.metrics`` and ``train.checkpoint``)."""
