"""Mistral-Large-2 123B [hf:mistralai/Mistral-Large-Instruct-2407]."""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", arch_type="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab_size=32768, head_dim=128, rope_theta=1000000.0, chunk_kv=2048,
    cut_layer=2, source="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = ModelConfig(
    name="mistral-large-smoke", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=640,
    vocab_size=512, head_dim=32, cut_layer=1, remat=False,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

ENTRY = ArchEntry(
    arch_id="mistral-large-123b", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention.")
