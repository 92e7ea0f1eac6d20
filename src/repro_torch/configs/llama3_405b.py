"""Llama-3 405B — dense GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", arch_type="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, head_dim=128, rope_theta=500000.0, chunk_kv=2048,
    cut_layer=2, source="arXiv:2407.21783",
)

SMOKE = ModelConfig(
    name="llama3-smoke", arch_type="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, d_ff=832,
    vocab_size=512, head_dim=32, rope_theta=500000.0,
    cut_layer=1, remat=False, source="arXiv:2407.21783",
)

ENTRY = ArchEntry(
    arch_id="llama3-405b", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention (paper model); "
               "see llama4-scout for the sliding-window dense variant.")
