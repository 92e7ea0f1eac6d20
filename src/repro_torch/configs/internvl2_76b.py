"""InternVL2-76B — InternViT + InternLM2 backbone [arXiv:2404.16821].

The InternViT-6B vision tower is the stubbed frontend (hidden 3200);
the caller provides projected patch embeddings.  The LM backbone below is
the InternLM2-72B-ish decoder the assignment specifies.
"""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", arch_type="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128, chunk_kv=2048,
    frontend="vision", frontend_dim=3200, frontend_tokens=256,
    cut_layer=2, source="arXiv:2404.16821",
)

SMOKE = ModelConfig(
    name="internvl2-smoke", arch_type="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
    vocab_size=512, frontend="vision", frontend_dim=64, frontend_tokens=8,
    cut_layer=1, remat=False, source="arXiv:2404.16821",
)

ENTRY = ArchEntry(
    arch_id="internvl2-76b", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention.")
