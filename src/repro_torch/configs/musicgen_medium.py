"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec conv codec is the stubbed modality frontend: the caller
provides precomputed frame embeddings (conditioning prefix) plus the audio
token stream over the 2048-entry codebook vocabulary.
"""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", arch_type="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, rope_theta=10000.0, chunk_kv=2048,
    frontend="audio", frontend_dim=128, frontend_tokens=256,
    cut_layer=4, source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", arch_type="audio",
    n_layers=2, d_model=192, n_heads=4, n_kv_heads=4, d_ff=384,
    vocab_size=256, frontend="audio", frontend_dim=32, frontend_tokens=8,
    cut_layer=1, remat=False, source="arXiv:2306.05284",
)

ENTRY = ArchEntry(
    arch_id="musicgen-medium", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention.")
