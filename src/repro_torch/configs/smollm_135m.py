"""SmolLM-135M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", arch_type="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab_size=49152, head_dim=64, rope_theta=10000.0, chunk_kv=2048,
    cut_layer=4, source="hf:HuggingFaceTB/SmolLM-135M",
)

SMOKE = ModelConfig(
    name="smollm-smoke", arch_type="dense",
    n_layers=2, d_model=192, n_heads=3, n_kv_heads=3, d_ff=512,
    vocab_size=512, head_dim=64, cut_layer=1, remat=False,
    source="hf:HuggingFaceTB/SmolLM-135M",
)

ENTRY = ArchEntry(
    arch_id="smollm-135m", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention.")
