"""Mamba2-130M — SSD (state-space duality), attention-free [arXiv:2405.21060]."""

from repro_torch.configs.base import ArchEntry, _ALL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", arch_type="ssm",
    n_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_chunk=128,
    cut_layer=4, source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke", arch_type="ssm",
    n_layers=2, d_model=128, d_ff=0, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
    cut_layer=1, remat=False, source="arXiv:2405.21060",
)

ENTRY = ArchEntry(
    arch_id="mamba2-130m", config=CONFIG, smoke=SMOKE, shapes=_ALL,
    skip_notes="runs long_500k: attention-free, O(1) state per token.")
