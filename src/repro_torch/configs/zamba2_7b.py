"""Zamba2-7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers with one SHARED attention+MLP block applied every 6 layers
(one param set, several depths — zamba2's signature trick), ssm_state=64.
"""

from repro_torch.configs.base import ArchEntry, _ALL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
    vocab_size=32000, head_dim=112, chunk_kv=2048,
    ssm_state=64, ssm_head_dim=64, ssm_chunk=128,
    hybrid_attn_every=6,
    cut_layer=4, source="arXiv:2411.15242",
)

SMOKE = ModelConfig(
    name="zamba2-smoke", arch_type="hybrid",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab_size=512, head_dim=32, ssm_state=16, ssm_head_dim=32, ssm_chunk=8,
    hybrid_attn_every=2, cut_layer=2, remat=False,
    source="arXiv:2411.15242",
)

ENTRY = ArchEntry(
    arch_id="zamba2-7b", config=CONFIG, smoke=SMOKE, shapes=_ALL,
    skip_notes="runs long_500k: SSM layers are O(1)/token; the shared "
               "attention blocks attend over the full 512k KV cache during "
               "decode (memory-bound, linear per step).")
