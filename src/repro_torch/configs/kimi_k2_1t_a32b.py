"""Kimi K2 — trillion-param MoE (paper-table) [arXiv:2501.kimi2]."""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab_size=163840, head_dim=112,
    n_experts=384, top_k=8, first_k_dense=1, n_shared_experts=1,
    capacity_factor=1.0, moe_chunk=512, chunk_kv=2048,
    # client keeps embed + the single dense layer (MoE stays server-side)
    cut_layer=1, source="arXiv:2501.kimi2",
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=512, head_dim=64,
    n_experts=4, top_k=2, first_k_dense=1, n_shared_experts=1,
    moe_chunk=64, cut_layer=1, remat=False, source="arXiv:2501.kimi2",
)

ENTRY = ArchEntry(
    arch_id="kimi-k2-1t-a32b", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention (no "
               "sliding-window variant published for K2).")
