"""Llama-4 Scout 17B-active / 16 experts — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

Scout interleaves chunked (8192-window) attention on most layers — modeled
here as sliding_window=8192, which is what qualifies this dense-attention
MoE for the long_500k decode shape (each step attends to at most 8192 keys).
"""

from repro_torch.configs.base import ArchEntry, _ALL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab_size=202048, head_dim=128, rope_theta=500000.0,
    sliding_window=8192, chunk_kv=2048,
    n_experts=16, top_k=1, n_shared_experts=1, capacity_factor=1.25,
    moe_chunk=512, cut_layer=4,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", arch_type="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab_size=512, head_dim=64, sliding_window=64,
    n_experts=4, top_k=1, n_shared_experts=1, moe_chunk=64,
    cut_layer=1, remat=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

ENTRY = ArchEntry(
    arch_id="llama4-scout-17b-a16e", config=CONFIG, smoke=SMOKE, shapes=_ALL,
    skip_notes="runs long_500k via the 8192 sliding/chunked attention "
               "window (decode touches a bounded KV slice per step).")
