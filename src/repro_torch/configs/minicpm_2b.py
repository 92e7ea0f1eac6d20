"""MiniCPM-2B — llama-like dense with the WSD schedule [arXiv:2404.06395].
The WSD (warmup-stable-decay) schedule itself lives in
repro_torch.optim.schedules.wsd.
"""

from repro_torch.configs.base import ArchEntry, _FULL
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", arch_type="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, head_dim=64, rope_theta=10000.0, chunk_kv=2048,
    cut_layer=4, source="arXiv:2404.06395",
)

SMOKE = ModelConfig(
    name="minicpm-smoke", arch_type="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=640,
    vocab_size=503,   # deliberately odd, like the parent's 122753
    cut_layer=1, remat=False, source="arXiv:2404.06395",
)

ENTRY = ArchEntry(
    arch_id="minicpm-2b", config=CONFIG, smoke=SMOKE, shapes=_FULL,
    skip_notes="long_500k skipped: full quadratic attention.")
