"""The ``--arch <id>`` registry over the ten LM architectures, in the
reference's order (``repro/configs/registry.py``)."""

from __future__ import annotations

from repro_torch.configs import (internvl2_76b, kimi_k2_1t_a32b,
                                 llama3_405b, llama4_scout_17b_a16e,
                                 mamba2_130m, minicpm_2b, mistral_large_123b,
                                 musicgen_medium, smollm_135m, zamba2_7b)
from repro_torch.configs.base import INPUT_SHAPES, ArchEntry

_MODULES = [kimi_k2_1t_a32b, musicgen_medium, internvl2_76b, minicpm_2b,
            llama3_405b, zamba2_7b, smollm_135m, mistral_large_123b,
            llama4_scout_17b_a16e, mamba2_130m]

REGISTRY: dict[str, ArchEntry] = {m.ENTRY.arch_id: m.ENTRY for m in _MODULES}

ARCH_IDS = list(REGISTRY)


def get(arch_id: str) -> ArchEntry:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown --arch {arch_id!r}; known: {ARCH_IDS}")
    return REGISTRY[arch_id]


def combos():
    """Every (arch_id, shape_name, runs) triple: 40 in all, ``runs``
    False where the arch skips the shape (long_500k but for four)."""
    out = []
    for aid, e in REGISTRY.items():
        for shape in INPUT_SHAPES:
            out.append((aid, shape, shape in e.shapes))
    return out
