"""What a run feeds both sides is made from ``--seed`` on the device: the
generators each family's reference draws its data and weights from, and
the draw of the initial weights from a family's list of leaves.

A family's reference (``families/<family>/reference.py``) draws its
hospitals' data from ``generator(seed, DATA_STREAM, device)`` and lists
its weights as specs that ``draw`` fills, in one call of the generator.
"""

from __future__ import annotations

import numpy as np
import torch

# the generators' seeds: a run's seed plus a fixed offset for each stream
DATA_STREAM, WEIGHT_STREAM = 0x5EED_DA7A, 0x5EED_3E16


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) + stream) % 2 ** 63)


def draw(seed: int, parts: list, device) -> list:
    """One flat ``{path: tensor}`` dict per part, each part a list of
    specs ``(path, shape, kind, var)``: kind ``"normal"`` draws N(0,
    var), ``"one"`` and ``"zero"`` are constants.  Every normal leaf of
    every part, in order, comes from one draw of the weight stream."""
    total = sum(int(np.prod(shape)) for specs in parts
                for _, shape, kind, _ in specs if kind == "normal")
    flat = torch.randn(total, generator=generator(seed, WEIGHT_STREAM, device),
                       device=device)
    out, off = [], 0
    for specs in parts:
        d = {}
        for path, shape, kind, var in specs:
            if kind == "one":
                d[path] = torch.ones(shape, device=device)
            elif kind == "zero":
                d[path] = torch.zeros(shape, device=device)
            else:
                n = int(np.prod(shape))
                d[path] = flat[off:off + n].view(shape) * var ** 0.5
                off += n
        out.append(d)
    return out
