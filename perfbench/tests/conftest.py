"""The benchmark's CPU tests: the repository root and ``src`` on the path,
and a small cell the tests drive through the harness on the CPU."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

MINI_CONFIGS = {
    # DENSENET_MINI and UNET_MINI of the program's paper_models, at 32x32
    "densenet": {"name": "densenet-mini", "family": "densenet",
                 "model": {"growth": 12, "blocks": [3, 6, 8], "stem_ch": 24,
                           "compression": 0.5, "in_ch": 1, "n_classes": 1,
                           "cut_layer": 3},
                 "image_size": 32, "precision": "fp32"},
    "unet": {"name": "unet-mini", "family": "unet",
             "model": {"widths": [16, 32, 64, 96], "in_ch": 1,
                       "n_classes": 1, "cut_layer": 2},
             "image_size": 32, "precision": "fp32"},
}


def mini_parts(family="densenet", traffic="sflv3-tenth-b16"):
    """(workload, config, traffic, limits) of a small cell: a traffic mix
    (the DenseNet cell's by default) and the DenseNet cell's limits over
    five hospitals of six to eight images, batches of two, on a mini
    model."""
    traffic = json.loads((ROOT / "perfbench" / "traffic" /
                          f"{traffic}.json").read_text())
    traffic.update(train_images=[6, 6, 8, 6, 6], val_images=2, batch=2)
    limits = json.loads((ROOT / "perfbench" / "limits" /
                         "densenet121.sflv3.fp32.json").read_text())
    w = {"name": "mini", "config": "mini", "traffic": "mini", "chips": 1}
    return w, MINI_CONFIGS[family], traffic, limits


@pytest.fixture
def cpu_threads():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
