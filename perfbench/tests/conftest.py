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
    # the port's dense LM kind at a size the CPU runs in a second
    "lm_dense": {"name": "lm-dense-mini", "family": "lm_dense",
                 "hidden_size": 64, "intermediate_size": 128,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "num_key_value_heads": 2, "vocab_size": 128,
                 "rope_theta": 10000.0, "rms_norm_eps": 1e-06,
                 "cut_layer": 1, "precision": "fp32"},
}
# three hospitals of 8, 6 and 4 sequences of 16 tokens, batches of two: an
# epoch of four steps, the smaller hospitals wrapping around in the last
LM_MINI_TRAFFIC = {
    "kind": "train", "method": "sflv3", "train_samples": [8, 6, 4],
    "val_samples": 2, "seq_len": 16, "batch": 2,
    "link": {"codec": "int8", "fused": False}, "privacy": None,
    "optimizer": {"name": "adam", "lr": 1e-3, "b1": 0.9, "b2": 0.999,
                  "eps": 1e-08}}


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


def lm_parts(limits: dict):
    """(workload, config, traffic, limits) of the ``lm_dense`` mini cell,
    under ``limits``, which the test states."""
    w = {"name": "mini", "config": "mini", "traffic": "mini", "chips": 1}
    return w, MINI_CONFIGS["lm_dense"], dict(LM_MINI_TRAFFIC), limits


@pytest.fixture
def cpu_threads():
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)
