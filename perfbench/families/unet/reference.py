"""The U-Net family's reference: ``reference/cnn.py``'s
``unet_units`` (the paper's Xception-style U-Net and its smaller kin, from
the configuration's ``model``) on the CNN families' chest X-rays
(``families/cnn/reference.py``).  Imports nothing of the program."""

from __future__ import annotations

from perfbench.families.cnn import reference as cnn
from perfbench.reference.cnn import unet_units as UNITS

hospitals = cnn.hospitals


def weights(seed: int, cfg: dict, n_hospitals: int, device) -> tuple:
    return cnn.weights(UNITS, seed, cfg, n_hospitals, device)


def model(cfg: dict):
    return cnn.Loss(UNITS, cfg)


def forward_flops(cfg: dict, traffic: dict) -> int:
    return cnn.forward_flops(UNITS, cfg)


def link_bytes(cfg: dict, traffic: dict, rows: int) -> int:
    return cnn.link_bytes(UNITS, cfg, rows)
