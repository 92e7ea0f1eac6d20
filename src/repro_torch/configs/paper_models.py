"""The paper's DenseNet-121 at 224^2 (§3.2) and the reduced "mini" variant
used for CPU runs.  Counterpart of ``repro/configs/paper_models.py``; the
U-Net configs wait for the U-Net slice."""

from repro_torch.models.cnn import DenseNetConfig

DENSENET121_PAPER = DenseNetConfig(
    name="densenet121-paper", growth=32, blocks=(6, 12, 24, 16), stem_ch=64,
    in_ch=1, n_classes=1, cut_layer=4)       # paper: first 4 layers at client

# reduced variant for CPU runs (orderings, not absolutes)
DENSENET_MINI = DenseNetConfig(
    name="densenet-mini", growth=12, blocks=(3, 6, 8), stem_ch=24,
    in_ch=1, n_classes=1, cut_layer=3)
