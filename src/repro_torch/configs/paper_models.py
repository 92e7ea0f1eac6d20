"""The paper's own two model families (§3.2): DenseNet-121 at 224^2 and
the U-Net (Xception-flavoured) at 768^2, plus the reduced "mini" variants
used for CPU runs.  Counterpart of ``repro/configs/paper_models.py``."""

from repro_torch.models.cnn import DenseNetConfig, UNetConfig

DENSENET121_PAPER = DenseNetConfig(
    name="densenet121-paper", growth=32, blocks=(6, 12, 24, 16), stem_ch=64,
    in_ch=1, n_classes=1, cut_layer=4)       # paper: first 4 layers at client

UNET_PAPER = UNetConfig(
    name="unet-xception-paper", widths=(64, 128, 256, 512, 728), in_ch=1,
    n_classes=1, cut_layer=6)                # paper: first 6 layers at client

# reduced variants for CPU runs (orderings, not absolutes)
DENSENET_MINI = DenseNetConfig(
    name="densenet-mini", growth=12, blocks=(3, 6, 8), stem_ch=24,
    in_ch=1, n_classes=1, cut_layer=3)

UNET_MINI = UNetConfig(
    name="unet-mini", widths=(16, 32, 64, 96), in_ch=1, n_classes=1,
    cut_layer=2)
