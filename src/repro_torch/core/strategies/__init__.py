"""Strategy registry — counterpart of ``repro.core.strategies``.

This slice ports SplitFedv3 (``sflv3_ac`` / ``sflv3_am``) on the stepwise
engine; every other method and option raises ``NotImplementedError``
naming the ROADMAP item that ports it.
"""

from repro_torch.core.strategies.base import EpochLog, Strategy
from repro_torch.core.strategies.split import SplitLearning
from repro_torch.core.strategies.splitfed import SplitFedV3
from repro_torch.device import resolve_device, use_full_fp32

METHODS = ["centralized", "fl", "sl_ac", "sl_am",
           "sflv2_ac", "sflv3_ac", "sflv1_ac"]


def make_strategy(method: str, adapter, opt_factory, n_clients,
                  transport=None, privacy=None, engine="stepwise",
                  shard=False, observe=None,
                  precision="fp32", participation=None, aggregator=None,
                  device=None):
    """method: ``sflv3_{ac,am}`` in this slice.

    ``device`` None means the CUDA card (raises without one); pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.  A
    ``transport`` (``repro_torch.wire.Transport``) must live on the same
    device.  ``precision="fp32"`` is full float32: on the card it turns
    cuDNN's TF32 convolutions off (``device.use_full_fp32``).  The default
    engine is ``"stepwise"``, the only one ported.
    """
    unported = [
        (privacy is not None, "privacy=", "M8 (privacy)"),
        (observe is not None, "observe=", "M10 (observability)"),
        (shard, "shard=True", "M11 (placement)"),
        (participation is not None, "participation=", "M9 (participation)"),
        (aggregator is not None, "aggregator=", "M9 (aggregation)"),
        (precision == "bf16", 'precision="bf16"', "M4 (cast_adapter)"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP "
                                      f"{item}")
    if precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    kind, _, schedule = method.rpartition("_")
    split_family = schedule in ("ac", "am")
    if method in ("centralized", "fl") or (
            split_family and kind in ("sl", "sflv1", "sflv2")):
        raise NotImplementedError(f"method {method!r} is not ported yet: "
                                  "ROADMAP M5 (strategies)")
    if kind != "sflv3" or not split_family:
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    if transport is not None and transport.device != device:
        raise ValueError(f"transport on {transport.device}, strategy on "
                         f"{device}")
    use_full_fp32(device)
    return SplitFedV3(adapter, opt_factory, n_clients, schedule,
                      transport=transport, device=device, engine=engine)


__all__ = ["Strategy", "EpochLog", "SplitLearning", "SplitFedV3",
           "make_strategy", "METHODS"]
