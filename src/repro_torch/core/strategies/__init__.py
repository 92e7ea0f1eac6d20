"""Strategy registry: the method grid of the paper's Table 2 —
counterpart of ``repro.core.strategies``.

Every method of ``METHODS`` is built, in the label-sharing (LS) and the
U-shaped (NLS) cut, on the compiled engine (the default) or the stepwise
one, in f32 or bf16, and with a ``PrivacyConfig``: DP-SGD on every
method, cut-layer noise on the split family, secure aggregation on FL;
with per-round ``participation`` (FL and the split family, compiled
engine), on FL any registered ``aggregator``, observed (``observe=``,
``repro_torch.obs``) and placed over several devices (``shard=True``,
``core.placement``).  The combinations the reference refuses raise its
``ValueError``.
"""

from repro_torch.core.partition import cast_adapter
from repro_torch.core.strategies.base import EpochLog, Strategy
from repro_torch.core.strategies.centralized import Centralized
from repro_torch.core.strategies.federated import FedAvg
from repro_torch.core.strategies.split import SplitLearning
from repro_torch.core.strategies.splitfed import (SplitFedV1, SplitFedV2,
                                                  SplitFedV3)
from repro_torch.device import resolve_device, use_full_fp32

METHODS = ["centralized", "fl", "sl_ac", "sl_am",
           "sflv2_ac", "sflv3_ac", "sflv1_ac"]

_SPLIT = {"sl": SplitLearning, "sflv1": SplitFedV1, "sflv2": SplitFedV2,
          "sflv3": SplitFedV3}


def make_strategy(method: str, adapter, opt_factory, n_clients,
                  transport=None, privacy=None, engine="compiled",
                  drop_remainder=True, shard=False, observe=None,
                  precision="fp32", participation=None, aggregator=None,
                  device=None, devices=None):
    """method: centralized | fl | sl_{ac,am} | sflv{1,2,3}_{ac,am}.

    ``transport`` (``repro_torch.wire.Transport``) compresses the cut-layer
    link of the SL/SFL family; centralized and FL have no cut layer.  It
    must live on the strategy's device.  ``privacy`` (a
    ``repro_torch.privacy.PrivacyConfig``) turns on DP-SGD for any method,
    cut-layer noise for the SL/SFL family (at every crossing, both under
    NLS) and pairwise-mask secure aggregation for FL, as in the reference.
    ``drop_remainder=False`` keeps each hospital's final short batch (SL,
    SFLv2, FL, centralized; SFLv3/v1 refuse it), private or not.

    ``device`` None means the CUDA card (raises without one); pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU.
    ``precision="fp32"`` is full float32: on the card it turns cuDNN's
    TF32 convolutions off (``device.use_full_fp32``); ``"bf16"`` trains
    through ``partition.cast_adapter`` (bf16 compute, f32 masters).
    ``engine="compiled"`` (the default, ``engine.py``) steps packed epochs
    and whole runs with one captured CUDA graph; ``"stepwise"`` calls the
    step from a Python loop.

    ``participation`` (``repro_torch.core.participation.Participation``)
    samples K of the N enrolled hospitals each round in ``Strategy.run``
    (fixed-size, Poisson or an explicit schedule; the split family takes
    fixed-size only): the compiled engine packs each round's cohort into a
    fixed slot axis and the RDP accountant composes at the amplified rate.
    Compiled engine only; centralized has no cohort to sample and secure
    aggregation assumes a fixed one.  ``Participation(n_global=N, k=N)``
    trains exactly as ``participation=None``.

    ``aggregator`` (FL only) replaces the data-size-weighted FedAvg mean by
    a rule of ``repro_torch.core.aggregate``: a registered name
    (``"trimmed_mean"``, ``"coordinate_median"``,
    ``"staleness_discounted"``, ``"hierarchical"``...) or an
    ``Aggregator`` (the way to set its parameters); on the compiled engine
    it runs inside the captured round body.

    ``observe`` (``repro_torch.obs.Telemetry`` | True | None) turns on the
    in-program metric taps for every ``Strategy.run`` (``run(observe=)``
    overrides it per run): per-round x per-hospital loss, gradient and
    update norms, FL's update cosine, the cut-layer payload's moments, the
    DP clip fraction and the per-round epsilon, computed inside the
    captured steps (``obs.telemetry``).  The split family refuses it
    together with ``participation``, as the reference does.

    ``shard=True`` places the hospital axis of every compiled run over
    ``devices`` (default: every visible CUDA device; the strategy's own
    device on the CPU), ``core.placement``: a hospital count that does not
    divide the device count is padded with zero-weight phantom hospitals,
    each device's chunk of hospitals trains in its own captured programs,
    and the cross-hospital reductions gather in hospital order
    (``core/strategies/placed.py``).  Results equal ``shard=False``'s
    (FL and SL/SFLv2 bit for bit, SFLv3/v1 within 1e-5); one device, and
    the stepwise engine, place nothing.  A device may repeat
    (``devices=[torch.device("cuda", 0)] * 4``: four chunks on one card).
    """
    if participation is not None and method == "centralized":
        raise ValueError("centralized pools all hospitals; there is no "
                         "per-round cohort to sample")
    if aggregator is not None and method != "fl":
        raise ValueError("aggregator= selects the FedAvg aggregation rule "
                         f"and applies to fl only, not {method}")
    adapter = cast_adapter(adapter, precision)
    kind, _, schedule = method.rpartition("_")
    if method in ("centralized", "fl"):
        if transport is not None:
            raise ValueError(f"{method} has no cut-layer link for a "
                             "transport codec")
        if privacy is not None and privacy.cut_noise_std > 0:
            raise ValueError(f"{method} has no cut layer to noise")
        if privacy is not None and privacy.secagg and method != "fl":
            raise ValueError("secure aggregation needs federated uploads")
    else:
        if privacy is not None and privacy.secagg:
            raise ValueError("secure aggregation applies to FL model "
                             f"uploads; {method} ships activations, not "
                             "updates")
        if kind not in _SPLIT or schedule not in ("ac", "am"):
            raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    if transport is not None and transport.device != device:
        raise ValueError(f"transport on {transport.device}, strategy on "
                         f"{device}")
    use_full_fp32(device)
    kw = dict(privacy=privacy, engine=engine, drop_remainder=drop_remainder,
              device=device, observe=observe, shard=shard, devices=devices)
    if method == "centralized":
        return Centralized(adapter, opt_factory, n_clients, **kw)
    kw["participation"] = participation
    if method == "fl":
        return FedAvg(adapter, opt_factory, n_clients, aggregator=aggregator,
                      **kw)
    return _SPLIT[kind](adapter, opt_factory, n_clients, schedule,
                        transport=transport, **kw)


__all__ = ["Strategy", "EpochLog", "Centralized", "FedAvg", "SplitLearning",
           "SplitFedV1", "SplitFedV2", "SplitFedV3", "make_strategy",
           "METHODS"]
