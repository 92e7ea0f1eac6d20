"""The system under test for the DenseNet family: the port's DenseNet
(``repro_torch.models.cnn.build_densenet``) behind ``make_strategy``, as
``families/cnn/program.py`` builds and drives every CNN strategy."""

from __future__ import annotations

from perfbench.families.cnn.program import (attach_tracer, dispatches,
                                            epoch, load, moments, params,
                                            strategy, val_loss)

__all__ = ["build", "load", "epoch", "params", "moments", "val_loss",
           "dispatches", "attach_tracer"]


def build(cfg: dict, traffic: dict, device, precision: str | None = None):
    from repro_torch.core.partition import cnn_adapter
    from repro_torch.models import cnn

    m = cfg["model"]
    net = cnn.build_densenet(cnn.DenseNetConfig(
        name=cfg["name"], growth=m["growth"], blocks=tuple(m["blocks"]),
        stem_ch=m["stem_ch"], compression=m["compression"],
        in_ch=m["in_ch"], n_classes=m["n_classes"],
        cut_layer=m["cut_layer"]))
    return strategy(cnn_adapter(net), cfg, traffic, device, precision)
