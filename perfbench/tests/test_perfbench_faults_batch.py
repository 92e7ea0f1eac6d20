"""As ``test_perfbench_faults_state``: half of each batch left out (the
mean taken over the rest), and the int8 cut-layer roundtrip left out,
each make a run of a small cell on the CPU come out NOT correct."""

import torch

from conftest import mini_parts

from perfbench import harness


def run(seed=67890):
    return harness.run("mini", seed, 0.1, False, 0.0, device="cpu",
                       b=harness.bench(), parts=mini_parts())


def test_half_batch_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.models import cnn

    full = cnn.bce_loss

    def half(logits, labels):
        n = labels.shape[0] // 2
        return full(logits[:n], labels[:n])
    monkeypatch.setattr(cnn, "bce_loss", half)
    out = run()
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]


def test_skipped_link_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.wire import codec

    monkeypatch.setattr(codec.Int8Codec, "fused_roundtrip",
                        lambda self, x: x + 0 * torch.zeros(()))
    out = run()
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]
