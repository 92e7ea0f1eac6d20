"""The port's six reference examples (``examples/<name>_torch.py``), each
run through its ``main`` with ``--device cpu`` at a tiny size (3 hospitals
of 16-32 images at 32^2, 2 epochs; the LM SMOKE configs with 6 new
tokens), and held to what each promises:

  * the training losses are finite and fall (the last epoch's mean below
    the first's);
  * ``federated_cxr``: the bytes of each method equal the reference's
    ``comm_per_epoch`` on the same arguments, exactly;
  * ``compressed_splitfed``: the simulated epoch's bytes and seconds over
    the hospital WAN equal the reference's ``simulate``, exactly;
  * ``private_splitfed``: each hospital's epsilon equals the reference
    accountant's for its steps and sampling rate, exactly;
  * ``train_and_serve``: every served score within 1e-5 of the
    training-side score, and the checkpoint round trip bit-exact;
  * ``serve_decode``: int32 tokens of the right shape, in the vocabulary.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.comm import comm_per_epoch as j_comm_per_epoch
from repro.core.partition import cnn_adapter as j_cnn_adapter
from repro.data.synthetic import make_cxr_clients
from repro.models.cnn import DenseNetConfig as JDenseNetConfig
from repro.models.cnn import build_densenet as j_build_densenet
from repro.privacy.accountant import epoch_steps as j_epoch_steps
from repro.privacy.accountant import epsilon as j_epsilon
from repro.wire import make_codec as j_make_codec
from repro.wire import simulate as j_simulate
from repro_torch.configs.registry import REGISTRY

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SMALL = ["--device", "cpu", "--hospitals", "3", "--epochs", "2"]


def _main(name, *argv):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch_example", EXAMPLES / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main(list(argv))


def _falls(losses):
    assert all(math.isfinite(l) for l in losses), losses
    assert losses[-1] < losses[0], losses


def _j_setup(images, val, test, cfg):
    """The reference's clients and adapter for an example's arguments."""
    clients = make_cxr_clients(seed=0, n_clients=len(images),
                               train_per_client=images, val_per_client=val,
                               test_per_client=test, image_size=32)
    return clients, j_cnn_adapter(j_build_densenet(JDenseNetConfig(**cfg)))


DENSENET = dict(growth=8, blocks=(2, 4), stem_ch=16, cut_layer=2)


def test_quickstart():
    out = _main("quickstart", *SMALL, "--images", "32")
    for method in ("sflv3_ac", "sl_ac"):
        _falls(out[method]["losses"])
        assert 0.0 <= out[method]["test"]["auroc"] <= 1.0
    assert 0.0 <= out["serve"]["score"] <= 1.0


def test_federated_cxr_bytes_equal_the_reference():
    out = _main("federated_cxr", *SMALL, "--images", "32")
    _falls(out["losses"])
    clients, ja = _j_setup([32] * 3, 32, 32, DENSENET)
    eb = {k: v[:16] for k, v in clients[0].train.items()}
    n_tr = [len(c.train["label"]) for c in clients]
    n_va = [len(c.val["label"]) for c in clients]
    want = {m: j_comm_per_epoch(m, ja, eb, n_tr, n_va, 16).bytes_per_epoch
            for m in ("fl", "sl_ac", "sflv3_ac")}
    want["sl_ac+int8"] = j_comm_per_epoch(
        "sl_ac", ja, eb, n_tr, n_va, 16,
        codec=j_make_codec("int8")).bytes_per_epoch
    assert out["bytes"] == want


def test_compressed_splitfed_simulation_equals_the_reference():
    out = _main("compressed_splitfed", *SMALL, "--images", "32")
    for run in out["runs"].values():
        _falls(run["losses"])
    assert out["runs"]["int8"]["compression"] > 3.0
    assert 0.0 < out["runs"]["int8"]["rel_l2"] < 0.1
    clients, ja = _j_setup([32] * 3, 32, 48, DENSENET)
    eb = {k: v[:16] for k, v in clients[0].train.items()}
    n_tr = [len(c.train["label"]) for c in clients]
    n_va = [len(c.val["label"]) for c in clients]
    for codec, got in out["simulated"].items():
        r = j_simulate("sflv3_ac", ja, eb, n_tr, n_va, 16, codec,
                       "hospital_wan", keep_events=False)
        assert got == {"bytes_on_wire": r.bytes_on_wire,
                       "wall_clock_s": r.wall_clock_s}, codec


def test_private_splitfed_epsilon_equals_the_reference():
    out = _main("private_splitfed", *SMALL, "--images", "32", "16", "32")
    _falls(out["non-private"]["losses"])
    for label, run in out.items():
        if label != "train_images":
            assert all(math.isfinite(l) for l in run["losses"]), label
            assert 0.0 <= run["dcor"] <= 1.0 and run["probe_r2"] <= 1.0
    (dp,) = [r for k, r in out.items() if k.startswith("dp-sgd")]
    # the reference's schedule: SFLv3 wraps the short hospital around
    want = j_epoch_steps("sflv3_ac", out["train_images"], 16)
    assert [r["steps"] for r in dp["privacy"]] == [2 * n for _, n in want]
    for (q, n), r in zip(want, dp["privacy"]):
        assert r["epsilon"] == j_epsilon(1.0, q, 2 * n)
    # unequal data, unequal epsilon; the other regimes keep no ledger
    assert dp["privacy"][0]["epsilon"] != dp["privacy"][1]["epsilon"]
    assert not out["non-private"]["privacy"]
    assert not [r for k, r in out.items() if k.startswith("cut-noise")][0][
        "privacy"]


def test_train_and_serve():
    out = _main("train_and_serve", *SMALL, "--images", "32")
    _falls([r["loss"] for r in out["rounds"]])
    assert all(r["max_diff"] <= 1e-5 for r in out["rounds"])
    assert [r["version"] for r in out["rounds"]] == [0, 1]
    assert out["checkpoint_exact"] and out["sflv3_max_diff"] <= 1e-5


@pytest.mark.parametrize("tokens", [6])
def test_serve_decode(tokens):
    out = _main("serve_decode", "--device", "cpu", "--tokens", str(tokens))
    assert list(out) == ["smollm-135m", "mamba2-130m", "zamba2-7b"]
    for arch, run in out.items():
        toks, vocab = run["tokens"], REGISTRY[arch].smoke.vocab_size
        assert toks.dtype == torch.int32 and toks.shape == (4, tokens)
        assert bool(((toks >= 0) & (toks < vocab)).all()), arch
        assert run["steps"] == 2 * (tokens - 1) and run["tok_s"] > 0
        assert np.isfinite(run["seconds"]).all()
