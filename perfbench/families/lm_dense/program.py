"""The system under test for the dense LM family: the port's decoder
(``repro_torch.models.transformer``, every layer of the ``dense`` kind)
trained by its SplitFedv3 step (``repro_torch.launch.train``:
``init_sflv3_params`` and ``make_sflv3_train_step(..., compress=True)``,
the int8 link by K1 then K2), as ``examples/train_lm_splitfed_torch.py``
trains it.  The port's LM training has no epoch of its own, so ``epoch``
steps it over the benchmark's schedule (``reference/train.py``
``epoch_batches``): every step stacks each hospital's batch, one after
another, into the step's ``tokens``.  The step returns one loss, the mean
over hospitals, so ``epoch``'s losses are [steps, 1].

``load`` draws the port's own parameter tree and copies the benchmark's
weights into it; ``params`` and ``moments`` read a state back as the
reference's flat dicts (``families/lm_dense/reference.py``): the port
stacks a run's layers on a leading axis and the hospitals' fronts on
another.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from perfbench.reference.train import epoch_batches

# the port's RMSNorm (``models.layers.rmsnorm_apply``) has this eps alone
PORT_RMS_EPS = 1e-6
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
# a reference leaf of a layer -> its path in the port's block
LEAVES = {"attn_norm": ("ln1", "scale"), "wq": ("attn", "wq"),
          "wk": ("attn", "wk"), "wv": ("attn", "wv"), "wo": ("attn", "wo"),
          "mlp_norm": ("ln2", "scale"), "w_gate": ("mlp", "wg"),
          "w_up": ("mlp", "wi"), "w_down": ("mlp", "wo")}


def _check(cfg: dict, traffic: dict) -> None:
    """Refuse what the configuration or traffic states and the port's
    dense LM cannot run as stated."""
    fixed = {"rms_norm_eps": PORT_RMS_EPS, "tie_word_embeddings": False,
             "hidden_act": "silu", "attention_bias": False}
    for key, value in fixed.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"{key}={cfg[key]!r}: the port's dense LM "
                             f"runs {value!r} only")
    link = traffic["link"]
    if link["codec"] not in ("int8", "identity") or link.get("fused"):
        raise ValueError(f"link {link}: the LM step's link is int8 by K1 "
                         "then K2 (unfused), or none")
    if traffic["optimizer"]["name"] != "adam":
        raise ValueError(f"unknown optimizer {traffic['optimizer']['name']!r}")


def build(cfg: dict, traffic: dict, device, precision: str | None = None):
    """The step of a cell: ``traffic``'s hospitals, link and Adam over
    ``cfg``'s decoder, computing in ``cfg``'s precision (``precision``
    overrides it: the control's program path)."""
    from repro_torch import optim
    from repro_torch.launch.train import make_sflv3_train_step
    from repro_torch.models.transformer import ModelConfig, TransformerLM

    _check(cfg, traffic)
    mc = ModelConfig(
        name=cfg["name"], arch_type="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim") or 0,
        rope_theta=float(cfg["rope_theta"]), cut_layer=cfg["cut_layer"],
        compute_dtype=DTYPES[precision or cfg["precision"]])
    model = TransformerLM.build(mc)
    o = traffic["optimizer"]
    opt = optim.adam(o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"])
    n = len(traffic["train_samples"])
    step = make_sflv3_train_step(model, opt, n,
                                 compress=traffic["link"]["codec"] == "int8")
    return types.SimpleNamespace(model=model, opt=opt, step=step,
                                 n_clients=n, device=torch.device(device))


def _pairs(model) -> list:
    """(segment, the port's leaf path, the reference's paths stacked into
    it or None, the reference's path if not stacked)."""
    out = [("front", ("embed", "table"), None, ("embed",))]
    first = 0
    for seg in model.segments:
        for run in seg.runs:
            layers = range(first, first + run.count)
            out += [(seg.name, (f"run_{run.run_id}",) + sub,
                     [(f"layer{i}", name) for i in layers], None)
                    for name, sub in LEAVES.items()]
            first += run.count
    return out + [("middle", ("final_norm", "scale"), None, ("final_norm",)),
                  ("middle", ("head", "w"), None, ("head",))]


def _leaf(tree: dict, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _trees(model, tree: dict) -> tuple:
    """(fronts, middle) of a ``{"fronts", "middle"}`` tree as the
    reference's flat dicts, cloned."""
    n = _leaf(tree["fronts"], ("embed", "table")).shape[0]
    fronts, middle = [{} for _ in range(n)], {}
    for seg, path, stacked, single in _pairs(model):
        if seg == "front":
            t = _leaf(tree["fronts"], path)
            for h in range(n):
                _split(fronts[h], t[h], stacked, single)
        else:
            _split(middle, _leaf(tree["middle"], path), stacked, single)
    return fronts, middle


def _split(out: dict, t, stacked, single) -> None:
    if stacked is None:
        out[single] = t.detach().clone()
    else:
        out.update({p: t[j].detach().clone() for j, p in enumerate(stacked)})


def load(strat, fronts: list, middle: dict) -> dict:
    """A fresh state (``init_sflv3_params``' tree, zero Adam moments)
    holding the benchmark's weights: hospital h's front ``fronts[h]`` and
    the server's ``middle`` (flat {path: tensor} dicts, copied)."""
    from repro_torch.launch.train import init_sflv3_params

    gen = torch.Generator(device=strat.device).manual_seed(0)
    params = init_sflv3_params(strat.model, gen, strat.n_clients,
                               strat.device)
    with torch.no_grad():
        for seg, path, stacked, single in _pairs(strat.model):
            parts = fronts if seg == "front" else [middle]
            dst = _leaf(params["fronts" if seg == "front" else "middle"], path)
            vals = [d[single] if stacked is None
                    else torch.stack([d[p] for p in stacked]) for d in parts]
            src = torch.stack(vals) if seg == "front" else vals[0]
            if tuple(dst.shape) != tuple(src.shape):
                raise ValueError(f"{seg} {path}: program {tuple(dst.shape)},"
                                 f" reference {tuple(src.shape)}")
            dst.copy_(src)
    return {"model": strat.model, "params": params,
            "opt": strat.opt.init(params)}


def params(state) -> tuple:
    """(fronts, middle) of a state as flat dicts, cloned."""
    return _trees(state["model"], state["params"])


def moments(state) -> tuple:
    """Adam's first moments of a state, (fronts, middle) as flat dicts."""
    return _trees(state["model"], state["opt"]["mu"])


def epoch(strat, state, train: list, rng, batch: int):
    """One epoch of every hospital over the benchmark's schedule; returns
    (state, per-step losses as a numpy array [steps, 1]).  The epoch's
    sequences and every step's rows go to the card in two copies, before
    the first step, so the host runs ahead of the card."""
    sizes = [len(d["tokens"]) for d in train]
    first = np.cumsum([0] + sizes[:-1])
    rows = np.stack([np.concatenate([first[h] + idx for h, idx in step])
                     for step in epoch_batches(sizes, batch, rng)])
    tokens = torch.from_numpy(np.concatenate([d["tokens"] for d in train]))
    tokens, rows = tokens.to(strat.device), torch.from_numpy(rows).to(
        strat.device)
    p, o, losses = state["params"], state["opt"], []
    for r in rows:
        p, o, loss = strat.step(p, o, {"tokens": tokens[r]})
        losses.append(loss)
    state = dict(state, params=p, opt=o)
    return state, torch.stack(losses).reshape(-1, 1).cpu().numpy()


@torch.no_grad()
def val_loss(strat, state, clients) -> float:
    """The mean over hospitals of the mean next-token loss of each
    hospital's validation sequences, through its own front and the
    middle with no link: the port's model, segment by segment."""
    from repro_torch.models.transformer import token_nll
    from repro_torch.tree import tree_map

    model, p = strat.model, state["params"]
    out = []
    for h, c in enumerate(clients):
        toks = torch.from_numpy(c.val["tokens"]).to(strat.device)
        front = tree_map(lambda x: x[h], p["fronts"])
        x, _, _ = model.apply({"front": front}, toks[:, :-1],
                              segment_range=(0, 1))
        logits, _, _ = model.apply({"front": front, "middle": p["middle"]},
                                   x, segment_range=(1, 2))
        out.append(token_nll(model.cfg, logits, toks).mean())
    return float(torch.stack(out).mean())


def dispatches(strat) -> int:
    """The step runs eagerly: no program replays to count."""
    return 0


def attach_tracer(strat):
    """A ``repro_torch.obs.trace.Tracer``; the LM step records no spans."""
    from repro_torch.obs.trace import Tracer
    return Tracer()
