"""The dense LM family's reference: a plain float32 decoder written from the
configuration (the Hugging Face ``config.json`` keys ``hidden_size``,
``intermediate_size``, ``num_hidden_layers``, ``num_attention_heads``,
``num_key_value_heads``, ``head_dim``, ``vocab_size``, ``rope_theta``,
``rms_norm_eps``; the benchmark's ``cut_layer`` and ``precision``), its
token data and weights from the seed, and its FLOP and byte counts.
Imports nothing of the program.

A layer, as ``repro_torch.models.transformer``'s ``dense`` kind computes
it: x + attention(RMSNorm(x)), then + SwiGLU(RMSNorm(x)).  RMSNorm scales
by rsqrt(mean(x^2) + eps); the rotary embedding turns the two halves of
each head (not interleaved pairs) by position / theta^(2i / head_dim);
attention is causal, grouped (query head j reads key-value head
j // (heads / kv_heads)), scaled by 1 / sqrt(head_dim), softmax in f32;
SwiGLU is (silu(x W_gate) * (x W_up)) W_down; then the final RMSNorm, the
LM head (no bias, not tied to the embedding) and next-token cross-entropy
(logsumexp minus the label's logit).  A dense weight is (in, out).  The
front is the embedding and layers [0, cut); the middle the rest, the final
norm and the head.  Departures from the port, none of them in value: the
port masks a hidden key with -1e30 where this takes -inf; it multiplies
by 1 / sqrt(head_dim) where this divides; its RMSNorm's eps is fixed at
1e-6 where this reads the configuration's (the program refuses another).

The port's SplitFedv3 step differentiates the mean over hospitals of
their losses (``repro_torch.launch.train``), so each front's gradient is
that of its own loss over the hospitals' count: ``fronts_take_mean``.

The data: each hospital draws its sequences of ``seq_len + 1`` tokens from
a distribution over the vocabulary of its own (softmax of 2 x a normal
draw), so the hospitals differ as their scanners do in the image
families; one ``torch.Generator`` on the card, a few calls a hospital.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from perfbench import inputs

ITEMSIZE = {"fp32": 4, "bf16": 2}
EMBED_STD = 0.02


def _sizes(cfg: dict) -> tuple:
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return h, kv, cfg.get("head_dim") or cfg["hidden_size"] // h


# -- the hospitals' sequences -------------------------------------------------------

def hospitals(seed: int, cfg: dict, traffic: dict, device) -> list:
    """One namespace per hospital with ``train`` and ``val`` dicts
    ({"tokens": (N, seq_len + 1) int64 numpy}); the volumes are
    ``traffic``'s ``train_samples`` and ``val_samples``."""
    gen = inputs.generator(seed, inputs.DATA_STREAM, device)
    width = traffic["seq_len"] + 1
    out = []
    for h, n_train in enumerate(traffic["train_samples"]):
        probs = torch.softmax(2.0 * torch.randn(
            cfg["vocab_size"], generator=gen, device=device), 0)
        parts = {}
        for name, n in (("train", n_train), ("val", traffic["val_samples"])):
            toks = torch.multinomial(probs, n * width, replacement=True,
                                     generator=gen)
            parts[name] = {"tokens": toks.view(n, width).cpu().numpy()}
        out.append(types.SimpleNamespace(name=f"H{h + 1}", **parts))
    return out


# -- weights --------------------------------------------------------------------------

def _layer_specs(cfg: dict, i: int) -> list:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv, hd = _sizes(cfg)
    n = f"layer{i}"
    return [((n, "attn_norm"), (d,), "one", None),
            ((n, "wq"), (d, h * hd), "normal", 1 / d),
            ((n, "wk"), (d, kv * hd), "normal", 1 / d),
            ((n, "wv"), (d, kv * hd), "normal", 1 / d),
            ((n, "wo"), (h * hd, d), "normal", 1 / (h * hd)),
            ((n, "mlp_norm"), (d,), "one", None),
            ((n, "w_gate"), (d, f), "normal", 1 / d),
            ((n, "w_up"), (d, f), "normal", 1 / d),
            ((n, "w_down"), (f, d), "normal", 1 / f)]


def param_specs(cfg: dict, seg: str) -> list:
    """(path, shape, kind, var) of every leaf of ``seg``, ``front`` or
    ``middle``, as ``inputs.draw`` takes them: dense weights N(0, 1 /
    fan_in), the embedding N(0, 0.02^2), norms' scales 1 (the port's
    initialisation)."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    cut, n = cfg["cut_layer"], cfg["num_hidden_layers"]
    if seg == "front":
        return [(("embed",), (v, d), "normal", EMBED_STD ** 2)] + [
            s for i in range(cut) for s in _layer_specs(cfg, i)]
    return [s for i in range(cut, n) for s in _layer_specs(cfg, i)] + [
        (("final_norm",), (d,), "one", None),
        (("head",), (d, v), "normal", 1 / d)]


def weights(seed: int, cfg: dict, n_hospitals: int, device) -> tuple:
    """Each hospital's own front and one middle, as flat {path: tensor}
    dicts, drawn in one call."""
    out = inputs.draw(seed, [param_specs(cfg, "front")] * n_hospitals
                      + [param_specs(cfg, "middle")], device)
    return out[:-1], out[-1]


# -- the model ------------------------------------------------------------------------

class Model:
    """The decoder's per-sequence losses from flat {path: tensor} dicts."""

    fronts_take_mean = True

    def __init__(self, cfg: dict):
        self.heads, self.kv_heads, self.head_dim = _sizes(cfg)
        self.theta = float(cfg["rope_theta"])
        self.eps = float(cfg["rms_norm_eps"])
        self.cut, self.layers = cfg["cut_layer"], cfg["num_hidden_layers"]

    def _norm(self, x, scale):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) \
            * scale

    def _rope(self, x):
        """x (B, S, heads, head_dim), positions 0..S-1."""
        hd, half = self.head_dim, self.head_dim // 2
        inv = 1.0 / self.theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = torch.arange(x.shape[1], dtype=torch.float32,
                           device=x.device)[:, None] * inv
        cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _layer(self, p: dict, i: int, x):
        n = f"layer{i}"
        b, s, _ = x.shape
        hd = self.head_dim
        h = self._norm(x, p[(n, "attn_norm")])
        q = self._rope((h @ p[(n, "wq")]).view(b, s, self.heads, hd))
        k = self._rope((h @ p[(n, "wk")]).view(b, s, self.kv_heads, hd))
        v = (h @ p[(n, "wv")]).view(b, s, self.kv_heads, hd)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
        att = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
        causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        att = att.masked_fill(~causal, -math.inf).softmax(-1)
        o = torch.einsum("bhst,bthd->bshd", att, v).reshape(b, s, -1)
        x = x + o @ p[(n, "wo")]
        h = self._norm(x, p[(n, "mlp_norm")])
        return x + (F.silu(h @ p[(n, "w_gate")]) * (h @ p[(n, "w_up")])) \
            @ p[(n, "w_down")]

    def loss_terms(self, front: dict, middle: dict, batch: dict, link=None):
        """Each sequence's mean next-token loss: the front, the cut link on
        each token's hidden state (None: none), the middle."""
        toks = batch["tokens"]
        x = front[("embed",)][toks[:, :-1]]
        for i in range(self.cut):
            x = self._layer(front, i, x)
        if link is not None:
            x = link(x, -1)
        for i in range(self.cut, self.layers):
            x = self._layer(middle, i, x)
        logits = self._norm(x, middle[("final_norm",)]) @ middle[("head",)]
        nll = torch.logsumexp(logits, -1) - logits.gather(
            -1, toks[:, 1:, None])[..., 0]
        return nll.mean(-1)


def model(cfg: dict) -> Model:
    return Model(cfg)


# -- counts -----------------------------------------------------------------------------

def forward_flops(cfg: dict, traffic: dict) -> int:
    """FLOPs of one sequence's forward pass (``seq_len`` positions, the
    full square of attention scores as computed), counted by
    ``FlopCounterMode`` on ``meta`` tensors (a multiply-add counts 2)."""
    meta = torch.device("meta")

    def params(seg):
        return {p: torch.empty(s, device=meta)
                for p, s, _, _ in param_specs(cfg, seg)}
    toks = torch.zeros((1, traffic["seq_len"] + 1), dtype=torch.long,
                       device=meta)
    with FlopCounterMode(display=False) as fc:
        Model(cfg).loss_terms(params("front"), params("middle"),
                              {"tokens": toks})
    return int(fc.get_total_flops())


def link_bytes(cfg: dict, traffic: dict, rows: int) -> int:
    """Bytes an int8 roundtrip of the cut moves for ``rows`` sequences:
    every hidden value at the boundary, in the configuration's precision,
    read once and written once."""
    return (2 * rows * traffic["seq_len"] * cfg["hidden_size"]
            * ITEMSIZE[cfg["precision"]])
