"""Plain PyTorch DenseNet-121 and U-Net of the paper (arXiv:2012.12591 §3.2),
written from the configuration files alone: the yardstick that decides a
CNN family's ``correct`` and counts its FLOPs (``families/densenet``,
``families/unet``).  It imports nothing of the program.

Tensors are NCHW float32.  A model is an ordered list of units; a config's
``cut`` puts units[0:cut] at the client (the front) and the rest at the
server (the middle).  Parameters are a nested dict ``{segment: {unit:
{layer: {leaf: tensor}}}}``; ``param_specs`` lists every leaf with its
shape and initial scale, so the benchmark can draw the weights itself.

Layer rules (the paper's JAX/flax model, which the program follows too):
convolutions pad by XLA's "SAME" rule (asymmetric at stride 2), GroupNorm
takes 8 groups (fewer where 8 does not divide the channels) with eps 1e-5,
the 3x3/2 stem pool pads "SAME" with -inf, a dense layer's weight is
(in, out), and the loss is the mean binary cross-entropy of one logit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

GN_GROUPS, GN_EPS = 8, 1e-5


# -- primitives ---------------------------------------------------------------

def groups_for(c: int) -> int:
    g = min(GN_GROUPS, c)
    while c % g:
        g -= 1
    return g


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x, k, s, value=0.0):
    (t, b), (lft, r) = same_pad(x.shape[2], k, s), same_pad(x.shape[3], k, s)
    return F.pad(x, (lft, r, t, b), value=value)


def conv(p, x, stride=1):
    w = p["w"]
    return F.conv2d(pad_same(x, w.shape[-1], stride), w, stride=stride)


def gn(p, x):
    return F.group_norm(x, groups_for(x.shape[1]), p["scale"], p["bias"],
                        GN_EPS)


def sepconv(p, x):
    dw = p["dw"]
    x = F.conv2d(pad_same(x, dw.shape[-1], 1), dw, groups=x.shape[1])
    return F.conv2d(x, p["pw"])


def bce(logits, labels):
    """Per-example binary cross-entropy of one logit each: (B,)."""
    z, y = logits.reshape(-1), labels.reshape(-1)
    return torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))


# -- parameter specs: (path, shape, kind, fan) ---------------------------------
# kind "conv" draws N(0, 2 / fan), "dense" N(0, 1 / fan), "one" and "zero"
# are constants

def _conv_spec(path, cin, cout, k):
    return [(path + ("w",), (cout, cin, k, k), "conv", cin * k * k)]


def _gn_spec(path, c):
    return [(path + ("scale",), (c,), "one", 0),
            (path + ("bias",), (c,), "zero", 0)]


def _sep_spec(path, cin, cout, k=3):
    return [(path + ("dw",), (cin, 1, k, k), "conv", k * k),
            (path + ("pw",), (cout, cin, 1, 1), "conv", cin)]


# -- DenseNet -------------------------------------------------------------------

def densenet_units(m: dict) -> list:
    """[(name, specs(prefix), apply(p, x))] of a DenseNet config ``m``
    (keys growth, blocks, stem_ch, compression, in_ch, n_classes)."""
    g, units = m["growth"], []

    def stem(p, x):
        h = F.relu(gn(p["n"], conv(p["c"], x, 2)))
        return F.max_pool2d(pad_same(h, 3, 2, -math.inf), 3, 2)

    units.append(("stem", lambda q: _conv_spec(q + ("c",), m["in_ch"],
                                               m["stem_ch"], 7)
                  + _gn_spec(q + ("n",), m["stem_ch"]), stem))
    ch = m["stem_ch"]
    for bi, n in enumerate(m["blocks"]):
        for li in range(n):
            def specs(q, c=ch):
                return (_gn_spec(q + ("n1",), c)
                        + _conv_spec(q + ("c1",), c, 4 * g, 1)
                        + _gn_spec(q + ("n2",), 4 * g)
                        + _conv_spec(q + ("c2",), 4 * g, g, 3))

            def layer(p, x):
                h = conv(p["c1"], F.relu(gn(p["n1"], x)))
                h = conv(p["c2"], F.relu(gn(p["n2"], h)))
                return torch.cat([x, h], 1)
            units.append((f"b{bi}_l{li}", specs, layer))
            ch += g
        if bi != len(m["blocks"]) - 1:
            out = int(ch * m["compression"])

            def specs(q, c=ch, o=out):
                return _gn_spec(q + ("n",), c) + _conv_spec(q + ("c",), c, o, 1)

            def trans(p, x):
                return F.avg_pool2d(conv(p["c"], F.relu(gn(p["n"], x))), 2, 2)
            units.append((f"t{bi}", specs, trans))
            ch = out

    def head_specs(q, c=ch):
        return _gn_spec(q + ("n",), c) + [
            (q + ("fc", "w"), (c, m["n_classes"]), "dense", c),
            (q + ("fc", "b"), (m["n_classes"],), "zero", 0)]

    def head(p, x):
        h = F.relu(gn(p["n"], x)).mean(dim=(2, 3))
        return h @ p["fc"]["w"] + p["fc"]["b"]
    units.append(("head", head_specs, head))
    return units


# -- U-Net ------------------------------------------------------------------------

def _pair_specs(q, cin, cout):
    return (_sep_spec(q + ("c1",), cin, cout) + _gn_spec(q + ("n1",), cout)
            + _sep_spec(q + ("c2",), cout, cout) + _gn_spec(q + ("n2",), cout))


def _pair(p, x):
    h = F.relu(gn(p["n1"], sepconv(p["c1"], x)))
    return F.relu(gn(p["n2"], sepconv(p["c2"], h)))


def unet_units(m: dict) -> list:
    """The U-Net of a config ``m`` (keys widths, in_ch, n_classes): an
    encoder of separable-conv pairs that keeps a skip before each 2x2 pool
    (the bottleneck keeps none), a decoder that upsamples (nearest), joins
    the skip and runs a pair, and a 1x1 head whose logit map is pooled by
    logsumexp minus log(H W) into one logit.  A unit maps ``(x, skips)``
    to ``(x, skips)``; the first lifts the image into that pair."""
    ws, units = list(m["widths"]), []
    units.append(("lift", lambda q: [], lambda p, x: (x, ())))
    chans = [m["in_ch"]] + ws
    for i, (ci, co) in enumerate(zip(chans[:-1], chans[1:])):
        down = i != len(ws) - 1

        def enc(p, s, down=down):
            x, skips = s
            h = _pair(p, x)
            if down:
                return F.max_pool2d(h, 2, 2), skips + (h,)
            return h, skips
        units.append((f"enc{i}", lambda q, ci=ci, co=co: _pair_specs(q, ci, co),
                      enc))
    cin = ws[-1]
    for i in range(len(ws) - 2, -1, -1):
        def dec(p, s):
            x, skips = s
            x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"),
                           skips[-1]], 1)
            return _pair(p, x), skips[:-1]
        units.append((f"dec{i}",
                      lambda q, ci=cin + ws[i], co=ws[i]: _pair_specs(q, ci, co),
                      dec))
        cin = ws[i]

    def head(p, s):
        seg = F.conv2d(s[0], p["c"]["w"])
        flat = seg.reshape(seg.shape[0], -1)
        return (torch.logsumexp(flat, -1, keepdim=True)
                - math.log(seg.shape[2] * seg.shape[3]))
    units.append(("head", lambda q, c=cin: _conv_spec(q + ("c",), c,
                                                      m["n_classes"], 1), head))
    return units


class Model:
    """A config's model, its units made by ``units`` (``densenet_units``
    or ``unet_units``) from ``cfg["model"]``, cut into the front (client)
    and the middle (server)."""

    def __init__(self, cfg: dict, units):
        self.cfg = cfg
        self.units = units(cfg["model"])
        self.cut = cfg["model"]["cut_layer"]
        self.segments = {"front": self.units[:self.cut],
                         "middle": self.units[self.cut:]}

    def param_specs(self, seg: str) -> list:
        out = []
        for name, specs, _ in self.segments[seg]:
            out += specs((name,))
        return out

    def apply(self, seg: str, params: dict, x):
        for name, _, fn in self.segments[seg]:
            x = fn(params.get(name, {}), x)
        return x

    def loss_terms(self, front, middle, image, label, link=None):
        """Per-example losses of a batch (``image`` NCHW): the front, the
        cut link ``link`` on every boundary leaf (None: none), the
        middle."""
        h = self.apply("front", front, image)
        if link is not None:
            h = map_leaves(link, h)
        return bce(self.apply("middle", middle, h), label)


def map_leaves(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, t) for t in tree)
    return fn(tree)


def leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [t for s in tree for t in leaves(s)]
    return [tree]


def nest(flat: dict) -> dict:
    """{path tuple: tensor} -> the nested parameter dict."""
    out: dict = {}
    for path, t in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = t
    return out


def flatten(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out
