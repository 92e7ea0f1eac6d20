"""Primitives of the model families: the CNN subset of
``repro/models/layers.py`` that DenseNet and the U-Net use, and the LM subset (dense,
RMSNorm, rotary embedding, GQA attention with its KV cache, SwiGLU,
embedding) that the transformer and Mamba2 use.

Parameters are plain dicts of tensors: conv weights are OIHW (the reference
keeps HWIO; ``repro_torch.interop`` converts), a dense weight is (in, out).
CNN activations are logically NCHW; a segment's input and output are NHWC in
memory (``models/cnn.py`` says how).  Convolutions and pools go to ATen /
cuDNN; GroupNorm, always followed by a ReLU, goes with it to K9 on the card
(``groupnorm_relu_apply``).  LM activations are (B, S, D) as in the
reference, and each op promotes and casts where the reference's does (a
bf16 tensor times an f32 one is f32 in both frameworks).

Every ``*_init`` draws from an explicit ``torch.Generator`` on the
generator's device and then moves the tensor, so one seed on a CPU
generator gives the same weights on every device (a CUDA generator draws
a large model on the card itself); on the ``meta`` device nothing is drawn
(shapes only).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.group_norm.ops import group_norm_relu
from repro_torch.tree import tree_leaves

INT32_MAX = torch.iinfo(torch.int32).max


def _normal(gen, shape, scale, device, dtype=torch.float32):
    """N(0, scale^2) draws of ``shape`` from ``gen`` on the generator's
    own device, then moved to ``device``; on ``meta`` nothing is drawn."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device) * scale
    return w.to(device=device, dtype=dtype)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of XLA's "SAME" for one spatial dim: at stride 2
    it is asymmetric, e.g. (2, 3) for a 7x7/2 conv on 224 and (0, 1) for a
    3x3/2 pool on 112."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, k, s, value=0.0):
    (hl, hh), (wl, wh) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    if hl == hh and wl == wh:
        return x, hl, wl
    return F.pad(x, (wl, wh, hl, hh), value=value), 0, 0


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------

def dense_init(gen, in_dim, out_dim, device):
    """Weight-only dense layer (bias-free, llama-style)."""
    return {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                         device)}


def dense_apply(p, x):
    return x @ p["w"].to(x.dtype)


def bias_dense_init(gen, in_dim, out_dim, device):
    return {"w": _normal(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                         device),
            "b": torch.zeros((out_dim,), device=device)}


def bias_dense_apply(p, x):
    return x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)


# ---------------------------------------------------------------------------
# norm
# ---------------------------------------------------------------------------

def rmsnorm_init(dim, device):
    return {"scale": torch.ones((dim,), device=device)}


def rmsnorm_apply(p, x, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def groupnorm_init(channels, device):
    return {"scale": torch.ones((channels,), device=device),
            "bias": torch.zeros((channels,), device=device)}


def num_groups(c: int, groups: int = 8) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def groupnorm_relu_apply(p, x, groups=8, eps=1e-5):
    """relu(GroupNorm(x)) of x: (B, C, H, W), batch-statistics-free, the
    statistics and the affine map in f32, the result in x's dtype.  On the
    card one hand kernel, K9 (``kernels/group_norm``; NCHW-contiguous out
    of either layout); elsewhere ATen's ``F.group_norm`` and ``F.relu``."""
    g = num_groups(x.shape[1], groups)
    scale, bias = p["scale"].float(), p["bias"].float()
    if x.device.type == "cuda":
        return group_norm_relu(x, scale, bias, g, eps)
    return F.relu(F.group_norm(x.float(), g, scale, bias, eps).to(x.dtype))


# ---------------------------------------------------------------------------
# conv and pools
# ---------------------------------------------------------------------------

def conv_init(gen, in_ch, out_ch, ksize, device):
    fan_in = in_ch * ksize * ksize
    return {"w": _normal(gen, (out_ch, in_ch, ksize, ksize),
                         math.sqrt(2.0 / fan_in), device)}


def conv_apply(p, x, stride=1):
    """"SAME" convolution (XLA's padding rule) of x: (B, C, H, W)."""
    w = p["w"].to(x.dtype)
    x, ph, pw = _pad_same(x, w.shape[-1], stride)
    return F.conv2d(x, w, stride=stride, padding=(ph, pw))


def avg_pool(x, window=2, stride=2):
    return F.avg_pool2d(x, window, stride)


def max_pool(x, window=2, stride=2, padding="VALID"):
    if padding == "SAME":
        x, ph, pw = _pad_same(x, window, stride, value=-math.inf)
        return F.max_pool2d(x, window, stride, padding=(ph, pw))
    return F.max_pool2d(x, window, stride)


def global_avg_pool(x):
    return x.mean(dim=(2, 3))


def sepconv_init(gen, in_ch, out_ch, ksize, device):
    """Depthwise-separable conv (Xception building block).  The depthwise
    weight is drawn as (C, 1, k, k), ``F.conv2d(groups=C)``'s layout and
    what ``interop`` makes of the reference's HWIO (k, k, 1, C)."""
    return {"dw": _normal(gen, (in_ch, 1, ksize, ksize),
                          math.sqrt(2.0 / (ksize * ksize)), device),
            "pw": _normal(gen, (out_ch, in_ch, 1, 1), math.sqrt(2.0 / in_ch),
                          device)}


def sepconv_apply(p, x):
    """"SAME" depthwise conv at stride 1, then the 1x1 pointwise conv."""
    dw = p["dw"].to(x.dtype)
    x = F.conv2d(x, dw, padding=dw.shape[-1] // 2, groups=x.shape[1])
    return F.conv2d(x, p["pw"].to(x.dtype))


def upsample2x(x):
    """Nearest-neighbour resize of (B, C, H, W) to (B, C, 2H, 2W): each
    pixel copied into a 2x2 block, as ``jax.image.resize(.., "nearest")``
    does at exactly 2x."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def param_count(params) -> int:
    return int(sum(l.numel() for l in tree_leaves(params)))


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates
    halves (not interleaved pairs); the f32 angles promote a bf16 x to f32,
    and the result is cast back, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal, optional sliding window, KV-cache decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    sliding_window: int | None = None   # None => full causal
    chunk_kv: int = 0                   # >0 => chunked (flash-style) prefill


def attention_init(gen, cfg: AttnConfig, device):
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": _normal(gen, (d, h * hd), 1 / math.sqrt(d), device),
            "wk": _normal(gen, (d, kvh * hd), 1 / math.sqrt(d), device),
            "wv": _normal(gen, (d, kvh * hd), 1 / math.sqrt(d), device),
            "wo": _normal(gen, (h * hd, d), 1 / math.sqrt(h * hd), device)}


def _mask(positions, kv_positions, sliding_window):
    """(B, S, T) bool: key t is visible from query s."""
    mask = kv_positions[:, None, :] <= positions[:, :, None]
    if sliding_window is not None:
        mask &= kv_positions[:, None, :] > positions[:, :, None] - sliding_window
    return mask


def _full_causal_attn(q, k, v, positions, kv_positions, sliding_window):
    """q: (B,S,H,hd)  k,v: (B,T,KV,hd).  Returns (B,S,H,hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, hd)
    logits = torch.einsum("bsgrd,btgd->bgrst", qg.float(),
                          k.float()) * (1.0 / math.sqrt(hd))
    mask = _mask(positions, kv_positions, sliding_window)
    logits = torch.where(mask[:, None, None], logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.float())
    return out.reshape(b, s, h, hd).to(q.dtype)


def _chunked_attn(q, k, v, positions, kv_positions, sliding_window, chunk):
    """Online softmax over KV chunks (the reference's ``lax.scan`` as a
    loop); the running max starts at -inf, masked logits are -1e30."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    t = k.shape[1]
    n_chunks = (t + chunk - 1) // chunk
    pad = n_chunks * chunk - t
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=INT32_MAX)
    qg = q.reshape(b, s, kvh, rep, hd).float()
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((b, kvh, rep, s), -math.inf, device=q.device)
    l = torch.zeros((b, kvh, rep, s), device=q.device)
    acc = torch.zeros((b, kvh, rep, s, hd), device=q.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.einsum("bsgrd,btgd->bgrst", qg, k[:, sl].float()) * scale
        mask = _mask(positions, kv_positions[:, sl], sliding_window)
        logits = torch.where(mask[:, None, None], logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrst,btgd->bgrsd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
    return out.to(q.dtype)


def attention_apply(p, cfg: AttnConfig, x, positions, cache=None,
                    use_pallas: bool = False):
    """x: (B, S, D).  ``cache``: None for a cacheless forward, or one
    layer's {"k": (B,T,KV,hd), "v": ..., "pos": (B,T) int32, "index": 0-d
    int32}.  Returns (out, new_cache).

    Unlike the reference, which returns new arrays, the cache's k, v and
    pos are updated in place (so a decode step copies one token, not the
    cache); ``new_cache`` holds those tensors and the advanced index, a
    new tensor: the layers of a run share one index tensor, which they
    only read (``transformer._run_apply`` advances it once a call).  The
    write slot is computed on the device, so a captured decode step
    serves every position.  ``use_pallas`` sends a cacheless, unwindowed
    forward to K7."""
    b, s, d = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, h, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(b, s, kvh, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(b, s, kvh, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None:
        ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
        cl = ck.shape[1]
        if s >= cl:
            # bulk prefill larger than a sliding-window ring cache: keep the
            # last `cl` tokens (their natural ring slots when cl | s) and
            # attend over the in-flight keys directly
            ck.copy_(k[:, -cl:])
            cv.copy_(v[:, -cl:])
            cpos.copy_(positions[:, -cl:])
            index = cache["index"] + s
            k_all, v_all, kv_pos = k, v, positions
        else:
            # ring-buffer indexing: sliding-window caches allocate max_len ==
            # window and wrap (harmless for full caches: index < max_len).
            # The start is clamped so the update fits, as
            # ``dynamic_update_slice`` clamps it
            idx = cache["index"] % cl
            slots = (torch.clamp_max(idx, cl - s)
                     + torch.arange(s, device=ck.device))
            ck.index_copy_(1, slots, k.to(ck.dtype))
            cv.index_copy_(1, slots, v.to(cv.dtype))
            cpos.index_copy_(1, slots, positions.to(cpos.dtype))
            index = idx + s
            k_all, v_all, kv_pos = ck, cv, cpos
        new_cache = {"k": ck, "v": cv, "pos": cpos, "index": index}
    else:
        new_cache = None
        k_all, v_all, kv_pos = k, v, positions

    if use_pallas and cache is None and cfg.sliding_window is None:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        out = fa_ops.flash_attention(q, k_all, v_all, causal=True)
    elif cfg.chunk_kv and k_all.shape[1] > cfg.chunk_kv:
        out = _chunked_attn(q, k_all, v_all, positions, kv_pos,
                            cfg.sliding_window, cfg.chunk_kv)
    else:
        out = _full_causal_attn(q, k_all, v_all, positions, kv_pos,
                                cfg.sliding_window)
    out = out.reshape(b, s, h * hd) @ p["wo"].to(x.dtype)
    return out, new_cache


def attention_cache_init(cfg: AttnConfig, batch: int, max_len: int,
                         dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), INT32_MAX, dtype=torch.int32,
                              device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# MLP and embeddings
# ---------------------------------------------------------------------------

def swiglu_init(gen, d_model, d_ff, device):
    return {"wi": _normal(gen, (d_model, d_ff), 1 / math.sqrt(d_model), device),
            "wg": _normal(gen, (d_model, d_ff), 1 / math.sqrt(d_model), device),
            "wo": _normal(gen, (d_ff, d_model), 1 / math.sqrt(d_ff), device)}


def swiglu_apply(p, x):
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)


def embedding_init(gen, vocab, d_model, device):
    return {"table": _normal(gen, (vocab, d_model), 0.02, device)}


def embedding_apply(p, ids, compute_dtype=None):
    out = p["table"][ids]
    return out.to(compute_dtype) if compute_dtype else out


# ---------------------------------------------------------------------------
# logical axes: one name (or None) per dim of each leaf, the trees the
# reference's ``*_init`` return beside the params; ``launch/mesh.py``'s
# rule table maps them to mesh axes.  A leaf's names follow the port's own
# layout (convolutions are OIHW where the reference's are HWIO).
# ---------------------------------------------------------------------------

def dense_axes(axes=("in", "out")):
    return {"w": tuple(axes)}


def bias_dense_axes(axes=("in", "out")):
    return {"w": tuple(axes), "b": (axes[-1],)}


def rmsnorm_axes():
    return {"scale": ("embed",)}


def groupnorm_axes():
    return {"scale": ("chan",), "bias": ("chan",)}


def conv_axes():
    return {"w": ("chan", "chan_in", None, None)}


def sepconv_axes():
    return {"dw": ("chan", None, None, None),
            "pw": ("chan", "chan_in", None, None)}


def attention_axes():
    return {"wq": ("embed", "heads_flat"), "wk": ("embed", "kv_flat"),
            "wv": ("embed", "kv_flat"), "wo": ("heads_flat", "embed")}


def swiglu_axes():
    return {"wi": ("embed", "ff"), "wg": ("embed", "ff"),
            "wo": ("ff", "embed")}


def embedding_axes():
    return {"table": ("vocab", "embed")}
