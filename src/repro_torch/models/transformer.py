"""Decoder-only LM family: the port of ``repro/models/transformer.py`` for
the kinds this slice carries, ``dense`` (attention + SwiGLU, e.g.
SmolLM-135M) and ``mamba`` (Mamba2/SSD).

The model is an ordered list of **segments**, the unit of the paper's
cut-layer partition:

    front  : embedding + layers[0:cut]
    middle : layers[cut:L] + final norm + LM head

Within a segment, consecutive same-kind layers are grouped into **runs**
whose params are stacked on a leading layer axis, as in the reference (a
run split at the cut keeps its id in front and takes ``id + 1000`` in the
middle); a run is a Python loop over that axis where the reference has
``lax.scan``.  MoE layers, the hybrid ``shared`` block, modality frontends,
the U-shaped (``nls``) tail and a padded vocabulary wait for later slices:
``build`` refuses them.  Training (``remat``, gradients through the
kernels) is not ported yet either; ``remat`` is kept as a field and has no
effect.

Caches are updated in place (see ``layers.attention_apply``); a run's
cache holds stacked tensors and one Python ``index``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0               # 0 => d_model // n_heads
    rope_theta: float = 500000.0
    sliding_window: int | None = None
    chunk_kv: int = 0               # chunked online-softmax threshold
    # MoE
    n_experts: int = 0
    top_k: int = 0
    first_k_dense: int = 0          # leading dense layers (Kimi-K2 style)
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_chunk: int = 1024
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_n_groups: int = 1
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0      # zamba2: shared attn block every k layers
    # variants
    vocab_pad_to: int = 0           # pad vocab to a multiple
    mamba_conv_gather: bool = True   # window-gather conv
    # modality frontend
    frontend: str | None = None     # None | "vision" | "audio"
    frontend_dim: int = 1024
    frontend_tokens: int = 256      # patches / audio frames per sample
    # split-learning defaults (the paper's technique)
    cut_layer: int = 4
    # numerics / training
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    # citation for the registry table
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def attn_config(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.resolved_head_dim,
            rope_theta=self.rope_theta, sliding_window=self.sliding_window,
            chunk_kv=self.chunk_kv)

    def mamba_config(self) -> M.MambaConfig:
        return M.MambaConfig(
            d_model=self.d_model, d_state=self.ssm_state,
            head_dim=self.ssm_head_dim, n_groups=self.ssm_n_groups,
            chunk=self.ssm_chunk, conv_gather=self.mamba_conv_gather)


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """Kind of each of the L layers, in depth order."""
    kinds = []
    for i in range(cfg.n_layers):
        if cfg.arch_type in ("ssm",):
            kinds.append("mamba")
        elif cfg.arch_type == "hybrid":
            kinds.append("mamba")
            if cfg.hybrid_attn_every and (i + 1) % cfg.hybrid_attn_every == 0:
                kinds.append("shared")
        elif cfg.n_experts and i >= cfg.first_k_dense:
            kinds.append("moe")
        else:
            kinds.append("dense")
    return kinds


@dataclasses.dataclass(frozen=True)
class RunSpec:
    kind: str
    count: int
    run_id: int


def group_runs(kinds: list[str]) -> list[RunSpec]:
    runs, rid = [], 0
    for k in kinds:
        if runs and runs[-1].kind == k and k != "shared":
            runs[-1] = RunSpec(k, runs[-1].count + 1, runs[-1].run_id)
        else:
            runs.append(RunSpec(k, 1, rid))
            rid += 1
    return runs


# ---------------------------------------------------------------------------
# per-layer blocks
# ---------------------------------------------------------------------------

def _dense_block_init(gen, cfg: ModelConfig, device):
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.attention_init(gen, cfg.attn_config(), device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, device)}


def _dense_block_apply(p, cfg, x, positions, cache, use_pallas=False):
    h, new_cache = L.attention_apply(
        p["attn"], cfg.attn_config(), L.rmsnorm_apply(p["ln1"], x),
        positions, cache, use_pallas=use_pallas)
    x = x + h
    x = x + L.swiglu_apply(p["mlp"], L.rmsnorm_apply(p["ln2"], x))
    return x, new_cache


def _mamba_block_init(gen, cfg: ModelConfig, device):
    return {"ln": L.rmsnorm_init(cfg.d_model, device),
            "mamba": M.mamba_init(gen, cfg.mamba_config(), device)}


def _mamba_block_apply(p, cfg, x, positions, cache, use_pallas=False):
    h, new_cache = M.mamba_apply(p["mamba"], cfg.mamba_config(),
                                 L.rmsnorm_apply(p["ln"], x), cache,
                                 use_pallas=use_pallas)
    return x + h, new_cache


_BLOCK_INIT = {"dense": _dense_block_init, "mamba": _mamba_block_init}
_BLOCK_APPLY = {"dense": _dense_block_apply, "mamba": _mamba_block_apply}


def _block_cache_init(kind, cfg: ModelConfig, batch, max_len, dtype, device):
    if kind == "dense":
        if cfg.sliding_window:
            # ring buffer: a sliding-window cache never needs more than the
            # window
            max_len = min(max_len, cfg.sliding_window)
        return L.attention_cache_init(cfg.attn_config(), batch, max_len,
                                      dtype, device)
    # The reference's conv state takes the compute dtype from the first
    # step on (the new cache is its scan's output); starting from zeros,
    # allocating it so gives the same values and lets it update in place
    return M.mamba_cache_init(cfg.mamba_config(), batch, cfg.compute_dtype,
                              device)


# ---------------------------------------------------------------------------
# runs (stacks of same-kind layers)
# ---------------------------------------------------------------------------

def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_init(gen, spec: RunSpec, cfg: ModelConfig, device):
    layers = [_BLOCK_INIT[spec.kind](gen, cfg, device)
              for _ in range(spec.count)]

    def stack(*leaves):
        return (torch.stack(leaves) if isinstance(leaves[0], torch.Tensor)
                else {k: stack(*(l[k] for l in leaves)) for k in leaves[0]})
    return stack(*layers)


def _run_apply(run_p, spec: RunSpec, cfg: ModelConfig, x, positions, cache,
               use_pallas=False):
    """One layer at a time over the stacked params; a cache's tensors are
    updated in place through their per-layer views."""
    apply = _BLOCK_APPLY[spec.kind]
    nc = None
    for i in range(spec.count):
        lc = None if cache is None else {
            k: v if k == "index" else v[i] for k, v in cache.items()}
        x, nc = apply(_layer(run_p, i), cfg, x, positions, lc, use_pallas)
    if cache is not None and "index" in cache:
        cache["index"] = nc["index"]     # every layer advanced it alike
    return x, cache


def _run_cache_init(spec: RunSpec, cfg: ModelConfig, batch, max_len, dtype,
                    device):
    one = _block_cache_init(spec.kind, cfg, batch, max_len, dtype, device)
    return {k: v if k == "index" else
            v.expand(spec.count, *v.shape).clone() for k, v in one.items()}


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentDef:
    name: str                         # front | middle
    runs: tuple[RunSpec, ...]         # layer runs inside this segment
    has_embed: bool = False
    has_final_norm: bool = False
    has_head: bool = False


def _segment_init(gen, seg: SegmentDef, cfg: ModelConfig, device):
    p = {}
    if seg.has_embed:
        p["embed"] = L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      device)
    for spec in seg.runs:
        p[f"run_{spec.run_id}"] = _run_init(gen, spec, cfg, device)
    if seg.has_final_norm:
        p["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    if seg.has_head:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, device)
    return p


def _segment_apply(p, seg: SegmentDef, cfg: ModelConfig, x, ctx):
    """x: token ids (B,S) if seg.has_embed else hidden (B,S,D).
    ctx: dict(positions, cache[segment] or None, use_pallas).
    Returns (x, new_seg_cache)."""
    positions = ctx["positions"]
    cache = ctx.get("cache")
    if seg.has_embed:
        x = L.embedding_apply(p["embed"], x, cfg.compute_dtype)
    for spec in seg.runs:
        rc = cache[f"cache_{spec.run_id}"] if cache is not None else None
        x, _ = _run_apply(p[f"run_{spec.run_id}"], spec, cfg, x, positions,
                          rc, use_pallas=ctx.get("use_pallas", False))
    if seg.has_final_norm:
        x = L.rmsnorm_apply(p["final_norm"], x)
    if seg.has_head:
        x = L.dense_apply(p["head"], x)
    return x, cache


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformerLM:
    cfg: ModelConfig
    segments: tuple[SegmentDef, ...]

    # ---- construction -----------------------------------------------------
    @staticmethod
    def build(cfg: ModelConfig, cut: int | None = None,
              nls: bool = False) -> "TransformerLM":
        """Split the layer stack at ``cut`` (the paper's cut layer)."""
        kinds = layer_kinds(cfg)
        missing = sorted({k for k in kinds if k not in _BLOCK_INIT})
        for flag, what in ((missing, f"layer kinds {missing}"),
                           (cfg.frontend, f"the {cfg.frontend} frontend"),
                           (nls, "nls=True (the U-shaped tail)"),
                           (cfg.vocab_pad_to, "vocab_pad_to")):
            if flag:
                raise NotImplementedError(
                    f"{what} not ported yet (ROADMAP M12)")
        cut = cfg.cut_layer if cut is None else cut
        cut = max(0, min(cut, len(kinds)))
        front_runs, middle_runs, seen = [], [], 0
        for r in group_runs(kinds):
            if seen + r.count <= cut:
                front_runs.append(r)
                seen += r.count
            elif seen >= cut:
                middle_runs.append(r)
            else:
                front_runs.append(RunSpec(r.kind, cut - seen, r.run_id))
                middle_runs.append(RunSpec(r.kind, r.count - (cut - seen),
                                           r.run_id + 1000))
                seen = cut
        return TransformerLM(cfg, (
            SegmentDef("front", tuple(front_runs), has_embed=True),
            SegmentDef("middle", tuple(middle_runs), has_final_norm=True,
                       has_head=True)))

    # ---- params -----------------------------------------------------------
    def init_params(self, gen: torch.Generator, device=None):
        """Every param, drawn on the CPU from ``gen`` in segment, run and
        layer order and moved to ``device`` (the CUDA card by default).
        The reference's ``init`` also returns a logical-axes tree for its
        launcher, which is not ported yet."""
        device = resolve_device(device)
        return {seg.name: _segment_init(gen, seg, self.cfg, device)
                for seg in self.segments}

    # ---- caches -----------------------------------------------------------
    def cache_init(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        device = resolve_device(device)
        return {seg.name: {f"cache_{s.run_id}": _run_cache_init(
                    s, self.cfg, batch, max_len, dtype, device)
                    for s in seg.runs}
                for seg in self.segments}

    # ---- forward ----------------------------------------------------------
    def apply(self, params, tokens, *, positions=None, cache=None,
              use_pallas=False, train=False, segment_range=(0, None),
              boundary_fn=None):
        """Full or partial (``segment_range``) forward.  tokens: (B,S)
        integer ids on the params' device.  Returns (logits_or_hidden,
        new_cache, aux); aux is the f32 zero of the dense and mamba kinds
        (MoE's balance loss waits for MoE).  ``train`` changes nothing in
        this slice."""
        b, s = tokens.shape[:2]
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=tokens.device).expand(b, s)
        x = tokens
        start, stop = segment_range
        segs = self.segments[start:stop]
        new_cache = dict(cache) if cache is not None else None
        for si, seg in enumerate(segs):
            ctx = {"positions": positions,
                   "cache": cache[seg.name] if cache is not None else None,
                   "use_pallas": use_pallas}
            x, seg_cache = _segment_apply(params[seg.name], seg, self.cfg,
                                          x, ctx)
            if cache is not None:
                new_cache[seg.name] = seg_cache
            if boundary_fn is not None and si != len(segs) - 1:
                # the paper's client->server link (e.g. int8 compression)
                x = boundary_fn(x)
        return x, new_cache, torch.zeros((), device=tokens.device)

    # ---- losses -----------------------------------------------------------
    def loss(self, params, batch, *, train=True, use_pallas=False,
             boundary_fn=None):
        """Next-token cross-entropy.  batch: {"tokens": (B, S)}."""
        tokens = batch["tokens"]
        logits, _, aux = self.apply(params, tokens[:, :-1], train=train,
                                    use_pallas=use_pallas,
                                    boundary_fn=boundary_fn)
        labels = tokens[:, 1:].long()
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0]
        return (lse - ll).mean() + aux
