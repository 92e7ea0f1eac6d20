"""Decoder-only LM family: the port of ``repro/models/transformer.py``.

The model is an ordered list of **segments**, the unit of the paper's
cut-layer partition:

    front  : embedding (+ modality projector) + layers[0:cut]
    middle : layers[cut:L] + final norm (+ LM head in label-sharing mode)
    tail   : LM head (only in the non-label-sharing / U-shaped mode)

Within a segment, consecutive same-kind layers are grouped into **runs**
whose params are stacked on a leading layer axis, as in the reference (a
run split at the cut keeps its id in front and takes ``id + 1000`` in the
middle); a run is a Python loop over that axis where the reference has
``lax.scan``.  Layer kinds: ``dense`` (attention + SwiGLU), ``moe``
(attention + MoE, ``models/moe.py``), ``mamba`` (Mamba2/SSD) and
``shared`` (the Zamba2-style shared attention block: one param set in the
segment that owns it, applied at several depths, each application with
its own KV cache).  A vision or audio frontend is a stub: its embeddings
arrive precomputed and a ``projector`` maps them to ``d_model`` ahead of
the token embeddings.  ``vocab_pad_to`` pads the embedding and head to a
multiple, and ``loss`` masks the padding slots out of the softmax.

Training: ``apply(train=True)`` with ``cfg.remat`` recomputes each layer
in the backward pass (``torch.utils.checkpoint``, the reference's
``nothing_saveable`` policy), and the MoE balance losses come back as
``aux``, which ``loss`` adds.

Caches are updated in place (see ``layers.attention_apply``); a run's
cache holds stacked tensors and one Python ``index``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE


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

    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab_size
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

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

    def moe_config(self) -> MOE.MoEConfig:
        return MOE.MoEConfig(
            d_model=self.d_model, d_ff=self.d_ff, n_experts=self.n_experts,
            top_k=self.top_k, capacity_factor=self.capacity_factor,
            chunk=self.moe_chunk, n_shared_experts=self.n_shared_experts)


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
    return x, new_cache, None


def _moe_block_init(gen, cfg: ModelConfig, device):
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.attention_init(gen, cfg.attn_config(), device),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "moe": MOE.moe_init(gen, cfg.moe_config(), device)}


def _moe_block_apply(p, cfg, x, positions, cache, use_pallas=False):
    h, new_cache = L.attention_apply(
        p["attn"], cfg.attn_config(), L.rmsnorm_apply(p["ln1"], x),
        positions, cache, use_pallas=use_pallas)
    x = x + h
    y, aux = MOE.moe_apply(p["moe"], cfg.moe_config(),
                           L.rmsnorm_apply(p["ln2"], x))
    return x + y, new_cache, 0.01 * aux["lb_loss"] + 0.001 * aux["z_loss"]


def _mamba_block_init(gen, cfg: ModelConfig, device):
    return {"ln": L.rmsnorm_init(cfg.d_model, device),
            "mamba": M.mamba_init(gen, cfg.mamba_config(), device)}


def _mamba_block_apply(p, cfg, x, positions, cache, use_pallas=False):
    h, new_cache = M.mamba_apply(p["mamba"], cfg.mamba_config(),
                                 L.rmsnorm_apply(p["ln"], x), cache,
                                 use_pallas=use_pallas)
    return x + h, new_cache, None


def _dense_block_axes(cfg: ModelConfig):
    return {"ln1": L.rmsnorm_axes(), "attn": L.attention_axes(),
            "ln2": L.rmsnorm_axes(), "mlp": L.swiglu_axes()}


def _moe_block_axes(cfg: ModelConfig):
    return {"ln1": L.rmsnorm_axes(), "attn": L.attention_axes(),
            "ln2": L.rmsnorm_axes(), "moe": MOE.moe_axes(cfg.moe_config())}


def _mamba_block_axes(cfg: ModelConfig):
    return {"ln": L.rmsnorm_axes(),
            "mamba": M.mamba_axes(cfg.mamba_config())}


_BLOCK_AXES = {"dense": _dense_block_axes, "moe": _moe_block_axes,
               "mamba": _mamba_block_axes, "shared": _dense_block_axes}

# a block returns (x, new_cache, aux): aux is None where the kind has no
# auxiliary loss (the reference's f32 zero)
_BLOCK_INIT = {"dense": _dense_block_init, "moe": _moe_block_init,
               "mamba": _mamba_block_init, "shared": _dense_block_init}
_BLOCK_APPLY = {"dense": _dense_block_apply, "moe": _moe_block_apply,
                "mamba": _mamba_block_apply, "shared": _dense_block_apply}


def _block_cache_init(kind, cfg: ModelConfig, batch, max_len, dtype, device):
    if kind in ("dense", "moe", "shared"):
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


def _add(aux, a):
    return aux if a is None else (a if aux is None else aux + a)


# ---------------------------------------------------------------------------
# runs (stacks of same-kind layers)
# ---------------------------------------------------------------------------

def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_init(gen, spec: RunSpec, cfg: ModelConfig, device):
    """A run's layers stacked on a leading axis; None for a ``shared``
    run, whose params are the segment's ``shared_block``."""
    if spec.kind == "shared":
        return None
    layers = [_BLOCK_INIT[spec.kind](gen, cfg, device)
              for _ in range(spec.count)]

    def stack(*leaves):
        return (torch.stack(leaves) if isinstance(leaves[0], torch.Tensor)
                else {k: stack(*(l[k] for l in leaves)) for k in leaves[0]})
    return stack(*layers)


def _run_axes(spec: RunSpec, cfg: ModelConfig):
    """A run's axes: its block's, each led by the stacked ``"layers"``
    dim; None for a ``shared`` run."""
    if spec.kind == "shared":
        return None

    def lead(a):
        return (("layers",) + a if isinstance(a, tuple)
                else {k: lead(v) for k, v in a.items()})
    return lead(_BLOCK_AXES[spec.kind](cfg))


def _run_apply(run_p, shared_p, spec: RunSpec, cfg: ModelConfig, x,
               positions, cache, use_pallas=False, remat=False):
    """One layer at a time over the stacked params (a ``shared`` run: the
    shared block once, on its own unstacked cache); a cache's tensors are
    updated in place through their per-layer views, and an attention
    run's one index tensor advances once a call, in place after its last
    layer (each layer reads it), so the cache dict keeps its tensors from
    call to call, as a captured decode step needs.  ``remat`` (training,
    no cache) recomputes each layer in the backward pass.  Returns (x,
    cache, aux), aux the layers' summed auxiliary loss or None."""
    apply = _BLOCK_APPLY[spec.kind]
    if spec.kind == "shared":
        if shared_p is None:
            raise TypeError(
                "a shared layer found no shared_block: pass the params of "
                "the segment that owns it")
        x, nc, aux = apply(shared_p, cfg, x, positions, cache, use_pallas)
        if cache is not None:
            cache["index"].copy_(nc["index"])
        return x, cache, aux
    def layer(lp, x):
        x, _, a = apply(lp, cfg, x, positions, None, use_pallas)
        return x, a

    aux = nc = None
    for i in range(spec.count):
        lp = _layer(run_p, i)
        if remat and cache is None:
            x, a = checkpoint(layer, lp, x, use_reentrant=False)
        else:
            lc = None if cache is None else {
                k: v if k == "index" else v[i] for k, v in cache.items()}
            x, nc, a = apply(lp, cfg, x, positions, lc, use_pallas)
        aux = _add(aux, a)
    if cache is not None and "index" in cache:
        cache["index"].copy_(nc["index"])   # every layer advanced it alike
    return x, cache, aux


def _run_cache_init(spec: RunSpec, cfg: ModelConfig, batch, max_len, dtype,
                    device):
    one = _block_cache_init(spec.kind, cfg, batch, max_len, dtype, device)
    if spec.kind == "shared":
        return one
    return {k: v if k == "index" else
            v.expand(spec.count, *v.shape).clone() for k, v in one.items()}


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SegmentDef:
    name: str                         # front | middle | tail
    runs: tuple[RunSpec, ...]         # layer runs inside this segment
    has_embed: bool = False
    has_frontend: bool = False
    has_final_norm: bool = False
    has_head: bool = False
    has_shared: bool = False          # owns the shared-attn param set


def _segment_init(gen, seg: SegmentDef, cfg: ModelConfig, device):
    p = {}
    if seg.has_embed:
        p["embed"] = L.embedding_init(gen, cfg.padded_vocab, cfg.d_model,
                                      device)
    if seg.has_frontend:
        p["projector"] = L.dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                      device)
    if seg.has_shared:
        p["shared_block"] = _dense_block_init(gen, cfg, device)
    for spec in seg.runs:
        if spec.kind != "shared":
            p[f"run_{spec.run_id}"] = _run_init(gen, spec, cfg, device)
    if seg.has_final_norm:
        p["final_norm"] = L.rmsnorm_init(cfg.d_model, device)
    if seg.has_head:
        p["head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, device)
    return p


def _segment_axes(seg: SegmentDef, cfg: ModelConfig):
    """``_segment_init``'s logical axes, key for key."""
    a = {}
    if seg.has_embed:
        a["embed"] = L.embedding_axes()
    if seg.has_frontend:
        a["projector"] = L.dense_axes(("frontend", "embed"))
    if seg.has_shared:
        a["shared_block"] = _dense_block_axes(cfg)
    for spec in seg.runs:
        if spec.kind != "shared":
            a[f"run_{spec.run_id}"] = _run_axes(spec, cfg)
    if seg.has_final_norm:
        a["final_norm"] = L.rmsnorm_axes()
    if seg.has_head:
        a["head"] = L.dense_axes(("embed", "vocab"))
    return a


def _segment_apply(p, seg: SegmentDef, cfg: ModelConfig, x, ctx):
    """x: token ids (B,S) if seg.has_embed else hidden (B,S,D).
    ctx: dict(positions, cache[segment] or None, use_pallas, train,
    frontend_emb, shared_block).  Returns (x, new_seg_cache, aux)."""
    positions = ctx["positions"]
    cache = ctx.get("cache")
    remat = cfg.remat and ctx.get("train", False)
    aux = None
    if seg.has_embed:
        tok_emb = L.embedding_apply(p["embed"], x, cfg.compute_dtype)
        if seg.has_frontend and ctx.get("frontend_emb") is not None:
            # decode steps past the prefix pass no frontend embeddings
            pe = ctx["frontend_emb"].to(cfg.compute_dtype)
            x = torch.cat([L.dense_apply(p["projector"], pe), tok_emb], 1)
        else:
            x = tok_emb
    shared_p = p.get("shared_block") or ctx.get("shared_block")
    for spec in seg.runs:
        rc = cache[f"cache_{spec.run_id}"] if cache is not None else None
        x, _, a = _run_apply(p.get(f"run_{spec.run_id}"), shared_p, spec,
                             cfg, x, positions, rc,
                             use_pallas=ctx.get("use_pallas", False),
                             remat=remat)
        aux = _add(aux, a)
    if seg.has_final_norm:
        x = L.rmsnorm_apply(p["final_norm"], x)
    if seg.has_head:
        x = L.dense_apply(p["head"], x)
    return x, cache, aux


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
        """Split the layer stack at ``cut`` (the paper's cut layer; it
        counts layers including ``shared`` applications).  ``nls`` adds
        the U-shaped client tail holding the LM head."""
        cut = cfg.cut_layer if cut is None else cut
        kinds = layer_kinds(cfg)
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
        shared_in_front = any(r.kind == "shared" for r in front_runs)
        shared_in_middle = any(r.kind == "shared" for r in middle_runs)
        segs = [SegmentDef("front", tuple(front_runs), has_embed=True,
                           has_frontend=cfg.frontend is not None,
                           has_shared=shared_in_front),
                SegmentDef("middle", tuple(middle_runs), has_final_norm=True,
                           has_head=not nls,
                           has_shared=shared_in_middle
                           and not shared_in_front)]
        if nls:
            segs.append(SegmentDef("tail", (), has_head=True))
        return TransformerLM(cfg, tuple(segs))

    # ---- params -----------------------------------------------------------
    def init_params(self, gen: torch.Generator | None, device=None,
                    segments=None):
        """Every param, drawn from ``gen`` (on the generator's device) in
        segment, run and layer order and moved to ``device`` (the CUDA
        card by default); ``segments`` names the segments to draw (all by
        default).  On ``device="meta"`` nothing is drawn or allocated and
        ``gen`` may be None: the params' shapes alone
        (``launch.train.param_shapes``).  The reference's ``init`` also
        returns the logical-axes tree: here ``init_axes``."""
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        return {seg.name: _segment_init(gen, seg, self.cfg, device)
                for seg in self.segments
                if segments is None or seg.name in segments}

    def init_axes(self, segments=None):
        """The logical-axes tree of ``init_params``' params (the same
        structure, one tuple of axis names per leaf): what the reference's
        ``init`` returns second, read by ``launch/mesh.py``."""
        return {seg.name: _segment_axes(seg, self.cfg)
                for seg in self.segments
                if segments is None or seg.name in segments}

    # ---- caches -----------------------------------------------------------
    def cache_init(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Every segment's decode caches; on ``device="meta"`` their
        shapes alone (``launch.specs.cache_specs``)."""
        device = (torch.device("meta") if str(device) == "meta"
                  else resolve_device(device))
        return {seg.name: {f"cache_{s.run_id}": _run_cache_init(
                    s, self.cfg, batch, max_len, dtype, device)
                    for s in seg.runs}
                for seg in self.segments}

    # ---- forward ----------------------------------------------------------
    def apply(self, params, tokens, *, positions=None, cache=None,
              frontend_emb=None, use_pallas=False, train=False,
              segment_range=(0, None), boundary_fn=None):
        """Full or partial (``segment_range``) forward.  tokens: (B,S)
        integer ids on the params' device; ``frontend_emb`` (B, F,
        frontend_dim) precomputed modality embeddings, prepended (the
        positions count them).  Returns (logits_or_hidden, new_cache,
        aux), aux the f32 sum of the MoE layers' balance losses (zero for
        the other kinds).  ``train`` turns on ``cfg.remat``."""
        b, s = tokens.shape[:2]
        if positions is None:
            total = s + (frontend_emb.shape[1]
                         if frontend_emb is not None else 0)
            positions = torch.arange(total, dtype=torch.int32,
                                     device=tokens.device).expand(b, total)
        shared_block = None
        for seg in self.segments:
            if seg.has_shared and seg.name in params:
                shared_block = params[seg.name].get("shared_block")
        x = tokens
        start, stop = segment_range
        segs = self.segments[start:stop]
        new_cache = dict(cache) if cache is not None else None
        aux = torch.zeros((), device=tokens.device)
        for si, seg in enumerate(segs):
            ctx = {"positions": positions,
                   "cache": cache[seg.name] if cache is not None else None,
                   "use_pallas": use_pallas, "train": train,
                   "frontend_emb": frontend_emb,
                   "shared_block": shared_block}
            x, seg_cache, a = _segment_apply(params[seg.name], seg, self.cfg,
                                             x, ctx)
            if a is not None:
                aux = aux + a.float()
            if cache is not None:
                new_cache[seg.name] = seg_cache
            if boundary_fn is not None and si != len(segs) - 1:
                # the paper's client->server link (e.g. int8 compression)
                x = boundary_fn(x)
        return x, new_cache, aux

    # ---- losses -----------------------------------------------------------
    def loss(self, params, batch, *, train=True, use_pallas=False,
             boundary_fn=None):
        """Next-token cross-entropy plus ``aux``.  batch: {"tokens": (B,
        S), ["frontend_emb"]}; with a frontend only the text positions are
        scored."""
        tokens = batch["tokens"]
        logits, _, aux = self.apply(
            params, tokens[:, :-1], frontend_emb=batch.get("frontend_emb"),
            train=train, use_pallas=use_pallas, boundary_fn=boundary_fn)
        return token_nll(self.cfg, logits, tokens).mean() + aux


def token_nll(cfg: ModelConfig, logits, tokens):
    """(B, S-1) next-token negative log-likelihoods of ``tokens`` (B, S)
    under ``logits``: a frontend's prefix positions are dropped, and the
    padding slots of a padded vocabulary are masked to -1e30 in f32."""
    labels = tokens[:, 1:].long()
    logits = logits[:, -labels.shape[1]:].float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device)
        logits = torch.where(pad >= cfg.vocab_size, -1e30, logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse - ll
