"""Serving steps: batched prefill and single-token decode with KV/SSM caches
(the port of ``repro/serving/engine.py``).

As in the reference, prefill and the prompt pass of ``greedy_generate`` go
through the cache with no hand kernel; K7 and K8 serve the cacheless
scoring forward (``TransformerLM.apply(..., use_pallas=True)``).  Caches
are updated in place, their attention index a 0-d int32 device tensor, so
one decode step serves every position: ``captured_decode_step`` captures
it as ONE CUDA graph per model and cache (``core.strategies.engine.
Program``), and ``greedy_generate`` replays it for every token.
"""

from __future__ import annotations

import threading
import weakref

import torch

from repro_torch.core.strategies.engine import Program
from repro_torch.models.layers import INT32_MAX
from repro_torch.tree import tree_leaves


def make_prefill_step(model, max_len: int, cache_dtype=torch.bfloat16):
    def prefill_step(params, batch):
        """batch: {"tokens": (B, S)} -> (last-position logits, cache)."""
        tokens = batch["tokens"]
        cache = model.cache_init(tokens.shape[0], max_len, dtype=cache_dtype,
                                 device=tokens.device)
        logits, cache, _ = model.apply(params, tokens, cache=cache,
                                       use_pallas=False)
        return logits[:, -1, :], cache
    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens, positions):
        """tokens: (B, 1); positions: (B, 1) absolute positions."""
        logits, cache, _ = model.apply(params, tokens, positions=positions,
                                       cache=cache)
        return logits[:, -1, :], cache
    return decode_step


class DecodeProgram(Program):
    """One model's decode step over static buffers: the params and cache
    it was built on (held, never copied: a replay reads the addresses it
    captured), and its own ``tokens`` and ``positions`` (B, 1) int32 and
    last-position ``logits`` (each allocated by the first step).
    ``carry()`` is every cache tensor (k, v, pos and index of each
    attention run, conv and ssm of each Mamba2 run), so the capture's
    warm-up leaves the cache as it found it.  On the CPU the same body
    runs eagerly.  The model is held weakly: the program lives in the
    per-model cache keyed by that model."""

    bodies = ("step",)

    def __init__(self, model, params, cache):
        leaves = tree_leaves(cache)
        super().__init__(leaves[0].device)
        self._model = weakref.ref(model)
        self.params, self.cache = params, cache
        self._params = tree_leaves(params)
        self._cache = leaves
        self.tokens = self.positions = self.logits = None
        self.lock = threading.Lock()

    def holds(self, params, cache=None) -> bool:
        """Whether ``params`` (and ``cache``) are the very tensors this
        program was built on."""
        return (_same(tree_leaves(params), self._params)
                and (cache is None or _same(tree_leaves(cache), self._cache)))

    def carry(self):
        return self._cache

    def _step(self):
        with torch.no_grad():
            logits, _, _ = self._model().apply(
                self.params, self.tokens, positions=self.positions,
                cache=self.cache)
            if self.logits is None:
                self.logits = torch.empty_like(logits[:, -1, :])
            self.logits.copy_(logits[:, -1, :])

    def step(self, tokens, positions):
        """Copy ``tokens`` (B, 1) and ``positions`` ((B, 1), or one int for
        every row) in and run the step (replay its graph on the card);
        the logits land in ``logits``."""
        if self.tokens is None:
            self.tokens = torch.zeros(tuple(tokens.shape), dtype=torch.int32,
                                      device=self.device)
            self.positions = torch.zeros_like(self.tokens)
        self.tokens.copy_(tokens)
        if isinstance(positions, int):
            self.positions.fill_(positions)
        else:
            self.positions.copy_(positions)
        self("step")


def _same(a: list, b: list) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


# the decode programs of each live model, by cache key: models are frozen
# dataclasses (hashable and weakref-able), so a WeakKeyDictionary keeps them
# without pinning dead models, and a program holds its model weakly
_DECODE_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _cache_key(cache, device=None) -> tuple:
    """The batch, length, dtypes and device of a cache (or of its shapes on
    ``meta``, for ``device``): every leaf's shape and dtype (two
    ``max_len`` that give one ring cache share it)."""
    leaves = tree_leaves(cache)
    return (device or leaves[0].device,) + tuple(
        (tuple(l.shape), l.dtype) for l in leaves)


def decode_program(model, params, cache) -> DecodeProgram:
    """The model's decode program for this cache's key, built anew (a new
    capture on the card) unless the cached one holds these very params
    and cache tensors: a program never replays against other addresses."""
    programs = _DECODE_CACHE.setdefault(model, {})
    key = _cache_key(cache)
    prog = programs.get(key)
    if prog is None or not prog.holds(params, cache):
        prog = programs[key] = DecodeProgram(model, params, cache)
    return prog


def decode_programs(model) -> list:
    """The model's live decode programs, one a cache key (each with its
    ``captures``, ``calls`` and ``capture_s``)."""
    return list(_DECODE_CACHE.get(model, {}).values())


def captured_decode_step(model):
    """The counterpart of the reference's ``jitted_decode_step``: the
    per-model decode step ``(params, cache, tokens, positions) ->
    (last-position logits, cache)``, one captured CUDA graph per model and
    cache key (batch, cache length and dtype, device) that every later
    call replays; other params or cache tensors capture anew.  The cache
    is updated in place, as the reference donates it.  On the CPU the
    step runs eagerly over the same buffers; on the card a failed capture
    raises, with no eager fallback."""
    def decode_step(params, cache, tokens, positions):
        """tokens: (B, 1); positions: (B, 1) absolute positions."""
        prog = decode_program(model, params, cache)
        with prog.lock:
            prog.step(tokens, positions)
            return prog.logits.clone(), cache
    return decode_step


def _reset_cache(cache) -> None:
    """A cache as ``cache_init`` made it, in place."""
    for name, leaf in cache.items():
        if isinstance(leaf, dict):
            _reset_cache(leaf)
        elif name == "pos":
            leaf.fill_(INT32_MAX)
        else:
            leaf.zero_()


@torch.no_grad()
def greedy_generate(model, params, prompt, max_new: int, max_len: int,
                    cache_dtype=torch.bfloat16):
    """Greedy autoregressive loop.  prompt: (B, S) integer ids on the
    params' device; returns (B, max_new) int32 ids.

    The prompt pass runs eagerly, as the reference's does, into the decode
    program's cache (the one kept for this model, batch, ``max_len``,
    dtype and device, reset; or a new one), then each further token is a
    step of that program: a replay of its CUDA graph on the card.  Nothing
    is read back from the device before the end."""
    b, s = prompt.shape
    key = _cache_key(model.cache_init(b, max_len, dtype=cache_dtype,
                                      device="meta"), prompt.device)
    prog = _DECODE_CACHE.setdefault(model, {}).get(key)
    if prog is None or not prog.holds(params):
        prog = decode_program(model, params, model.cache_init(
            b, max_len, dtype=cache_dtype, device=prompt.device))
    with prog.lock:
        _reset_cache(prog.cache)
        logits, _, _ = model.apply(params, prompt, cache=prog.cache)
        tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
        out = [tok]
        for i in range(max_new - 1):
            prog.step(tok, s + i)
            tok = prog.logits.argmax(dim=-1, keepdim=True).to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1)
