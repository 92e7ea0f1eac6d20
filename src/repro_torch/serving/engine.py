"""Serving steps: batched prefill and single-token decode with KV/SSM caches
(the port of ``repro/serving/engine.py``).

As in the reference, prefill and the prompt pass of ``greedy_generate`` go
through the cache with no hand kernel; K7 and K8 serve the cacheless
scoring forward (``TransformerLM.apply(..., use_pallas=True)``).  PyTorch
runs eagerly, so there is no per-model compiled decode step here; a CUDA
graph of the decode step is later work.  Caches are updated in place.
"""

from __future__ import annotations

import torch


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


@torch.no_grad()
def greedy_generate(model, params, prompt, max_new: int, max_len: int,
                    cache_dtype=torch.bfloat16):
    """Greedy autoregressive loop.  prompt: (B, S) integer ids on the
    params' device; returns (B, max_new) int32 ids."""
    b, s = prompt.shape
    cache = model.cache_init(b, max_len, dtype=cache_dtype,
                             device=prompt.device)
    logits, cache, _ = model.apply(params, prompt, cache=cache)
    decode = make_decode_step(model)
    tok = logits[:, -1:, :].argmax(dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        pos = torch.full((b, 1), s + i, dtype=torch.int32,
                         device=prompt.device)
        lg, cache = decode(params, cache, tok, pos)
        tok = lg.argmax(dim=-1)[:, None].to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)
