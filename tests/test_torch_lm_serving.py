"""The port's serving engine (prefill, decode, greedy generation over the
KV and SSM caches) on the CPU: greedy tokens equal to ``repro``'s for both
LM families in f32, and the three cases of ``tests/test_serving.py``
mirrored on the port with that test's tolerances (2e-5 for prefill then
decode against the full forward, 2e-4 for the sliding-window ring cache
and bulk prefill into it: f32 round-off of other summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_130m as JM
from repro.configs import smollm_135m as JSM
from repro.models.transformer import TransformerLM as JLM
from repro.serving import engine as JE
from repro_torch.configs import mamba2_130m as TM
from repro_torch.configs import smollm_135m as TSM
from repro_torch.interop import lm_params_to_numpy
from repro_torch.models.transformer import ModelConfig, TransformerLM
from repro_torch.serving.engine import (greedy_generate, make_decode_step,
                                        make_prefill_step)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["smollm", "mamba2"])
def test_greedy_generate_matches_repro(name):
    jc, tc = {"smollm": (JSM.SMOKE, TSM.SMOKE),
              "mamba2": (JM.SMOKE, TM.SMOKE)}[name]
    jm = JLM.build(dataclasses.replace(jc, compute_dtype=jnp.float32))
    tm = TransformerLM.build(dataclasses.replace(tc,
                                                 compute_dtype=torch.float32))
    pt = tm.init_params(torch.Generator().manual_seed(0), CPU)
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    prompt = np.random.default_rng(0).integers(0, jc.vocab_size, (2, 16))
    prompt = prompt.astype(np.int32)
    want = JE.greedy_generate(jm, pj, jnp.asarray(prompt), max_new=6,
                              max_len=24, cache_dtype=jnp.float32)
    got = greedy_generate(tm, pt, torch.from_numpy(prompt), max_new=6,
                          max_len=24, cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _model(**kw):
    cfg = ModelConfig(name="t", arch_type="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
                      cut_layer=1, remat=False, compute_dtype=torch.float32,
                      **kw)
    model = TransformerLM.build(cfg)
    return model, model.init_params(torch.Generator().manual_seed(0), CPU)


def _toks(n, s, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 97, (n, s)).astype(np.int32))


def test_prefill_then_decode_matches_full():
    model, params = _model()
    toks = _toks(2, 9)
    full, _, _ = model.apply(params, toks)
    prefill = make_prefill_step(model, max_len=16, cache_dtype=torch.float32)
    logits8, cache = prefill(params, {"tokens": toks[:, :8]})
    torch.testing.assert_close(logits8, full[:, 7], rtol=2e-5, atol=2e-5)
    decode = make_decode_step(model)
    lg, cache = decode(params, cache, toks[:, 8:9],
                       torch.full((2, 1), 8, dtype=torch.int32))
    torch.testing.assert_close(lg, full[:, 8], rtol=2e-5, atol=2e-5)


def test_sliding_window_ring_cache_matches_full_attention_window():
    """Decode through a window-sized ring cache == windowed attention."""
    model, params = _model(sliding_window=4)
    toks = _toks(1, 12)
    full, _, _ = model.apply(params, toks)       # masked sliding attention
    cache = model.cache_init(1, 64, dtype=torch.float32, device=CPU)
    kv = [c["k"] for seg in cache.values() for c in seg.values()]
    assert kv and all(k.shape[2] == 4 for k in kv)   # ring size == window
    decode = make_decode_step(model)
    outs = []
    for t in range(12):
        lg, cache = decode(params, cache, toks[:, t:t + 1],
                           torch.full((1, 1), t, dtype=torch.int32))
        outs.append(lg[:, None])
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-4,
                               atol=2e-4)


def test_bulk_prefill_into_ring_cache_then_decode():
    model, params = _model(sliding_window=4)
    toks = _toks(1, 9)
    full, _, _ = model.apply(params, toks)
    prefill = make_prefill_step(model, max_len=8, cache_dtype=torch.float32)
    logits, cache = prefill(params, {"tokens": toks[:, :8]})
    torch.testing.assert_close(logits, full[:, 7], rtol=2e-4, atol=2e-4)
    decode = make_decode_step(model)
    lg, _ = decode(params, cache, toks[:, 8:9],
                   torch.full((1, 1), 8, dtype=torch.int32))
    torch.testing.assert_close(lg, full[:, 8], rtol=2e-4, atol=2e-4)


def test_mamba_prefill_then_decode_matches_full():
    """Mamba2 SMOKE: prefill (the chunked SSD from a zero state) then
    recurrent decode steps against the cacheless forward (2e-4: the
    recurrence sums in another order than the chunked form)."""
    model = TransformerLM.build(dataclasses.replace(
        TM.SMOKE, compute_dtype=torch.float32))
    params = model.init_params(torch.Generator().manual_seed(0), CPU)
    toks = _toks(2, 19)
    full, _, _ = model.apply(params, toks)
    prefill = make_prefill_step(model, max_len=32, cache_dtype=torch.float32)
    logits, cache = prefill(params, {"tokens": toks[:, :16]})
    torch.testing.assert_close(logits, full[:, 15], rtol=2e-4, atol=2e-4)
    decode = make_decode_step(model)
    for t in range(16, 19):
        lg, cache = decode(params, cache, toks[:, t:t + 1],
                           torch.full((2, 1), t, dtype=torch.int32))
        torch.testing.assert_close(lg, full[:, t], rtol=2e-4, atol=2e-4)
