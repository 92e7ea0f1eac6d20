"""The port's captured decode step (``serving.engine.captured_decode_step``,
the counterpart of ``repro.serving.engine.jitted_decode_step``) and its
device-side cache index, on the CPU at SMOKE sizes against ``repro``
(params drawn by the port and converted, numpy-seeded prompts, f32):

  * the attention caches' index: after a prefill and k decode steps every
    index is a 0-d int32 tensor equal to the reference's (whose stacked
    runs carry one a layer), advanced once a step, never once a layer; on
    a full cache, a sliding-window ring cache that wraps
    (``sliding_window=4``) and Zamba2's two shared-block caches;
  * ``greedy_generate``'s tokens equal the reference's for SmolLM, Mamba2,
    Zamba2, an MoE kind (Kimi-K2's top-2 with a dense first layer) and a
    frontend kind (InternVL2, text prompts);
  * step-by-step decode through the captured step against the full
    forward, at the reference's ``test_smoke_decode`` bar (atol 2e-4,
    rtol 2e-3);
  * the program cache: one program per model and cache key, a new one
    for other params or another cache, and none left once the model is
    dropped.

On the CPU a program runs its step body eagerly over the same static
buffers its CUDA graph replays on the card.
"""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models.transformer import TransformerLM as JLM
from repro.serving import engine as JE
from repro_torch.interop import lm_params_to_numpy
from repro_torch.models.transformer import ModelConfig as TConfig
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving import engine as E
from repro_torch.tree import tree_map

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _pair(arch, **kw):
    """The reference model and the port's twin (f32 compute) with the same
    params."""
    jc = dataclasses.replace(JR.get(arch).smoke, compute_dtype=jnp.float32,
                             **kw)
    fields = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    fields.update(compute_dtype=torch.float32, param_dtype=torch.float32)
    jm, tm = JLM.build(jc), TransformerLM.build(TConfig(**fields))
    pt = tm.init_params(torch.Generator().manual_seed(0), CPU)
    pj = jax.tree.map(jnp.asarray, lm_params_to_numpy(pt))
    return jm, tm, pj, pt


def _prompt(vocab, b=2, s=8, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _indices(cache, path=()):
    """{path: index leaf} of a cache tree."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(_indices(v, path + (k,)))
        elif k == "index":
            out[path] = v
    return out


@pytest.mark.parametrize("arch, kw, prompt, steps", [
    # three layers: the middle's run stacks two, which share one index
    ("smollm-135m", {"n_layers": 3}, 5, 4),          # a full cache
    ("smollm-135m", {"n_layers": 3, "sliding_window": 4}, 3, 6),  # wraps
    ("smollm-135m", {"n_layers": 3, "sliding_window": 4}, 6, 3),  # bulk
    ("zamba2-7b", {}, 5, 3),                         # two shared caches
], ids=["full", "ring", "ring-bulk", "zamba2-shared"])
def test_cache_index_matches_the_reference(arch, kw, prompt, steps):
    jm, tm, pj, pt = _pair(arch, **kw)
    toks = _prompt(tm.cfg.vocab_size, s=prompt + steps)
    max_len = prompt + steps
    jc = jm.cache_init(2, max_len, jnp.float32)
    tc = tm.cache_init(2, max_len, torch.float32, device=CPU)
    held = {p: t for p, t in _indices(tc).items()}
    assert held and all(t.dim() == 0 and t.dtype == torch.int32
                        for t in held.values())
    if arch == "zamba2-7b":
        assert len(held) == 2          # one per shared-block application
    _, jc, _ = jm.apply(pj, jnp.asarray(toks[:, :prompt]), cache=jc)
    _, tc, _ = tm.apply(pt, torch.from_numpy(toks[:, :prompt]), cache=tc)
    step = E.captured_decode_step(tm)
    for t in range(prompt, prompt + steps + 1):
        want = {p: np.asarray(v) for p, v in _indices(jc).items()}
        got = _indices(tc)
        assert got.keys() == want.keys()
        for p, v in got.items():
            assert v is held[p]        # advanced in place, never replaced
            assert v.shape == () and v.dtype == torch.int32
            # one index a run (the reference's stacked run: one a layer)
            assert (want[p] == int(v)).all(), (p, int(v), want[p])
            if "sliding_window" not in kw:   # once a step, not a layer
                assert int(v) == t
        if t == prompt + steps:
            break
        pos = np.full((2, 1), t, np.int32)
        _, jc, _ = jm.apply(pj, jnp.asarray(toks[:, t:t + 1]),
                            positions=jnp.asarray(pos), cache=jc)
        _, tc = step(pt, tc, torch.from_numpy(toks[:, t:t + 1]),
                     torch.from_numpy(pos))


@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-130m", "zamba2-7b",
                                  "kimi-k2-1t-a32b", "internvl2-76b"])
def test_greedy_generate_matches_repro(arch):
    jm, tm, pj, pt = _pair(arch)
    prompt = _prompt(tm.cfg.vocab_size, s=8, seed=1)
    want = JE.greedy_generate(jm, pj, jnp.asarray(prompt), max_new=6,
                              max_len=16, cache_dtype=jnp.float32)
    got = E.greedy_generate(tm, pt, torch.from_numpy(prompt), max_new=6,
                            max_len=16, cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a second generation steps the same program over its reset cache
    (prog,) = E.decode_programs(tm)
    again = E.greedy_generate(tm, pt, torch.from_numpy(prompt), max_new=6,
                              max_len=16, cache_dtype=torch.float32)
    assert torch.equal(again, got)
    assert E.decode_programs(tm) == [prog]
    assert prog.calls == {"step": 10}


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-7b", "smollm-135m"])
def test_step_by_step_decode_matches_the_full_forward(arch):
    """The reference's ``test_smoke_decode`` on the port, each token a step
    of the captured decode step from an empty cache."""
    _, tm, _, pt = _pair(arch)
    toks = torch.from_numpy(_prompt(tm.cfg.vocab_size, s=8, seed=2))
    full, _, _ = tm.apply(pt, toks)
    cache = tm.cache_init(2, 16, dtype=torch.float32, device=CPU)
    step = E.captured_decode_step(tm)
    outs = []
    for t in range(8):
        lg, cache = step(pt, cache, toks[:, t:t + 1],
                         torch.full((2, 1), t, dtype=torch.int32))
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=2e-3)


def test_one_program_per_model_and_key():
    _, tm, _, pt = _pair("smollm-135m")
    tok = torch.zeros((2, 1), dtype=torch.int32)
    cache = tm.cache_init(2, 16, dtype=torch.float32, device=CPU)
    step = E.captured_decode_step(tm)
    step(pt, cache, tok, tok)
    prog = E.decode_program(tm, pt, cache)
    step(pt, cache, tok, tok + 1)
    assert E.decode_program(tm, pt, cache) is prog
    assert prog.calls == {"step": 2}
    # another cache of the same key, or other params: a new program in
    # the key's place, never a replay against the old tensors
    other = tm.cache_init(2, 16, dtype=torch.float32, device=CPU)
    step(pt, other, tok, tok)
    assert E.decode_program(tm, pt, other) is not prog
    assert len(E.decode_programs(tm)) == 1
    p2 = tree_map(torch.clone, pt)
    step(p2, other, tok, tok)
    assert not E.decode_program(tm, p2, other).holds(pt)
    # another key (batch, length or dtype): a program of its own
    step(pt, tm.cache_init(1, 16, dtype=torch.float32, device=CPU),
         tok[:1], tok[:1])
    step(pt, tm.cache_init(2, 12, dtype=torch.float32, device=CPU), tok, tok)
    step(pt, tm.cache_init(2, 16, dtype=torch.bfloat16, device=CPU), tok,
         tok)
    assert len(E.decode_programs(tm)) == 4
    # the entry goes with the model: a program holds its model weakly
    ref, n = weakref.ref(tm), len(E._DECODE_CACHE)
    del tm, step, prog
    gc.collect()
    assert ref() is None and len(E._DECODE_CACHE) == n - 1
