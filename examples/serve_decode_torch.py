"""Serving example on the PyTorch port (the port's
``examples/serve_decode.py``: the same configs and sizes): batched prefill
and greedy autoregressive decode over the KV cache, on the SmolLM-family
SMOKE config, the Mamba2 SSM family (the O(1)-state decode path) and the
Zamba2 hybrid.  Each token after the prompt is one replay of the model's
captured decode step (``serving.engine.captured_decode_step``): the first
generation captures it, the second only replays.  It runs on the CUDA card
unless given ``--device cpu``.

  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
      [--tokens N]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import REGISTRY
from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import decode_programs, greedy_generate


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(arch_id: str, device, batch=4, prompt_len=16, max_new=24):
    cfg = REGISTRY[arch_id].smoke
    model = TransformerLM.build(cfg)
    params = model.init_params(torch.Generator().manual_seed(0), device)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "the CPU")
    secs = []
    for _ in range(2):          # the first captures the step, the second
        _sync(device)           # replays it
        t0 = time.perf_counter()
        out = greedy_generate(model, params, prompt, max_new=max_new,
                              max_len=prompt_len + max_new)
        _sync(device)
        secs.append(time.perf_counter() - t0)
    (prog,) = decode_programs(model)
    rate = batch * max_new / secs[1]
    print(f"[{arch_id}] generated {tuple(out.shape)} tokens in "
          f"{secs[1]:.3f} s ({rate:.1f} new tok/s on {name}; the first "
          f"call {secs[0]:.3f} s; captures {prog.captures}, steps "
          f"{prog.calls['step']})")
    print("  first row:", out[0].tolist())
    return {"tokens": out.cpu(), "seconds": secs, "tok_s": rate,
            "captures": prog.captures, "steps": prog.calls["step"],
            "device": name}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=24,
                    help="new tokens a prompt")
    ap.add_argument("--device", default=None,
                    help="cpu, or the CUDA card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return {
        # dense GQA decode
        "smollm-135m": run("smollm-135m", device, max_new=args.tokens),
        # SSM recurrent decode (O(1) state)
        "mamba2-130m": run("mamba2-130m", device, max_new=args.tokens),
        # hybrid: SSM + shared-attention KV cache
        "zamba2-7b": run("zamba2-7b", device, max_new=args.tokens)}


if __name__ == "__main__":
    main()
