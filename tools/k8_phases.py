"""Where K8's time goes: ``ssd_chunk_fwd`` timed with its phases switched
off, on one card, in one process.

Copies ``csrc/ssd_scan.cu`` with preprocessor switches around its last
three phases (found by their comments) and builds it four times: whole;
without the state product; without it and M xbar; and without those and
the M^T writes (with its results unused the compiler may drop the C B^T
products too: the staging, the cumsum and the decay vectors remain).  Each build is timed at
Mamba2-130M's scoring shape (``chip_smoke.LM_SSD``, bf16 B/C, phase 3's
draw) in the model's layout and row-major, with CUDA events
(``chip_smoke.cuda_ms``), twice.  With a phase off the outputs are wrong;
only the times mean anything, and a phase's cost is the difference
between neighbouring lines.  Run from the root of a checkout:

    python3 tools/k8_phases.py
"""

import ctypes
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "tools")]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import k8_compare as K  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SS  # noqa: E402

# (switch, the comment that opens the phase, the line that follows it)
PHASES = [
    ("NO_M", "  // M^T[j, i] = S[i, j] exp(cs_i - cs_j)",
     "  cp_async_wait<0>();  // xbar"),
    ("NO_Y", "  // y_intra = M xbar: warp w takes panel w",
     "  // state = (B o dte)^T xbar"),
    ("NO_STATE", "  // state = (B o dte)^T xbar",
     "}\n\ntemplate <typename T>\nint prepare("),
]
BUILDS = [("whole", []), ("no state product", ["NO_STATE"]),
          ("no state product, no M xbar", ["NO_STATE", "NO_Y"]),
          ("no state product, no M xbar, no M writes",
           ["NO_STATE", "NO_Y", "NO_M"])]


def switched_source(out: Path) -> Path:
    src = (B.CSRC / "ssd_scan.cu").read_text()
    for name, start, end in PHASES:
        i = src.index(start)
        j = src.index(end, i + len(start))
        src = (src[:i] + f"#ifndef {name}\n" + src[i:j] + "#endif\n"
               + src[j:])
    path = out / "ssd_scan_phases.cu"
    path.write_text(src)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_phases: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    C.log(C.card_line())
    gen = torch.Generator(device=dev).manual_seed(2)
    b, nc, q, h, p, g, n = C.LM_SSD
    with tempfile.TemporaryDirectory() as tmp:
        source = switched_source(Path(tmp))
        fns = {label: K.load_entry(source, tmp, [f"-D{s}" for s in sw],
                                   str(i))
               for i, (label, sw) in enumerate(BUILDS)}
        for model_layout in (True, False):
            args = C.ssd_inputs(dev, gen, *C.LM_SSD, torch.bfloat16,
                                model_layout=model_layout)
            f32 = dict(dtype=torch.float32, device=dev)
            outs = [torch.empty(s, **f32) for s in
                    ((b, nc, q, h, p), (b, nc, h, n, p), (b, nc, q, h),
                     (b, nc, q, h))]
            dims = SS.kernel_dims(*args)
            cdims = (ctypes.c_longlong * len(dims))(*dims)
            for label, fn in fns.items():
                def run(fn=fn):
                    err = fn(*(t.data_ptr() for t in (*args, *outs)), cdims,
                             B.DTYPE_CODES[torch.bfloat16],
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"ssd_chunk_fwd: cudaError {err}")
                t0, t1 = C.cuda_ms(run), C.cuda_ms(run)
                C.log(f"K8 at {C.LM_SSD} B/C bf16, "
                      f"{'model' if model_layout else 'row-major'} layout, "
                      f"{label}: {(t0 + t1) / 2:.4f} ms ({t0:.4f}, {t1:.4f})")
    C.log(C.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
