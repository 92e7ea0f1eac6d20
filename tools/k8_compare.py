"""Time K8 (``ssd_chunk_fwd`` of ``csrc/ssd_scan.cu``) against the
``ssd_chunk_fwd`` of an earlier ``ssd_scan.cu``, on one card, in one
process.

Both take the same C interface (the earlier one reads the first 26 of the
28 ``dims``), so both run on the same inputs: Mamba2-130M's scoring shape
(``chip_smoke.LM_SSD``: b 4, 16 chunks of 128, 24 heads, p 64, state 128),
drawn as ``chip_smoke.py`` phase 3 draws them: B and C in bf16 in the
model's layout (xbar, B and C with the sequence innermost, as the model's
conv lays them out) and row-major, and in f32 in the model's layout.
Each pair is timed as bare launches with CUDA events (``chip_smoke.cuda_ms``)
in the order earlier, this, this, earlier, and both outputs are held to the
plain version within 3e-4.  Run from the root
of a checkout, with the earlier source at any path:

    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > old_ssd_scan.cu
    python3 tools/k8_compare.py old_ssd_scan.cu
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SR  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan as SS  # noqa: E402

_P = ctypes.c_void_p


def load_entry(source: Path, out_dir: str, flags=(), name="earlier"):
    """Build ``source`` with the port's nvcc flags (and ``flags``); its K8
    entry point."""
    lib = Path(out_dir) / f"libssd_scan_{name}.so"
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, *flags, "-o", str(lib),
                    str(source)], check=True)
    fn = ctypes.CDLL(str(lib)).ssd_chunk_fwd
    fn.argtypes = [_P] * 9 + [ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    return fn


def main(source: Path) -> int:
    if not torch.cuda.is_available():
        print("k8_compare: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    C.log(C.card_line())
    from repro_torch.device import use_full_fp32
    use_full_fp32(dev)
    B.build(["ssd_scan.cu"])
    gen = torch.Generator(device=dev).manual_seed(2)
    with tempfile.TemporaryDirectory() as tmp:
        earlier = load_entry(source, tmp)
        for dt, model_layout in ((torch.bfloat16, True),
                                 (torch.bfloat16, False),
                                 (torch.float32, True)):
            args = C.ssd_inputs(dev, gen, *C.LM_SSD, dt,
                                model_layout=model_layout)
            want = SR.ssd_chunk_ref(*args)
            outs = [torch.empty_like(t) for t in want]
            dims = SS.kernel_dims(*args)
            cdims = (ctypes.c_longlong * len(dims))(*dims)

            def run_earlier():
                err = earlier(*(t.data_ptr() for t in (*args, *outs)), cdims,
                              B.DTYPE_CODES[dt],
                              torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"earlier ssd_chunk_fwd: cudaError {err}")

            def run_this():
                return SS.ssd_chunk(*args)

            run_earlier()
            got = run_this()
            torch.cuda.synchronize()
            ok = [all(torch.allclose(a, w, atol=3e-4, rtol=3e-4)
                      for a, w in zip(o, want)) for o in (outs, got)]
            e0, t0 = C.cuda_ms(run_earlier), C.cuda_ms(run_this)
            t1, e1 = C.cuda_ms(run_this), C.cuda_ms(run_earlier)
            C.log(f"K8 at {C.LM_SSD} B/C {str(dt)[6:]}, "
                  f"{'model' if model_layout else 'row-major'} layout: earlier "
                  f"{(e0 + e1) / 2:.4f} ms ({e0:.4f}, {e1:.4f}); this "
                  f"{(t0 + t1) / 2:.4f} ms ({t0:.4f}, {t1:.4f}); "
                  f"{(e0 + e1) / (t0 + t1):.2f}x; within 3e-4 of the plain "
                  f"version: earlier {ok[0]}, this {ok[1]}")
            if not all(ok):
                return 1
    C.log(C.card_line())
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
