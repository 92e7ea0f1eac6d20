"""Time K1 (``cut_quantize`` of ``csrc/cut_layer.cu``) against the K1 of an
earlier ``cut_layer.cu``, on one card, in one process.

The earlier K1 is one warp a row, eight rows a block, with the C entry
point ``cut_quantize(x, q, scale, rows, d, dtype, stream)``; this one takes
the plan of ``act_compress.quantize_plan`` as two more arguments.  Both run
as bare launches (outputs allocated once) on the same rows: the main path's
250,880 x 160 and the U-Net's widest leaf, 5,898,240 x 64, in f32 and bf16,
drawn as ``chip_smoke.py`` phase 3 draws them, timed with CUDA events
(``chip_smoke.cuda_ms``: 20 launches) in the order earlier, this, this,
earlier, beside the bound.  Their q and scale must be bit-equal to each
other and to the plain version.  Run from the root of a checkout, with the
earlier source at any path:

    git show <rev>:src/repro_torch/kernels/csrc/cut_layer.cu > old_cut_layer.cu
    python3 tools/k1_compare.py old_cut_layer.cu
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
from repro_torch.kernels.act_compress import act_compress as AC  # noqa: E402

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def load_earlier(source: Path, out_dir: str):
    """Build ``source`` with the port's nvcc flags; its K1 entry point."""
    lib = Path(out_dir) / "libcut_layer_earlier.so"
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(source)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).cut_quantize
    fn.argtypes = [_P, _P, _P, _N, _I, _I, _P]
    fn.restype = _I
    return fn


def main(source: Path) -> int:
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    C.log(C.card_line())
    B.build(("cut_layer.cu",))
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        earlier = load_earlier(source, tmp)
        gen = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for t, d in [(C.MAIN_ROWS, C.MAIN_D), (C.UNET_ROWS, C.UNET_D)]:
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn((t, d), device=dev, generator=gen)
                     * 3).to(dt)
                q_e = torch.empty((t, d), dtype=torch.int8, device=dev)
                s_e = torch.empty((t, 1), dtype=torch.float32, device=dev)
                q, s = torch.empty_like(q_e), torch.empty_like(s_e)
                args = AC.quantize_args(x, q, s)
                args_e = (x.data_ptr(), q_e.data_ptr(), s_e.data_ptr(), t, d,
                          B.DTYPE_CODES[dt], stream)

                def run_earlier():
                    rc = earlier(*args_e)
                    if rc:
                        raise RuntimeError(f"earlier K1 failed: CUDA error "
                                           f"{rc}")

                run_earlier()
                AC.QUANTIZE(*args)
                same = (torch.equal(q, q_e) and torch.equal(s, s_e)
                        and C.k1_equals_plain(x, q, s))
                ok = ok and same
                e0 = C.cuda_ms(run_earlier)
                n0 = C.cuda_ms(lambda: AC.QUANTIZE(*args))
                n1 = C.cuda_ms(lambda: AC.QUANTIZE(*args))
                e1 = C.cuda_ms(run_earlier)
                n = x.numel()
                b_ms, _ = C.bound("K1", t, d, x.element_size() * n, n + 4 * t)
                e_ms, n_ms = (e0 + e1) / 2, (n0 + n1) / 2
                C.log(f"K1 at {t} x {d} {str(dt)[6:]} ({C.k1_path(x)}): "
                      f"earlier {e_ms:.4f} ms ({e0:.4f}, {e1:.4f}; "
                      f"{100 * b_ms / e_ms:.1f}% of the bound), this "
                      f"{n_ms:.4f} ms ({n0:.4f}, {n1:.4f}; "
                      f"{100 * b_ms / n_ms:.1f}%), {e_ms / n_ms:.2f}x; bound "
                      f"{b_ms:.4f} ms by bytes; q and scale bit-equal to "
                      f"each other and the plain version: {same}")
                del x, q_e, s_e, q, s
                torch.cuda.empty_cache()
        C.log(C.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
