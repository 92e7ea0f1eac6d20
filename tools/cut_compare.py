"""Time K1, K2, K3 and K4 (``cut_quantize``, ``cut_dequantize``,
``cut_roundtrip`` and ``cut_noise_roundtrip`` of ``csrc/cut_layer.cu``)
against those of an earlier ``cut_layer.cu``, on one card, in one process.

An entry point of the earlier source takes the launch plan (two ints,
``group`` and ``vecs``, before the stream) or not, as its C declaration
says: ``cut_quantize(x, q, scale, rows, d, dtype[, group, vecs], stream)``,
``cut_dequantize(q, scale, out, rows, d, out_dtype[, group, vecs],
stream)``, ``cut_roundtrip(x, out, rows, d, dtype[, group, vecs], stream)``
and ``cut_noise_roundtrip(x, z, w, out, rows, d, dtype[, group, vecs],
stream)``; where it does, it gets this source's plan.  Both run as bare
launches (outputs allocated once) on the same rows: the main path's
250,880 x 160 and the U-Net's widest leaf, 5,898,240 x 64, in f32 and
bf16, and K4 also at one hospital's 50,176 x 160 f32 rows, drawn as
``chip_smoke.py`` phase 3 draws them (K2's levels and scales K1's of those
rows, K4's noise f32, its row weights ones), timed with CUDA events
(``chip_smoke.cuda_ms``: 20 launches) in the order earlier, this, this,
earlier (K2: earlier, this, ``torch.mul(q, s, out=out)``, the same
``torch.mul``, this, earlier), beside the bound.  Their outputs (and
``torch.mul``'s) must be bit-equal to each other and to the plain version.
Then K2 of this source runs on every plan its vector path can take at the
shape (``act_compress.vector_plans``) and on its general path, each
bit-equal to the plain version, timed in turn and again in the reverse
order; so too at every width of ``chip_smoke.VECTOR_D`` and 1024, in f32
and bf16, with the main path's element count (250,880 x 160).  Run from
the root of a checkout, with the earlier source at any path:

    git show <rev>:src/repro_torch/kernels/csrc/cut_layer.cu > old_cut_layer.cu
    python3 tools/cut_compare.py old_cut_layer.cu
"""

import ctypes
import re
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
from repro_torch.kernels.act_compress import ref as R  # noqa: E402
from repro_torch.kernels.cut_fuse import cut_fuse as CF  # noqa: E402
from repro_torch.kernels.cut_fuse import ref as RF  # noqa: E402

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# each entry point's arguments before the plan and the stream
ARGS = {"cut_quantize": [_P, _P, _P, _N, _I, _I],
        "cut_dequantize": [_P, _P, _P, _N, _I, _I],
        "cut_roundtrip": [_P, _P, _N, _I, _I],
        "cut_noise_roundtrip": [_P, _P, _P, _P, _N, _I, _I]}


def takes_plan(text: str, symbol: str) -> bool:
    """Whether the C declaration of ``symbol`` in ``text`` has the plan."""
    params = re.search(rf"int {symbol}\(([^)]*)\)", text).group(1)
    n = params.count(",") + 1
    if n not in (len(ARGS[symbol]) + 1, len(ARGS[symbol]) + 3):
        raise ValueError(f"{symbol} takes {n} arguments")
    return n == len(ARGS[symbol]) + 3


def load_earlier(source: Path, out_dir: str):
    """Build ``source`` with the port's nvcc flags; {symbol: fn(args)} for
    its four entry points, each raising on a failed launch."""
    lib = Path(out_dir) / "libcut_layer_earlier.so"
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(source)],
                   check=True)
    so, text = ctypes.CDLL(str(lib)), source.read_text()
    fns = {}
    for symbol, argtypes in ARGS.items():
        plan = takes_plan(text, symbol)
        fn = getattr(so, symbol)
        fn.argtypes = argtypes + [_I, _I] * plan + [_P]
        fn.restype = _I

        def call(args, fn=fn, plan=plan, symbol=symbol):
            stream = torch.cuda.current_stream().cuda_stream
            rc = fn(*(args if plan else args[:-2]), stream)
            if rc:
                raise RuntimeError(f"earlier {symbol} failed: CUDA error {rc}")
        fns[symbol] = call
    return fns


def compare(key, earlier, this, args, outs, plain, nbytes, t, d, dt,
            library=None):
    """Launch both once, hold their outputs ``outs`` (this one's, then the
    earlier one's, then ``library()``'s if given, each into ``outs``)
    bit-equal to each other and to ``plain()``, then time them; returns
    whether they agreed."""
    this(*args)
    mine = [o.clone() for o in outs]
    earlier(args)
    want = plain()
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(mine, outs, want))
    if library:
        library()
        same = same and all(torch.equal(a, b) for a, b in zip(mine, outs))
    del mine, want
    e0 = C.cuda_ms(lambda: earlier(args))
    n0 = C.cuda_ms(lambda: this(*args))
    lib = [C.cuda_ms(library), C.cuda_ms(library)] if library else []
    n1 = C.cuda_ms(lambda: this(*args))
    e1 = C.cuda_ms(lambda: earlier(args))
    b_ms, _ = C.bound(key, t, d, *nbytes)
    e_ms, n_ms = (e0 + e1) / 2, (n0 + n1) / 2
    plan = args[-2:] if args[-1] else "general"
    lib_ms = (f"; torch.mul {sum(lib) / 2:.4f} ms ({lib[0]:.4f}, "
              f"{lib[1]:.4f}; {200 * b_ms / sum(lib):.1f}%)" if lib else "")
    C.log(f"{key} at {t} x {d} {str(dt)[6:]} (plan {plan}): earlier "
          f"{e_ms:.4f} ms ({e0:.4f}, {e1:.4f}; {100 * b_ms / e_ms:.1f}% of "
          f"the bound), this {n_ms:.4f} ms ({n0:.4f}, {n1:.4f}; "
          f"{100 * b_ms / n_ms:.1f}%), {e_ms / n_ms:.2f}x{lib_ms}; bound "
          f"{b_ms:.4f} ms by bytes; outputs bit-equal to each other and the "
          f"plain version: {same}")
    return same


def k2_plans(args, out, plain, nbytes, t, d, dt):
    """K2 of this source on every vector plan of rows of ``d`` elements of
    ``dt`` and on its general path (``args`` with each plan in place of
    its own), each bit-equal to ``plain()``, timed in turn and then in the
    reverse order; returns whether all agreed."""
    plans = AC.vector_plans(d, dt) + [(1, 0)]
    want, same = plain(), True
    for p in plans:
        out.zero_()
        AC.DEQUANTIZE(*args[:-2], *p)
        same = same and torch.equal(out, want)
    del want
    ms = {p: [C.cuda_ms(lambda p=p: AC.DEQUANTIZE(*args[:-2], *p))]
          for p in plans}
    for p in reversed(plans):
        ms[p].append(C.cuda_ms(lambda p=p: AC.DEQUANTIZE(*args[:-2], *p)))
    b_ms, _ = C.bound("K2", t, d, *nbytes)
    C.log(f"K2 plans at {t} x {d} {str(dt)[6:]} (chosen {tuple(args[-2:])}; "
          f"bound {b_ms:.4f} ms; all bit-equal to the plain version: "
          f"{same}): " + "; ".join(
              f"{'general' if p[1] == 0 else p} {sum(v) / 2:.4f} ms "
              f"({v[0]:.4f}, {v[1]:.4f}; {200 * b_ms / sum(v):.1f}%)"
              for p, v in ms.items()))
    return same


def main(source: Path) -> int:
    if not torch.cuda.is_available():
        print("cut_compare: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    C.log(C.card_line())
    B.build(("cut_layer.cu",))
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        earlier = load_earlier(source, tmp)
        gen = torch.Generator(device=dev).manual_seed(0)
        shapes = [(C.MAIN_ROWS, C.MAIN_D, dt) for dt in (torch.float32,
                                                         torch.bfloat16)]
        shapes += [(C.UNET_ROWS, C.UNET_D, dt) for dt in (torch.float32,
                                                          torch.bfloat16)]
        shapes.append((C.HOSPITAL_ROWS, C.MAIN_D, torch.float32))
        for t, d, dt in shapes:
            x = (torch.randn((t, d), device=dev, generator=gen) * 3).to(dt)
            z = torch.randn((t, d), device=dev, generator=gen) * 0.5
            w = torch.ones((t, 1), device=dev)
            n, e = x.numel(), x.element_size()
            out = torch.empty_like(x)
            if t != C.HOSPITAL_ROWS:
                q = torch.empty((t, d), dtype=torch.int8, device=dev)
                s = torch.empty((t, 1), dtype=torch.float32, device=dev)
                ok &= compare("K1", earlier["cut_quantize"], AC.QUANTIZE,
                              AC.quantize_args(x, q, s), (q, s),
                              lambda: R.quantize_ref(x),
                              (e * n, n + 4 * t), t, d, dt)
                args = AC.dequantize_args(q, s, out)
                k2_bytes = (n + 4 * t, e * n)
                ok &= compare("K2", earlier["cut_dequantize"], AC.DEQUANTIZE,
                              args, (out,),
                              lambda: (R.dequantize_ref(q, s, dt),),
                              k2_bytes, t, d, dt,
                              lambda: torch.mul(q, s, out=out))
                ok &= k2_plans(args, out, lambda: R.dequantize_ref(q, s, dt),
                               k2_bytes, t, d, dt)
                del q, s
                ok &= compare("K3", earlier["cut_roundtrip"], CF.ROUNDTRIP,
                              CF.roundtrip_args(x, out), (out,),
                              lambda: (R.roundtrip_ref(x),), (e * n, e * n),
                              t, d, dt)
            ok &= compare("K4", earlier["cut_noise_roundtrip"],
                          CF.NOISE_ROUNDTRIP,
                          CF.noise_roundtrip_args(x, z, w, out), (out,),
                          lambda: (RF.noise_roundtrip_ref(x, z, w),),
                          ((e + 4) * n + 4 * t, e * n), t, d, dt)
            del x, z, w, out
            torch.cuda.empty_cache()
        # K2's plans at every width the main path hands the link, each at
        # the main path's element count
        for d in C.VECTOR_D + (1024,):
            t = C.MAIN_ROWS * C.MAIN_D // d
            q, s = AC.quantize_rows(torch.randn((t, d), device=dev,
                                                generator=gen) * 3)
            for dt in (torch.float32, torch.bfloat16):
                out = torch.empty((t, d), dtype=dt, device=dev)
                ok &= k2_plans(AC.dequantize_args(q, s, out), out,
                               lambda: R.dequantize_ref(q, s, dt),
                               (q.numel() + 4 * t,
                                out.element_size() * q.numel()), t, d, dt)
                del out
            del q, s
            torch.cuda.empty_cache()
        C.log(C.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
