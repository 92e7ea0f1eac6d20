"""Time K6 (``dp_scale_accum`` of ``csrc/dp_clip.cu``) against the chunked
K6 of an earlier ``dp_clip.cu``, on one card, in one process.

The chunked design gives one block of 256 threads to each 4096-column chunk
of a leaf, each thread walking its column down the batch.  Its C entry point
is ``dp_scale_accum(table, n_leaves, batch, chunks, chunk, scales, out,
stream)`` and it reads the first four segments of the table that
``leaf_table`` uploads (pointers, lengths, chunk and column prefix sums),
so both kernels run on one table: one hospital's 364 DenseNet-121 leaves,
16 x 6,948,609 f32, drawn as ``chip_smoke.py`` phase 3 draws them.

Both are timed as bare launches into one flat output with CUDA events
(``chip_smoke.cuda_ms``), in the order chunked, this, this, chunked, beside
the GEMV ``s @ g`` and ``scale_accum_leaves`` (this launch and the cut of
its output into 364 views).  The two outputs must be bit-equal.  Run from
the root of a checkout, with the earlier source at any path:

    git show <rev>:src/repro_torch/kernels/csrc/dp_clip.cu > old_dp_clip.cu
    python3 tools/k6_compare.py old_dp_clip.cu
"""

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.configs.paper_models import DENSENET121_PAPER  # noqa: E402
from repro_torch.core.partition import META, cnn_adapter  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels.dp_clip import dp_clip as DC  # noqa: E402
from repro_torch.models.cnn import build_densenet  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def load_chunked(source: Path, out_dir: str):
    """Build ``source`` with the port's nvcc flags; its K6 entry point."""
    lib = Path(out_dir) / "libdp_clip_chunked.so"
    subprocess.run([B._nvcc(), *B.NVCC_FLAGS, "-o", str(lib), str(source)],
                   check=True)
    fn = ctypes.CDLL(str(lib)).dp_scale_accum
    fn.argtypes = [_P, _I, _I, _N, _N, _P, _P, _P]
    fn.restype = _I
    return fn


def main(source: Path) -> int:
    if not torch.cuda.is_available():
        print("k6_compare: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    C.log(C.card_line())
    B.build(("dp_clip.cu",))
    with tempfile.TemporaryDirectory() as tmp:
        chunked = load_chunked(source, tmp)
        gen = torch.Generator(device=dev).manual_seed(0)
        shapes = [tuple(l.shape) for l in tree_leaves(cnn_adapter(
            build_densenet(DENSENET121_PAPER)).init(None, META))]
        leaves = [torch.randn((C.BATCH, math.prod(sh)), device=dev,
                              generator=gen) for sh in shapes]
        s = torch.rand((C.BATCH, 1), device=dev, generator=gen)
        big = torch.cat(leaves, dim=1)
        lt = DC.leaf_table(leaves)
        old = torch.empty((big.shape[1],), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run_chunked():
            rc = chunked(lt.table.data_ptr(), len(leaves), C.BATCH,
                         lt.chunks, DC.CHUNK, s.data_ptr(), old.data_ptr(),
                         stream)
            if rc:
                raise RuntimeError(f"chunked K6 failed: CUDA error {rc}")

        run_chunked()
        new = DC.scale_accum_flat(lt, s)
        torch.cuda.synchronize()
        same = torch.equal(old, new)
        c0 = C.cuda_ms(run_chunked)
        n0 = C.cuda_ms(lambda: DC.scale_accum_flat(lt, s))
        n1 = C.cuda_ms(lambda: DC.scale_accum_flat(lt, s))
        c1 = C.cuda_ms(run_chunked)
        gemv = C.cuda_ms(lambda: s.reshape(1, C.BATCH) @ big)
        views = C.cuda_ms(lambda: DC.scale_accum_leaves(lt, s))
        C.log(f"K6 at {C.BATCH} x {big.shape[1]} f32, {len(leaves)} leaves: "
              f"chunked {(c0 + c1) / 2:.4f} ms ({c0:.4f}, {c1:.4f}); this "
              f"{(n0 + n1) / 2:.4f} ms ({n0:.4f}, {n1:.4f}); GEMV s @ g "
              f"{gemv:.4f} ms; scale_accum_leaves {views:.4f} ms; outputs "
              f"bit-equal: {same}")
        C.log(C.card_line())
    return 0 if same else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
