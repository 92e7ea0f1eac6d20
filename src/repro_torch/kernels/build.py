"""Build, load and launch the hand-written CUDA kernels.

The port's counterpart of ``repro/kernels/compat.py``.  Every ``.cu`` file
under ``csrc/`` has a plain C interface; ``nvcc`` compiles each into its own
shared library under ``build/`` (git-ignored) the first time a kernel of it
is launched, and ``ctypes`` loads it.  A library is named by the hash of its
source, the ``nvcc`` flags and the ``nvcc`` version, so a change to any of
them rebuilds it and a stale one is never loaded.

There is no fallback: the wrappers take their plain PyTorch version for a
tensor that lies on the CPU, and for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes of the C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


@functools.cache
def _nvcc_version() -> str:
    return subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def library_path(source: str) -> Path:
    src = CSRC / source
    h = hashlib.sha1(src.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    h.update(_nvcc_version().encode())
    return BUILD / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(sources=None) -> list[Path]:
    """Compile every source not built yet (all of ``csrc/`` by default),
    one ``nvcc`` process per source, all started together."""
    sources = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None \
        else list(sources)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in sources:
        out = library_path(s)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs.append((s, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for s, out, tmp, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            failed.append(f"{s}:\n{log}")
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return [library_path(s) for s in sources]


@functools.cache
def load(source: str) -> ctypes.CDLL:
    path = library_path(source)
    if not path.exists():
        build([source])
    return ctypes.CDLL(str(path))


class CudaKernel:
    """One C entry point of a ``csrc/`` library, with its launch count.

    ``launches`` goes up by one for every launch the kernel accepted, and
    nowhere else; a caller that wants the count of one run sets it to 0
    before the run.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        # every entry point takes the stream last
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(load(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1

    def __repr__(self):
        return f"CudaKernel({self.symbol}, launches={self.launches})"


def check_rows(x: torch.Tensor, dtypes, name: str) -> None:
    """Raise unless ``x`` is what a row kernel takes: a contiguous 2-D CUDA
    tensor of one of ``dtypes`` with at least one column."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {x.dtype} not in {tuple(dtypes)}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{name}: expected (T, D) with D >= 1, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")
