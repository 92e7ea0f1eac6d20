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

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
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
    before the run.  A CUDA graph replays its launches without calling
    the wrapper: the compiled engine (``core/strategies/engine.py``) takes
    back the counts its capture added (a capture records, it does not
    launch) and adds each graph's launches at every replay.
    """

    #: every entry point of the port, in the order they were declared
    instances: list = []

    def __init__(self, source: str, symbol: str, argtypes):
        CudaKernel.instances.append(self)
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


class GraphTables:
    """The device tables (``upload_int64``) of one captured CUDA graph.

    A table holds host data (device pointers of the step's own tensors),
    so the graph cannot write it: it is copied in once, after the capture.
    Nor can it live in the graph's memory pool, which hands the memory of
    a tensor freed earlier in the capture to a later one, so that every
    replay would overwrite the table with the step's intermediates.  So
    the warm-up run of the step records the size of every table it
    uploads, ``reserve`` allocates them outside the pool before the
    capture, the capture takes them in the same order, and ``fill``
    writes the values the capture computed.  Use it as a context around
    the warm-up and around the capture; keep it as long as the graph.
    """

    def __init__(self):
        self.sizes: list = []
        self.tables: list = []
        self.values: list = []

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def reserve(self, device) -> None:
        self.tables = [torch.empty((n,), dtype=torch.int64, device=device)
                       for n in self.sizes]

    def take(self, values) -> torch.Tensor:
        i = len(self.values)
        if i >= len(self.tables) or self.tables[i].numel() != len(values):
            raise RuntimeError(
                "upload_int64 during a CUDA graph capture: the warm-up run "
                "did not upload a table of this size at this point")
        self.values.append(list(values))
        return self.tables[i]

    def fill(self) -> None:
        for t, v in zip(self.tables, self.values):
            t.copy_(torch.tensor(v, dtype=torch.int64))


# the GraphTables of the capture (or warm-up) in progress, innermost last
_ACTIVE: list = []


def upload_int64(values, device) -> torch.Tensor:
    """``values`` (Python ints) -> an int64 tensor on ``device``: one
    pinned host-to-device copy, or, during a CUDA graph capture, the next
    table of the active ``GraphTables`` (a capture without one raises: a
    host copy recorded in a graph would read a host buffer the allocator
    reuses after the capture)."""
    active = _ACTIVE[-1] if _ACTIVE else None
    if torch.cuda.is_current_stream_capturing():
        if active is None:
            raise RuntimeError("upload_int64 during a CUDA graph capture "
                               "needs a GraphTables (see its docstring)")
        return active.take(values)
    if active is not None:
        active.sizes.append(len(values))
    return torch.tensor(values, dtype=torch.int64).pin_memory().to(
        device, non_blocking=True)


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


_SHAPES = threading.local()


@contextlib.contextmanager
def shapes_only():
    """Inside, a ``meta`` tensor takes a wrapper's plain version, which on
    ``meta`` computes the output's shape alone and launches nothing: the
    dry run's mode (``launch.dryrun``).  Outside, ``meta`` raises as any
    device without a kernel does."""
    prev = getattr(_SHAPES, "on", False)
    _SHAPES.on = True
    try:
        yield
    finally:
        _SHAPES.on = prev


def on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises, ``meta`` but under
    ``shapes_only``."""
    if x.device.type == "cpu" or (x.device.type == "meta"
                                  and getattr(_SHAPES, "on", False)):
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {x.device}")
