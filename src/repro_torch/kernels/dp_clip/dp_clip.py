"""K5 and K6: DP-SGD's per-example squared norms and scaled batch sum, each
one launch over all the leaves of a hospital's per-example gradients.

Hopper counterparts of ``sqnorms_pallas`` / ``scale_accum_pallas`` (which
the reference launches once per leaf); the CUDA source and its design note
are in ``kernels/csrc/dp_clip.cu``.  A leaf is a contiguous (B, n) f32
matrix, one row per example; ``leaf_table`` checks the leaves and uploads
their table once for both kernels (checking 364 leaves in Python costs
about as much host time as the two launches).  CPU leaves take the plain
versions in ``ref.py``, leaf by leaf; CUDA leaves launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels.dp_clip import ref

_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

SQNORMS = B.CudaKernel("dp_clip.cu", "dp_sqnorms", [_P, _I, _I, _N, _N, _P, _P])
SCALE_ACCUM = B.CudaKernel("dp_clip.cu", "dp_scale_accum",
                           [_P, _I, _I, _N, _P, _P])

CHUNK = 4096     # columns of one leaf that one K5 block takes
GROUP = 4        # adjacent columns one K6 thread takes (one float4 a row)


@dataclasses.dataclass(frozen=True)
class LeafTable:
    """A hospital's per-example gradient leaves, each a contiguous (B, n_l)
    f32 matrix, and, for CUDA leaves, the int64 device table K5 and K6 read
    (``table_values``).  It is checked and uploaded once and serves both
    kernels."""
    leaves: list
    batch: int
    lens: list
    chunks: int                  # K5 blocks per example
    groups: int                  # K6 column groups, all leaves
    table: torch.Tensor | None   # None for CPU leaves (plain versions)


def _prefix(counts):
    out = [0]
    for c in counts:
        out.append(out[-1] + c)
    return out


def table_values(ptrs, lens) -> list:
    """The int64 rows of the device table, for leaves at ``ptrs`` of
    ``lens`` columns: the L pointers, the L lengths, K5's chunk prefix sums
    (L + 1; ceil(n / CHUNK) chunks a leaf), the column prefix sums (L + 1;
    where each leaf's sums start in K6's output) and K6's group prefix sums
    (L + 1; ceil(n / GROUP) groups a leaf)."""
    return (list(ptrs) + list(lens) + _prefix(-(-n // CHUNK) for n in lens)
            + _prefix(lens) + _prefix(-(-n // GROUP) for n in lens))


def leaf_table(leaves) -> LeafTable:
    """Check ``leaves`` and build their table (on the leaves' device)."""
    if not leaves:
        raise ValueError("leaf_table: no leaves")
    b, lens = leaves[0].shape[0], [l.shape[1] for l in leaves]
    chunks = sum(-(-n // CHUNK) for n in lens)
    groups = sum(-(-n // GROUP) for n in lens)
    if B.on_cpu(leaves[0], "leaf_table"):
        return LeafTable(leaves, b, lens, chunks, groups, None)
    dev = leaves[0].device
    for l in leaves:
        B.check_rows(l, (torch.float32,), "leaf_table")
        if l.shape[0] != b or l.device != dev:
            raise ValueError(f"leaf_table: every leaf must be (B={b}, n) on "
                             f"{dev}")
    vals = table_values([l.data_ptr() for l in leaves], lens)
    table = torch.tensor(vals, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    return LeafTable(leaves, b, lens, chunks, groups, table)


def sqnorms_leaves(t: LeafTable):
    """(B,) f32: the sum over every leaf of the per-example sums of
    squares."""
    if t.table is None:
        return sum(ref.sqnorms_ref(l) for l in t.leaves).reshape(-1)
    out = torch.empty((t.batch,), dtype=torch.float32, device=t.table.device)
    if not t.chunks:
        return out.zero_()
    partials = torch.empty((t.batch * t.chunks,), dtype=torch.float64,
                           device=out.device)
    SQNORMS(t.table.data_ptr(), len(t.leaves), t.batch, t.chunks, CHUNK,
            partials.data_ptr(), out.data_ptr())
    return out


def scale_accum_flat(t: LeafTable, scales):
    """scales: (B, 1) f32 -> (sum n_l,) f32, the leaves' ``sum_b scales[b]
    * leaf[b]`` one after another."""
    if t.table is None:
        return torch.cat([ref.scale_accum_ref(l, scales).reshape(-1)
                          for l in t.leaves])
    if (scales.device != t.table.device or scales.dtype != torch.float32
            or scales.numel() != t.batch):
        raise ValueError("scale_accum_flat: scales must be B f32 values "
                         f"on {t.table.device}")
    out = torch.empty((sum(t.lens),), dtype=torch.float32,
                      device=t.table.device)
    if t.groups:
        SCALE_ACCUM(t.table.data_ptr(), len(t.leaves), t.batch, t.groups,
                    scales.contiguous().data_ptr(), out.data_ptr())
    return out


def scale_accum_leaves(t: LeafTable, scales):
    """scales: (B, 1) f32 -> list of (n_l,) f32, each ``sum_b scales[b] *
    leaf[b]``: views of ``scale_accum_flat``'s output (cutting it into 364
    views costs the host more than the kernel takes on the card)."""
    return list(scale_accum_flat(t, scales).split(t.lens))
