"""Hospital-axis device placement, pad-to-devices — the port of
``repro/core/placement.py``.

The paper's comparison (FL vs SL vs SplitFed on per-hospital cohorts) is
parallel over hospitals, and every compiled program of
``core/strategies/engine.py`` carries a hospital-leading axis: the packed
``[C, NB, B, ...]`` batch stacks, the stacked client params and optimizer
state, the step table's rows.  ``Placement`` makes that axis a split
dimension:

  * **devices** — a tuple of ``torch.device``s, one per chunk.  A device
    may repeat (``[cuda:0] * 4``: virtual devices, the port's counterpart
    of the reference's ``--xla_force_host_platform_device_count``), so a
    chunk is named by its INDEX, never by its device.  Fewer than two
    entries disable the placement: every op is then the identity.
  * **pad-to-devices** — ``n_clients`` is padded UP to the next multiple
    of the device count with *phantom hospitals*: zero-sample hospitals
    whose batch rows are zeros, whose masks are all invalid and whose
    FedAvg, server-gradient and client-sync weights are exactly zero
    (``client_weights``).  So any hospital count runs on any device count,
    with the results of the unplaced run (``core/strategies/placed.py``).
  * **chunks** — hospital ``h`` of ``c_pad`` lives on
    ``devices[h // (c_pad // d)]``: contiguous chunks, the reference's 1-D
    ``("hosp",)`` split.  Each chunk's hospitals train on its device in
    its own captured programs; the cross-hospital reductions gather onto
    the first device in hospital order.
  * **specs** — ``sharding``, ``tree_shardings`` and ``leaf_specs``
    describe the split through the launch layer's rule table
    (``launch/mesh.py``, the logical axis ``"clients"``), so the same rule
    places the axis on the production ``("pod", "data", "model")`` meshes,
    where ``"clients"`` maps to the data axis.

Strategies hold one ``Placement`` (``Strategy.__init__``, from
``make_strategy(..., shard=True)``); ``engine.pack_epoch``/``pack_run``
take ``pad_clients=placement.n_pad``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

HOSP_AXIS = "hosp"


class HospMesh:
    """The 1-D ``("hosp",)`` mesh the rule table reads: its axis names and
    a device array of the chunks' devices."""

    axis_names = (HOSP_AXIS,)

    def __init__(self, devices):
        self.devices = np.empty((len(devices),), dtype=object)
        self.devices[:] = list(devices)


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One device's hospitals: chunk ``index`` of the placement, its
    ``device`` and its global hospital ids ``ids`` (real and phantom)."""
    index: int
    device: torch.device
    ids: tuple

    @property
    def size(self) -> int:
        return len(self.ids)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Device placement of the hospital axis.

    ``n_clients`` is the REAL hospital count; ``c_pad >= n_clients`` the
    layout count (a multiple of the device count): rows past ``n_clients``
    are phantom hospitals.  ``devices`` is the chunks' device tuple, or
    None when placement is disabled (one device, shard off), in which case
    only the padding contract applies (one chunk on the caller's device).
    """
    n_clients: int
    c_pad: int
    devices: tuple | None = None

    @classmethod
    def make(cls, n_clients: int, enabled: bool = True,
             devices=None) -> "Placement":
        """The placement of ``n_clients`` hospitals on ``devices`` (None:
        every visible CUDA device).  Disabled, one-device and zero-client
        placements are total no-ops: no devices, no padding."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = tuple(torch.device(d) for d in devices)
        if not enabled or n_clients <= 0 or len(devices) < 2:
            return cls(n_clients, max(n_clients, 0), None)
        d = len(devices)
        return cls(n_clients, -(-n_clients // d) * d, devices)

    # -- predicates ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        """Devices exist: the hospital axis is split over them."""
        return self.devices is not None

    @property
    def padded(self) -> bool:
        return self.c_pad > self.n_clients

    @property
    def n_pad(self) -> int:
        """Phantom hospital count appended by ``engine.pack_epoch``."""
        return self.c_pad - self.n_clients

    @property
    def mesh(self) -> HospMesh | None:
        return HospMesh(self.devices) if self.enabled else None

    # -- phantom-hospital masking -------------------------------------------
    def client_weights(self) -> np.ndarray:
        """``[c_pad]`` float32: 1 for real hospitals, 0 for phantoms: the
        weights that make FedAvg, the SFLv3 server-gradient mean and the
        SFLv2/v1 client syncs ignore the padding rows."""
        w = np.zeros((self.c_pad,), np.float32)
        w[:self.n_clients] = 1.0
        return w

    # -- chunks --------------------------------------------------------------
    def chunks(self, device: torch.device) -> list[Chunk]:
        """The hospital chunks, one per device in order; a disabled
        placement is one chunk of all ``c_pad`` hospitals on ``device``."""
        if not self.enabled:
            return [Chunk(0, torch.device(device), tuple(range(self.c_pad)))]
        size = self.c_pad // len(self.devices)
        return [Chunk(k, dev, tuple(range(k * size, (k + 1) * size)))
                for k, dev in enumerate(self.devices)]

    def device_of(self, hospital: int) -> torch.device | None:
        """The device hospital ``hospital`` of ``c_pad`` lives on (None
        when disabled)."""
        if not self.enabled:
            return None
        return self.devices[hospital // (self.c_pad // len(self.devices))]

    # -- shardings (built through the launch-layer rule table) ---------------
    def sharding(self, shape: tuple, axis: int = 0):
        """A ``launch.mesh.Sharding`` splitting ``shape``'s ``axis`` over
        the hospital mesh, via ``spec_for`` (divisibility and axis-reuse
        rules)."""
        from repro_torch.launch.mesh import Sharding, spec_for
        axes = tuple("clients" if i == axis else None
                     for i in range(len(shape)))
        return Sharding(self.mesh, spec_for(axes, shape, self.mesh))

    def tree_shardings(self, tree, axis: int = 0):
        """A ``Sharding`` tree for a stacked-client tree (every leaf
        carries the hospital axis at ``axis``) via
        ``launch.mesh.tree_shardings``."""
        from repro_torch.launch.mesh import tree_shardings
        from repro_torch.tree import tree_map
        axes = tree_map(lambda l: tuple("clients" if i == axis else None
                                        for i in range(l.ndim)), tree)
        return tree_shardings(axes, tree, self.mesh)

    def leaf_specs(self, tree, axis: int = 0):
        """Per-leaf spec tree: leaves carrying the hospital axis at
        ``axis`` are split on "hosp", the rest (0-d optimizer counts,
        server-shaped leaves) replicated."""
        from repro_torch.tree import tree_map

        def one(l):
            if getattr(l, "ndim", 0) > axis and l.shape[axis] == self.c_pad:
                return (None,) * axis + (HOSP_AXIS,)
            return ()
        return tree_map(one, tree)

    # -- placement ops -------------------------------------------------------
    def put(self, tree, axis: int = 0):
        """Split every leaf whose ``shape[axis] == c_pad`` into its chunks,
        chunk ``k`` moved to ``devices[k]`` (a list of tensors, one per
        chunk); other leaves (server params, scalars) are left alone.
        Identity when disabled."""
        if not self.enabled:
            return tree
        from repro_torch.tree import tree_map
        size = self.c_pad // len(self.devices)

        def one(x):
            if getattr(x, "ndim", 0) > axis and x.shape[axis] == self.c_pad:
                x = torch.as_tensor(x)
                return [x.narrow(axis, k * size, size).to(dev)
                        for k, dev in enumerate(self.devices)]
            return x
        return tree_map(one, tree)

    def pad_tree(self, tree, mode: str = "edge"):
        """Pad the leading hospital axis of every leaf (tensors or numpy
        arrays) from ``n_clients`` to ``c_pad`` rows.  ``mode="edge"``
        repeats the last real row (finite phantom params keep every model
        forward well defined); ``mode="zeros"`` appends zero rows.
        Identity when not padded."""
        if not self.padded:
            return tree
        from repro_torch.tree import tree_map
        pad = self.n_pad

        def one(x):
            if getattr(x, "ndim", 0) < 1 or x.shape[0] != self.n_clients:
                return x
            if isinstance(x, torch.Tensor):
                tail = (x[-1:].expand(pad, *x.shape[1:]) if mode == "edge"
                        else x.new_zeros((pad, *x.shape[1:])))
                return torch.cat([x, tail])
            x = np.asarray(x)
            tail = (np.broadcast_to(x[-1:], (pad, *x.shape[1:]))
                    if mode == "edge" else np.zeros((pad, *x.shape[1:]),
                                                    x.dtype))
            return np.concatenate([x, tail], axis=0)
        return tree_map(one, tree)

    def pad_rows(self, x: np.ndarray, axis: int = 0) -> np.ndarray:
        """Zero-pad a host ``[..., n_clients, ...]`` array (the hospital
        axis at ``axis``) to ``c_pad`` rows."""
        if not self.padded or x.shape[axis] != self.n_clients:
            return x
        shape = list(x.shape)
        shape[axis] = self.n_pad
        return np.concatenate([x, np.zeros(shape, x.dtype)], axis=axis)


__all__ = ["Placement", "Chunk", "HospMesh", "HOSP_AXIS"]
