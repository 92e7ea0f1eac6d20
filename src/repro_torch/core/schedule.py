"""Client interleaving schedules for split learning (paper §3.4) — a copy
of ``repro/core/schedule.py``.

* ``alternate_client`` (AC): each client trains on its ENTIRE local data,
  clients taken in order — long single-client runs on the shared server
  segment (the cause of catastrophic forgetting the paper discusses).
* ``alternate_minibatch`` (AM, the paper's proposal): clients take turns at
  MINI-BATCH granularity; a client that runs out of batches drops out while
  the rest continue — the server segment sees an interleaved stream.
"""

from __future__ import annotations

import numpy as np


def alternate_client(n_batches: list[int]) -> list[tuple[int, int]]:
    order = []
    for c, nb in enumerate(n_batches):
        order.extend((c, b) for b in range(nb))
    return order


def alternate_minibatch(n_batches: list[int]) -> list[tuple[int, int]]:
    order = []
    for b in range(max(n_batches, default=0)):
        for c, nb in enumerate(n_batches):
            if b < nb:
                order.append((c, b))
    return order


SCHEDULES = {"ac": alternate_client, "am": alternate_minibatch}


def schedule_array(name: str, n_batches: list[int]):
    """Schedule as a dense ``[steps, 2]`` int32 array of (client, batch)."""
    rows = SCHEDULES[name](list(n_batches))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)
