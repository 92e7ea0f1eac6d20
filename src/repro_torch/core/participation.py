"""Per-round client participation: sampling K of N global hospitals — a
copy of ``repro/core/participation.py`` (pure numpy: the same spec draws
the same hospital ids for every ``(seed, round)``).

Production federations do not train every enrolled hospital every round:
each round samples K participants out of N >> K (fixed-size uniform
sampling) or includes each hospital independently with probability q
(Poisson sampling, the variant the subsampled-Gaussian RDP bound is
stated for).  A frozen ``Participation`` spec makes that a layer:

  * the compiled engine packs each round's SAMPLED hospitals into a
    FIXED ``slots``-wide hospital axis (``engine.pack_participation_run``);
    who participates is per-round data copied into a program's static
    buffers before the round, never a shape change, so one capture of
    each body serves every round of a run and compute scales with K, not
    N;
  * sampling draws come from the spec's OWN ``(seed, round)`` streams:
    they never perturb the data-shuffle rng, and a hospital's batches and
    noise streams depend only on (round, hospital), never on who else was
    sampled (co-sample independence);
  * the RDP accountant composes each round at the amplified rate
    ``q_round * q_batch`` (``Strategy._dp_account(q_scale=...)``);
  * wire accounting only sees sampled clients' transfers
    (``Transport.record_epoch(client_set=...)``).

``Participation(n_global=N, k=N)`` trains exactly as no participation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Participation:
    """Frozen per-round sampling spec.

    Exactly one of:
      * ``k``        — fixed-size: K hospitals uniformly without
                       replacement each round;
      * ``q``        — Poisson: each hospital independently with
                       probability q each round;
      * ``schedule`` — an explicit tuple of per-round hospital-id tuples
                       (replay / tests / external samplers).  Determinism
                       means NO sampling randomness, so schedules get no
                       privacy amplification (``rate`` is 1).

    ``slots`` is the packed hospital-axis width: K for fixed-size; for
    Poisson it defaults to ``n_global`` and, when set smaller, rounds
    that draw more than ``slots`` hospitals keep a uniform ``slots``-
    subset of the draw (documented truncation — the amplified accountant
    rate stays q, an upper bound on the truncated inclusion rate).
    ``seed`` feeds ``(seed, round)`` counter streams, so draws are
    round-addressable and independent of everything else in the run.
    """
    n_global: int
    k: int | None = None
    q: float | None = None
    schedule: tuple = None
    seed: int = 0
    slots: int | None = None

    def __post_init__(self):
        if self.n_global < 1:
            raise ValueError("n_global must be >= 1")
        given = [self.k is not None, self.q is not None,
                 self.schedule is not None]
        if sum(given) != 1:
            raise ValueError("give exactly one of k=, q=, schedule=")
        if self.k is not None and not 1 <= self.k <= self.n_global:
            raise ValueError(f"k must be in [1, {self.n_global}]")
        if self.q is not None and not 0.0 < self.q <= 1.0:
            raise ValueError("q must be in (0, 1]")
        if self.schedule is not None:
            sched = tuple(tuple(sorted(int(i) for i in r))
                          for r in self.schedule)
            for r in sched:
                if any(not 0 <= i < self.n_global for i in r):
                    raise ValueError("schedule ids must be in "
                                     f"[0, {self.n_global})")
                if len(set(r)) != len(r):
                    raise ValueError("schedule rounds must not repeat ids")
            object.__setattr__(self, "schedule", sched)
        if self.slots is not None and self.slots < 1:
            raise ValueError("slots must be >= 1")

    @property
    def kind(self) -> str:
        if self.k is not None:
            return "fixed"
        if self.q is not None:
            return "poisson"
        return "schedule"

    @property
    def n_slots(self) -> int:
        if self.slots is not None:
            return self.slots
        if self.k is not None:
            return self.k
        if self.q is not None:
            return self.n_global
        return max((len(r) for r in self.schedule), default=1) or 1

    @property
    def rate(self) -> float:
        """Per-round inclusion probability for the amplified accountant.
        Deterministic schedules have no sampling randomness: rate 1."""
        if self.k is not None:
            return self.k / self.n_global
        if self.q is not None:
            return self.q
        return 1.0

    def round_ids(self, round_index: int) -> np.ndarray:
        """Sorted global hospital ids sampled for one round."""
        if self.schedule is not None:
            if round_index >= len(self.schedule):
                raise ValueError(
                    f"schedule has {len(self.schedule)} rounds; "
                    f"round {round_index} requested")
            return np.asarray(self.schedule[round_index], np.int64)
        rng = np.random.default_rng([self.seed, round_index])
        if self.k is not None:
            ids = rng.choice(self.n_global, size=self.k, replace=False)
        else:
            ids = np.flatnonzero(rng.random(self.n_global) < self.q)
            if len(ids) > self.n_slots:
                ids = rng.choice(ids, size=self.n_slots, replace=False)
        return np.sort(ids.astype(np.int64))


def as_participation(spec) -> Participation | None:
    """``None`` passes through; a ``Participation`` validates its width."""
    if spec is None or isinstance(spec, Participation):
        return spec
    raise TypeError("participation= must be a Participation or None, "
                    f"got {type(spec).__name__}")


__all__ = ["Participation", "as_participation"]
