"""RDP (moments) accountant for the subsampled Gaussian mechanism — a copy
of ``repro/privacy/accountant.py`` (pure Python), so the same ``step``
calls give exactly the same epsilon.

Tracks Renyi-DP at a grid of integer orders and converts to an
(eps, delta) statement.  For Poisson-style subsampling at rate ``q`` with
noise multiplier ``sigma``, the per-step RDP at integer order ``alpha`` is
(Mironov et al. 2019, eq. for the Sampled Gaussian Mechanism):

    RDP(alpha) = log( sum_{k=0..alpha} C(alpha,k) (1-q)^(alpha-k) q^k
                      * exp((k^2 - k) / (2 sigma^2)) ) / (alpha - 1)

computed in log-space.  RDP composes additively across steps — which is
exactly what lets one accountant span FL rounds, SL client turns and
SplitFed epochs: every mechanism application on a hospital's data is one
``step(q, n)`` call, whatever the schedule interleaving looks like
(DESIGN.md §8 records the per-schedule counts).

Guarantees are PER HOSPITAL: hospital i's sampling rate is
``batch_size / n_i`` against its own dataset, so unequal data volumes (the
paper's 3772-vs-880 split) yield unequal epsilons at the same sigma.
"""

from __future__ import annotations

import math


DEFAULT_ORDERS = tuple(range(2, 65)) + (80, 96, 128, 192, 256)


def _log_comb(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1)
            - math.lgamma(n - k + 1))


def rdp_sampled_gaussian(q: float, sigma: float, order: int) -> float:
    """One step's RDP at integer ``order`` for sampling rate ``q``."""
    if order < 2 or order != int(order):
        raise ValueError(f"integer orders >= 2 only, got {order}")
    if sigma <= 0:
        return math.inf
    if q <= 0:
        return 0.0
    if q >= 1.0:
        return order / (2 * sigma * sigma)       # plain Gaussian mechanism
    log_terms = []
    for k in range(order + 1):
        log_terms.append(_log_comb(order, k)
                         + (order - k) * math.log1p(-q)
                         + (k * math.log(q) if k else 0.0)
                         + (k * k - k) / (2 * sigma * sigma))
    m = max(log_terms)
    lse = m + math.log(sum(math.exp(t - m) for t in log_terms))
    return max(lse, 0.0) / (order - 1)


def rdp_to_eps(rdp: dict[int, float], delta: float) -> tuple[float, int]:
    """min over orders of the classic RDP->(eps, delta) conversion."""
    best, best_order = math.inf, 0
    for order, r in rdp.items():
        if not math.isfinite(r):
            continue
        eps = r + math.log(1.0 / delta) / (order - 1)
        if eps < best:
            best, best_order = eps, order
    return best, best_order


class RDPAccountant:
    """Composes subsampled-Gaussian steps; reports (eps, delta)."""

    def __init__(self, noise_multiplier: float, delta: float = 1e-5,
                 orders=DEFAULT_ORDERS):
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.orders = tuple(orders)
        self._rdp = {o: 0.0 for o in self.orders}
        self.steps = 0
        self._cache: dict[float, dict] = {}

    def step(self, q: float, count: int = 1):
        """Record ``count`` mechanism applications at sampling rate ``q``.

        ``q <= 0`` (never sampled) is a no-op: the data never entered the
        mechanism, so no privacy is spent."""
        if count <= 0 or q <= 0:
            return
        if q not in self._cache:
            self._cache[q] = {o: rdp_sampled_gaussian(
                q, self.noise_multiplier, o) for o in self.orders}
        per = self._cache[q]
        for o in self.orders:
            self._rdp[o] += count * per[o]
        self.steps += count

    def epsilon(self) -> tuple[float, int]:
        if self.steps == 0:
            return 0.0, 0
        return rdp_to_eps(self._rdp, self.delta)

    def summary(self) -> dict:
        eps, order = self.epsilon()
        return {"epsilon": eps, "delta": self.delta,
                "noise_multiplier": self.noise_multiplier,
                "steps": self.steps, "opt_order": order}


def epsilon(noise_multiplier: float, q: float, steps: int,
            delta: float = 1e-5) -> float:
    """One-shot (eps at delta) for ``steps`` compositions at rate ``q``."""
    acct = RDPAccountant(noise_multiplier, delta)
    acct.step(q, steps)
    return acct.epsilon()[0]


def epoch_steps(method: str, n_train: list[int], batch_size: int) -> list:
    """Per-hospital (q, steps) for ONE epoch of each training schedule.

    FL local epochs and both SL schedules visit every client batch exactly
    once per epoch (AC vs AM only permutes the interleaving — composition
    is order-invariant).  Batch-synchronous SFLv3/v1 wrap short clients
    around so every client is sampled ``max_b`` times per epoch.
    """
    counts = [max(n // batch_size, 1) for n in n_train]
    qs = [min(batch_size / max(n, 1), 1.0) for n in n_train]
    if method.startswith(("sflv3", "sflv1")):
        steps = [max(counts)] * len(n_train)
    else:                                   # fl / centralized / sl / sflv2
        steps = counts
    return list(zip(qs, steps))
