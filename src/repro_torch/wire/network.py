"""Network models — what a byte on the wire costs in wall-clock seconds.

A ``NetworkModel`` is a symmetric per-client link to the server: fixed
bandwidth, propagation latency (half the RTT per one-way transfer),
multiplicative log-normal jitter, and a straggler mixture (a fraction of
clients whose effective bandwidth is divided by a slowdown factor —
the "one hospital is on a bad uplink" regime that dominates synchronous
SFLv3/FL rounds).

Scenario presets model the paper's deployment settings:
  * ``lan``          — hospitals co-located with the server (10 Gb/s).
  * ``hospital_wan`` — the realistic multi-site setting (100 Mb/s WAN,
                       30 ms RTT, 1 in 5 sites on a 4x slower link).
  * ``cellular``     — edge/ambulatory clients (20 Mb/s, 60 ms, heavy
                       jitter, 1 in 3 clients 8x slower).

All sampling goes through an explicit ``numpy.random.Generator`` so
simulations are reproducible and straggler ablations can reuse seeds.
A copy of ``repro/wire/network.py`` (pure numpy): the same generator calls
in the same order, so the port's timelines equal the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    name: str
    bandwidth_bps: float          # per-client link, each direction
    rtt_s: float                  # round-trip propagation latency
    jitter: float = 0.0           # sigma of mean-one log-normal noise
    straggler_frac: float = 0.0   # fraction of clients on a slow link
    straggler_slowdown: float = 1.0   # bandwidth divisor for stragglers

    def client_multipliers(self, n_clients: int,
                           rng: np.random.Generator) -> np.ndarray:
        """Per-client transfer-time multipliers, sampled once per run."""
        mult = np.ones(n_clients)
        slow = rng.uniform(size=n_clients) < self.straggler_frac
        mult[slow] = self.straggler_slowdown
        return mult

    def transfer_time(self, nbytes: float, rng: np.random.Generator,
                      mult: float = 1.0) -> float:
        """Seconds for one one-way transfer of ``nbytes`` on this link."""
        t = self.rtt_s / 2 + mult * nbytes * 8.0 / self.bandwidth_bps
        if self.jitter > 0:
            # mean-one log-normal: E[exp(N(-s^2/2, s))] = 1
            t *= rng.lognormal(-self.jitter ** 2 / 2, self.jitter)
        return t

    def without_stragglers(self) -> "NetworkModel":
        return dataclasses.replace(self, straggler_frac=0.0,
                                   straggler_slowdown=1.0,
                                   name=f"{self.name}-nostraggler")


SCENARIOS = {
    "lan": NetworkModel("lan", bandwidth_bps=10e9, rtt_s=0.2e-3,
                        jitter=0.01),
    "hospital_wan": NetworkModel("hospital_wan", bandwidth_bps=100e6,
                                 rtt_s=30e-3, jitter=0.1,
                                 straggler_frac=0.2, straggler_slowdown=4.0),
    "cellular": NetworkModel("cellular", bandwidth_bps=20e6, rtt_s=60e-3,
                             jitter=0.3, straggler_frac=0.33,
                             straggler_slowdown=8.0),
}


def make_network(name) -> NetworkModel:
    if isinstance(name, NetworkModel):
        return name
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown network scenario {name!r} "
                       f"(one of {sorted(SCENARIOS)})") from None
