"""Pairwise-mask secure aggregation for FedAvg (Bonawitz et al.,
simulated) — the port's copy of ``repro/privacy/secagg.py``, which is pure
numpy but imports ``jax`` for its tree walks.

Each pair of hospitals (i, j) derives a shared mask from a pairwise seed
(standing in for the X25519 key agreement of the real protocol); client i
ADDS the mask to its update, client j SUBTRACTS it, so the server-side SUM
telescopes to the true aggregate while every individual upload is
uniformly random.

Arithmetic is fixed point modulo 2^32, held in ``int64``/``uint32`` numpy
arrays exactly as in the reference, so mask cancellation is EXACT; the
only loss is the fixed-point quantization of the update itself (<=
2^-frac_bits per element, default 2^-16).  Weighted FedAvg folds the
normalized data-size weight in client-side (weights are public metadata),
keeping the server a pure modular adder.  The masks are drawn from
``np.random.default_rng((seed, round, lo, hi))`` leaf by leaf in the
reference's leaf order (dict keys sorted, as ``jax.tree`` walks them), so
the masked uploads, the aggregate and ``summary()``'s bytes are the
reference's bit for bit.  The protocol runs on the host; the strategy
moves the locals there and the aggregate back (``core.aggregate.
SecAggregator``).

Wire costs: the masked payload is metered as the identity codec ships it
(uint32 ships like f32: secagg hides the update but does not compress it)
plus the pairwise handshake bytes (2 x 32 B keys per client up, the keyset
broadcast down, and one encrypted share per ordered pair relayed through
the server).
"""

from __future__ import annotations

import dataclasses

import numpy as np

KEY_BYTES = 32          # one X25519 public key
SHARE_BYTES = 120       # one encrypted masked-seed share (seed + MAC + iv)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples of arrays,
    dict keys in sorted order (the reference's ``jax.tree`` order, which
    fixes the order the mask streams are drawn in)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


@dataclasses.dataclass
class SecAgg:
    """One aggregation group of ``n_clients`` hospitals."""
    n_clients: int
    seed: int = 0
    frac_bits: int = 16
    bytes_on_wire: float = 0.0
    rounds: int = 0

    def __post_init__(self):
        self._scale = float(2 ** self.frac_bits)

    # -- fixed point ---------------------------------------------------------
    def _quantize(self, tree):
        return _map(lambda x: np.round(np.asarray(x, np.float64)
                                       * self._scale).astype(np.int64)
                    .astype(np.uint32), tree)

    def _dequantize_sum(self, tree):
        """uint32 modular sum -> float (centered signed interpretation)."""
        def deq(x):
            signed = x.astype(np.int64)
            signed = np.where(signed >= 2 ** 31, signed - 2 ** 32, signed)
            return (signed / self._scale).astype(np.float32)
        return _map(deq, tree)

    def _pair_masks(self, i: int, j: int, tree):
        """Shared uint32 mask stream for the unordered pair {i, j}."""
        lo, hi = min(i, j), max(i, j)
        rng = np.random.default_rng((self.seed, self.rounds, lo, hi))
        return _map(lambda x: rng.integers(0, 2 ** 32, size=np.shape(x),
                                           dtype=np.uint32), tree)

    # -- protocol ------------------------------------------------------------
    def mask_update(self, client: int, tree, weight: float):
        """Client-side: fixed-point encode ``weight * tree`` + pair masks."""
        q = self._quantize(_map(lambda x: np.asarray(x, np.float64) * weight,
                                tree))
        for other in range(self.n_clients):
            if other == client:
                continue
            m = self._pair_masks(client, other, tree)
            sign = 1 if client < other else -1
            q = _map(lambda a, b: ((a.astype(np.int64)
                                    + sign * b.astype(np.int64)) % (2 ** 32))
                     .astype(np.uint32), q, m)
        return q

    def aggregate(self, masked_trees):
        """Server-side: modular sum; masks telescope away."""
        total = masked_trees[0]
        for t in masked_trees[1:]:
            total = _map(lambda a, b: ((a.astype(np.int64)
                                        + b.astype(np.int64)) % (2 ** 32))
                         .astype(np.uint32), total, t)
        return self._dequantize_sum(total)

    def aggregate_weighted(self, trees, weights):
        """Full round: mask every client's update, sum, meter the bytes.

        ``weights`` are data sizes; normalization happens client-side so the
        modular sum is directly the weighted mean.
        """
        wsum = float(sum(weights))
        masked = [self.mask_update(i, t, w / wsum)
                  for i, (t, w) in enumerate(zip(trees, weights))]
        self._account(trees[0])
        self.rounds += 1
        return self.aggregate(masked)

    # -- byte metering -------------------------------------------------------
    def handshake_bytes(self) -> int:
        n = self.n_clients
        keys_up = n * 2 * KEY_BYTES
        keys_down = n * (n - 1) * 2 * KEY_BYTES      # keyset broadcast
        shares = n * (n - 1) * 2 * SHARE_BYTES       # relay: up + down legs
        return keys_up + keys_down + shares

    def _account(self, example_tree):
        # the identity codec's bytes of the update as f32
        payload = int(sum(np.size(x) * 4 for x in _leaves(example_tree)))
        self.bytes_on_wire += (self.n_clients * payload
                               + self.handshake_bytes())

    def summary(self) -> dict:
        return {"n_clients": self.n_clients, "rounds": self.rounds,
                "bytes_on_wire": self.bytes_on_wire,
                "handshake_bytes_per_round": self.handshake_bytes(),
                "frac_bits": self.frac_bits}
