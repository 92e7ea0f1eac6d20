"""Synthetic stand-ins for the paper's data (see DESIGN.md §1 — data gate).

``make_cxr_clients`` emits a 5-hospital non-IID binary-classification task
mimicking the paper's TB chest-X-ray setup: positives carry bright nodular
blobs on a smooth background; each client has its own scanner-like domain
shift (contrast, noise floor, blob intensity, spatial prior).  Prevalence is
50% in train and 10% in val/test, matching §3.1 of the paper.

The port keeps its own copy of the reference's generator (``repro/data/
synthetic.py``), and of its LM token streams: the same seed gives
byte-identical numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ClientData:
    name: str
    train: dict      # {"image": (N,H,W,1) f32, "label": (N,) f32, "mask": (N,H,W,1)}
    val: dict
    test: dict


def _smooth_noise(rng, n, size, sigma):
    low = rng.normal(0, 1, (n, size // 8, size // 8)).astype(np.float32)
    img = np.kron(low, np.ones((8, 8), np.float32))       # cheap upsample
    img += rng.normal(0, sigma, (n, size, size)).astype(np.float32)
    return img


def _add_blobs(rng, img, mask, intensity, center_bias, n_blobs=(1, 4)):
    n, size, _ = img.shape
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for i in range(n):
        k = rng.integers(n_blobs[0], n_blobs[1] + 1)
        for _ in range(k):
            cx = np.clip(rng.normal(center_bias[0], 0.2), 0.1, 0.9) * size
            cy = np.clip(rng.normal(center_bias[1], 0.2), 0.1, 0.9) * size
            r = rng.uniform(size * 0.08, size * 0.18)
            blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * r * r)))
            img[i] += intensity * blob
            mask[i] |= blob > 0.4
    return img, mask


def _make_split(rng, n, size, prevalence, shift):
    labels = (rng.uniform(0, 1, n) < prevalence).astype(np.float32)
    img = _smooth_noise(rng, n, size, shift["noise"])
    mask = np.zeros((n, size, size), bool)
    pos = labels > 0.5
    if pos.any():
        img[pos], mask[pos] = _add_blobs(
            rng, img[pos], mask[pos], shift["intensity"], shift["center"])
    img = shift["gain"] * img + shift["offset"]
    img = np.tanh(img).astype(np.float32)
    return {"image": img[..., None], "label": labels,
            "mask": mask[..., None].astype(np.float32)}


def make_cxr_clients(seed=0, n_clients=5, train_per_client=120,
                     val_per_client=60, test_per_client=60, image_size=64,
                     size_skew=None, label_skew_alpha=None):
    """``train_per_client`` may be an int or a per-client list (the paper's
    hospitals have very different data volumes — 3772 vs 880).

    Two cross-device-realism knobs (both OFF by default — the defaults
    stay byte-identical because each knob draws from its OWN seeded
    stream, never the shared shift rng):

    * ``size_skew``: a positive float — per-client train sizes are drawn
      log-normal around ``train_per_client`` with sigma ``size_skew``
      (min 2 samples), mimicking the heavy-tailed hospital volumes of a
      real federation.  Ignored when ``train_per_client`` is a list.
    * ``label_skew_alpha``: Dirichlet/Beta concentration — each client's
      TRAIN prevalence is drawn ``Beta(alpha, alpha)`` instead of the
      paper's uniform 50% (small alpha => clients specialize toward
      mostly-positive or mostly-negative label pools).  Val/test keep the
      paper's 10% prevalence.
    """
    rng = np.random.default_rng(seed)
    sizes = None
    if size_skew is not None and not isinstance(train_per_client,
                                                (list, tuple)):
        if size_skew <= 0:
            raise ValueError("size_skew must be positive")
        size_rng = np.random.default_rng([seed, 1011])
        sizes = np.maximum(2, np.round(
            train_per_client
            * np.exp(size_rng.normal(0.0, size_skew, n_clients))
        ).astype(int))
    prevs = None
    if label_skew_alpha is not None:
        if label_skew_alpha <= 0:
            raise ValueError("label_skew_alpha must be positive")
        label_rng = np.random.default_rng([seed, 2022])
        prevs = label_rng.beta(label_skew_alpha, label_skew_alpha,
                               n_clients)
    clients = []
    for c in range(n_clients):
        # strong non-IID scanner shift: even hospitals see BRIGHT lesions,
        # odd hospitals see DARK ones, on different backgrounds — a shared
        # (server) segment trained sequentially must not forget either mode
        polarity = 1.0 if c % 2 == 0 else -1.0
        shift = {
            "noise": rng.uniform(0.08, 0.3),
            "gain": rng.uniform(0.5, 1.5),
            "offset": rng.uniform(-0.4, 0.4),
            "intensity": polarity * rng.uniform(2.0, 3.5),
            "center": (rng.uniform(0.25, 0.75), rng.uniform(0.25, 0.75)),
        }
        n_tr = (train_per_client[c] if isinstance(train_per_client,
                                                  (list, tuple))
                else train_per_client)
        if sizes is not None:
            n_tr = int(sizes[c])
        tr_prev = 0.5 if prevs is None else float(prevs[c])
        clients.append(ClientData(
            name=f"DT{c + 1}",
            train=_make_split(rng, n_tr, image_size, tr_prev, shift),
            val=_make_split(rng, val_per_client, image_size, 0.1, shift),
            test=_make_split(rng, test_per_client, image_size, 0.1, shift)))
    return clients


def pooled(clients, split):
    """Centralized pooling of all client splits."""
    keys = getattr(clients[0], split).keys()
    return {k: np.concatenate([getattr(c, split)[k] for c in clients])
            for k in keys}


def batches(data, batch_size, rng=None, drop_remainder=True):
    n = len(data["label"])
    idx = np.arange(n)
    if rng is not None:
        rng.shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, stop, batch_size):
        sel = idx[s:s + batch_size]
        yield {k: v[sel] for k, v in data.items()}


# ---------------------------------------------------------------------------
# token streams for the LM architectures
# ---------------------------------------------------------------------------

def token_stream(seed, vocab, n_seqs, seq_len, order=1):
    """Markov token source — learnable structure for tiny-LM e2e runs."""
    rng = np.random.default_rng(seed)
    v_eff = min(vocab, 256)
    trans = rng.dirichlet(np.full(v_eff, 0.1), size=v_eff).astype(np.float32)
    cum = np.cumsum(trans, axis=1)
    toks = np.zeros((n_seqs, seq_len), np.int32)
    state = rng.integers(0, v_eff, n_seqs)
    for t in range(seq_len):
        u = rng.uniform(0, 1, n_seqs).astype(np.float32)
        state = (cum[state] < u[:, None]).sum(axis=1).clip(0, v_eff - 1)
        toks[:, t] = state
    return toks


def lm_clients(seed, vocab, n_clients, seqs_per_client, seq_len):
    """Per-client token sources with different Markov chains (non-IID)."""
    return [token_stream(seed + 17 * c, vocab, seqs_per_client, seq_len)
            for c in range(n_clients)]
