"""Deterministic synthetic data (numpy only): kNN vectors, LM token streams
and click logs.

The port's own copy of the vector generators, ``host_slice``,
``token_stream``/``lm_batch`` and ``recsys_batch`` of
``repro/data/synthetic.py``: the same seeds give the same arrays in both
packages, bit for bit, so the parity tests and ``chip_smoke.py`` can feed
one dataset to either.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def host_slice(global_batch: int, n_hosts: int, host_id: int) -> slice:
    """The rows of a global batch that host ``host_id`` of ``n_hosts`` reads."""
    per = global_batch // n_hosts
    return slice(host_id * per, (host_id + 1) * per)


def random_vectors(n: int, d: int, seed: int = 0, dtype=np.float32) -> np.ndarray:
    """The paper's Table-1 workload: i.i.d. random vectors."""
    return _rng(seed).standard_normal((n, d), dtype=dtype)


def clustered_vectors(
    n: int, d: int, n_clusters: int = 64, spread: float = 0.15, seed: int = 0
) -> np.ndarray:
    """Recommender-like embeddings: gaussian mixture with tight clusters."""
    g = _rng(seed)
    centers = g.standard_normal((n_clusters, d), dtype=np.float32)
    assign = g.integers(0, n_clusters, n)
    return centers[assign] + spread * g.standard_normal((n, d), dtype=np.float32)


def distribution_vectors(n: int, d: int, seed: int = 0) -> np.ndarray:
    """Row-stochastic positive vectors (for KL / Hellinger distances)."""
    g = _rng(seed)
    x = g.gamma(1.0, 1.0, (n, d)).astype(np.float32) + 1e-6
    return x / x.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# LM token streams.
# ---------------------------------------------------------------------------


def token_stream(batch: int, seq_len: int, vocab: int, seed: int, step: int) -> dict:
    """One [B, S+1] window of a synthetic Zipf-ish token stream.

    Returns dict(tokens [B, S], labels [B, S]) int32, the next-token shift
    applied.  Zipf exponent 1.1 approximates natural-text unigram
    statistics, so the embedding rows read are as hot as real text's.
    """
    g = _rng(seed, step)
    raw = g.zipf(1.1, size=(batch, seq_len + 1)).astype(np.int64)
    toks = np.minimum(raw - 1, vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_batch(batch: int, seq_len: int, vocab: int, seed: int = 0, step: int = 0) -> dict:
    return token_stream(batch, seq_len, vocab, seed, step)


# ---------------------------------------------------------------------------
# Click logs (recsys).
# ---------------------------------------------------------------------------


def recsys_batch(arch: str, batch: int, cfg, seed: int = 0, step: int = 0) -> dict:
    """One training/serving batch for the given recsys architecture.

    Ids are drawn as ``random() ** 2 * size``, so low ids repeat (hot rows).
    Click labels come from a planted logistic model over a few hashed id
    buckets, so CTR losses actually decrease while training (pure-noise
    labels would plateau at ln 2).
    """
    g = _rng(seed, step)

    def planted_labels(ids: np.ndarray) -> np.ndarray:
        w = ((ids.astype(np.int64) * 2654435761) % 97 < 33).astype(np.float32)  # hidden pattern
        # Standardize the field average: its raw std shrinks as 1/sqrt(n_fields),
        # so without this the per-example logit collapses to a constant for wide
        # models and the planted signal is unlearnable noise.  z is ~N(0, 1).
        q = 33.0 / 97.0
        z = (w.mean(axis=1) - q) / np.sqrt(q * (1.0 - q) / ids.shape[1])
        p = 1.0 / (1.0 + np.exp(-1.5 * z))
        return (g.random(len(p)) < p).astype(np.float32)

    if arch == "dlrm-rm2":
        sizes = np.asarray(cfg.sizes())
        sparse = (g.random((batch, cfg.n_sparse)) ** 2 * sizes).astype(np.int32)
        return {
            "dense": g.standard_normal((batch, cfg.n_dense), dtype=np.float32),
            "sparse": sparse,
            "labels": planted_labels(sparse),
        }
    if arch == "xdeepfm":
        sizes = np.asarray(cfg.sizes())
        sparse = (g.random((batch, cfg.n_sparse)) ** 2 * sizes).astype(np.int32)
        return {"sparse": sparse, "labels": planted_labels(sparse)}
    if arch == "bst":
        hist = (g.random((batch, cfg.seq_len - 1)) ** 2 * cfg.n_items).astype(np.int32)
        target = (g.random((batch,)) ** 2 * cfg.n_items).astype(np.int32)
        others = (g.random((batch, cfg.n_other)) * np.asarray(cfg.sizes())).astype(np.int32)
        return {
            "hist": hist,
            "target": target,
            "others": others,
            "labels": planted_labels(np.concatenate([hist, target[:, None]], 1)),
        }
    if arch == "two-tower-retrieval":
        user = (g.random((batch, cfg.n_user_fields)) ** 2
                * np.asarray(cfg.u_sizes())).astype(np.int32)
        item = (g.random((batch, cfg.n_item_fields)) ** 2
                * np.asarray(cfg.i_sizes())).astype(np.int32)
        return {"user": user, "item": item}
    raise KeyError(arch)
