"""Deterministic synthetic kNN vectors (numpy only).

The port's own copy of the vector generators of ``repro/data/synthetic.py``:
the same seeds give the same arrays in both packages, so the parity tests
and ``chip_smoke.py`` can feed one dataset to either.
"""
from __future__ import annotations

import numpy as np


def _rng(seed: int, step: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


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
