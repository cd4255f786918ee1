"""Lloyd k-means on the device (DESIGN.md §IVF).

PyTorch port of ``repro/core/kmeans.py::lloyd``, the coarse quantizer's
trainer.  The assignment step is a kNN problem (k = 1 over the centroid
set), so it runs on the repo's own solver (``knn_query``, by default the
fused kernel); re-centring is an ``index_add_`` mean, and an empty cluster
keeps its centroid, so a rebuild from the same start gives the same
quantizer.  Rows come pre-mapped into the space to cluster in; the
clustering is by squared euclidean distance there.

The reference draws its start from ``jax.random.permutation``, which torch
cannot replay.  So the start is either given (``init_perm``, e.g. the
reference's own draw, as the parity tests do) or drawn from a
``torch.Generator``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def lloyd(g: Tensor, k: int, *, iters: int = 10, init_perm: Tensor | None = None,
          generator: torch.Generator | None = None,
          impl: str = "fused") -> tuple[Tensor, Tensor]:
    """Lloyd k-means over pre-mapped rows ``g`` [n, d].

    Returns (centroids [k, d] fp32, assign [n] int32) on ``g``'s device.
    The start is the rows ``init_perm[:k]``; without ``init_perm``, a
    ``torch.randperm`` of the rows from ``generator`` (a CPU generator).
    Each iteration assigns by 1-NN over the centroids (``knn_query`` with
    ``impl``) and re-centres each cluster on its mean.
    """
    from repro_torch.core.knn import knn_query

    n = g.shape[0]
    assert 1 <= k <= n, (k, n)
    g = g.float()
    if init_perm is None:
        init_perm = torch.randperm(n, generator=generator)
    cent = g[torch.as_tensor(init_perm[:k], device=g.device).long()]

    def assign_to(cent):
        return knn_query(g, cent, 1, distance="sqeuclidean", impl=impl).indices[:, 0].long()

    ones = torch.ones(n, dtype=torch.float32, device=g.device)
    for _ in range(iters):
        a = assign_to(cent)
        sums = torch.zeros_like(cent).index_add_(0, a, g)
        cnt = torch.zeros(k, dtype=torch.float32, device=g.device).index_add_(0, a, ones)
        cent = torch.where(cnt[:, None] > 0, sums / torch.clamp_min(cnt[:, None], 1.0), cent)
    return cent, assign_to(cent).to(torch.int32)
