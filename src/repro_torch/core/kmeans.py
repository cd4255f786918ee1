"""Lloyd k-means on the device (DESIGN.md §IVF).

PyTorch port of ``repro/core/kmeans.py::lloyd``, the coarse quantizer's
trainer.  The assignment step is a kNN problem (k = 1 over the centroid
set), so it runs on the repo's own solver (``knn_query``, by default the
fused kernel); re-centring is a per-cluster mean, and an empty cluster
keeps its centroid.  Rows come pre-mapped into the space to cluster in; the
clustering is by squared euclidean distance there.

Training is deterministic on every device: the same rows and start give
the same centroids bit for bit, so a rebuild of one epoch trains the same
cells and codes.  On the card that rules out the obvious primitives, whose
floating-point sums run in an order set by the hardware's timing:
``index_add_`` (atomic adds) and the 1-D ``cumsum`` (a single-pass scan),
both listed by torch as nondeterministic on CUDA.  So a cluster's sum is a
segmented sum over the rows sorted stably by cluster
(``core.segments.group_sums``), which on the CPU is the sequential
``index_add_`` bit for bit; and k-means++'s inverse CDF is a prefix sum in a fixed order
(``_ordered_cumsum``).

The reference draws its start from ``jax.random.permutation``, which torch
cannot replay.  So the start is either given (``init_perm``, e.g. the
reference's own draw, as the parity tests do, which then reproduces the
reference's clustering) or drawn from a ``torch.Generator``.  A drawn start
is the port's own: k-means++ (D^2 sampling, ``kmeanspp_rows``), not a
uniform draw.  On clustered rows a uniform start leaves whole clusters
without a seed, and Lloyd then merges them into shared cells: at the
``query_1m`` shape of ``chip_smoke.py`` (4096 clusters, 4096 cells) that
put 39% of the rows in cells of more than 300 rows, and held residual
IVF-PQ's recall@10 at overfetch 8 to 0.83 against its probe ceiling of
0.93 (``PERF.md``).
"""
from __future__ import annotations

import torch

from repro_torch.core.segments import group_sums

Tensor = torch.Tensor


def lloyd(g: Tensor, k: int, *, iters: int = 10, init_perm: Tensor | None = None,
          generator: torch.Generator | None = None,
          impl: str = "fused") -> tuple[Tensor, Tensor]:
    """Lloyd k-means over pre-mapped rows ``g`` [n, d].

    Returns (centroids [k, d] fp32, assign [n] int32) on ``g``'s device.
    The start is the rows ``init_perm[:k]``; without ``init_perm``, the
    k-means++ rows ``kmeanspp_rows(g, k, generator)`` (a CPU generator).
    Each iteration assigns by 1-NN over the centroids (``knn_query`` with
    ``impl``) and re-centres each cluster on its mean.
    """
    from repro_torch.core.knn import knn_query

    n = g.shape[0]
    assert 1 <= k <= n, (k, n)
    g = g.float()
    if init_perm is None:
        init_perm = kmeanspp_rows(g, k, generator)
    cent = g[torch.as_tensor(init_perm[:k], device=g.device).long()]

    def assign_to(cent):
        return knn_query(g, cent, 1, distance="sqeuclidean", impl=impl).indices[:, 0].long()

    for _ in range(iters):
        a = assign_to(cent)
        sums, cnt = group_sums(g, a, k)
        cnt = cnt.float()
        cent = torch.where(cnt[:, None] > 0, sums / torch.clamp_min(cnt[:, None], 1.0), cent)
    return cent, assign_to(cent).to(torch.int32)


def kmeanspp_rows(g: Tensor, k: int, generator: torch.Generator | None = None) -> Tensor:
    """k row indices of ``g`` [n, d] by D^2 sampling (k-means++): the first
    uniformly, each next one with probability proportional to its squared
    distance to the nearest row drawn so far.

    The uniforms come from ``generator`` (a CPU generator) up front; each
    draw is an inverse-CDF lookup on ``g``'s device, so a start on the card
    never waits on the host.  Distances use ``|x|^2 - 2 x.c + |c|^2``, one
    matrix-vector product a draw, clamped at 0; the CDF is a float64 prefix
    sum in a fixed order (``_ordered_cumsum``).
    """
    n = g.shape[0]
    u = torch.rand(k, generator=generator, dtype=torch.float64)
    sq = (g * g).sum(1)
    rows = torch.empty(k, dtype=torch.long, device=g.device)
    rows[0] = min(int(u[0] * n), n - 1)
    d2 = torch.full((n,), float("inf"), device=g.device)
    for j in range(1, k):
        c = rows[j - 1]
        d2 = torch.minimum(d2, torch.clamp_min(sq - 2.0 * (g @ g[c]) + sq[c], 0.0))
        cdf = _ordered_cumsum(d2.double())
        rows[j] = torch.searchsorted(cdf, (cdf[-1] * float(u[j])).reshape(1)).clamp_(max=n - 1)[0]
    return rows


_SCAN_ROWS = 1024


def _ordered_cumsum(x: Tensor) -> Tensor:
    """Inclusive prefix sum of the 1-D ``x``, summed in an order fixed by its
    length alone, on any device.

    A scan along the last dimension of a 2-D tensor runs each row in a fixed
    order; a 1-D CUDA ``cumsum`` does not.  So ``x`` is laid out as
    ``_SCAN_ROWS`` rows (zero padded), each row scanned, and the row totals,
    scanned as the first of two rows, added to the rows after them.
    """
    n = x.numel()
    width = max(1, -(-n // _SCAN_ROWS))
    buf = x.new_zeros(_SCAN_ROWS * width)
    buf[:n] = x
    rows = buf.view(_SCAN_ROWS, width).cumsum(1)
    totals = x.new_zeros(2, _SCAN_ROWS)
    totals[0] = rows[:, -1]
    base = totals.cumsum(1)[0]
    rows[1:] += base[:-1, None]
    return rows.reshape(-1)[:n]
