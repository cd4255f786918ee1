"""Public wrappers around the kernels: operand maps, masks, output widths.

PyTorch port of ``repro/kernels/ops.py`` for the three kernels of the exact
kNN path.  Each wrapper maps raw vectors to the matmul form (``fx``, ``gy``,
``hx``, ``hy``, ``alpha``), turns dead database rows into ``hy = +inf``,
and cuts the kernel's ``[m, K]`` output to ``[m, k]``.

Padding: the Pallas kernels need every axis padded to its block; the CUDA
kernels mask ragged rows and columns themselves, so only ``d`` is padded,
with zero coordinates, to the float4 width of the tile loads (zero
coordinates add nothing to ``fx . gy``: the operands are padded after their
maps).  The cumulative per-coordinate kernel (``cumulative=True``) and the
quantized and filtered operands of ``fused_knn`` come with later slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import topk as T
from repro_torch.core.distances import finalize_kind, get_distance
from repro_torch.kernels import fused_knn as _fused
from repro_torch.kernels import pairwise_distance as _pd
from repro_torch.kernels import stream_topk as _st


def _mxu_operands(x, y, distance: str):
    mf = get_distance(distance).matmul_form
    fx = mf.fx(x).float()
    gy = mf.gy(y).float()
    hx = mf.hx(x).float()[:, None].contiguous()
    hy = mf.hy(y).float()[None, :].contiguous()
    pad = (-fx.shape[1]) % 4
    if pad:
        fx, gy = F.pad(fx, (0, pad)), F.pad(gy, (0, pad))
    return fx.contiguous(), gy.contiguous(), hx, hy, mf.alpha


def pairwise_distance(x, y, *, distance: str = "sqeuclidean", cumulative: bool = False):
    """[m, n] distance matrix via the pairwise-distance kernel (phase 1)."""
    if cumulative:
        raise NotImplementedError(
            "the per-coordinate cumulative kernel is not ported yet")
    fx, gy, hx, hy, alpha = _mxu_operands(x, y, distance)
    return _pd.pairwise_distance(fx, gy, hx, hy, alpha=alpha,
                                 finalize=finalize_kind(get_distance(distance)))


def stream_topk(x, k: int, *, threshold_skip: bool | None = None):
    """Ascending k smallest per row of [m, n] + int32 ids (phase 2)."""
    vals, idx = _st.stream_topk(x.float().contiguous(), k, threshold_skip=threshold_skip)
    return vals[:, :k], idx[:, :k]


def fused_knn(q, db, k: int, *, distance: str = "sqeuclidean",
              exclude_self: bool = False, db_valid: int | None = None,
              db_live=None, q_allowed=None, threshold_skip: bool | None = None):
    """kNN of ``q`` against ``db`` with the fused kernel; returns KNNResult.

    ``db_valid``: rows at index >= db_valid score +inf.  ``db_live``: bool
    [n] mask, False rows score +inf (the serving index's tombstones).  Both
    ride the rank-1 ``hy`` term, so the kernel never sees a mask operand.
    """
    from repro_torch.core.knn import KNNResult

    if q_allowed is not None:
        raise NotImplementedError("per-query filters come with the filtered slice")
    if not isinstance(db, torch.Tensor):
        raise NotImplementedError("quantized database replicas come with the two-stage slice")
    n = db.shape[0]
    fx, gy, hx, hy, alpha = _mxu_operands(q, db, distance)
    if db_valid is not None:
        hy = torch.where(torch.arange(n, device=hy.device)[None, :] < db_valid, hy, T.POS_INF)
    if db_live is not None:
        hy = torch.where(db_live[None, :], hy, T.POS_INF)
    vals, idx = _fused.fused_knn(
        fx, gy, hx, hy, k, distance_finalize=finalize_kind(get_distance(distance)),
        alpha=alpha, n_real=n, exclude_self=exclude_self, threshold_skip=threshold_skip)
    return KNNResult(vals[:, :k], idx[:, :k])
