"""Oracles the kernels are held against, and the check that holds them.

Each kernel's plain version lives beside its wrapper (``*_plain``).  The
oracles here take raw vectors and a distance name and build on those plain
versions, except ``pairwise_distance_ref``, which takes the per-coordinate
(cumulative) route and so checks the matmul form itself.
"""
from __future__ import annotations

import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import FINALIZERS, finalize_kind, get_distance
from repro_torch.kernels import ops
from repro_torch.kernels.pairwise_distance import pairwise_distance_plain
from repro_torch.kernels.stream_topk import stream_topk_plain


def pairwise_distance_ref(x, y, *, distance: str = "sqeuclidean", chunk=None):
    """O(m n d) reference distance matrix via the cumulative path."""
    return get_distance(distance).pairwise(x, y, chunk=chunk)


def pairwise_distance_mxu_ref(x, y, *, distance: str = "sqeuclidean"):
    """The matmul-form distance matrix (the arithmetic the kernels use)."""
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, distance)
    return pairwise_distance_plain(fx, gy, hx, hy, alpha=alpha,
                                   finalize=finalize_kind(get_distance(distance)))


def stream_topk_ref(x, k: int):
    """Ascending k smallest per row + int32 indices (stable order)."""
    vals, idx = stream_topk_plain(x, k)
    return vals[:, :k], idx[:, :k]


def fused_knn_ref(q, db, k: int, *, distance: str = "sqeuclidean", exclude_self=False):
    """Cumulative distance matrix + top-k, unfused."""
    d = pairwise_distance_ref(q, db, distance=distance)
    if exclude_self:
        eye = torch.eye(d.shape[0], d.shape[1], dtype=torch.bool, device=d.device)
        d = torch.where(eye, T.POS_INF, d)
    return stream_topk_ref(d, k)


def operand_distance(fx, gy, hx, hy, *, alpha: float, finalize: str, gy_scale=None):
    """``dist(rows, cols)``: the distance of each (row, column) pair,
    recomputed from the matmul-form operands one pair at a time (``gy`` of
    any storage type, with its int8 scales ``gy_scale`` [1, n])."""
    def dist(rows, cols):
        t = alpha * (fx[rows] * gy[cols].float()).sum(1)
        if gy_scale is not None:
            t = t * gy_scale[0, cols]
        return FINALIZERS[finalize](t + hx[rows, 0] + hy[0, cols])
    return dist


def _require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_topk(v, i, pv, pi, *, n: int, rtol: float, atol: float, dist=None,
               chunk: int = 4096) -> dict:
    """Hold a top-k result ``(v, i)`` against the plain version's ``(pv, pi)``,
    slot by slot, ties allowed for; raise ``AssertionError`` on a miss.

    Values agree within ``atol + rtol * |pv|``; ``+inf`` slots agree and
    carry id -1; ids lie in ``[0, n)`` and no row repeats one.  Where the
    ids of a slot differ, the result's id must either stand in the plain
    row at a value within tolerance of the one it is reported at (near-equal
    candidates in swapped order), or, if the plain row lacks it (a near-tie
    cut at the k-th place), ``dist(rows, ids)`` (its distance recomputed
    from the operands) must agree with the reported value, and that value
    with the plain row's last finite one.  So right values under wrong ids
    fail.  Returns the max |dv|, the share of equal ids, and the counts of
    swapped and cut ids.
    """
    fin = torch.isfinite(pv)
    _require(torch.equal(fin, torch.isfinite(v)), "+inf slots differ")
    _require(torch.equal(i < 0, ~fin) and torch.equal(pi < 0, ~fin),
             "+inf slots must carry id -1, and only they")
    _require(bool((i < n).all()), f"an id past the {n} columns")
    tol = lambda ref: atol + rtol * ref.abs()  # noqa: E731
    diff = torch.where(fin, (v - pv).abs(), torch.zeros_like(v))
    err = float(diff.max()) if diff.numel() else 0.0
    _require(bool((diff <= tol(pv)).all()), f"values disagree: max |dv| = {err}")
    s = torch.sort(i.long(), dim=1).values
    _require(not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()),
             "a row repeats an id")
    miss = i != pi
    rows = miss.any(1).nonzero().flatten()
    swapped = cut = 0
    for r0 in range(0, rows.numel(), chunk):
        r = rows[r0 : r0 + chunk]
        rv, ri, rpv, rpi, rm = v[r], i[r], pv[r], pi[r], miss[r]
        eq = ri[:, :, None] == rpi[:, None, :]
        found = eq.any(2)
        held_at = torch.where(eq, rpv[:, None, :], torch.zeros_like(rpv[:, None, :])).sum(2)
        in_set = rm & found
        _require(bool(((held_at - rv).abs() <= tol(held_at))[in_set].all()),
                 "an id is reported at another value than the plain version's")
        out = rm & ~found
        if bool(out.any()):
            _require(dist is not None, "an id outside the plain version's set, "
                     "and no distance to check it by")
            rr, cc = out.nonzero(as_tuple=True)
            rep = rv[rr, cc]
            true = dist(r[rr], ri[rr, cc].long())
            _require(bool(((true - rep).abs() <= tol(rep)).all()),
                     "an id outside the plain version's set is not at its own distance")
            last = torch.where(torch.isfinite(rpv), rpv, -T.POS_INF).max(1).values[rr]
            _require(bool(((rep - last).abs() <= tol(last)).all()),
                     "an id outside the plain version's set, away from the k-th value")
        swapped += int(in_set.sum())
        cut += int(out.sum())
    return {"max_abs_err": err, "id_agreement": float((~miss).float().mean()),
            "swapped": swapped, "cut_ties": cut}
