"""Single-device k-nearest-vector solver (paper Sect. 4-6).

PyTorch port of ``repro/core/knn.py::knn_query`` / ``knn_allpairs``.

* Phase 1 (Sect. 5): distances tile by tile, in matmul form.
* Phase 2 (Sect. 6): each row's k smallest kept in a running sorted buffer,
  with the heap-top filter (``core.topk``).
* Symmetric delta (Sect. 4): only upper-triangle tiles are computed; each
  tile updates the buffers of its rows and, transposed, of its columns.

``impl`` selects the substrate: ``"torch"`` (plain tensor tiles, the
reference's ``"jnp"``), ``"kernel"`` (the pairwise-distance kernel per tile
plus the plain selection, the reference's ``"pallas"``) and ``"fused"`` (the
fused distance + selection kernel, the default, so that the card runs the
kernel unless the caller asks otherwise).  The reference's ``lax.scan`` and
``fori_loop`` over tiles are Python loops here.

The functions take tensors and run where they lie: CUDA tensors launch the
kernels, CPU tensors run the kernels' plain versions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import Distance, get_distance, is_symmetric, matmul_finalize
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor

IMPLS = ("torch", "kernel", "fused")


class KNNResult(NamedTuple):
    distances: Tensor  # [m, k] ascending
    indices: Tensor  # [m, k] int32, -1 for padding (k > n_valid)


def pairwise_tile(x_tile: Tensor, y_tile: Tensor, dist: Distance, *,
                  use_matmul: bool = True, chunk: int | None = None) -> Tensor:
    """One [m_tile, n_tile] distance tile, fp32 accumulate."""
    if use_matmul and dist.matmul_form is not None:
        return dist.matmul_form.pairwise(x_tile, y_tile, matmul_finalize(dist))
    return dist.pairwise(x_tile, y_tile, chunk)


def _pad_rows(x: Tensor, mult: int) -> Tensor:
    pad = (-x.shape[0]) % mult
    if pad:
        x = torch.cat([x, x.new_zeros((pad, x.shape[1]))], dim=0)
    return x


def _mask_tile(tile, row_off, col_off, n_rows, n_cols, exclude_diag):
    m, nn = tile.shape
    col_ids = col_off + torch.arange(nn, device=tile.device)
    tile = torch.where(col_ids[None, :] >= n_cols, T.POS_INF, tile)
    if exclude_diag:
        row_ids = row_off + torch.arange(m, device=tile.device)
        tile = torch.where(row_ids[:, None] == col_ids[None, :], T.POS_INF, tile)
    return tile


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


def _tile_fn(impl: str, distance: str):
    dist = get_distance(distance)
    if impl == "kernel":
        return lambda a, b: kops.pairwise_distance(a, b, distance=distance)
    return lambda a, b: pairwise_tile(a, b, dist)


def knn_query(queries: Tensor, database: Tensor, k: int, *,
              distance: str = "sqeuclidean", tile_m: int = 256, tile_n: int = 1024,
              impl: str = "fused", exclude_self: bool = False,
              threshold_skip: bool | None = None, db_live: Tensor | None = None,
              q_allowed: Tensor | None = None) -> KNNResult:
    """k nearest database rows for each query row (asymmetric problem).

    ``threshold_skip=None`` resolves per substrate (on inside the kernels,
    off on the plain selection), see ``topk.resolve_threshold_skip``.
    ``db_live``: bool [n] row mask; False rows score +inf and are never
    selected (the serving index's tombstones).  ``tile_m``/``tile_n`` tile
    the plain and per-tile-kernel paths; the fused kernel picks its own.
    """
    _check_impl(impl)
    if q_allowed is not None:
        raise NotImplementedError("per-query filters come with the filtered slice")
    m_real, d = queries.shape
    n_real = database.shape[0]
    assert database.shape[1] == d, (queries.shape, database.shape)
    k = min(k, n_real if not exclude_self else max(n_real - 1, 1))

    if impl == "fused":
        return kops.fused_knn(queries, database, k, distance=distance,
                              exclude_self=exclude_self, db_live=db_live,
                              threshold_skip=threshold_skip)
    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    tile_fn = _tile_fn(impl, distance)
    q = _pad_rows(queries, tile_m)
    db = _pad_rows(database, tile_n)
    live = None
    if db_live is not None:
        live = torch.cat([db_live, db_live.new_zeros(db.shape[0] - n_real)])

    vals, idx = [], []
    for row_off in range(0, q.shape[0], tile_m):
        qt = q[row_off : row_off + tile_m]
        run = T.init_running(tile_m, k, device=queries.device)
        for col_off in range(0, db.shape[0], tile_n):
            tile = tile_fn(qt, db[col_off : col_off + tile_n])
            tile = _mask_tile(tile, row_off, col_off, m_real, n_real, exclude_self)
            if live is not None:
                tile = torch.where(live[None, col_off : col_off + tile_n], tile, T.POS_INF)
            run = T.update_running(*run, tile, col_off, threshold_skip=threshold_skip)
        v, i = T.finalize_topk(*run, k)
        vals.append(v)
        idx.append(i)
    return KNNResult(torch.cat(vals)[:m_real], torch.cat(idx)[:m_real])


def knn_allpairs(x: Tensor, k: int, *, distance: str = "sqeuclidean",
                 gsize: int = 512, impl: str = "fused", symmetric: bool = True,
                 exclude_self: bool = True,
                 threshold_skip: bool | None = None) -> KNNResult:
    """k nearest vectors to each vector (the paper's problem, one device).

    ``symmetric=True`` computes only the upper-triangle grids and pushes
    each tile into its row buffers and, transposed, its column buffers: the
    paper's Fig. 5 with one device.  ``symmetric=False`` (and an asymmetric
    distance) solve the full square ``knn_query(x, x)``.

    ``impl="fused"`` always solves the full square in the fused kernel, as
    ``knn_query(x, x, exclude_self=True)``: its tile never leaves the chip,
    so the mirror update has nothing to save.  (The reference's symmetric
    branch sends ``"fused"`` to plain tiles instead; the results agree.)
    """
    _check_impl(impl)
    if impl == "fused" or not symmetric or not is_symmetric(distance):
        return knn_query(x, x, k, distance=distance, tile_m=min(gsize, 256),
                         tile_n=gsize, impl=impl, exclude_self=exclude_self,
                         threshold_skip=threshold_skip)

    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    tile_fn = _tile_fn(impl, distance)
    n_real = x.shape[0]
    k = min(k, max(n_real - 1, 1) if exclude_self else n_real)
    xp = _pad_rows(x, gsize)
    n_grids = xp.shape[0] // gsize
    run_v, run_i = T.init_running(xp.shape[0], k, device=x.device)

    # Static upper-triangle tile list (X >= Y), the nDevices = 1 schedule.
    for Y in range(n_grids):
        for X in range(Y, n_grids):
            row_off, col_off = Y * gsize, X * gsize
            rs, cs = slice(row_off, row_off + gsize), slice(col_off, col_off + gsize)
            tile = tile_fn(xp[rs], xp[cs])
            # Row-side update (grid (X, Y)).
            t_row = _mask_tile(tile, row_off, col_off, n_real, n_real, exclude_self)
            run_v[rs], run_i[rs] = T.update_running(
                run_v[rs], run_i[rs], t_row, col_off, threshold_skip=threshold_skip)
            # Mirror-side update (grid (Y, X)); a diagonal tile has none.
            if X != Y:
                t_col = _mask_tile(tile.T, col_off, row_off, n_real, n_real, exclude_self)
                run_v[cs], run_i[cs] = T.update_running(
                    run_v[cs], run_i[cs], t_col, row_off, threshold_skip=threshold_skip)
    vals, idx = T.finalize_topk(run_v, run_i, k)
    return KNNResult(vals[:n_real], idx[:n_real])
