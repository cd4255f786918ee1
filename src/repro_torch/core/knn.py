"""Single-device k-nearest-vector solver (paper Sect. 4-6), and the
two-stage quantized and IVF retrieval built on it.

PyTorch port of ``repro/core/knn.py``: ``knn_query`` / ``knn_allpairs``;
``rescore``, ``quantized_scan`` (scalar and ADC branches), ``scan_width``,
``two_stage_query`` (DESIGN.md §Quantized); ``ivf_query`` (DESIGN.md §IVF)
and ``ivfpq_query`` (DESIGN.md §PQ); each with the per-query filters of
DESIGN.md §17 (``q_allowed``, and ``exclude_rows`` on the IVF paths).

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
from repro_torch.core.distances import (
    Distance,
    QuantizedRows,
    get_distance,
    is_symmetric,
    matmul_finalize,
    quantize_rows,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_knn import check_mask, mask_bits_at, pack_mask, unpack_mask

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


def _allowed_rows(q_allowed, m: int, n: int, m_pad: int, n_pad: int) -> Tensor:
    """A per-query filter (the fused kernel's packed words, [m or 1, W]) as
    bool [m_pad, n_pad]: pad rows (sliced off) and pad columns (already
    +inf) False."""
    check_mask(q_allowed, m, n)
    allowed = unpack_mask(q_allowed, n).expand(m, n)
    out = torch.zeros((m_pad, n_pad), dtype=torch.bool, device=allowed.device)
    out[:m, :n] = allowed
    return out


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
    selected (the serving index's tombstones).  ``q_allowed``: the per-query
    filter (DESIGN.md §17) as the fused kernel's packed bitmap, int32
    [m or 1, ceil(n / 32)] (``kernels.fused_knn.pack_mask``); row j scores
    +inf for query i where its bit is clear.  Both masks compose (a row must be live and
    allowed); an all-True bitmap gives the result of None.  On the fused
    path the bitmap is a kernel operand, on the others a ``where`` beside
    ``db_live``.  ``tile_m``/``tile_n`` tile the plain and per-tile-kernel
    paths; the fused kernel picks its own.
    """
    _check_impl(impl)
    m_real, d = queries.shape
    n_real = database.shape[0]
    assert database.shape[1] == d, (queries.shape, database.shape)
    k = min(k, n_real if not exclude_self else max(n_real - 1, 1))

    if impl == "fused":
        return kops.fused_knn(queries, database, k, distance=distance,
                              exclude_self=exclude_self, db_live=db_live,
                              q_allowed=q_allowed, threshold_skip=threshold_skip)
    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    tile_fn = _tile_fn(impl, distance)
    q = _pad_rows(queries, tile_m)
    db = _pad_rows(database, tile_n)
    live = None
    if db_live is not None:
        live = torch.cat([db_live, db_live.new_zeros(db.shape[0] - n_real)])
    allowed = None
    if q_allowed is not None:
        allowed = _allowed_rows(q_allowed, m_real, n_real, q.shape[0], db.shape[0])

    vals, idx = [], []
    for row_off in range(0, q.shape[0], tile_m):
        qt = q[row_off : row_off + tile_m]
        run = T.init_running(tile_m, k, device=queries.device)
        for col_off in range(0, db.shape[0], tile_n):
            tile = tile_fn(qt, db[col_off : col_off + tile_n])
            tile = _mask_tile(tile, row_off, col_off, m_real, n_real, exclude_self)
            if live is not None:
                tile = torch.where(live[None, col_off : col_off + tile_n], tile, T.POS_INF)
            if allowed is not None:
                tile = torch.where(allowed[row_off : row_off + tile_m, col_off : col_off + tile_n],
                                   tile, T.POS_INF)
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


# ---------------------------------------------------------------------------
# Two-stage quantized retrieval: compressed scan + exact rescore
# (DESIGN.md §Quantized).
# ---------------------------------------------------------------------------


def rescore(queries: Tensor, database: Tensor, cand_idx: Tensor, k: int, *,
            distance: str = "sqeuclidean", impl: str = "torch") -> KNNResult:
    """Exact top-k re-rank of per-query candidate rows [m, Kp] (-1 = empty).

    The repair stage of the quantized scan: gather the fp32 rows the scan
    nominated, score them exactly, keep the k best.  ``impl="fused"`` runs
    the rescore kernel (``kernels/rescore.py``); any other impl the plain
    gather + batched dot + stable top-k.  Candidate slots must be distinct
    within a row (scan output is).
    """
    if impl == "fused":
        return kops.rescore_topk(queries, database, cand_idx, k, distance=distance)
    m, d = queries.shape
    n = database.shape[0]
    Kp = cand_idx.shape[1]
    dist = get_distance(distance)
    mf = dist.matmul_form
    rows = database[cand_idx.clamp(0, n - 1).reshape(-1).long()]  # [m * Kp, d]
    gy = mf.gy(rows).float().reshape(m, Kp, d)
    hy = mf.hy(rows).float().reshape(m, Kp)
    fx = mf.fx(queries).float()
    hx = mf.hx(queries).float()[:, None]
    dots = torch.einsum("md,mcd->mc", fx, gy)
    tile = matmul_finalize(dist)(mf.alpha * dots + hx + hy)
    tile = torch.where(cand_idx >= 0, tile, T.POS_INF)
    kk = min(k, Kp)
    vals, pos = T.topk_smallest(tile, kk)
    idx = cand_idx.gather(1, pos.long())
    idx = torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)
    if kk < k:
        vals, idx = T.pad_topk(vals, idx, k)
    return KNNResult(vals, idx)


def quantized_scan(queries: Tensor, db_q, k: int, *,
                   distance: str = "sqeuclidean", tile_m: int = 256, tile_n: int = 1024,
                   threshold_skip: bool | None = None, db_live: Tensor | None = None,
                   probed: Tensor | None = None, cell_cap: int | None = None,
                   pq_codebook=None, cell_bias: Tensor | None = None,
                   q_allowed: Tensor | None = None) -> KNNResult:
    """Tiled plain scan of a compressed replica: the stage-1 reference.

    ``db_q`` is a ``QuantizedRows`` replica (scalar branch) or a
    ``core.pq.PQCodes`` replica (ADC branch, with ``pq_codebook``).

    Scalar branch: per column tile the stored rows are widened to fp32 and
    the int8 scale folds into the epilogue, ``finalize(alpha * (fx @
    data^T) * scale + hx + hy)``.  The replica is never dequantized as a
    whole: the only fp32 database-shaped tensors are the [tile_n, d]
    per-tile upcasts.

    ADC branch (DESIGN.md §PQ), the plain counterpart of the ``pq_scan``
    kernel: the per-query LUTs are built once (``core.pq.build_pq_luts``)
    and each column tile sums its codes' table entries
    (``kernels.pq_scan.adc_scores``); ``cell_bias`` [m, ncells] (the
    residual cross term, ``core.pq.pq_cell_bias``) is added per column by
    its cell, ``cell_cap`` giving the cells.

    ``db_live``: [n] bool row mask (tombstones).  ``probed`` / ``cell_cap``:
    a per-QUERY cell mask [m, ncells] for the plain IVF path; a column of
    cell ``c`` is +inf for queries that did not probe ``c``.  ``q_allowed``:
    the per-query filter (DESIGN.md §17), packed as ``knn_query`` takes it;
    a clear bit is +inf.
    """
    from repro_torch.core.pq import PQCodes, build_pq_luts
    from repro_torch.kernels.pq_scan import adc_scores

    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    dist = get_distance(distance)
    mf = dist.matmul_form
    fin = matmul_finalize(dist)
    m_real = queries.shape[0]
    pq = isinstance(db_q, PQCodes)
    n_real = (db_q.codes if pq else db_q.data).shape[0]
    k = min(k, n_real)
    if pq:
        if pq_codebook is None:
            raise ValueError("a PQCodes scan needs its codebook")
        luts = build_pq_luts(pq_codebook, queries, distance=distance)  # [m, pq_m, ncodes]
        luts = _pad_rows(luts.reshape(m_real, -1), tile_m).reshape(-1, *luts.shape[1:])
    else:
        fx = _pad_rows(mf.fx(queries).float(), tile_m)
    if cell_bias is not None:
        if not pq or cell_cap is None:
            raise ValueError("a cell bias needs a PQCodes replica and cell_cap")
        cell_bias = _pad_rows(cell_bias, tile_m)
    hx = _pad_rows(mf.hx(queries).float()[:, None], tile_m)
    # Dead rows die through the hy epilogue term, as in the kernels.
    hy = db_q.hy.float()
    if db_live is not None:
        hy = torch.where(db_live, hy, T.POS_INF)
    if probed is not None:
        if cell_cap is None:
            raise ValueError("a per-query probe mask needs cell_cap")
        probed = _pad_rows(probed, tile_m)
    if q_allowed is not None:
        q_allowed = _allowed_rows(q_allowed, m_real, n_real, hx.shape[0], n_real)
    vals, idx = [], []
    for row_off in range(0, hx.shape[0], tile_m):
        rows = slice(row_off, row_off + tile_m)
        hxt = hx[rows]
        run = T.init_running(tile_m, k, device=queries.device)
        for col_off in range(0, n_real, tile_n):
            cols = slice(col_off, col_off + tile_n)
            if pq:
                t = adc_scores(luts[rows], db_q.codes[cols])
                if cell_bias is not None:
                    cell = torch.arange(col_off, col_off + t.shape[1],
                                        device=t.device) // cell_cap
                    t = t + cell_bias[rows][:, cell]
            else:
                t = mf.alpha * (fx[rows] @ db_q.data[cols].float().T)  # per-tile upcast only
                if db_q.scale is not None:
                    t = t * db_q.scale[cols][None, :]
            tile = fin(t + hxt + hy[None, cols])
            if probed is not None:
                cell = torch.arange(col_off, col_off + tile.shape[1],
                                    device=tile.device) // cell_cap
                tile = torch.where(probed[row_off : row_off + tile_m][:, cell], tile,
                                   T.POS_INF)
            if q_allowed is not None:
                tile = torch.where(q_allowed[rows, cols], tile, T.POS_INF)
            run = T.update_running(*run, tile, col_off, threshold_skip=threshold_skip)
        v, i = T.finalize_topk(*run, k)
        vals.append(v)
        idx.append(i)
    return KNNResult(torch.cat(vals)[:m_real], torch.cat(idx)[:m_real])


def scan_width(n: int, k: int, overfetch: int) -> int:
    """Candidate fetch width K' = min(n, overfetch * next_pow2(k)) of the
    quantized scan.  At K' = n the two-stage pipeline is exhaustive and
    exact by construction."""
    assert overfetch >= 1, overfetch
    return min(n, overfetch * T.next_pow2(k))


def two_stage_query(queries: Tensor, database: Tensor, db_q: QuantizedRows, k: int, *,
                    distance: str = "sqeuclidean", impl: str = "fused", overfetch: int = 4,
                    threshold_skip: bool | None = None, db_live: Tensor | None = None,
                    q_allowed: Tensor | None = None) -> KNNResult:
    """Quantized scan of ``db_q`` + exact fp32 rescore against ``database``.

    Stage 1 scans the low-precision replica for K' = scan_width(n, k,
    overfetch) candidates (tombstones masked inside the scan); stage 2
    re-scores them against the fp32 rows and returns the exact top-k of the
    candidate set.  With a float32 replica the set contains the true top-k,
    so the result is exact.  ``impl="fused"`` scans with the fused kernel
    and rescores with the rescore kernel; other impls run the plain
    ``quantized_scan`` and the plain rescore.  (The reference's Pallas
    query tile ``bm`` is a block size of its kernel; the CUDA kernel plans
    its own, and the result does not depend on it.)  ``q_allowed`` (packed
    as ``knn_query`` takes it, DESIGN.md §17) masks the scan per query, so
    the candidate set, and with it the exact rescore, only ever holds
    allowed rows.
    """
    _check_impl(impl)
    n = database.shape[0]
    k_scan = scan_width(n, k, overfetch)
    if impl == "fused":
        cand = kops.fused_knn(queries, db_q, k_scan, distance=distance, db_live=db_live,
                              q_allowed=q_allowed, threshold_skip=threshold_skip).indices
    else:
        cand = quantized_scan(queries, db_q, k_scan, distance=distance, db_live=db_live,
                              q_allowed=q_allowed, threshold_skip=threshold_skip).indices
    return rescore(queries, database, cand, min(k, n), distance=distance, impl=impl)


def _packed_allowed(ivf, q_allowed):
    """A per-query bitmap over the n rows in original order -> one over the
    S slots in packed-slot order (pad slots disallowed), both packed: the
    per-query analogue of ``core.ivf.packed_live``, riding the packing
    permutation (DESIGN.md §17)."""
    if q_allowed is None:
        return None
    n = ivf.slot_of_row.shape[0]
    safe = ivf.row_of_slot.clamp(0, n - 1).long()
    return pack_mask(unpack_mask(q_allowed, n)[:, safe] & (ivf.row_of_slot >= 0)[None, :])


def _post_filter(cand, rows, q_allowed):
    """Drop scanned candidates whose row the per-query bitmap disallows:
    ``cand`` [m, K'] packed slots, ``rows`` their original rows (-1 empty);
    dropped slots become -1.  The bitmap is read only at the candidates."""
    if q_allowed is None:
        return cand
    return torch.where(mask_bits_at(q_allowed, rows), cand, -1)


def _mask_excluded_rows(rows: Tensor, exclude_rows: Tensor | None) -> Tensor:
    """Drop candidate rows named by a per-query exclusion list.

    ``exclude_rows`` [m, E] int32 database rows, -1 padded; matching
    candidates become -1 (the empty slot ``rescore`` maps to +inf / id -1).
    Exactness needs the candidate width to exceed k + E: callers widen
    ``overfetch`` (DESIGN.md §17).  Each row's list is sorted once and the
    candidates looked up in it, where the reference compares [m, K', E].
    """
    if exclude_rows is None or exclude_rows.shape[1] == 0:
        return rows
    ex = torch.sort(exclude_rows.to(rows.dtype), dim=1).values.contiguous()
    pos = torch.searchsorted(ex, rows.contiguous()).clamp(max=ex.shape[1] - 1)
    hit = (ex.gather(1, pos) == rows) & (rows >= 0)
    return torch.where(hit, -1, rows)


# ---------------------------------------------------------------------------
# IVF cell-probed retrieval: coarse quantizer + pruned scan + exact rescore
# (DESIGN.md §IVF).
# ---------------------------------------------------------------------------


def ivf_query(queries: Tensor, database: Tensor, ivf, k: int, *, nprobe: int = 8,
              distance: str = "sqeuclidean", impl: str = "fused", overfetch: int = 4,
              threshold_skip: bool | None = None, db_live: Tensor | None = None,
              packed_q: QuantizedRows | None = None, q_allowed: Tensor | None = None,
              exclude_rows: Tensor | None = None) -> KNNResult:
    """Cell-probed kNN: centroid shortlist -> pruned scan -> exact rescore.

    ``ivf`` is a trained ``core.ivf.IVFCells`` over ``database``:

      1. shortlist: the ``nprobe`` nearest centroids per query (``knn_query``
         over [ncells, d]);
      2. pruned scan of the cell-packed replica (``packed_q``, else the fp32
         packed rows) for K' = scan_width(n, k, overfetch) candidates.
         ``impl="fused"`` runs the ``ivf_scan`` kernel, each query tile
         scanning the union of its queries' probes, each cell up to its
         last live slot (fetch width capped at ``cell_cap``); other impls run ``quantized_scan`` with a per-query
         probe mask;
      3. rescore: candidates map back through ``row_of_slot`` and re-rank
         exactly against the fp32 corpus.

    ``nprobe = ncells`` probes everything: with the fp32 packed replica the
    result equals ``knn_query``.  Every consumer takes the shortlist as a
    set of cells, so there the shortlist is all cells and no kNN over the
    centroids runs.  ``db_live`` is the [n] tombstone mask in original row
    order; it rides the packing permutation.

    ``q_allowed`` (packed as ``knn_query`` takes it, over the rows in
    original order, DESIGN.md §17) is the per-query filter: on ``impl="fused"`` the ``ivf_scan`` kernel is left as
    it is and the bitmap drops disallowed candidates before the rescore
    (post-filter at scan width: widen ``overfetch`` for selective filters);
    on the other impls it is permuted to slot order and masks inside the
    plain scan (pre-filter, exact under the full-probe hatch).
    ``exclude_rows`` ([m, E] int32, -1 padded) names per-query rows dropped
    at the rescore on every impl.
    """
    from repro_torch.core import ivf as IVF

    _check_impl(impl)
    n = database.shape[0]
    if q_allowed is not None:
        check_mask(q_allowed, queries.shape[0], n)
    k = min(k, n)
    ncells, cap = ivf.ncells, ivf.cell_cap
    cells = IVF.shortlist(queries, ivf.centroids, nprobe, distance=distance, impl=impl)
    live_p = IVF.packed_live(ivf, db_live)
    k_scan = scan_width(n, k, overfetch)
    if impl == "fused":
        cand = kops.ivf_scan(queries, ivf.packed if packed_q is None else packed_q, cells,
                             min(k_scan, cap), cell_cap=cap, distance=distance,
                             packed_live=live_p, threshold_skip=threshold_skip).indices
        cand = _post_filter(cand, _slot_rows(ivf, cand), q_allowed)
    else:
        scan_q = packed_q
        if scan_q is None:
            scan_q = quantize_rows(ivf.packed, "float32", distance=distance)
        probed = torch.zeros((queries.shape[0], ncells), dtype=torch.bool,
                             device=queries.device)
        probed.scatter_(1, cells.long(), True)
        cand = quantized_scan(queries, scan_q, k_scan, distance=distance, db_live=live_p,
                              probed=probed, cell_cap=cap,
                              q_allowed=_packed_allowed(ivf, q_allowed),
                              threshold_skip=threshold_skip).indices
    rows = _mask_excluded_rows(_slot_rows(ivf, cand), exclude_rows)
    return rescore(queries, database, rows, k, distance=distance,
                   impl="fused" if impl == "fused" else "torch")


def _slot_rows(ivf, cand):
    """Packed slots -> original rows, -1 kept."""
    safe = cand.clamp(0, ivf.row_of_slot.shape[0] - 1).long()
    return torch.where(cand >= 0, ivf.row_of_slot[safe], -1)


# ---------------------------------------------------------------------------
# IVF-PQ: coarse quantizer + product-quantized ADC scan + exact rescore
# (DESIGN.md §PQ).
# ---------------------------------------------------------------------------


def ivfpq_query(queries: Tensor, database: Tensor, ivf, pq_cb, pq_codes, k: int, *,
                nprobe: int = 8, distance: str = "sqeuclidean", impl: str = "fused",
                overfetch: int = 4, threshold_skip: bool | None = None,
                db_live: Tensor | None = None, residual: bool = True,
                q_allowed: Tensor | None = None,
                exclude_rows: Tensor | None = None) -> KNNResult:
    """IVF-PQ kNN: centroid shortlist -> ADC scan of m-byte codes -> rescore.

    ``ivf`` is a trained ``core.ivf.IVFCells`` over ``database`` and
    ``pq_cb`` / ``pq_codes`` its PQ replica in packed-slot order
    (``core.pq.build_ivfpq``; ``residual`` must say how it was built).
    Stage 1 probes ``nprobe`` cells and scans their code blocks for K' =
    scan_width(n, k, overfetch) candidates: ``impl="fused"`` runs the
    ``pq_scan`` kernel (fetch width capped at ``cell_cap``), other impls the
    plain ADC branch of ``quantized_scan`` with a per-query probe mask.
    Stage 2 maps the candidates back through ``row_of_slot`` and re-ranks
    them exactly against the fp32 corpus.

    PQ is lossy, but candidate order is its only error: with ``nprobe =
    ncells`` and ``overfetch`` spanning the corpus the result is
    ``knn_query``'s.  At ``nprobe >= ncells`` every cell is taken without a
    kNN over the centroids, as in ``ivf_query``.  ``db_live`` is the [n]
    tombstone mask in original row order.  ``q_allowed`` / ``exclude_rows``
    follow ``ivf_query``: post-filtered at the candidates on
    ``impl="fused"``, pre-filtered inside the plain ADC scan otherwise, the
    exclusions dropped at the rescore (DESIGN.md §17).
    """
    from repro_torch.core import ivf as IVF
    from repro_torch.core.pq import pq_cell_bias

    _check_impl(impl)
    n = database.shape[0]
    if q_allowed is not None:
        check_mask(q_allowed, queries.shape[0], n)
    k = min(k, n)
    ncells, cap = ivf.ncells, ivf.cell_cap
    cells = IVF.shortlist(queries, ivf.centroids, nprobe, distance=distance, impl=impl)
    live_p = IVF.packed_live(ivf, db_live)
    k_scan = scan_width(n, k, overfetch)
    if impl == "fused":
        cand = kops.pq_scan(queries, pq_cb, pq_codes, cells, min(k_scan, cap), cell_cap=cap,
                            centroids=ivf.centroids if residual else None, distance=distance,
                            packed_live=live_p, threshold_skip=threshold_skip).indices
        cand = _post_filter(cand, _slot_rows(ivf, cand), q_allowed)
    else:
        probed = torch.zeros((queries.shape[0], ncells), dtype=torch.bool,
                             device=queries.device)
        probed.scatter_(1, cells.long(), True)
        cbias = pq_cell_bias(queries, ivf.centroids, distance=distance) if residual else None
        cand = quantized_scan(queries, pq_codes, k_scan, distance=distance, db_live=live_p,
                              probed=probed, cell_cap=cap, pq_codebook=pq_cb,
                              cell_bias=cbias, q_allowed=_packed_allowed(ivf, q_allowed),
                              threshold_skip=threshold_skip).indices
    rows = _mask_excluded_rows(_slot_rows(ivf, cand), exclude_rows)
    return rescore(queries, database, rows, k, distance=distance,
                   impl="fused" if impl == "fused" else "torch")
