"""Public wrappers around the kernels: operand maps, masks, output widths.

PyTorch port of ``repro/kernels/ops.py`` for the kernels of the exact kNN,
two-stage quantized, IVF and IVF-PQ paths.  Each wrapper maps raw vectors
to the matmul form (``fx``, ``gy``, ``hx``, ``hy``, ``alpha``), or takes a
``QuantizedRows`` replica already in ``gy`` form, or builds the ADC lookup
tables of a PQ replica, turns dead database rows into ``hy = +inf``, and
cuts the kernel's ``[m, K]`` output to ``[m, k]``.

Padding: the Pallas kernels need every axis padded to its block; the CUDA
kernels mask ragged rows and columns themselves, so only ``d`` is padded,
with zero coordinates, to the four-element width of the tile loads (zero
coordinates add nothing to ``fx . gy``, nor to any cumulative accumulator:
the operands are padded after their maps).  The per-query filter of
``fused_knn`` (``q_allowed``) is the kernel's bit-packed bitmap
(``fused_knn.pack_mask``), passed through as it is, not the reference's
padded fp32 block: the kernel masks ragged columns itself, so the bitmap
needs no padding either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import topk as T
from repro_torch.core.distances import (
    QuantizedRows,
    cumulative_kind,
    finalize_kind,
    get_distance,
)
from repro_torch.kernels import fused_knn as _fused
from repro_torch.kernels import ivf_scan as _ivf
from repro_torch.kernels import pairwise_distance as _pd
from repro_torch.kernels import pq_scan as _pq
from repro_torch.kernels import rescore as _rs
from repro_torch.kernels import stream_topk as _st


def _pad_d(*ts):
    """Zero coordinates up to a multiple of 4 on the last axis."""
    pad = (-ts[0].shape[-1]) % 4
    return [F.pad(t, (0, pad)).contiguous() if pad else t.contiguous() for t in ts]


def _mxu_operands(x, y, distance: str):
    mf = get_distance(distance).matmul_form
    fx = mf.fx(x).float()
    gy = mf.gy(y).float()
    hx = mf.hx(x).float()[:, None].contiguous()
    hy = mf.hy(y).float()[None, :].contiguous()
    fx, gy = _pad_d(fx, gy)
    return fx, gy, hx, hy, mf.alpha


def _scan_operands(q, db, distance: str, live=None):
    """(fx, gy, gy_scale, hx, hy, alpha) of a scan of ``db``: raw fp32 rows,
    or a ``QuantizedRows`` replica whose rows stay in their storage type
    (the kernel widens them as it loads them).  ``live`` False rows get
    ``hy = +inf``."""
    if isinstance(db, QuantizedRows):
        mf = get_distance(distance).matmul_form
        fx, gy = _pad_d(mf.fx(q).float(), db.data)
        hx = mf.hx(q).float()[:, None].contiguous()
        hy = db.hy.float()[None, :]
        gs = None if db.scale is None else db.scale.float()[None, :].contiguous()
        alpha = mf.alpha
    else:
        fx, gy, hx, hy, alpha = _mxu_operands(q, db, distance)
        gs = None
    if live is not None:
        hy = torch.where(live[None, :], hy, T.POS_INF)
    return fx, gy, gs, hx, hy.contiguous(), alpha


def pairwise_distance(x, y, *, distance: str = "sqeuclidean", cumulative: bool = False):
    """[m, n] distance matrix via a pairwise-distance kernel (phase 1).

    ``cumulative=True`` takes the paper's generic route: the distance's
    ``pre`` map, then its own accumulator folded one coordinate at a time
    (``csrc/pairwise_cumulative.cu``); otherwise the matmul form.
    """
    dist = get_distance(distance)
    if cumulative:
        if dist.pre is not None:
            x, y = dist.pre(x), dist.pre(y)
        xp, yp = _pad_d(x.float(), y.float())
        acc, fin = cumulative_kind(dist)
        return _pd.pairwise_distance_cumulative(xp, yp, accumulate=acc, finalize=fin,
                                                init=dist.init)
    fx, gy, hx, hy, alpha = _mxu_operands(x, y, distance)
    return _pd.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize=finalize_kind(dist))


def stream_topk(x, k: int, *, threshold_skip: bool | None = None):
    """Ascending k smallest per row of [m, n] + int32 ids (phase 2)."""
    vals, idx = _st.stream_topk(x.float().contiguous(), k, threshold_skip=threshold_skip)
    return vals[:, :k], idx[:, :k]


def fused_knn(q, db, k: int, *, distance: str = "sqeuclidean",
              exclude_self: bool = False, db_valid: int | None = None,
              db_live=None, q_allowed=None, threshold_skip: bool | None = None):
    """kNN of ``q`` against ``db`` with the fused kernel; returns KNNResult.

    ``db`` is raw fp32 rows [n, d] or a ``QuantizedRows`` replica (bf16 /
    int8 in ``gy`` space, ``core.distances.quantize_rows``); distances are
    then exact with respect to the dequantized rows, so callers over-fetch
    and rescore.  ``db_valid``: rows at index >= db_valid score +inf.
    ``db_live``: bool [n] mask, False rows score +inf (the serving index's
    tombstones).  Both ride the rank-1 ``hy`` term.  ``q_allowed``: the
    per-query filter (DESIGN.md §17) as the kernel's packed bitmap, int32
    [m or 1, ceil(n / 32)] (``fused_knn.pack_mask``); a clear bit scores
    +inf for that query.  It composes with both masks; an all-True bitmap
    gives the result of None.
    """
    from repro_torch.core.knn import KNNResult

    fx, gy, gs, hx, hy, alpha = _scan_operands(q, db, distance, db_live)
    n = gy.shape[0]
    if db_valid is not None:
        hy = torch.where(torch.arange(n, device=hy.device)[None, :] < db_valid, hy, T.POS_INF)
    vals, idx = _fused.fused_knn(
        fx, gy, hx, hy, k, distance_finalize=finalize_kind(get_distance(distance)),
        alpha=alpha, n_real=n, exclude_self=exclude_self, threshold_skip=threshold_skip,
        gy_scale=gs, q_mask=q_allowed)
    return KNNResult(vals[:, :k], idx[:, :k])


def cell_extent(packed_live, ncells: int, cell_cap: int):
    """Per cell, one past its last live slot (0 for a cell with none), int32
    [ncells]: the leading slots a scan must read, every slot past them being
    dead.  Without a mask every slot is live, and the extent is ``cell_cap``."""
    if packed_live is None:
        return torch.full((ncells,), cell_cap, dtype=torch.int32)
    lv = packed_live.view(ncells, cell_cap)
    last = cell_cap - lv.flip(1).to(torch.uint8).argmax(1)  # the first live slot from the end
    return torch.where(lv.any(1), last, 0).to(torch.int32)


def _union_probes(cells, m: int, S: int, k: int, *, cell_cap: int, tile_m: int, packed_live,
                  device):
    """(probes, tile_m, cell_extent) of a cell-probed scan of ``m`` queries
    over ``S`` packed slots: the union tiles of ``min(tile_m,
    next_pow2(max(m, 8)))`` queries, as the reference takes them, pad
    queries repeating the last query's probes (which leaves the union as it
    is), and each cell's extent.  Refuses a fetch wider than a cell."""
    from repro_torch.core.ivf import tile_probe_lists

    if S % cell_cap:
        raise ValueError(f"packed size {S} is not a multiple of cell_cap {cell_cap}")
    if T.next_pow2(k) > cell_cap:
        raise ValueError(f"fetch width K={T.next_pow2(k)} exceeds the cell block "
                         f"({cell_cap}); lower k or rebuild with a larger cell_cap")
    tile_m = min(tile_m, T.next_pow2(max(m, 8)))
    pad = (-m) % tile_m
    if pad:
        cells = torch.cat([cells, cells[-1:].expand(pad, cells.shape[1])])
    probes = tile_probe_lists(cells, S // cell_cap, tile_m)
    return probes, tile_m, cell_extent(packed_live, S // cell_cap, cell_cap).to(device)


def ivf_scan_operands(q, db, cells, k: int, *, cell_cap: int, distance: str = "sqeuclidean",
                      tile_m: int = 256, packed_live=None):
    """The ``ivf_scan`` kernel's operands for a scan of ``db``:
    (probes, fx, gy, gy_scale, hx, hy, alpha, tile_m, cell_extent).

    Every query of a union tile scans the union of the tile's probes
    (``core.ivf.tile_probe_lists``, tiles as ``_union_probes`` takes them),
    each cell up to its last live slot (``cell_extent``).
    """
    fx, gy, gs, hx, hy, alpha = _scan_operands(q, db, distance, packed_live)
    probes, tile_m, extent = _union_probes(cells, q.shape[0], gy.shape[0], k,
                                           cell_cap=cell_cap, tile_m=tile_m,
                                           packed_live=packed_live, device=q.device)
    return probes, fx, gy, gs, hx, hy, alpha, tile_m, extent


def ivf_scan(q, db, cells, k: int, *, cell_cap: int, distance: str = "sqeuclidean",
             tile_m: int = 256, packed_live=None, threshold_skip: bool | None = None):
    """Cell-probed kNN scan of a cell-packed corpus; returns KNNResult.

    ``db`` is the cell-packed [S, d] fp32 array (``core.ivf.IVFCells.packed``)
    or its ``QuantizedRows`` replica; ``cells`` [m, nprobe] int32 is each
    query's probed-cell shortlist; tiles of queries scan the union of their
    probes (``ivf_scan_operands``).  ``packed_live``: bool [S] mask in
    packed-slot order; dead slots get ``hy = +inf``, and the scan stops each
    cell at its last live slot.  Ids are PACKED slots (map back via
    ``row_of_slot``).
    """
    from repro_torch.core.knn import KNNResult

    probes, fx, gy, gs, hx, hy, alpha, tile_m, extent = ivf_scan_operands(
        q, db, cells, k, cell_cap=cell_cap, distance=distance, tile_m=tile_m,
        packed_live=packed_live)
    vals, idx = _ivf.ivf_scan(
        probes, fx, gy, hx, hy, k, cell_cap=cell_cap, tile_m=tile_m,
        cell_extent=extent, distance_finalize=finalize_kind(get_distance(distance)),
        alpha=alpha, gy_scale=gs, threshold_skip=threshold_skip)
    return KNNResult(vals[:, :k], idx[:, :k])


def pq_scan_operands(q, pq_cb, pq_codes, cells, k: int, *, cell_cap: int, centroids=None,
                     distance: str = "sqeuclidean", tile_m: int = 256, packed_live=None):
    """The ``pq_scan`` kernel's operands for an ADC scan of a cell-packed PQ
    replica: (probes, luts, codes, hx, hy, qc, tile_m, cell_extent).

    ``luts`` [m, pq_m * ncodes] are the flattened per-query tables
    (``core.pq.build_pq_luts``), ``hy`` the replica's rank-1 term with dead
    slots at ``+inf`` (``packed_live``), ``qc`` the residual cross term
    (``core.pq.pq_cell_bias``, None for plain codes).  The union tiles and
    extents are ``ivf_scan_operands``'s (``_union_probes``).
    """
    from repro_torch.core.pq import build_pq_luts, pq_cell_bias

    mf = get_distance(distance).matmul_form
    m = q.shape[0]
    probes, tile_m, extent = _union_probes(cells, m, pq_codes.codes.shape[0], k,
                                           cell_cap=cell_cap, tile_m=tile_m,
                                           packed_live=packed_live, device=q.device)
    luts = build_pq_luts(pq_cb, q, distance=distance).reshape(m, -1).contiguous()
    hx = mf.hx(q).float()[:, None].contiguous()
    hy = pq_codes.hy.float()[None, :]
    if packed_live is not None:
        hy = torch.where(packed_live[None, :], hy, T.POS_INF)
    qc = None if centroids is None else pq_cell_bias(q, centroids, distance=distance).contiguous()
    return (probes, luts, pq_codes.codes.contiguous(), hx, hy.contiguous(), qc, tile_m,
            extent)


def pq_scan(q, pq_cb, pq_codes, cells, k: int, *, cell_cap: int, centroids=None,
            distance: str = "sqeuclidean", tile_m: int = 256, packed_live=None,
            threshold_skip: bool | None = None):
    """Cell-probed ADC scan of a PQ-coded, cell-packed corpus; returns
    KNNResult.

    ``pq_cb`` / ``pq_codes`` are the ``core.pq`` codebook and replica (codes
    in packed-slot order); ``cells`` [m, nprobe] int32 each query's probed
    cells; ``centroids`` (the IVF coarse table) marks the codes residual and
    brings the per-(query, cell) cross term; None means plain codes.
    Operands as ``pq_scan_operands`` builds them; ids are PACKED slots.
    """
    from repro_torch.core.knn import KNNResult

    probes, luts, codes, hx, hy, qc, tile_m, extent = pq_scan_operands(
        q, pq_cb, pq_codes, cells, k, cell_cap=cell_cap, centroids=centroids,
        distance=distance, tile_m=tile_m, packed_live=packed_live)
    vals, idx = _pq.pq_scan(
        probes, luts, codes, hx, hy, k, cell_cap=cell_cap, ncodes=pq_cb.ncodes,
        tile_m=tile_m, cell_extent=extent, qc=qc,
        distance_finalize=finalize_kind(get_distance(distance)),
        threshold_skip=threshold_skip)
    return KNNResult(vals[:, :k], idx[:, :k])


def rescore_operands(q, db, cand_idx, k: int, *, distance: str = "sqeuclidean"):
    """The rescore kernel's operands: (fx, cand, hx, hy_cand, cand_idx), the
    candidate axis padded to ``K * 2^t`` with empty slots (``hy = +inf``,
    id -1) as the reference pads it.  The gather ``db[cand_idx]`` and the
    ``gy`` / ``hy`` maps run here, as the reference leaves them to XLA."""
    m, d = q.shape
    n = db.shape[0]
    Kp = cand_idx.shape[1]
    K = T.next_pow2(k)
    mf = get_distance(distance).matmul_form
    rows = db[cand_idx.clamp(0, n - 1).reshape(-1).long()]  # [m * Kp, d]
    cand = mf.gy(rows).float().reshape(m, Kp, d)
    hy_c = torch.where(cand_idx >= 0, mf.hy(rows).float().reshape(m, Kp), T.POS_INF)
    Kp_pad = K * T.next_pow2(-(-max(Kp, K) // K))
    cand = F.pad(cand, (0, 0, 0, Kp_pad - Kp))
    hy_c = F.pad(hy_c, (0, Kp_pad - Kp), value=T.POS_INF).contiguous()
    cip = F.pad(cand_idx, (0, Kp_pad - Kp), value=-1)
    fx, cand = _pad_d(mf.fx(q).float(), cand)
    return fx, cand, mf.hx(q).float()[:, None].contiguous(), hy_c, cip


def rescore_topk(q, db, cand_idx, k: int, *, distance: str = "sqeuclidean"):
    """Exact re-rank of per-query candidate rows; returns KNNResult [m, k].

    ``cand_idx`` [m, Kp] int32 database rows (-1 = empty slot), distinct
    within a row.  The kernel scores the gathered [m, Kp, d] block
    (``rescore_operands``) and selects; positions map back to rows through
    ``cand_idx``, and an empty slot comes back as +inf / -1.
    """
    from repro_torch.core.knn import KNNResult

    dist = get_distance(distance)
    fx, cand, hx, hy_c, cip = rescore_operands(q, db, cand_idx, k, distance=distance)
    vals, pos = _rs.rescore_topk(fx, cand, hx, hy_c, k, alpha=dist.matmul_form.alpha,
                                 finalize=finalize_kind(dist))
    idx = cip.gather(1, pos.clamp(min=0).long())
    idx = torch.where(torch.isfinite(vals), idx, -1).to(torch.int32)
    return KNNResult(vals[:, :k], idx[:, :k])
