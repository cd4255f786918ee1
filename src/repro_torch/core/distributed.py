"""Multi-device k-nearest-vector solvers (paper Sect. 4) on a one-process mesh.

PyTorch port of ``repro/core/distributed.py``.  The paper's multi-GPU
design has three load-bearing ideas:

  1. symmetric delta => compute only the upper triangle, each tile feeding
     both its row heaps and (transposed) its column heaps;
  2. zigzag assignment of grid rows to devices for static load balance;
  3. per-device private heaps, with no synchronization until one final
     merge (on the CPU in the paper).

The reference runs each shard body under ``jax.shard_map``; here a
``launch.mesh.Mesh`` of positions stands in for the devices, and a shard
body is a loop over the positions of the axis it runs on, each position's
work enqueued on its own device and stream (``Mesh.on``) from the one
calling thread.  The collectives are copies between the positions'
tensors (``permute``, ``rotate``, ``all_gather``, and for the sharded
train steps ``all_reduce`` and ``reduce_scatter``: autograd functions over
a group of positions whose backward is the collective's transpose); each
notes itself in ``launch.hlo_stats``'s open recordings, for the dry run's
accounting.

* ``make_ring_allpairs``: rows sharded; a half ring of hops rotates
  visiting blocks so each unordered pair of blocks meets once, the
  visiting block's heap travelling with it ("boomerang") and routed home
  by one rotation (ideas 1 and 3, balance exact).
* ``make_triangle_allpairs``: the paper's layout: one all-gather, the
  zigzag schedule of ``core.grid``, full-length heaps on every position,
  then a log2(P) butterfly merge in place of the paper's CPU merge.
* ``make_query_sharded``, ``make_ivf_query_sharded``,
  ``make_ivfpq_query_sharded``: the serving path: queries sharded on one
  axis, the database (or its cell blocks) on another, a local scan, then
  the butterfly merge over the database axis.

``impl`` is ``"torch"`` (plain tensor code, the reference's ``"jnp"``),
``"kernel"`` or ``"fused"``.  Ring and triangle tiles with ``"kernel"``
(the reference's ``"pallas"``; ``"fused"`` runs the same, because a tile
feeds two sides of the problem and has to leave the chip) take the
``pairwise_distance`` kernel for the tile, the ``stream_topk`` kernel for
each row's top K and, on the transposed tile, each column's, and the
bitonic merge into the running heaps.  The sharded queries with
``"fused"`` run ``fused_knn`` (and its merge), ``rescore_topk``,
``ivf_scan`` and ``pq_scan``.  CPU tensors run the kernels' plain
versions; positions on CUDA launch the kernels or raise.

A tile is walked in blocks of ``COL_CHUNK`` columns, so a position never
holds more than ``rows x COL_CHUNK`` distances and their transpose (a full
ring tile at n = 160,000 over four positions would be 6.4 GB, and its
transpose as much again).  The row side keeps the K smallest by (value,
column) whatever the blocks; the column side of a block is its columns'
whole update.

Tie rules (``ROADMAP.md``'s deliberate differences): the merges keep the
running buffer first (``topk.merge_topk_sorted``), so after the butterfly
two positions can hold different ids at exact value ties; the sharded
makers return the first position's copy along the database axis, as the
reference's ``out_specs`` do.  The bf16 wire stores the travelling payload
in bf16 between hops and merges in fp32, as the reference's does.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import ivf as IVF
from repro_torch.core import topk as T
from repro_torch.core.distances import QuantizedRows, get_distance, is_symmetric, quantize_rows
from repro_torch.core.knn import (
    KNNResult,
    _check_impl,
    _pad_rows,
    pairwise_tile,
    quantized_scan,
    rescore,
    scan_width,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import stream_topk as _st
from repro_torch.launch import hlo_stats

Tensor = torch.Tensor

COL_CHUNK = 8192  # columns of a tile held at once


# ---------------------------------------------------------------------------
# Collectives: copies between the positions' tensors.
# ---------------------------------------------------------------------------


def permute(mesh, pos: Sequence[int], parts: list, perm) -> list:
    """``ppermute``: ``out[d]`` is ``parts[s]`` copied onto position
    ``pos[d]`` for each (s, d) of ``perm``, a permutation of ``range(len(pos))``."""
    out = [None] * len(parts)
    for s, d in perm:
        out[d] = mesh.copy(parts[s], pos[s], pos[d])
    if any(o is None for o in out):
        raise ValueError(f"perm {list(perm)} is not a permutation of {len(parts)} positions")
    hlo_stats.note("collective-permute", out[:1], pos)
    return out


def rotate(mesh, pos: Sequence[int], parts: list, shift: int) -> list:
    """The static ring permute: position i sends to (i + shift) mod P."""
    P = len(parts)
    return permute(mesh, pos, parts, [(i, (i + shift) % P) for i in range(P)])


def _cat_parts(mesh, pos, parts, dim: int) -> list:
    """The parts concatenated along ``dim`` on ``pos[0]``, copied to the others."""
    got = [parts[0]] + [mesh.copy(parts[s], pos[s], pos[0]) for s in range(1, len(parts))]
    with mesh.on(pos[0]):
        whole = torch.cat(got, dim)
    out = [whole] + [mesh.copy(whole, pos[0], d) for d in pos[1:]]
    hlo_stats.note("all-gather", out[:1], pos)
    return out


def _sum_parts(mesh, pos, parts) -> torch.Tensor:
    """The parts' sum on ``pos[0]``, added in position order."""
    acc = parts[0]
    for s in range(1, len(parts)):
        other = mesh.copy(parts[s], pos[s], pos[0])
        with mesh.on(pos[0]):
            acc = acc + other
    return acc


def _reduce_parts(mesh, pos, parts) -> list:
    acc = _sum_parts(mesh, pos, parts)
    out = [acc] + [mesh.copy(acc, pos[0], d) for d in pos[1:]]
    hlo_stats.note("all-reduce", out[:1], pos)
    return out


def _scatter_parts(mesh, pos, parts, dim: int) -> list:
    acc = _sum_parts(mesh, pos, parts)
    size = acc.shape[dim] // len(pos)
    out = []
    for i, d in enumerate(pos):
        with mesh.on(pos[0]):
            block = acc.narrow(dim, i * size, size).contiguous()
        out.append(block if d == pos[0] else mesh.copy(block, pos[0], d))
    hlo_stats.note("reduce-scatter", out[:1], pos)
    return out


# Autograd materializes an unused output's gradient as zeros
# (``ctx.set_materialize_grads``' default), so a backward sees every part.
# Each runs as a collective program (``Mesh.scope``): autograd hands a
# backward its gradients on the stream the forward was called from (the
# caller's), where it may have summed two of them.
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, pos, *parts):
        ctx.mesh, ctx.pos = mesh, pos
        with mesh.scope():
            return tuple(_reduce_parts(mesh, pos, list(parts)))

    @staticmethod
    def backward(ctx, *grads):
        with ctx.mesh.scope():
            return (None, None, *_reduce_parts(ctx.mesh, ctx.pos, list(grads)))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, pos, dim, *parts):
        ctx.mesh, ctx.pos, ctx.dim = mesh, pos, dim
        with mesh.scope():
            return tuple(_cat_parts(mesh, pos, list(parts), dim))

    @staticmethod
    def backward(ctx, *grads):
        with ctx.mesh.scope():
            return (None, None, None, *_scatter_parts(ctx.mesh, ctx.pos, list(grads), ctx.dim))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, pos, dim, *parts):
        ctx.mesh, ctx.pos, ctx.dim = mesh, pos, dim
        with mesh.scope():
            return tuple(_scatter_parts(mesh, pos, list(parts), dim))

    @staticmethod
    def backward(ctx, *grads):
        with ctx.mesh.scope():
            return (None, None, None, *_cat_parts(ctx.mesh, ctx.pos, list(grads), ctx.dim))


def all_gather(mesh, pos: Sequence[int], parts: list, dim: int = 0) -> list:
    """``all_gather(tiled=True)``: every position gets the concatenation of
    all positions' parts along ``dim``, in position order.  Its gradient is
    ``reduce_scatter``'s."""
    if len(parts) == 1:
        return list(parts)
    return list(_AllGather.apply(mesh, tuple(pos), dim, *parts))


def all_reduce(mesh, pos: Sequence[int], parts: list) -> list:
    """``psum``: the parts' sum, added in position order on ``pos[0]`` and
    copied to every other position, so every position holds the same bits.
    Its gradient is the all-reduce of the cotangents (its transpose)."""
    if len(parts) == 1:
        return list(parts)
    return list(_AllReduce.apply(mesh, tuple(pos), *parts))


def reduce_scatter(mesh, pos: Sequence[int], parts: list, dim: int = 0) -> list:
    """``psum_scatter(tiled=True)``: the parts' sum (``all_reduce``'s order),
    cut along ``dim`` into one block a position.  Its gradient is
    ``all_gather``'s."""
    if len(parts) == 1:
        return list(parts)
    return list(_ReduceScatter.apply(mesh, tuple(pos), dim, *parts))


def tree_merge_topk(mesh, pos: Sequence[int], run_v: list, run_i: list,
                    *, wire_dtype=None) -> tuple[list, list]:
    """All-reduce-style top-k merge: XOR butterfly of bitonic merges.

    After log2(P) rounds every position holds the K smallest of the union of
    all positions' sorted K-buffers.  Each position merges its own buffer
    first (it wins ties).  ``wire_dtype`` (bf16): the value buffer is
    STORED in the wire type between rounds, so every position compares
    identically rounded values and ships 2 bytes a value; merges run in
    fp32 and ids stay int32.  Returns fp32 values.
    """
    P = len(pos)
    if P & (P - 1):
        raise ValueError(f"butterfly merge needs a power-of-two axis, got {P}")
    run_v, run_i = list(run_v), list(run_i)
    if wire_dtype is not None:
        for p in range(P):
            with mesh.on(pos[p]):
                run_v[p] = run_v[p].to(wire_dtype)
    d = 1
    while d < P:
        perm = [(i, i ^ d) for i in range(P)]
        ov = permute(mesh, pos, run_v, perm)
        oi = permute(mesh, pos, run_i, perm)
        for p in range(P):
            with mesh.on(pos[p]):
                mv, mi = T.merge_topk_sorted(run_v[p].float(), run_i[p], ov[p].float(), oi[p])
                run_v[p] = mv if wire_dtype is None else mv.to(wire_dtype)
                run_i[p] = mi
        d *= 2
    for p in range(P):
        with mesh.on(pos[p]):
            run_v[p] = run_v[p].float()
    return run_v, run_i


# ---------------------------------------------------------------------------
# Tiles: distances, masks, selection, the heaps they feed.
# ---------------------------------------------------------------------------


def _tile(rows: Tensor, cols: Tensor, distance: str, impl: str) -> Tensor:
    if impl == "torch":
        return pairwise_tile(rows, cols, get_distance(distance))
    return kops.pairwise_distance(rows, cols, distance=distance)


def _select(tile: Tensor, K: int, offset: int, impl: str):
    """The K smallest of each row by (value, column), ascending, ids offset
    by ``offset`` (-1 on +inf): ``stream_topk`` (the paper's phase 2) or
    the plain stable sort."""
    if impl == "torch":
        return T.tile_topk(tile, K, offset)
    v, i = _st.stream_topk(tile.contiguous(), K)
    return v, torch.where(i >= 0, i + offset, -1)


def _mask(tile: Tensor, row_off: int, col_off: int, n_real: int, diag: bool) -> Tensor:
    """Pad rows and columns (ids >= ``n_real``) and, with ``diag``, each
    row's own column to +inf, in place."""
    m, c = tile.shape
    if col_off + c > n_real:
        tile[:, max(0, n_real - col_off):] = T.POS_INF
    if row_off + m > n_real:
        tile[max(0, n_real - row_off):] = T.POS_INF
    if diag:
        tile.diagonal(offset=row_off - col_off).fill_(T.POS_INF)
    return tile


def _fold(rows: Tensor, cols: Tensor, run, mirror, *, row_off: int, col_off: int,
          n_real: int, diag: bool, distance: str, impl: str, K: int, threshold_skip: bool):
    """Fold the tile ``rows x cols`` into the rows' heap ``run`` (ids
    ``col_off + j``) and, unless ``mirror`` is None, its transpose into the
    columns' heap ``mirror`` (ids ``row_off + i``; values stored in its own
    type, merged in fp32), a block of ``COL_CHUNK`` columns at a time."""
    rv, ri = run
    for c0 in range(0, cols.shape[0], COL_CHUNK):
        c1 = min(cols.shape[0], c0 + COL_CHUNK)
        tile = _mask(_tile(rows, cols[c0:c1], distance, impl), row_off, col_off + c0,
                     n_real, diag)
        if impl == "torch":
            rv, ri = T.update_running(rv, ri, tile, col_off + c0, threshold_skip=threshold_skip)
        else:
            rv, ri = T.merge_topk_sorted(rv, ri, *_select(tile, K, col_off + c0, impl))
        if mirror is not None:
            mv, mi = mirror
            tv, ti = _select(tile.T, K, row_off, impl)
            nv, ni = T.merge_topk_sorted(mv[c0:c1].float(), mi[c0:c1], tv, ti)
            mv[c0:c1] = nv.to(mv.dtype)
            mi[c0:c1] = ni
    return rv, ri


# ---------------------------------------------------------------------------
# Ring all-pairs.
# ---------------------------------------------------------------------------


def ring_allpairs_shard(mesh, pos: Sequence[int], x_parts: list, *, k: int,
                        distance: str = "sqeuclidean", n_real: int, impl: str = "kernel",
                        threshold_skip: bool | None = None, wire_dtype=None) -> list:
    """Per-position body of the half-ring symmetric all-pairs kNN.

    ``x_parts[p]``: position ``pos[p]``'s row block [n_loc, d] (zero rows
    past ``n_real`` globally).  Returns each block's ascending (values,
    indices) [n_loc, K].
    """
    _check_impl(impl)
    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    sym = is_symmetric(distance)
    P = len(pos)
    n_loc = x_parts[0].shape[0]
    K = T.next_pow2(k)
    kw = dict(n_real=n_real, distance=distance, impl=impl, K=K, threshold_skip=threshold_skip)

    # Diagonal tile: own vs own, self excluded.  No communication.
    run = []
    for p in range(P):
        with mesh.on(pos[p]):
            x = x_parts[p]
            init = T.init_running(n_loc, k, device=x.device)
            run.append(_fold(x, x, init, None, row_off=p * n_loc, col_off=p * n_loc,
                             diag=True, **kw))
    if P == 1:
        return run

    n_steps = P // 2 if sym else P - 1
    # Boomerang state: the visiting block and the heap its hosts build for
    # it.  With ``wire_dtype`` both travel STORED in the wire type.
    vis_block, vis_v, vis_i = [], [], []
    for p in range(P):
        with mesh.on(pos[p]):
            x = x_parts[p]
            v, i = T.init_running(n_loc, k, device=x.device)
            vis_block.append(x if wire_dtype is None else x.to(wire_dtype))
            vis_v.append(v if wire_dtype is None else v.to(wire_dtype))
            vis_i.append(i)

    for s in range(1, n_steps + 1):
        # After s hops position p hosts block (p - s) mod P and its heap.
        vis_block = rotate(mesh, pos, vis_block, 1)
        vis_v = rotate(mesh, pos, vis_v, 1)
        vis_i = rotate(mesh, pos, vis_i, 1)
        for p in range(P):
            # Even P's last half-step would meet each pair {p, p + P/2}
            # twice: only the lower position keeps it (the paper's virtual
            # mirror).  A dropped tile is all +inf, which changes no heap.
            if sym and P % 2 == 0 and s == n_steps and p >= P // 2:
                continue
            src = (p - s) % P
            with mesh.on(pos[p]):
                x = x_parts[p]
                run[p] = _fold(x, vis_block[p].to(x.dtype), run[p],
                               (vis_v[p], vis_i[p]) if sym else None,
                               row_off=p * n_loc, col_off=src * n_loc, diag=False, **kw)

    if sym:
        # Route each travelling heap home: block q's heap sits at (q + S) mod P.
        vis_v = rotate(mesh, pos, vis_v, -n_steps)
        vis_i = rotate(mesh, pos, vis_i, -n_steps)
        for p in range(P):
            with mesh.on(pos[p]):
                run[p] = T.merge_topk_sorted(*run[p], vis_v[p].float(), vis_i[p])
    return run


# ---------------------------------------------------------------------------
# The paper's triangle with the zigzag schedule.
# ---------------------------------------------------------------------------


def triangle_allpairs_shard(mesh, pos: Sequence[int], x_parts: list, tiles, valid, *, k: int,
                            distance: str = "sqeuclidean", gsize: int, n_real: int,
                            impl: str = "kernel", threshold_skip: bool | None = None) -> list:
    """Paper Fig. 5: zigzag-assigned upper-triangle grids, per-position heaps.

    ``tiles``/``valid``: the padded static schedule (``grid.make_schedule``,
    numpy [P, max_tiles, 2] / [P, max_tiles]); position ``pos[p]`` walks
    row p.  Returns each position's PARTIAL heaps for ALL rows [n_pad, K];
    ``tree_merge_topk`` merges them, as the paper merges per-GPU heaps.
    """
    _check_impl(impl)
    threshold_skip = T.resolve_threshold_skip(threshold_skip, kernel=False)
    # One all-gather: the paper ships the whole dataset to every GPU up front.
    xs = all_gather(mesh, pos, x_parts)
    K = T.next_pow2(k)
    kw = dict(n_real=n_real, distance=distance, impl=impl, K=K, threshold_skip=threshold_skip)
    heaps = []
    for p in range(len(pos)):
        with mesh.on(pos[p]):
            x = xs[p]
            rv, ri = T.init_running(x.shape[0], k, device=x.device)
            for (X, Y), ok in zip(tiles[p].tolist(), valid[p].tolist()):
                if not ok:  # schedule padding: an all-+inf tile
                    continue
                rs = slice(Y * gsize, (Y + 1) * gsize)
                cs = slice(X * gsize, (X + 1) * gsize)
                # The row side into rows' heaps; the column side (none on a
                # diagonal grid) into the columns' heaps, in place.
                mirror = None if X == Y else (rv[cs], ri[cs])
                rv[rs], ri[rs] = _fold(x[rs], x[cs], (rv[rs], ri[rs]), mirror,
                                       row_off=Y * gsize, col_off=X * gsize, diag=X == Y, **kw)
            heaps.append((rv, ri))
    return heaps


# ---------------------------------------------------------------------------
# Query-sharded kNN (the serving path).
# ---------------------------------------------------------------------------


def _pad_to(vals: Tensor, idx: Tensor, K: int):
    return T.pad_topk(vals, idx, K) if vals.shape[1] < K else (vals, idx)


def query_sharded_shard(mesh, pos: Sequence[int], q_parts: list, db_parts: list,
                        live_parts: list | None = None, db_q_parts: list | None = None, *,
                        k: int, distance: str = "sqeuclidean", n_db_real: int,
                        impl: str = "fused", scan_dtype: str = "float32", overfetch: int = 4,
                        wire_dtype=None, threshold_skip: bool | None = None):
    """Queries of one block on every position of ``pos``, the database
    sharded over them; each scans its shard, then the butterfly merge.

    ``live_parts``: bool [n_loc] per shard (tombstones): dead rows score +inf
    BEFORE the merge, so its payload stays K a row.  ``scan_dtype`` !=
    "float32" runs the two-stage pipeline per shard: the bf16/int8 replica
    (``db_q_parts``, else quantized on the fly) scanned for K' =
    scan_width candidates, rescored exactly against the fp32 shard, then
    merged (``wire_dtype``: the merge's compressed wire).  Ids are global
    database rows.  Returns per position (values [m_loc, k], ids).
    """
    _check_impl(impl)
    P = len(pos)
    K = T.next_pow2(k)
    vals, idx = [], []
    for p in range(P):
        with mesh.on(pos[p]):
            q, db = q_parts[p], db_parts[p]
            live = None if live_parts is None else live_parts[p]
            n_loc = db.shape[0]
            local_valid = min(max(n_db_real - p * n_loc, 0), n_loc)
            if scan_dtype != "float32":
                db_q = None if db_q_parts is None else db_q_parts[p]
                if db_q is None:
                    db_q = quantize_rows(db, scan_dtype, distance=distance)
                k_scan = scan_width(n_loc, min(k, n_loc), overfetch)
                if impl == "fused":
                    cand = kops.fused_knn(q, db_q, k_scan, distance=distance,
                                          db_valid=local_valid, db_live=live,
                                          threshold_skip=threshold_skip).indices
                else:
                    ok = torch.arange(n_loc, device=db.device) < local_valid
                    ok = ok if live is None else ok & live
                    cand = quantized_scan(q, db_q, k_scan, distance=distance, db_live=ok,
                                          threshold_skip=threshold_skip).indices
                v, i = rescore(q, db, cand, min(k, n_loc), distance=distance,
                               impl="fused" if impl == "fused" else "torch")
            elif impl == "fused":
                v, i = kops.fused_knn(q, db, min(k, n_loc), distance=distance,
                                      db_valid=local_valid, db_live=live,
                                      threshold_skip=threshold_skip)
            else:
                tile = _tile(q, db, distance, impl)
                tile[:, local_valid:] = T.POS_INF  # ragged database: pad rows score +inf
                if live is not None:
                    tile = torch.where(live[None, :], tile, T.POS_INF)
                v, i = _select(tile, K, 0, impl)
            v, i = _pad_to(v, i, K)
            vals.append(v)
            idx.append(torch.where(i >= 0, i + p * n_loc, -1))
    vals, idx = tree_merge_topk(mesh, pos, vals, idx, wire_dtype=wire_dtype)
    return [(v[:, :k], i[:, :k]) for v, i in zip(vals, idx)]


def _probed_mask(local_cells: Tensor, ncells_loc: int) -> Tensor:
    """bool [m, ncells_loc]: the shard's cells each query probes (probes of
    other shards' cells match nothing)."""
    m = local_cells.shape[0]
    ok = (local_cells >= 0) & (local_cells < ncells_loc)
    probed = torch.zeros((m, ncells_loc + 1), dtype=torch.bool, device=local_cells.device)
    probed.scatter_(1, torch.where(ok, local_cells, ncells_loc).long(), True)
    return probed[:, :ncells_loc]


def _externalize_slots(vals, idx, row_of_slot, K):
    """Packed slots -> global corpus rows (-1 kept), padded to width K."""
    safe = idx.clamp(0, row_of_slot.shape[0] - 1).long()
    idx = torch.where(idx >= 0, row_of_slot[safe], -1)
    return _pad_to(vals, idx, K)


def ivf_shard_topk(q: Tensor, centroids: Tensor, packed: Tensor, slot_ids: Tensor,
                   live: Tensor, scan_db=None, *, k: int, nprobe: int, cell_lo: int,
                   cell_cap: int, distance: str = "sqeuclidean", impl: str = "fused",
                   scan_dtype: str = "float32", pq_cb=None, residual: bool = True,
                   overfetch: int = 4, threshold_skip: bool | None = None):
    """One shard's sorted [m, next_pow2(k)] (values, ids) over its cells.

    The per-position body of the sharded IVF and IVF-PQ queries, and the
    whole local query of a shard worker (``serving.shards.ShardWorker``):
    the shard owns the global cells ``[cell_lo, cell_lo + ncells_loc)``,
    ``packed`` [ncells_loc * cell_cap, d] its fp32 slot rows.  It computes
    the GLOBAL shortlist (``centroids`` are the replicated coarse table),
    keeps the probes of its own cells (``cells - cell_lo``: another shard's
    cell matches nothing, and a query tile with no local probe scans
    nothing), scans ``scan_db`` for K' = scan_width candidates, rescores
    them exactly against ``packed`` and maps slots through ``slot_ids``
    (-1 kept): corpus rows on a mesh, external ids in a worker.

    ``scan_db``: the slot rows' ``QuantizedRows`` replica (None: quantized
    here to ``scan_dtype``, or ``packed`` itself for a float32 fused scan),
    or, with ``pq_cb``, their ``PQCodes`` (ADC, the residual cross term
    against the shard's own slice of ``centroids`` when ``residual``).
    ``impl="fused"`` runs ``ivf_scan`` / ``pq_scan`` (fetch width capped at
    ``cell_cap``), the other impls the plain per-query probe mask.
    ``live``: bool [S_loc], pad slots and tombstones dead.
    """
    from repro_torch.core.pq import pq_cell_bias

    _check_impl(impl)
    S_loc = packed.shape[0]
    if S_loc % cell_cap:
        raise ValueError(f"a shard of {S_loc} slots is not whole cells of {cell_cap}")
    ncells_loc = S_loc // cell_cap
    k_loc = min(k, S_loc)
    local_cells = IVF.shortlist(q, centroids, nprobe, distance=distance, impl=impl) - cell_lo
    k_scan = scan_width(S_loc, k_loc, overfetch)
    if pq_cb is not None:
        cent_local = centroids[cell_lo : cell_lo + ncells_loc]
        if impl == "fused":
            cand = kops.pq_scan(q, pq_cb, scan_db, local_cells, min(k_scan, cell_cap),
                                cell_cap=cell_cap, centroids=cent_local if residual else None,
                                distance=distance, packed_live=live,
                                threshold_skip=threshold_skip).indices
        else:
            cbias = pq_cell_bias(q, cent_local, distance=distance) if residual else None
            cand = quantized_scan(q, scan_db, k_scan, distance=distance, db_live=live,
                                  probed=_probed_mask(local_cells, ncells_loc),
                                  cell_cap=cell_cap, pq_codebook=pq_cb, cell_bias=cbias,
                                  threshold_skip=threshold_skip).indices
    elif impl == "fused":
        if scan_db is None:
            scan_db = (packed if scan_dtype == "float32" else
                       quantize_rows(packed, scan_dtype, distance=distance))
        cand = kops.ivf_scan(q, scan_db, local_cells, min(k_scan, cell_cap),
                             cell_cap=cell_cap, distance=distance, packed_live=live,
                             threshold_skip=threshold_skip).indices
    else:
        if scan_db is None:
            scan_db = quantize_rows(packed, scan_dtype, distance=distance)
        cand = quantized_scan(q, scan_db, k_scan, distance=distance, db_live=live,
                              probed=_probed_mask(local_cells, ncells_loc),
                              cell_cap=cell_cap, threshold_skip=threshold_skip).indices
    v, i = rescore(q, packed, cand, k_loc, distance=distance,
                   impl="fused" if impl == "fused" else "torch")
    return _externalize_slots(v, i, slot_ids, T.next_pow2(k))


def _shard_live(ros: Tensor, live_parts: list | None, p: int) -> Tensor:
    """A mesh shard's live slots: pad slots are dead by construction."""
    live = ros >= 0
    return live if live_parts is None else live & live_parts[p]


def ivf_query_sharded_shard(mesh, pos: Sequence[int], q_parts: list, cent_parts: list,
                            packed_parts: list, ros_parts: list, live_parts: list | None = None,
                            packed_q_parts: list | None = None, *, k: int, nprobe: int,
                            cell_cap: int, distance: str = "sqeuclidean", impl: str = "fused",
                            scan_dtype: str = "float32", overfetch: int = 4, wire_dtype=None,
                            threshold_skip: bool | None = None):
    """IVF serving path: centroids replicated, cell blocks row-sharded.

    Shard p owns global cells ``[p * ncells_loc, (p + 1) * ncells_loc)``
    and runs ``ivf_shard_topk`` on them (its slots mapped to GLOBAL corpus
    rows through its ``row_of_slot`` slice); the butterfly merges K exact
    (value, row) pairs a query row.
    """
    _check_impl(impl)
    vals, idx = [], []
    for p in range(len(pos)):
        with mesh.on(pos[p]):
            packed, ros = packed_parts[p], ros_parts[p]
            v, i = ivf_shard_topk(
                q_parts[p], cent_parts[p], packed, ros, _shard_live(ros, live_parts, p),
                None if packed_q_parts is None else packed_q_parts[p], k=k, nprobe=nprobe,
                cell_lo=p * (packed.shape[0] // cell_cap), cell_cap=cell_cap,
                distance=distance, impl=impl, scan_dtype=scan_dtype, overfetch=overfetch,
                threshold_skip=threshold_skip)
            vals.append(v)
            idx.append(i)
    vals, idx = tree_merge_topk(mesh, pos, vals, idx, wire_dtype=wire_dtype)
    return [(v[:, :k], i[:, :k]) for v, i in zip(vals, idx)]


def ivfpq_query_sharded_shard(mesh, pos: Sequence[int], q_parts: list, cent_parts: list,
                              cb_parts: list, codes_parts: list, packed_parts: list,
                              ros_parts: list, live_parts: list | None = None, *, k: int,
                              nprobe: int, cell_cap: int, distance: str = "sqeuclidean",
                              impl: str = "fused", overfetch: int = 4, wire_dtype=None,
                              threshold_skip: bool | None = None, residual: bool = True):
    """IVF-PQ serving path: codebook and centroids replicated, code blocks
    row-sharded, with ``ivf_query_sharded_shard``'s contract: each shard's
    probes ADC-scanned over its code rows (``ivf_shard_topk`` with its
    codebook), the exact local rescore, global rows, the butterfly merge."""
    _check_impl(impl)
    vals, idx = [], []
    for p in range(len(pos)):
        with mesh.on(pos[p]):
            packed, ros = packed_parts[p], ros_parts[p]
            v, i = ivf_shard_topk(
                q_parts[p], cent_parts[p], packed, ros, _shard_live(ros, live_parts, p),
                codes_parts[p], k=k, nprobe=nprobe,
                cell_lo=p * (packed.shape[0] // cell_cap), cell_cap=cell_cap,
                distance=distance, impl=impl, pq_cb=cb_parts[p], residual=residual,
                overfetch=overfetch, threshold_skip=threshold_skip)
            vals.append(v)
            idx.append(i)
    vals, idx = tree_merge_topk(mesh, pos, vals, idx, wire_dtype=wire_dtype)
    return [(v[:, :k], i[:, :k]) for v, i in zip(vals, idx)]


# ---------------------------------------------------------------------------
# Entry points over a mesh.
# ---------------------------------------------------------------------------


pad_rows_to = _pad_rows  # zero rows up to a multiple of ``mult``: the reference's name


def _blocks(x, n_blocks: int) -> list:
    """``x`` (a tensor, or a NamedTuple of tensors split alike) in
    ``n_blocks`` equal leading-axis blocks."""
    if x is None:
        return [None] * n_blocks
    if isinstance(x, tuple):
        return [type(x)(*parts) for parts in zip(*(_blocks(t, n_blocks) for t in x))]
    if x.shape[0] % n_blocks:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_blocks} blocks")
    n = x.shape[0] // n_blocks
    return [x[b * n : (b + 1) * n] for b in range(n_blocks)]


def _put(mesh, x, p: int):
    """The caller's ``x`` (tensor, NamedTuple of them, or None) on position p."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_put(mesh, t, p) for t in x))
    return mesh.put(x, p)


def _gather(mesh, outs: list, device) -> KNNResult:
    """Per-block (values, ids), each block's copy on the caller's device, in
    block order (the caller's stream waits for the mesh at scope exit)."""
    return KNNResult(torch.cat([v.to(device) for v, _ in outs]),
                     torch.cat([i.to(device) for _, i in outs]))


def make_ring_allpairs(mesh, *, axes=None, k: int, distance: str = "sqeuclidean",
                       impl: str = "kernel", threshold_skip: bool | None = None,
                       wire_dtype=None):
    """An all-pairs kNN over ``mesh``: a ring over the flattened ``axes``.

    Returns fn(x [n, d], n_real) -> KNNResult with n % P == 0 (use
    ``pad_rows_to``); row block p goes to the p-th position along the axes
    (every setting of any other axis computes the same; the first one's
    result is returned, on ``x``'s device).
    """
    _check_impl(impl)
    axes = mesh.axes(axes)

    def fn(x: Tensor, n_real: int) -> KNNResult:
        groups = mesh.groups(axes)
        P = len(groups[0])
        if x.shape[0] % P:
            raise ValueError(f"{x.shape[0]} rows do not split over {P} positions (pad_rows_to)")
        with mesh.scope():
            runs = []
            for pos in groups:
                parts = [mesh.put(b, p) for b, p in zip(_blocks(x, P), pos)]
                runs.append(ring_allpairs_shard(
                    mesh, pos, parts, k=k, distance=distance, n_real=n_real, impl=impl,
                    threshold_skip=threshold_skip, wire_dtype=wire_dtype))
        v, i = _gather(mesh, runs[0], x.device)
        return KNNResult(v[:n_real, :k], i[:n_real, :k])

    return fn


def make_triangle_allpairs(mesh, *, axes=None, k: int, gsize: int,
                           distance: str = "sqeuclidean", impl: str = "kernel",
                           threshold_skip: bool | None = None):
    """The paper's zigzag/triangle kNN over ``mesh``; the final butterfly
    merge, then each position keeps its row block.  fn(x [n_pad, d],
    n_real) -> KNNResult with n_pad a multiple of ``gsize`` and of P."""
    from repro_torch.core import grid as G

    _check_impl(impl)
    axes = mesh.axes(axes)

    def fn(x: Tensor, n_real: int) -> KNNResult:
        groups = mesh.groups(axes)
        P = len(groups[0])
        n_pad = x.shape[0]
        if n_pad % gsize or n_pad % P:
            raise ValueError(f"{n_pad} rows must be a multiple of gsize {gsize} and of {P}")
        sched = G.make_schedule(n_pad, gsize, P)
        n_loc = n_pad // P
        with mesh.scope():
            outs = []
            for pos in groups:
                parts = [mesh.put(b, p) for b, p in zip(_blocks(x, P), pos)]
                heaps = triangle_allpairs_shard(
                    mesh, pos, parts, sched.tiles, sched.valid, k=k, distance=distance,
                    gsize=gsize, n_real=n_real, impl=impl, threshold_skip=threshold_skip)
                # Paper: merge the per-GPU heaps at the end; here a log-depth
                # butterfly on the positions, then each keeps its row block.
                rv, ri = tree_merge_topk(mesh, pos, *zip(*heaps))
                outs.append([(rv[p][p * n_loc : (p + 1) * n_loc],
                              ri[p][p * n_loc : (p + 1) * n_loc]) for p in range(P)])
        v, i = _gather(mesh, outs[0], x.device)
        return KNNResult(v[:n_real, :k], i[:n_real, :k])

    return fn


def _query_layout(mesh, query_axis, db_axis):
    """(the db-axis groups, and for each group its query block and whether
    it is the first group holding that block), checking that the queries
    are replicated over ``db_axis``."""
    q_axes = mesh.axes(query_axis)
    if db_axis in q_axes:
        raise ValueError("queries must be replicated over db_axis (the butterfly merge runs "
                         f"across it); got query_axis={query_axis!r} == db_axis={db_axis!r}")
    mesh.axes(db_axis)
    groups = mesh.groups(db_axis)
    blocks = [mesh.index_along(g[0], q_axes) for g in groups]
    first = [blocks.index(b) == j for j, b in enumerate(blocks)]
    n_q = 1
    for a in q_axes:
        n_q *= mesh.shape[a]
    return groups, blocks, first, n_q


def _run_query_groups(mesh, query_axis, db_axis, q, body):
    """Run ``body(pos, q_block) -> per-position results`` once per db-axis
    group, and return, for each query block in order, its first group's
    first position's result on ``q``'s device."""
    groups, blocks, first, n_q = _query_layout(mesh, query_axis, db_axis)
    q_blocks = _blocks(q, n_q)
    with mesh.scope():
        got = {}
        for pos, b, keep in zip(groups, blocks, first):
            outs = body(pos, q_blocks[b])
            if keep:
                got[b] = outs[0]
    return _gather(mesh, [got[b] for b in range(n_q)], q.device)


def make_query_sharded(mesh, *, query_axis, db_axis: str, k: int,
                       distance: str = "sqeuclidean", impl: str = "fused",
                       scan_dtype: str = "float32", overfetch: int = 4, wire_dtype=None,
                       threshold_skip: bool | None = None):
    """Serving-path kNN: queries over ``query_axis``, the database over
    ``db_axis`` (``query_sharded_shard``).

    fn(q [m, d], db [n, d], n_db_real, db_live=None, db_q=None) -> KNNResult,
    m a multiple of the query axis' size, n of the db axis'.  ``db_live``
    (bool [n]) and ``db_q`` (a ``QuantizedRows`` replica of the whole padded
    database) shard over ``db_axis`` beside the rows.
    """
    _check_impl(impl)

    def fn(q: Tensor, db: Tensor, n_db_real: int, db_live: Tensor | None = None,
           db_q: QuantizedRows | None = None) -> KNNResult:
        P = mesh.shape[db_axis]
        db_b, live_b, dbq_b = _blocks(db, P), _blocks(db_live, P), _blocks(db_q, P)

        def body(pos, q_block):
            return query_sharded_shard(
                mesh, pos, [mesh.put(q_block, p) for p in pos],
                [mesh.put(b, p) for b, p in zip(db_b, pos)],
                None if db_live is None else [mesh.put(b, p) for b, p in zip(live_b, pos)],
                None if db_q is None else [_put(mesh, b, p) for b, p in zip(dbq_b, pos)],
                k=k, distance=distance, n_db_real=n_db_real, impl=impl,
                scan_dtype=scan_dtype, overfetch=overfetch, wire_dtype=wire_dtype,
                threshold_skip=threshold_skip)

        return _run_query_groups(mesh, query_axis, db_axis, q, body)

    return fn


def make_ivf_query_sharded(mesh, *, query_axis, db_axis: str, k: int, nprobe: int,
                           cell_cap: int, distance: str = "sqeuclidean", impl: str = "fused",
                           scan_dtype: str = "float32", overfetch: int = 4, wire_dtype=None,
                           threshold_skip: bool | None = None):
    """IVF serving-path kNN over ``mesh`` (``ivf_query_sharded_shard``).

    fn(q [m, d], centroids [ncells, d], packed [S, d], row_of_slot [S],
    live_packed [S] bool | None, packed_q QuantizedRows | None) -> KNNResult
    with GLOBAL corpus rows.  ``centroids`` replicate; the slot arrays shard
    over ``db_axis``, which must divide ncells (a cell never straddles two
    shards).
    """
    _check_impl(impl)

    def fn(q, centroids, packed, row_of_slot, live_packed=None, packed_q=None) -> KNNResult:
        P = mesh.shape[db_axis]
        if packed.shape[0] % (P * cell_cap):
            raise ValueError(f"ncells = {packed.shape[0] // cell_cap} must divide over "
                             f"db_axis ({P})")
        pk, rs, lv, pq = (_blocks(a, P) for a in (packed, row_of_slot, live_packed, packed_q))

        def body(pos, q_block):
            on = lambda blocks: [_put(mesh, b, p) for b, p in zip(blocks, pos)]  # noqa: E731
            return ivf_query_sharded_shard(
                mesh, pos, [mesh.put(q_block, p) for p in pos],
                [mesh.put(centroids, p) for p in pos], on(pk), on(rs),
                None if live_packed is None else on(lv), None if packed_q is None else on(pq),
                k=k, nprobe=nprobe, cell_cap=cell_cap, distance=distance, impl=impl,
                scan_dtype=scan_dtype, overfetch=overfetch, wire_dtype=wire_dtype,
                threshold_skip=threshold_skip)

        return _run_query_groups(mesh, query_axis, db_axis, q, body)

    return fn


def make_ivfpq_query_sharded(mesh, *, query_axis, db_axis: str, k: int, nprobe: int,
                             cell_cap: int, distance: str = "sqeuclidean", impl: str = "fused",
                             overfetch: int = 4, wire_dtype=None,
                             threshold_skip: bool | None = None, residual: bool = True):
    """IVF-PQ serving-path kNN over ``mesh`` (``ivfpq_query_sharded_shard``).

    fn(q [m, d], centroids [ncells, d], pq_cb PQCodebook, pq_codes PQCodes,
    packed [S, d], row_of_slot [S], live_packed [S] bool | None) ->
    KNNResult with GLOBAL corpus rows.  The centroids and the codebook
    replicate; the code rows, their ``hy``, the fp32 packed rows (the
    rescore's operand), ``row_of_slot`` and ``live_packed`` shard over
    ``db_axis``.  ``residual`` must say how the codes were built.
    """
    _check_impl(impl)

    def fn(q, centroids, pq_cb, pq_codes, packed, row_of_slot, live_packed=None) -> KNNResult:
        P = mesh.shape[db_axis]
        if packed.shape[0] % (P * cell_cap):
            raise ValueError(f"ncells = {packed.shape[0] // cell_cap} must divide over "
                             f"db_axis ({P})")
        pk, rs, lv, cd = (_blocks(a, P) for a in (packed, row_of_slot, live_packed, pq_codes))

        def body(pos, q_block):
            on = lambda blocks: [_put(mesh, b, p) for b, p in zip(blocks, pos)]  # noqa: E731
            return ivfpq_query_sharded_shard(
                mesh, pos, [mesh.put(q_block, p) for p in pos],
                [mesh.put(centroids, p) for p in pos], [_put(mesh, pq_cb, p) for p in pos],
                on(cd), on(pk), on(rs), None if live_packed is None else on(lv),
                k=k, nprobe=nprobe, cell_cap=cell_cap, distance=distance, impl=impl,
                overfetch=overfetch, wire_dtype=wire_dtype, threshold_skip=threshold_skip,
                residual=residual)

        return _run_query_groups(mesh, query_axis, db_axis, q, body)

    return fn
