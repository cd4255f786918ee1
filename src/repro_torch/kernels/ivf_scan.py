"""IVF cell-probed scan, as a CUDA kernel.

Stage 1 of IVF: the fused scan restricted, for each tile of ``tile_m``
queries, to the union of the cells its queries probe.  Replaces
``repro/kernels/ivf_scan.py::ivf_scan_pallas`` (body ``_kernel``).  Source:
``csrc/ivf_scan.cu``, the kernel of ``csrc/fused_knn.cuh`` (3xTF32
``wgmma`` product of ``csrc/gemm_tc.cuh``, selection of ``csrc/select.cuh``)
walking a tile table instead of a contiguous range (``kernels/scan.py`` on
this side, shared with ``fused_knn``).  ``gy`` is the cell-packed corpus
(cell c owns slots ``[c * cell_cap, (c + 1) * cell_cap)``, its rows first)
in fp32, bf16 or int8 (with ``gy_scale``); pad and dead slots carry ``hy =
+inf``, and ``cell_extent`` gives, per cell, how many of its leading slots
to scan.

Bound on the H100: operations (2 · rows · scanned rows · d, three TF32
passes on the tensor cores, two for a bf16 / int8 ``gy``).  A cell that is
not in a tile's probe list costs no reads: ``tile_table`` lists, per union
tile, the 128-column tiles of the distinct cells its list names, each cell
only up to its extent (``ops.ivf_scan_operands`` takes the extent from the
live mask: one past the cell's last live slot, so the slots it skips are
+inf and never selected), with the cell's end, past which no column
enters.  The card builds the table itself (``build_table``, one launch).
The table is split across CTAs by tiles (``split_bounds``) when the query
blocks alone cannot fill the card, and ``merge_partials`` merges the
partial sets.  A CTA owns rows of one union tile, so union tiles of fewer
queries than its 64 or 128 rows run with dead rows.  K: up to
``stream_topk.MAX_SELECT_K`` = 4096 on the card (K-buffers in the output
past 256), and at most ``cell_cap`` (``ops``).

Result contract, the same as the reference's: per query the K =
next_pow2(k) smallest, by (value, packed slot), of the fused tile over the
first ``cell_extent[c]`` slots of every distinct cell c in its tile's
list, ascending; ids are packed slots; ``+inf`` slots carry ``-1``.
``ivf_scan_plain`` is that contract in plain PyTorch: per tile, gather the
union's slots, score, stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.stream_topk import MAX_K, require_card_k, sorted_prefix

LAUNCHES = 0
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)
TABLE_LAUNCHES = 0  # launches of the tile-table kernel
TILE_COLS = 128  # columns of a tile-table entry (csrc/fused_knn.cuh kFusedBN)


def ivf_scan_plain(probes, fx, gy, hx, hy, k: int, *, cell_cap: int, tile_m: int,
                   cell_extent, alpha: float, finalize: str, gy_scale=None):
    """The kernel's function in plain PyTorch; (values [m, K], ids [m, K])."""
    m = fx.shape[0]
    K = T.next_pow2(k)
    lane = torch.arange(cell_cap, device=fx.device)
    vals, idx = [], []
    for t in range(-(-m // tile_m)):
        cells = torch.unique_consecutive(probes[t]).long()  # the list, duplicates skipped
        cells = cells[(cells >= 0) & (cells < cell_extent.shape[0])]  # a slot naming no cell
        cols = cells[:, None] * cell_cap + lane
        cols = cols[lane[None, :] < cell_extent[cells].long()[:, None]]  # ascending slots
        cols = torch.cat([cols.reshape(-1), cols.new_full((1,), -1)])  # -1: the empty id
        g, h = gy[cols[:-1]], hy[:, cols[:-1]]
        gs = None if gy_scale is None else gy_scale[:, cols[:-1]]
        r_end = min(m, (t + 1) * tile_m)
        step = max(1, SC.PLAIN_CHUNK // max(len(cols), 1))
        for r0 in range(t * tile_m, r_end, step):
            r1 = min(r_end, r0 + step)
            tile = SC.scan_tile_plain(fx[r0:r1], g, hx[r0:r1], h, alpha=alpha,
                                      finalize=finalize, gy_scale=gs)
            v, p = sorted_prefix(tile, K)
            vals.append(v)
            idx.append(cols[p.long()].int())  # position -1 reads the -1 at the end
    if not vals:
        return sorted_prefix(torch.zeros((0, 1), device=fx.device), K)
    return torch.cat(vals), torch.cat(idx)


def tile_table(probes: torch.Tensor, cell_extent: torch.Tensor,
               cell_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(table [nt, T, 2] int32, counts [nt] int32) of probe lists ``probes``
    [nt, W]: row t of ``table`` lists, for each distinct cell c of list t (a
    slot equal to its predecessor, or naming no cell, is skipped) in slot
    order, one entry per 128-column tile of its first ``cell_extent[c]``
    slots: (the tile's first column, the cell's end ``c * cell_cap +
    cell_extent[c]``).  ``counts[t]`` entries of row t are live; the rest,
    up to max(1, max counts), are zeros.  Computed where ``probes`` lies,
    with one read back of that width."""
    nt, W = probes.shape
    ncells = cell_extent.shape[0]
    p = probes.long()
    fresh = torch.ones_like(p, dtype=torch.bool)
    fresh[:, 1:] = p[:, 1:] != p[:, :-1]
    ok = fresh & (p >= 0) & (p < ncells)
    cell = p.clamp(0, ncells - 1)
    ext = cell_extent.long()[cell].clamp(0, cell_cap)
    tiles = torch.where(ok, (ext + TILE_COLS - 1) // TILE_COLS, 0)  # [nt, W]
    end = tiles.cumsum(1)  # one past each slot's last entry
    counts = end[:, -1]
    width = max(1, int(counts.max()))
    e = torch.arange(width, device=probes.device).expand(nt, width).contiguous()
    slot = torch.searchsorted(end, e, right=True).clamp(max=W - 1)  # the slot of entry e
    base = cell.gather(1, slot) * cell_cap
    col0 = base + (e - (end - tiles).gather(1, slot)) * TILE_COLS
    hi = base + ext.gather(1, slot)
    live = e < counts[:, None]
    table = torch.stack([torch.where(live, col0, 0), torch.where(live, hi, 0)], 2)
    return table.int().contiguous(), counts.int()


def split_bounds(counts: torch.Tensor, splits: int) -> torch.Tensor:
    """[nt, splits + 1] int32: split s of union tile t walks entries
    ``[bounds[t, s], bounds[t, s + 1])`` of its table, ``floor(s counts[t] /
    splits)`` on: ascending ranges that cover the table once and differ in
    length by at most one entry."""
    s = torch.arange(splits + 1, device=counts.device)
    return (counts.long()[:, None] * s[None, :] // splits).int().contiguous()


# ivf_scan_table(probes, extent, table, bounds, nt, W, ncells, cell_cap, T,
#                splits, stream)
TABLE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def build_table(probes, cell_extent, cell_cap: int,
                splits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(table [nt, T, 2], bounds [nt, splits + 1]): ``tile_table``'s entries
    and ``split_bounds``.  On the card, one launch of the table kernel and
    no read back, the rows sized by the bound T = min(W, ncells) *
    ceil(cell_cap / 128) (the entries past each row's count are not
    written, and no split reaches them); CPU tensors run the plain
    versions."""
    nt, W = probes.shape
    ncells = cell_extent.shape[0]
    width = max(1, min(W, ncells) * -(-cell_cap // TILE_COLS))
    if B.on_meta(probes, cell_extent):
        table = torch.empty((nt, width, 2), dtype=torch.int32, device="meta")
        bounds = torch.empty((nt, splits + 1), dtype=torch.int32, device="meta")
        B.shape_call("ivf_scan_table", flops=0.0,
                     nbytes=B.nbytes(probes, cell_extent, table, bounds))
        return table, bounds
    if not B.on_cuda(probes, cell_extent):
        table, counts = tile_table(probes, cell_extent, cell_cap)
        return table, split_bounds(counts, splits)
    table = torch.empty((nt, width, 2), dtype=torch.int32, device=probes.device)
    bounds = torch.empty((nt, splits + 1), dtype=torch.int32, device=probes.device)
    B.launch("ivf_scan", "ivf_scan_table", TABLE_ARGTYPES, probes.device, B.ptr(probes),
             B.ptr(cell_extent), B.ptr(table), B.ptr(bounds), nt, W, ncells, cell_cap, width,
             splits)
    B.count_launch(__name__, TABLE_LAUNCHES=1)
    return table, bounds


def plan(probes, cell_extent, cell_cap: int, m: int, tile_m: int, K: int,
         device: torch.device, gy_dtype=torch.float32,
         scaled: bool = False) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """(tile table, split bounds, BM, splits) of a launch over ``m`` queries
    in union tiles of ``tile_m``: each union tile's table split until the
    row blocks of all of them fill the card's resident CTAs once (a union
    tile with fewer entries than splits leaves some empty)."""
    rows = min(tile_m, m)  # the queries of a union tile
    bm = SC.block_rows(rows, K)
    per_sm, _, _ = SC.kernel_shape("ivf_scan", device, bm, K, gy_dtype, scaled)
    row_blocks = probes.shape[0] * -(-rows // bm)
    splits = max(1, min(per_sm * B.sm_count(device) // row_blocks, 65535))
    return (*build_table(probes, cell_extent, cell_cap, splits), bm, splits)


# ivf_scan(table, bounds, fx, gy, gs, hx, hy, out_v, out_i, m, d, S, T, K,
#          tile_m, threshold_skip, alpha, finalize, gy_dtype, bm, splits,
#          stream)
C_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float]
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def ivf_scan_partials(probes, fx, gy, hx, hy, k: int, *, cell_cap: int, tile_m: int,
                      cell_extent, distance_finalize: str, alpha: float, gy_scale=None,
                      threshold_skip: bool | None = None):
    """The kernel's own output: partial sets (values [S', m, K], ids
    [S', m, K]), split s over the s-th range of each union tile's table.

    ``probes`` [ceil(m / tile_m), W] int32, row t the list of queries
    ``[t * tile_m, (t + 1) * tile_m)``; the other operands as
    ``fused_knn_partials`` takes them, ``gy`` [S, d] cell-packed with
    S % cell_cap == 0.  ``cell_extent`` [S / cell_cap] int32: the leading
    slots of each cell to scan (``cell_cap`` for whole cells).  CPU tensors
    run the plain version, as one split; CUDA tensors launch the kernel
    (d % 4 == 0).
    """
    m, d = fx.shape
    S = gy.shape[0]
    K = T.next_pow2(k)
    B.require(distance_finalize in FINALIZE_CODES,
              lambda: f"unknown finalizer {distance_finalize!r}")
    B.require(cell_cap > 0 and S % cell_cap == 0, lambda: f"S={S} is not a multiple of {cell_cap}")
    B.require(probes.dtype == torch.int32 and probes.dim() == 2
              and probes.shape[0] == -(-m // tile_m) and probes.shape[1] > 0
              and probes.is_contiguous(),
              lambda: f"probes: want contiguous int32 [{-(-m // tile_m)}, W], got "
              f"{probes.dtype} {tuple(probes.shape)}")
    SC.check_scan_operands(fx, gy, hx, hy, gy_scale)
    B.require(cell_extent.dtype == torch.int32 and tuple(cell_extent.shape)
              == (S // cell_cap,) and cell_extent.is_contiguous(),
              lambda: f"cell_extent: want contiguous int32 [{S // cell_cap}], got "
              f"{cell_extent.dtype} {tuple(cell_extent.shape)}")
    extra = [] if gy_scale is None else [gy_scale]
    if B.on_meta(probes, fx, gy, hx, hy, cell_extent, *extra):
        require_card_k(K, "ivf_scan")
        B.require_vec4(d, fx, gy)
        v, i = B.meta_topk((1, m), K)
        # A ceiling: each union tile's list probes min(W, ncells) whole cells.
        cols = min(probes.shape[1], S // cell_cap) * cell_cap
        nt = probes.shape[0]
        B.shape_call("ivf_scan", flops=2.0 * m * cols * d,
                     nbytes=B.nbytes(probes, fx, hx, cell_extent, v, i)
                     + nt * cols * (d * gy.element_size() + 4 * (1 + len(extra))))
        return v, i
    if not B.on_cuda(probes, fx, gy, hx, hy, cell_extent, *extra):
        v, i = ivf_scan_plain(probes, fx, gy, hx, hy, k, cell_cap=cell_cap, tile_m=tile_m,
                              cell_extent=cell_extent, alpha=alpha, finalize=distance_finalize,
                              gy_scale=gy_scale)
        return v[None], i[None]
    require_card_k(K, "ivf_scan")
    B.require_vec4(d, fx, gy)
    dev = fx.device
    if m == 0:
        return (torch.full((1, 0, K), T.POS_INF, device=dev),
                torch.full((1, 0, K), -1, dtype=torch.int32, device=dev))
    table, bounds, bm, splits = plan(probes, cell_extent, cell_cap, m, tile_m, K, dev,
                                     gy.dtype, gy_scale is not None)
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("ivf_scan", "ivf_scan", C_ARGTYPES, dev,
             B.ptr(table), B.ptr(bounds), B.ptr(fx), B.ptr(gy), B.ptr(gy_scale),
             B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx), m, d, S, table.shape[1], K, tile_m,
             int(skip), float(alpha), FINALIZE_CODES[distance_finalize],
             SC.GY_CODES[gy.dtype], bm, splits)
    B.count_launch(__name__, LAUNCHES=1, WIDE_LAUNCHES=K > MAX_K)
    return vals, idx


def ivf_scan(probes, fx, gy, hx, hy, k: int, **kw):
    """Cell-probed scan over matmul-form operands; (values [m, K], packed
    slot ids [m, K]).  The operands and keywords are
    ``ivf_scan_partials``'s; a split list's partial sets are merged by the
    merge kernel."""
    vals, idx = ivf_scan_partials(probes, fx, gy, hx, hy, k, **kw)
    if vals.shape[0] == 1:
        return vals[0], idx[0]
    return merge_partials(vals, idx)
