"""IVF cell-probed scan, as a CUDA kernel.

Stage 1 of IVF: the fused scan restricted, for each tile of ``tile_m``
queries, to the union of the cells its queries probe.  Replaces
``repro/kernels/ivf_scan.py::ivf_scan_pallas`` (body ``_kernel``).  Source:
``csrc/ivf_scan.cu``, with the tile walk of ``csrc/scan.cuh`` and its fp32
SIMT tile product (``kernels/scan.py`` on this side, shared with
``fused_knn``).  ``gy`` is
the cell-packed corpus (cell c owns slots ``[c * cell_cap, (c + 1) *
cell_cap)``, its rows first) in fp32, bf16 or int8 (with ``gy_scale``);
pad and dead slots carry ``hy = +inf``, and ``cell_extent`` gives, per
cell, how many of its leading slots to scan.

Bound on the H100: operations (2 · rows · scanned rows · d fp32 FMAs).  A
cell that is not in a tile's probe list costs no reads: each CTA walks only
the cells its list names, as the TPU kernel's index map DMAs only those
blocks.  A CTA also stops each cell at its extent, rounded up to a
128-column tile, instead of at ``cell_cap`` (``ops.ivf_scan_operands``
takes the extent from the live mask: one past the cell's last live slot,
so the slots it skips are +inf and never selected).  A slot equal to its
predecessor (the list's padding) is skipped.  The probe list is split
across CTAs when the query tiles alone cannot fill the card, and
``merge_partials`` merges the partial sets.

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
from repro_torch.kernels.stream_topk import require_card_k, sorted_prefix

LAUNCHES = 0


def ivf_scan_plain(probes, fx, gy, hx, hy, k: int, *, cell_cap: int, tile_m: int,
                   cell_extent, alpha: float, finalize: str, gy_scale=None):
    """The kernel's function in plain PyTorch; (values [m, K], ids [m, K])."""
    m = fx.shape[0]
    K = T.next_pow2(k)
    lane = torch.arange(cell_cap, device=fx.device)
    vals, idx = [], []
    for t in range(-(-m // tile_m)):
        cells = torch.unique_consecutive(probes[t]).long()  # the list, duplicates skipped
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


def live_slots(probes: torch.Tensor) -> int:
    """The width W' such that every slot past it, in every tile's list,
    repeats its predecessor: the kernel would skip them all.  (One read of
    the lists on the host.)"""
    fresh = torch.ones_like(probes, dtype=torch.bool)
    fresh[:, 1:] = probes[:, 1:] != probes[:, :-1]
    pos = torch.arange(probes.shape[1], device=probes.device)
    return int(torch.where(fresh, pos, 0).max()) + 1


def plan(probes, m: int, tile_m: int, K: int, device: torch.device, gy_dtype=torch.float32,
         scaled: bool = False) -> tuple[torch.Tensor, int, int, int]:
    """(the probe lists cut to their live width, BM, splits, slots per
    split) of a launch over ``m`` queries in union tiles of ``tile_m``."""
    probes = probes[:, : live_slots(probes)].contiguous()
    bm = SC.block_rows(m, K)
    if tile_m % bm and m > tile_m:  # a CTA's rows must share one union tile
        bm = 64
    B.require(tile_m % bm == 0 or m <= tile_m,
              f"tile_m={tile_m} with {m} queries: the kernel's query blocks (at least 64 "
              "rows) must divide tile_m, or the batch must be one tile")
    per_sm, _, _ = SC.kernel_shape("ivf_scan", device, bm, K, gy_dtype, scaled)
    splits, sps = SC.split_plan(m, probes.shape[1], bm, 1, per_sm * B.sm_count(device))
    return probes, bm, splits, sps


# ivf_scan(probes, extent, fx, gy, gs, hx, hy, out_v, out_i, m, d, S, W, K,
#          cell_cap, tile_m, threshold_skip, alpha, finalize, gy_dtype, bm,
#          splits, slots_per_split, stream)
C_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def ivf_scan_partials(probes, fx, gy, hx, hy, k: int, *, cell_cap: int, tile_m: int,
                      cell_extent, distance_finalize: str, alpha: float, gy_scale=None,
                      threshold_skip: bool | None = None):
    """The kernel's own output: partial sets (values [S', m, K], ids
    [S', m, K]), split s over the s-th range of each tile's probe list.

    ``probes`` [ceil(m / tile_m), W] int32, row t the list of queries
    ``[t * tile_m, (t + 1) * tile_m)``; the other operands as
    ``fused_knn_partials`` takes them, ``gy`` [S, d] cell-packed with
    S % cell_cap == 0.  ``cell_extent`` [S / cell_cap] int32: the leading
    slots of each cell to scan (``cell_cap`` for whole cells).  CPU tensors
    run the plain version, as one split; CUDA tensors launch the kernel
    (d % 4 == 0).
    """
    global LAUNCHES
    m, d = fx.shape
    S = gy.shape[0]
    K = T.next_pow2(k)
    B.require(distance_finalize in FINALIZE_CODES, f"unknown finalizer {distance_finalize!r}")
    B.require(cell_cap > 0 and S % cell_cap == 0, f"S={S} is not a multiple of {cell_cap}")
    B.require(probes.dtype == torch.int32 and probes.dim() == 2
              and probes.shape[0] == -(-m // tile_m) and probes.shape[1] > 0
              and probes.is_contiguous(),
              f"probes: want contiguous int32 [{-(-m // tile_m)}, W], got "
              f"{probes.dtype} {tuple(probes.shape)}")
    SC.check_scan_operands(fx, gy, hx, hy, gy_scale)
    B.require(cell_extent.dtype == torch.int32 and tuple(cell_extent.shape)
              == (S // cell_cap,) and cell_extent.is_contiguous(),
              f"cell_extent: want contiguous int32 [{S // cell_cap}], got "
              f"{cell_extent.dtype} {tuple(cell_extent.shape)}")
    if not B.on_cuda(probes, fx, gy, hx, hy, cell_extent,
                     *([] if gy_scale is None else [gy_scale])):
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
    probes, bm, splits, sps = plan(probes, m, tile_m, K, dev, gy.dtype, gy_scale is not None)
    W = probes.shape[1]
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("ivf_scan", "ivf_scan", C_ARGTYPES, dev,
             B.ptr(probes), B.ptr(cell_extent), B.ptr(fx), B.ptr(gy), B.ptr(gy_scale),
             B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx), m, d, S, W, K, cell_cap, tile_m,
             int(skip), float(alpha), FINALIZE_CODES[distance_finalize],
             SC.GY_CODES[gy.dtype], bm, splits, sps)
    LAUNCHES += 1
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
