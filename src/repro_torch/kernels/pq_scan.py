"""IVF-PQ ADC scan, as a CUDA kernel.

Stage 1 of IVF-PQ: for each tile of ``tile_m`` queries, the union of the
cells its queries probe is scanned by asymmetric distance computation over
the cells' uint8 codes.  Replaces ``repro/kernels/pq_scan.py::pq_scan_pallas``
(body ``_kernel``, tile ``adc_tile``).  Source: ``csrc/pq_scan.cu``,
selection in ``csrc/select.cuh``.  Per query q and packed slot s of a
probed cell c::

    score = finalize(sum_j luts[q, j, codes[s, j]] (+ qc[q, c]) + hx[q] + hy[s])

The TPU has no per-lane gather, so the reference expands each code block
to a one-hot operand and contracts it against the LUTs on the MXU.  A
Hopper thread can gather, so here the query block's LUTs sit in shared
memory and each thread sums its slot's ``pq_m`` entries.  One query's LUT
is ``pq_m * ncodes * 4`` bytes (32 KiB at pq_m = 32, nbits = 8), so a CTA
holds the LUTs of a few queries (``QB``, a power of two up to 8), not the
reference's 256: several CTAs cover one union tile, and each walks that
tile's whole probe list.  The codes are the replica's own row-major
``[S, pq_m]`` array (the reference transposes them for its lane axis): a
128-slot tile of a cell is one contiguous run of ``128 * pq_m`` bytes.

Bound on the H100: operations (``pq_m`` fp32 adds per (query, live row)
pair; the codes and ``hy`` of a row are read once from device memory, but
every CTA of a tile reads them again, from L2).  Each cell is walked to
its extent (one past its last live slot), a slot that repeats its
predecessor in the list is skipped, and the list is split across CTAs
when the query blocks cannot fill the card (``merge_partials`` merges the
partial sets, lower splits winning ties as in one pass).  K up to
``stream_topk.MAX_SELECT_K`` = 4096 on the card: past 256 the K-buffers
are the output's rows, in device memory, since they do not fit beside the
LUTs.

Result contract, the same as the reference's: per query the K =
next_pow2(k) smallest, by (value, packed slot), of the scores over the
first ``cell_extent[c]`` slots of every distinct cell c in its tile's list,
ascending; ids are packed slots; ``+inf`` slots carry ``-1``.  The sum over
j runs in another order than the reference's contraction, so values agree
to rounding, not bit for bit.  ``pq_scan_plain`` is that contract in plain
PyTorch: per tile, gather the union's codes, look the LUTs up with
``torch.gather``, sum, stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import FINALIZERS
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC
from repro_torch.kernels.ivf_scan import live_slots
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.stream_topk import MAX_K, require_card_k, sorted_prefix

LAUNCHES = 0
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)
MAX_QB = 8  # queries per CTA
LUT_BUDGET = 96 * 1024  # bytes of LUTs per CTA: two or more CTAs per SM


def adc_scores(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[mq, nc] sums ``sum_j luts[q, j, codes[s, j]]`` of per-query tables
    ``luts`` [mq, pq_m, ncodes] over code rows ``codes`` [nc, pq_m]."""
    mq, pq_m, _ = luts.shape
    idx = codes.long().T[None].expand(mq, pq_m, codes.shape[0])
    return luts.gather(2, idx).sum(1)


def pq_scan_plain(probes, luts, codes, hx, hy, k: int, *, cell_cap: int, ncodes: int,
                  tile_m: int, cell_extent, finalize: str, qc=None):
    """The kernel's function in plain PyTorch; (values [m, K], ids [m, K])."""
    m = luts.shape[0]
    pq_m = codes.shape[1]
    K = T.next_pow2(k)
    lut3 = luts.reshape(m, pq_m, ncodes)
    lane = torch.arange(cell_cap, device=luts.device)
    vals, idx = [], []
    for t in range(-(-m // tile_m)):
        cells = torch.unique_consecutive(probes[t]).long()  # the list, duplicates skipped
        cols = cells[:, None] * cell_cap + lane
        cols = cols[lane[None, :] < cell_extent[cells].long()[:, None]]  # ascending slots
        cols = torch.cat([cols.reshape(-1), cols.new_full((1,), -1)])  # -1: the empty id
        c, h, cell_of = codes[cols[:-1]], hy[:, cols[:-1]], cols[:-1] // cell_cap
        r_end = min(m, (t + 1) * tile_m)
        step = max(1, SC.PLAIN_CHUNK // max(len(cols) * pq_m, 1))
        for r0 in range(t * tile_m, r_end, step):
            r1 = min(r_end, r0 + step)
            s = adc_scores(lut3[r0:r1], c)
            if qc is not None:
                s = s + qc[r0:r1][:, cell_of]
            v, p = sorted_prefix(FINALIZERS[finalize](s + hx[r0:r1] + h), K)
            vals.append(v)
            idx.append(cols[p.long()].int())  # position -1 reads the -1 at the end
    if not vals:
        return sorted_prefix(torch.zeros((0, 1), device=luts.device), K)
    return torch.cat(vals), torch.cat(idx)


def query_block(lut_floats: int) -> int:
    """QB: the largest power of two up to ``MAX_QB`` whose LUTs fit the
    per-CTA budget (at least 1)."""
    qb = MAX_QB
    while qb > 1 and qb * lut_floats * 4 > LUT_BUDGET:
        qb //= 2
    return qb


# pq_scan_occupancy(qb, lut_floats, pq_m, K, out[2])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SHAPES: dict = {}


def kernel_shape(device: torch.device, qb: int, lut_floats: int, pq_m: int,
                 K: int) -> tuple[int, int]:
    """(CTAs resident per SM, shared-memory bytes per CTA) of the kernel as
    compiled for QB, from the CUDA occupancy calculator."""
    key = (torch.device(device).index, qb, lut_floats, pq_m, K)
    if key not in _SHAPES:
        out = (ctypes.c_int * 2)()
        B.call("pq_scan", "pq_scan_occupancy", OCCUPANCY_ARGTYPES, device, qb, lut_floats,
               pq_m, K, out)
        B.require(out[0] > 0, lambda: f"the pq_scan kernel does not fit an SM at QB={qb}, "
                  f"{lut_floats} LUT entries per query, K={K}")
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]


def plan(probes, m: int, lut_floats: int, pq_m: int, K: int,
         device: torch.device) -> tuple[torch.Tensor, int, int, int]:
    """(the probe lists cut to their live width, QB, splits, slots per
    split) of a launch over ``m`` queries."""
    probes = probes[:, : live_slots(probes)].contiguous()
    qb = query_block(lut_floats)
    per_sm, _ = kernel_shape(device, qb, lut_floats, pq_m, K)
    splits, sps = SC.split_plan(m, probes.shape[1], qb, 1, per_sm * B.sm_count(device))
    return probes, qb, splits, sps


# pq_scan(probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S, W,
#         K, cell_cap, tile_m, threshold_skip, finalize, qb, splits, slots_per_split,
#         stream)
C_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


def pq_scan_partials(probes, luts, codes, hx, hy, k: int, *, cell_cap: int, ncodes: int,
                     tile_m: int, cell_extent, distance_finalize: str, qc=None,
                     threshold_skip: bool | None = None):
    """The kernel's own output: partial sets (values [S', m, K], ids
    [S', m, K]), split s over the s-th range of each tile's probe list.

    ``probes`` [ceil(m / tile_m), W] int32, row t the list of queries
    ``[t * tile_m, (t + 1) * tile_m)``; ``luts`` [m, pq_m * ncodes] fp32;
    ``codes`` [S, pq_m] uint8, cell-packed (S % cell_cap == 0); ``hx``
    [m, 1] and ``hy`` [1, S] fp32 (``+inf`` on dead slots); ``qc``
    [m, S / cell_cap] fp32 or None; ``cell_extent`` [S / cell_cap] int32,
    the leading slots of each cell to scan.  CPU tensors run the plain
    version, as one split; CUDA tensors launch the kernel.
    """
    global LAUNCHES, WIDE_LAUNCHES
    m, L = luts.shape
    S, pq_m = codes.shape
    K = T.next_pow2(k)
    B.require(distance_finalize in FINALIZE_CODES,
              lambda: f"unknown finalizer {distance_finalize!r}")
    B.require(2 <= ncodes <= 256 and ncodes & (ncodes - 1) == 0,
              lambda: f"ncodes={ncodes}: want a power of 2 in [2, 256]")
    B.require(L == pq_m * ncodes,
              lambda: f"luts: want [{m}, {pq_m} * {ncodes}], got {tuple(luts.shape)}")
    B.require(cell_cap > 0 and S % cell_cap == 0, lambda: f"S={S} is not a multiple of {cell_cap}")
    ncells = S // cell_cap
    B.require(codes.dtype == torch.uint8 and codes.is_contiguous(),
              lambda: f"codes: want contiguous uint8 [S, pq_m], got {codes.dtype}")
    B.require(probes.dtype == torch.int32 and probes.dim() == 2
              and probes.shape[0] == -(-m // tile_m) and probes.shape[1] > 0
              and probes.is_contiguous(),
              lambda: f"probes: want contiguous int32 [{-(-m // tile_m)}, W], got "
              f"{probes.dtype} {tuple(probes.shape)}")
    for name, t, shape in (("luts", luts, (m, L)), ("hx", hx, (m, 1)), ("hy", hy, (1, S))):
        B.require_f32(name, t, shape)
    if qc is not None:
        B.require_f32("qc", qc, (m, ncells))
    B.require(cell_extent.dtype == torch.int32 and tuple(cell_extent.shape) == (ncells,)
              and cell_extent.is_contiguous(),
              lambda: f"cell_extent: want contiguous int32 [{ncells}], got "
              f"{cell_extent.dtype} {tuple(cell_extent.shape)}")
    if not B.on_cuda(probes, luts, codes, hx, hy, cell_extent, *([] if qc is None else [qc])):
        v, i = pq_scan_plain(probes, luts, codes, hx, hy, k, cell_cap=cell_cap, ncodes=ncodes,
                             tile_m=tile_m, cell_extent=cell_extent,
                             finalize=distance_finalize, qc=qc)
        return v[None], i[None]
    require_card_k(K, "pq_scan")
    dev = luts.device
    if m == 0:
        return (torch.full((1, 0, K), T.POS_INF, device=dev),
                torch.full((1, 0, K), -1, dtype=torch.int32, device=dev))
    B.require(codes.data_ptr() % 4 == 0, "codes must be aligned to 4 bytes")
    probes, qb, splits, sps = plan(probes, m, L, pq_m, K, dev)
    W = probes.shape[1]
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("pq_scan", "pq_scan", C_ARGTYPES, dev,
             B.ptr(probes), B.ptr(cell_extent), B.ptr(luts), B.ptr(codes), B.ptr(qc),
             B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx), m, pq_m, ncodes, S, W, K,
             cell_cap, tile_m, int(skip), FINALIZE_CODES[distance_finalize], qb, splits, sps)
    LAUNCHES += 1
    WIDE_LAUNCHES += K > MAX_K
    return vals, idx


def pq_scan(probes, luts, codes, hx, hy, k: int, **kw):
    """Cell-probed ADC scan over prebuilt operands; (values [m, K], packed
    slot ids [m, K]).  The operands and keywords are
    ``pq_scan_partials``'s; a split list's partial sets are merged by the
    merge kernel."""
    vals, idx = pq_scan_partials(probes, luts, codes, hx, hy, k, **kw)
    if vals.shape[0] == 1:
        return vals[0], idx[0]
    return merge_partials(vals, idx)
