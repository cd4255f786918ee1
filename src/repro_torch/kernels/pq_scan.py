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
Hopper lane can gather, so here the work is table lookups from shared
memory.  A CTA of 16 warps holds the tables of ``QB`` queries (a power of
two up to 8, from ``LUT_BUDGET``) and walks its union tile's probe list in
units of 32 slots of one cell; warp w scores unit w of each stage of 16 for
all QB queries, lane l slot l.  Two modes (``plan``):

* ring mode (``pq_m`` a multiple of 32, the tables within the budget, the
  codes aligned to 16 bytes): the tables transposed per block of 32
  subspaces to ``[code][32]``, each lane reading subspace ``(l + t) mod 32``
  at step t, so every lookup of a warp hits its own bank; each warp's codes
  staged ahead by ``cp.async`` into a ring of three units;
* generic mode (any other ``pq_m``, or a table past the budget, ROADMAP
  F2): the tables as stored, in chunks of ``chunk`` subspaces that fit,
  reloaded a stage at a time with the partial sums carried across chunks;
  the codes read from device memory.  Any table size serves.

The codes are the replica's own row-major ``[S, pq_m]`` array (the
reference transposes them for its lane axis): a unit is one contiguous run
of ``32 * pq_m`` bytes.  Selection is ``csrc/select.cuh``'s staged bulk
merge: per query a K-buffer and a staging area in shared memory, for every
K up to ``stream_topk.MAX_SELECT_K`` = 4096.

Bound on the H100: the table lookups.  The operations bound counts ``pq_m``
fp32 adds per (query, live row) pair at 67 TFLOP/s; the lookups are
shared-memory loads, at best one 32-lane wavefront a cycle per SM
(``lookup_floor_ms``).  Each cell is walked to its extent (one past its
last live slot), a slot that repeats its predecessor in the list is
skipped, and the list is split across CTAs when the query blocks cannot
fill the card (``merge_partials`` merges the partial sets, lower splits
winning ties as in one pass).

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
from typing import NamedTuple

import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import FINALIZERS
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.stream_topk import MAX_K, MAX_SELECT_K, require_card_k, sorted_prefix

LAUNCHES = 0
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)
MAX_QB = 8  # queries per CTA
LUT_BUDGET = 128 * 1024  # bytes of tables per CTA (one CTA an SM at pq_m 32, 8 bits)
RING_UNITS = 3  # units of 32 slots in each warp's code ring (csrc/pq_scan.cu kPqRing)
RING_BUDGET = 56 * 1024  # bytes of code rings per CTA, else generic mode
WARPS = 16  # warps of a CTA (csrc/pq_scan.cu kPqWarps)
STAGE_SLOTS = 32 * WARPS  # slots a stage: a unit of 32 a warp (kPqStage)
SMEM_LIMIT = 232448 - 2048  # a CTA's shared memory, less the static arrays


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
        cells = cells[(cells >= 0) & (cells < cell_extent.shape[0])]  # a slot naming no cell
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


def staging_cap(K: int) -> int:
    """A staging area's keys (csrc/select.cuh ``staging_cap``, floor
    ``2 * STAGE_SLOTS``)."""
    return min(MAX_SELECT_K, max(2 * STAGE_SLOTS, 2 * K))


def smem_bytes(qb: int, ring: bool, chunk: int, pq_m: int, ncodes: int, K: int) -> int:
    """Dynamic shared memory of a CTA (csrc/pq_scan.cu ``pq_smem_bytes``):
    each warp's code ring, the QB table chunks, K-buffers and staging
    areas."""
    return ((WARPS * RING_UNITS * 32 * (pq_m + 4) if ring else 0) + 4 * qb * chunk * ncodes
            + 8 * qb * (K + staging_cap(K)))


class Plan(NamedTuple):
    probes: torch.Tensor  # the probe lists, contiguous
    qb: int               # queries a CTA
    ring: bool            # ring mode (else generic)
    chunk: int            # subspaces of a staged table chunk (pq_m: the whole table)
    splits: int           # ranges of each tile's list, one CTA each
    slots_per_split: int


def kernel_mode(pq_m: int, ncodes: int, K: int, aligned: bool = True) -> tuple[int, bool, int]:
    """(QB, ring mode, chunk) for tables of ``pq_m * ncodes`` entries.

    A table within ``LUT_BUDGET`` is staged whole, QB of them as
    ``query_block`` gives, halved while the CTA's shared memory exceeds
    ``SMEM_LIMIT``; ring mode where ``pq_m`` is a multiple of 32, the ring
    fits ``RING_BUDGET`` and the codes are aligned to 16 bytes.  A larger
    table is staged in chunks, one query a CTA: the most subspaces (a
    multiple of 4 where ``pq_m`` is) whose chunk fits the budget.
    """
    lut = pq_m * ncodes
    if lut * 4 <= LUT_BUDGET:
        ring = (pq_m % 32 == 0 and aligned
                and WARPS * RING_UNITS * 32 * (pq_m + 4) <= RING_BUDGET)
        qb = query_block(lut)
        while qb > 1 and smem_bytes(qb, ring, pq_m, pq_m, ncodes, K) > SMEM_LIMIT:
            qb //= 2
        return qb, ring, pq_m
    chunk = max(1, LUT_BUDGET // (4 * ncodes))
    if pq_m % 4 == 0 and chunk >= 4:
        chunk -= chunk % 4
    return 1, False, min(chunk, pq_m)


def lookup_floor_ms(pairs: int, pq_m: int, sm_count: int = 132, clock_hz: float = 1.98e9) -> float:
    """The shared-memory floor of the lookups: ``pairs * pq_m`` loads, one
    32-lane wavefront a cycle per SM (H100 SXM: 132 SMs at 1.98 GHz)."""
    return pairs * pq_m / 32 / (sm_count * clock_hz) * 1e3


# pq_scan_occupancy(qb, ring, chunk, pq_m, ncodes, K, out[2])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]
_SHAPES: dict = {}


def kernel_shape(device: torch.device, qb: int, ring: bool, chunk: int, pq_m: int,
                 ncodes: int, K: int) -> tuple[int, int]:
    """(CTAs resident per SM, shared-memory bytes per CTA) of the kernel as
    compiled for QB and the mode, from the CUDA occupancy calculator."""
    key = (torch.device(device).index, qb, ring, chunk, pq_m, ncodes, K)
    if key not in _SHAPES:
        out = (ctypes.c_int * 2)()
        B.call("pq_scan", "pq_scan_occupancy", OCCUPANCY_ARGTYPES, device, qb, int(ring),
               chunk, pq_m, ncodes, K, out)
        B.require(out[0] > 0, lambda: f"the pq_scan kernel does not fit an SM at QB={qb}, "
                  f"ring {ring}, chunk {chunk} of pq_m {pq_m}, K={K}")
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]


def plan(probes, m: int, pq_m: int, ncodes: int, K: int, device: torch.device,
         tile_m: int, aligned: bool = True) -> Plan:
    """The launch over ``m`` queries: mode, QB (at most the largest power
    of 2 dividing ``tile_m`` when the batch spans several union tiles), and
    the split of each tile's list.  The lists are taken whole: the kernel
    skips a repeated slot as cheaply as the host could cut it, and cutting
    would read them back."""
    probes = probes.contiguous()
    qb, ring, chunk = kernel_mode(pq_m, ncodes, K, aligned)
    if m > tile_m:
        qb = min(qb, tile_m & -tile_m)
    per_sm, _ = kernel_shape(device, qb, ring, chunk, pq_m, ncodes, K)
    splits, sps = SC.split_plan(m, probes.shape[1], qb, 1, per_sm * B.sm_count(device))
    return Plan(probes, qb, ring, chunk, splits, sps)


# pq_scan(probes, extent, luts, codes, qc, hx, hy, out_v, out_i, m, pq_m, ncodes, S, W,
#         K, cell_cap, tile_m, threshold_skip, finalize, qb, splits, slots_per_split,
#         ring, chunk, stream)
C_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p]


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
    extra = [] if qc is None else [qc]
    if B.on_meta(probes, luts, codes, hx, hy, cell_extent, *extra):
        require_card_k(K, "pq_scan")
        v, i = B.meta_topk((1, m), K)
        # A ceiling: each tile's list probes min(W, ncells) whole cells.
        cols = min(probes.shape[1], ncells) * cell_cap
        B.shape_call("pq_scan", flops=1.0 * m * cols * pq_m,
                     nbytes=B.nbytes(probes, luts, hx, cell_extent, *extra, v, i)
                     + probes.shape[0] * cols * (pq_m + 4))
        return v, i
    if not B.on_cuda(probes, luts, codes, hx, hy, cell_extent, *extra):
        v, i = pq_scan_plain(probes, luts, codes, hx, hy, k, cell_cap=cell_cap, ncodes=ncodes,
                             tile_m=tile_m, cell_extent=cell_extent,
                             finalize=distance_finalize, qc=qc)
        return v[None], i[None]
    require_card_k(K, "pq_scan")
    dev = luts.device
    if m == 0:
        return (torch.full((1, 0, K), T.POS_INF, device=dev),
                torch.full((1, 0, K), -1, dtype=torch.int32, device=dev))
    B.require(pq_m % 4 != 0 or codes.data_ptr() % 4 == 0, "codes must be aligned to 4 bytes")
    pl = plan(probes, m, pq_m, ncodes, K, dev, tile_m, aligned=codes.data_ptr() % 16 == 0)
    probes, splits = pl.probes, pl.splits
    W = probes.shape[1]
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("pq_scan", "pq_scan", C_ARGTYPES, dev,
             B.ptr(probes), B.ptr(cell_extent), B.ptr(luts), B.ptr(codes), B.ptr(qc),
             B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx), m, pq_m, ncodes, S, W, K,
             cell_cap, tile_m, int(skip), FINALIZE_CODES[distance_finalize], pl.qb, splits,
             pl.slots_per_split, int(pl.ring), pl.chunk)
    B.count_launch(__name__, LAUNCHES=1, WIDE_LAUNCHES=K > MAX_K)
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
