"""Fused kNN: distance tile and top-K selection in one CUDA kernel.

Replaces ``repro/kernels/fused_knn.py::fused_knn_pallas`` (body ``_kernel``).
Source: ``csrc/fused_knn.cuh``, built as ``csrc/fused_knn.cu`` (unmasked)
and ``csrc/fused_knn_masked.cu`` (with ``q_mask``), with
``csrc/gemm_tc.cuh`` for the tile product and its walk (``kernels/scan.py``
for what the wrapper shares with ``ivf_scan``, whose kernel is this one
walking a tile table) and ``csrc/select.cuh`` for the selection.  ``gy`` is fp32,
or a bf16 / int8 scan replica (``core.distances.quantize_rows``) whose int8
rows carry a per-row ``gy_scale``: the kernel widens each element to fp32
as it stages it, and folds the scale into the epilogue.

``q_mask`` is the reference's per-query filter (DESIGN.md §17) in the
port's own format: a bit-packed bitmap, int32 words holding uint32 bits,
``[m, ceil(n / 32)]`` (or one row ``[1, ceil(n / 32)]`` shared by the
batch), bit ``c % 32`` of word ``c // 32`` of row ``i`` set where query
``i`` may see column ``c`` (``pack_mask`` / ``unpack_mask``).  A masked
column scores ``+inf`` and never enters, as a column past ``n_real``.

Bound on the H100: operations (2·m·n·d, as three TF32 passes on the tensor
cores, two for a bf16 / int8 ``gy``: ``kernels/tf32.py``; the [m, n]
distances never reach device memory).  One CTA owns BM query rows (128
where K <= 32, else 64: ``block_rows``) and walks a range of 128-column
database tiles, keeping each row's K-buffer in shared memory.  When the query tiles alone cannot fill the card
(a serving batch), the database axis is split across CTAs and a second
kernel (``merge_partials``) merges the partial sets; ``plan`` picks BM and
the split from what the compiled kernel reports of its occupancy.

K: up to ``MAX_SELECT_K`` = 4096 on the card.  Up to 256 a CTA keeps its
rows' K-buffers in shared memory; K = 512 to 4096 keep them in the
kernel's own ``[splits, m, K]`` output, fed by staging areas in shared
memory that each row's warp sorts and merges into its row in one pass
(``csrc/fused_knn.cuh``, ``csrc/select.cuh``).  A CPU tensor serves any K.

Result contract, the same as the reference's: per query the K =
next_pow2(k) smallest of ``finalize(alpha * (fx @ gy^T) * gy_scale + hx +
hy)`` by (value, column), ascending, over columns < ``n_real`` (and != the
row with ``exclude_self``, and allowed by ``q_mask``), ``+inf`` slots
carrying id ``-1``; a row with fewer than K such columns ends in ``+inf``
slots.  ``fused_knn_plain`` computes it in plain PyTorch: matmul form,
masks, stable sort, take K.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.scan import WIDE_MAX_K, block_rows  # noqa: F401 (the layout rule)
from repro_torch.kernels.stream_topk import MAX_K, require_card_k, sorted_prefix

LAUNCHES = 0
MASKED_LAUNCHES = 0  # launches with a q_mask (counted in LAUNCHES too)
WIDE_LAUNCHES = 0  # launches at K > 256, K-buffers in the output (in LAUNCHES too)
_BIT = torch.arange(32, dtype=torch.int64)


def mask_words(n: int) -> int:
    """Words of a packed bitmap row over ``n`` columns."""
    return -(-n // 32)


def pack_mask(allowed: torch.Tensor) -> torch.Tensor:
    """bool [r, n] -> the packed bitmap, int32 [r, ceil(n / 32)]: bit
    ``c % 32`` of word ``c // 32`` is ``allowed[:, c]`` (LSB first); the
    bits past ``n`` are 0.  int32 holds the uint32 bits (bit 31 the sign).
    A block of rows at a time, to bound the int64 scratch."""
    r, n = allowed.shape
    W = mask_words(n)
    out = torch.empty((r, W), dtype=torch.int32, device=allowed.device)
    bit = _BIT.to(allowed.device)
    rows = max(1, SC.PLAIN_CHUNK // max(W * 32, 1))
    for r0 in range(0, r, rows):
        blk = allowed[r0 : r0 + rows]
        bits = torch.zeros((blk.shape[0], W * 32), dtype=torch.int64, device=allowed.device)
        bits[:, :n] = blk
        words = (bits.view(-1, W, 32) << bit).sum(2)
        out[r0 : r0 + rows] = torch.where(words >= 2**31, words - 2**32, words)
    return out


def unpack_mask(words: torch.Tensor, n: int) -> torch.Tensor:
    """The packed bitmap [r, >= ceil(n / 32)] -> bool [r, n]."""
    col = torch.arange(n, device=words.device)
    return ((words[:, col // 32] >> (col % 32).to(torch.int32)) & 1).bool()


def mask_bits_at(words: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Bit ``cols[i, j]`` of row ``i`` of the bitmap (row 0 for a shared
    row), bool of ``cols``' shape; a negative column reads False."""
    safe = cols.clamp(min=0).long()
    w = words.expand(cols.shape[0], -1).gather(1, safe // 32)
    return (((w >> (safe % 32).to(torch.int32)) & 1) == 1) & (cols >= 0)


def check_mask(q_mask, m: int, n: int) -> None:
    """A packed bitmap for ``m`` queries over ``n`` columns: int32, [m, W]
    or a shared row [1, W], W >= ceil(n / 32), each row contiguous."""
    B.require(q_mask.dtype == torch.int32 and q_mask.dim() == 2
              and q_mask.shape[0] in (1, m) and q_mask.shape[1] >= mask_words(n)
              and q_mask.stride(1) == 1,
              lambda: f"q_mask: want int32 [{m} or 1, >= {mask_words(n)}] packed words, got "
              f"{q_mask.dtype} {tuple(q_mask.shape)}")


def fused_knn_plain(fx, gy, hx, hy, k: int, *, alpha: float, finalize: str,
                    n_real: int, exclude_self: bool = False, gy_scale=None, q_mask=None):
    """The fused kernel's function in plain PyTorch, a block of rows at a time."""
    m, n = fx.shape[0], gy.shape[0]
    K = T.next_pow2(k)
    rows = max(1, SC.PLAIN_CHUNK // max(n, 1))
    col = torch.arange(n, device=fx.device)
    gy = gy.float()
    vals, idx = [], []
    for r0 in range(0, m, rows):
        tile = SC.scan_tile_plain(fx[r0 : r0 + rows], gy, hx[r0 : r0 + rows], hy,
                                  alpha=alpha, finalize=finalize, gy_scale=gy_scale)
        dead = (col >= n_real)[None, :]
        if exclude_self:
            row = torch.arange(r0, r0 + tile.shape[0], device=fx.device)
            dead = dead | (row[:, None] == col[None, :])
        if q_mask is not None:
            words = q_mask if q_mask.shape[0] == 1 else q_mask[r0 : r0 + tile.shape[0]]
            dead = dead | ~unpack_mask(words, n)
        v, i = sorted_prefix(torch.where(dead, T.POS_INF, tile), K)
        vals.append(v)
        idx.append(i)
    if not vals:
        return sorted_prefix(torch.zeros((0, n), device=fx.device), K)
    return torch.cat(vals), torch.cat(idx)


def plan(m: int, n: int, K: int, device: torch.device, gy_dtype=torch.float32,
         scaled: bool = False, masked: bool = False) -> tuple[int, int, int]:
    """(BM, splits, tiles per split) for an [m] x [n] search at width K."""
    bm = block_rows(m, K)
    per_sm, tile_n, _ = SC.kernel_shape(_library(masked), device, bm, K, gy_dtype, scaled)
    return (bm, *SC.split_plan(m, n, bm, tile_n, per_sm * B.sm_count(device)))


def _library(masked: bool) -> str:
    """The library (and entry point) of the masked or the unmasked kernels."""
    return "fused_knn_masked" if masked else "fused_knn"


# fused_knn(fx, gy, gs, hx, hy, out_v, out_i, m, n, d, K, n_real, exclude_self,
#           threshold_skip, alpha, finalize, gy_dtype, bm, splits,
#           tiles_per_split, stream)
C_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])
# fused_knn_masked(fx, gy, gs, qm, hx, hy, out_v, out_i, m, n, d, K, n_real,
#                  qm_stride, exclude_self, threshold_skip, alpha, finalize,
#                  gy_dtype, bm, splits, tiles_per_split, stream)
MASKED_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fused_knn_partials(fx, gy, hx, hy, k: int, *, distance_finalize: str, alpha: float,
                       n_real: int, exclude_self: bool = False,
                       threshold_skip: bool | None = None, gy_scale=None, q_mask=None):
    """The fused kernel's own output: partial sets (values [S, m, K], ids
    [S, m, K]), split s over the s-th range of database tiles of ``plan``.

    ``fx`` [m, d], ``hx`` [m, 1], ``hy`` [1, n] fp32; ``gy`` [n, d] fp32,
    bf16 or int8, with ``gy_scale`` [1, n] fp32 or None; all contiguous.
    Dead database rows carry ``hy = +inf``.  ``q_mask``: the packed bitmap
    (``check_mask``) or None.  CPU tensors run the plain version, as one
    split, at any K; CUDA tensors launch the kernel (d % 4 == 0, K <=
    ``stream_topk.MAX_SELECT_K``).
    """
    m, d = fx.shape
    n = gy.shape[0]
    K = T.next_pow2(k)
    B.require(distance_finalize in FINALIZE_CODES,
              lambda: f"unknown finalizer {distance_finalize!r}")
    B.require(0 <= n_real <= n, lambda: f"n_real={n_real} outside [0, {n}]")
    SC.check_scan_operands(fx, gy, hx, hy, gy_scale)
    extra = [t for t in (gy_scale, q_mask) if t is not None]
    if q_mask is not None:
        check_mask(q_mask, m, n)
    if B.on_meta(fx, gy, hx, hy, *extra):
        require_card_k(K, "fused_knn")
        B.require_vec4(d, fx, gy)
        v, i = B.meta_topk((1, m), K)
        B.shape_call("fused_knn", flops=2.0 * m * n * d,
                     nbytes=B.nbytes(fx, gy, hx, hy, *extra, v, i))
        return v, i
    if not B.on_cuda(fx, gy, hx, hy, *extra):
        v, i = fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize=distance_finalize,
                               n_real=n_real, exclude_self=exclude_self, gy_scale=gy_scale,
                               q_mask=q_mask)
        return v[None], i[None]
    require_card_k(K, "fused_knn")
    B.require_vec4(d, fx, gy)
    dev = fx.device
    if m == 0 or n == 0:
        return (torch.full((1, m, K), T.POS_INF, device=dev),
                torch.full((1, m, K), -1, dtype=torch.int32, device=dev))
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    masked = q_mask is not None
    bm, splits, tps = plan(m, n, K, dev, gy.dtype, gy_scale is not None, masked)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    tail = (int(skip), float(alpha), FINALIZE_CODES[distance_finalize], SC.GY_CODES[gy.dtype],
            bm, splits, tps)
    if masked:
        qm_stride = 0 if q_mask.shape[0] == 1 else q_mask.stride(0)
        B.launch("fused_knn_masked", "fused_knn_masked", MASKED_ARGTYPES, dev,
                 B.ptr(fx), B.ptr(gy), B.ptr(gy_scale), B.ptr(q_mask), B.ptr(hx), B.ptr(hy),
                 B.ptr(vals), B.ptr(idx), m, n, d, K, n_real, qm_stride, int(exclude_self),
                 *tail)
    else:
        B.launch("fused_knn", "fused_knn", C_ARGTYPES, dev,
                 B.ptr(fx), B.ptr(gy), B.ptr(gy_scale), B.ptr(hx), B.ptr(hy), B.ptr(vals),
                 B.ptr(idx), m, n, d, K, n_real, int(exclude_self), *tail)
    B.count_launch(__name__, LAUNCHES=1, MASKED_LAUNCHES=masked, WIDE_LAUNCHES=K > MAX_K)
    return vals, idx


def fused_knn(fx, gy, hx, hy, k: int, **kw):
    """Fused kNN over matmul-form operands; (values [m, K], ids [m, K]).

    The operands and keywords are ``fused_knn_partials``'s.  Where the
    database axis was split, the merge kernel joins the partial sets.
    """
    vals, idx = fused_knn_partials(fx, gy, hx, hy, k, **kw)
    if vals.shape[0] == 1:
        return vals[0], idx[0]
    return merge_partials(vals, idx)
