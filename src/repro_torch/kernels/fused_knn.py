"""Fused kNN: distance tile and top-K selection in one CUDA kernel.

Replaces ``repro/kernels/fused_knn.py::fused_knn_pallas`` (body ``_kernel``)
for an fp32 ``gy`` without a per-query mask.  Source: ``csrc/fused_knn.cu``,
with ``csrc/gemm.cuh`` for the tile product and ``csrc/select.cuh`` for the
selection.  The bf16/int8 ``gy`` with ``gy_scale`` and the ``q_mask``
operand belong to the quantized and filtered paths and raise here.

Bound on the H100: operations (2·m·n·d fp32 FMAs; the [m, n] distances never
reach device memory).  One CTA owns BM query rows and walks a range of
128-column database tiles, keeping each row's K-buffer in shared memory.
When the query tiles alone cannot fill the card (a serving batch), the
database axis is split across CTAs and a second kernel
(``merge_partials``) merges the partial sets; ``plan`` picks BM and the
split from what the compiled kernel reports of its occupancy.

Result contract, the same as the reference's: per query the K =
next_pow2(k) smallest of ``finalize(alpha * fx @ gy^T + hx + hy)`` by
(value, column), ascending, over columns < ``n_real`` (and != the row with
``exclude_self``), ``+inf`` slots carrying id ``-1``.  ``fused_knn_plain``
computes it in plain PyTorch: matmul form, mask, stable sort, take K.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES, pairwise_distance_plain
from repro_torch.kernels.stream_topk import MAX_K, sorted_prefix

LAUNCHES = 0
_PLAIN_CHUNK = 1 << 27
_SHAPES: dict = {}


def fused_knn_plain(fx, gy, hx, hy, k: int, *, alpha: float, finalize: str,
                    n_real: int, exclude_self: bool = False):
    """The fused kernel's function in plain PyTorch, a block of rows at a time."""
    m, n = fx.shape[0], gy.shape[0]
    K = T.next_pow2(k)
    rows = max(1, _PLAIN_CHUNK // max(n, 1))
    col = torch.arange(n, device=fx.device)
    vals, idx = [], []
    for r0 in range(0, m, rows):
        tile = pairwise_distance_plain(fx[r0 : r0 + rows], gy, hx[r0 : r0 + rows], hy,
                                       alpha=alpha, finalize=finalize)
        dead = (col >= n_real)[None, :]
        if exclude_self:
            row = torch.arange(r0, r0 + tile.shape[0], device=fx.device)
            dead = dead | (row[:, None] == col[None, :])
        v, i = sorted_prefix(torch.where(dead, T.POS_INF, tile), K)
        vals.append(v)
        idx.append(i)
    if not vals:
        return sorted_prefix(torch.zeros((0, n), device=fx.device), K)
    return torch.cat(vals), torch.cat(idx)


def block_rows(m: int, K: int) -> int:
    """BM: 128 query rows per CTA, or 64 where the K-buffers need the room
    (K = 256) or the batch is small."""
    return 128 if (K <= 128 and m > 64) else 64


def split_plan(m: int, n: int, bm: int, tile_n: int, resident: int) -> tuple[int, int]:
    """(splits, tiles per split) of the database axis.

    The axis is split until the grid fills the card's ``resident`` CTAs
    once, and never past that: a second, partial wave would take as long
    as the first.  With at least ``resident`` query tiles it is not split.
    """
    row_tiles = -(-m // bm)
    n_tiles = -(-n // tile_n)
    splits = max(1, min(n_tiles, resident // row_tiles))
    tps = -(-n_tiles // splits)
    return -(-n_tiles // tps), tps


def kernel_shape(device: torch.device, bm: int, K: int) -> tuple[int, int, int]:
    """(CTAs resident per SM, columns per tile, shared-memory bytes per CTA)
    of the compiled kernel at BM and K, as the CUDA occupancy calculator
    gives them for its registers and shared memory."""
    key = (torch.device(device).index, bm, K)
    if key not in _SHAPES:
        out = (ctypes.c_int * 3)()
        B.call("fused_knn", "fused_knn_occupancy", OCCUPANCY_ARGTYPES, device, bm, K, out)
        B.require(out[0] > 0, f"the fused kernel does not fit an SM at BM={bm}, K={K}")
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]


def plan(m: int, n: int, K: int, device: torch.device) -> tuple[int, int, int]:
    """(BM, splits, tiles per split) for an [m] x [n] search at width K."""
    bm = block_rows(m, K)
    per_sm, tile_n, _ = kernel_shape(device, bm, K)
    return (bm, *split_plan(m, n, bm, tile_n, per_sm * B.sm_count(device)))


# fused_knn_f32(fx, gy, hx, hy, out_v, out_i, m, n, d, K, n_real, exclude_self,
#               threshold_skip, alpha, finalize, bm, splits, tiles_per_split,
#               stream)
C_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float]
              + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# fused_knn_occupancy(bm, K, out[3])
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def fused_knn_partials(fx, gy, hx, hy, k: int, *, distance_finalize: str, alpha: float,
                       n_real: int, exclude_self: bool = False,
                       threshold_skip: bool | None = None, gy_scale=None, q_mask=None):
    """The fused kernel's own output: partial sets (values [S, m, K], ids
    [S, m, K]), split s over the s-th range of database tiles of ``plan``.

    ``fx`` [m, d], ``gy`` [n, d], ``hx`` [m, 1], ``hy`` [1, n] fp32 and
    contiguous.  Dead database rows carry ``hy = +inf``.  CPU tensors run
    the plain version, as one split; CUDA tensors launch the kernel
    (d % 4 == 0).
    """
    global LAUNCHES
    if gy_scale is not None or q_mask is not None or gy.dtype in (torch.bfloat16, torch.int8):
        raise NotImplementedError(
            "gy_scale (bf16/int8 gy) and q_mask come with the quantized and "
            "filtered slices of the port")
    m, d = fx.shape
    n = gy.shape[0]
    K = T.next_pow2(k)
    B.require(K <= MAX_K, f"K = next_pow2(k) = {K} exceeds the kernel's {MAX_K}")
    B.require(distance_finalize in FINALIZE_CODES, f"unknown finalizer {distance_finalize!r}")
    B.require(0 <= n_real <= n, f"n_real={n_real} outside [0, {n}]")
    for name, t, shape in (("fx", fx, (m, d)), ("gy", gy, (n, d)),
                           ("hx", hx, (m, 1)), ("hy", hy, (1, n))):
        B.require_f32(name, t, shape)
    if not B.on_cuda(fx, gy, hx, hy):
        v, i = fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize=distance_finalize,
                               n_real=n_real, exclude_self=exclude_self)
        return v[None], i[None]
    B.require_vec4(d, fx, gy)
    dev = fx.device
    if m == 0 or n == 0:
        return (torch.full((1, m, K), T.POS_INF, device=dev),
                torch.full((1, m, K), -1, dtype=torch.int32, device=dev))
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    bm, splits, tps = plan(m, n, K, dev)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("fused_knn", "fused_knn_f32", C_ARGTYPES, dev,
             B.ptr(fx), B.ptr(gy), B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx),
             m, n, d, K, n_real, int(exclude_self), int(skip), float(alpha),
             FINALIZE_CODES[distance_finalize], bm, splits, tps)
    LAUNCHES += 1
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
