"""Fused kNN: distance tile and top-K selection in one CUDA kernel.

Replaces ``repro/kernels/fused_knn.py::fused_knn_pallas`` (body ``_kernel``)
without the per-query mask.  Source: ``csrc/fused_knn.cu``, with
``csrc/gemm_tc.cuh`` for the tile product and its walk (``kernels/scan.py``
for what the wrapper shares with ``ivf_scan``) and ``csrc/select.cuh`` for
the selection.  ``gy`` is fp32, or a bf16 / int8 scan replica
(``core.distances.quantize_rows``) whose int8 rows carry a per-row
``gy_scale``: the kernel widens each element to fp32 as it stages it, and
folds the scale into the epilogue.  The ``q_mask`` operand belongs to the
filtered slice and raises here.

Bound on the H100: operations (2·m·n·d, as three TF32 passes on the tensor
cores, two for a bf16 / int8 ``gy``: ``kernels/tf32.py``; the [m, n]
distances never reach device memory).  One CTA owns BM query rows (128
where K <= 32, else 64: ``block_rows``) and walks a range of 128-column
database tiles, keeping each row's K-buffer in shared memory.  When the query tiles alone cannot fill the card
(a serving batch), the database axis is split across CTAs and a second
kernel (``merge_partials``) merges the partial sets; ``plan`` picks BM and
the split from what the compiled kernel reports of its occupancy.

Result contract, the same as the reference's: per query the K =
next_pow2(k) smallest of ``finalize(alpha * (fx @ gy^T) * gy_scale + hx +
hy)`` by (value, column), ascending, over columns < ``n_real`` (and != the
row with ``exclude_self``), ``+inf`` slots carrying id ``-1``.
``fused_knn_plain`` computes it in plain PyTorch: matmul form, mask, stable
sort, take K.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC
from repro_torch.kernels.merge_partials import merge_partials
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.stream_topk import MAX_K, sorted_prefix

LAUNCHES = 0
WIDE_MAX_K = 32  # the widest K of the kernel's 128-row layout (csrc/fused_knn.cu kWideMaxK)


def fused_knn_plain(fx, gy, hx, hy, k: int, *, alpha: float, finalize: str,
                    n_real: int, exclude_self: bool = False, gy_scale=None):
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
        v, i = sorted_prefix(torch.where(dead, T.POS_INF, tile), K)
        vals.append(v)
        idx.append(i)
    if not vals:
        return sorted_prefix(torch.zeros((0, n), device=fx.device), K)
    return torch.cat(vals), torch.cat(idx)


def block_rows(m: int, K: int) -> int:
    """BM, the query rows of a CTA: 128 where the K-buffers leave the room
    (K <= 32) and the batch fills them, else 64."""
    return 128 if (K <= WIDE_MAX_K and m > 64) else 64


def plan(m: int, n: int, K: int, device: torch.device, gy_dtype=torch.float32,
         scaled: bool = False) -> tuple[int, int, int]:
    """(BM, splits, tiles per split) for an [m] x [n] search at width K."""
    bm = block_rows(m, K)
    per_sm, tile_n, _ = SC.kernel_shape("fused_knn", device, bm, K, gy_dtype, scaled)
    return (bm, *SC.split_plan(m, n, bm, tile_n, per_sm * B.sm_count(device)))


# fused_knn(fx, gy, gs, hx, hy, out_v, out_i, m, n, d, K, n_real, exclude_self,
#           threshold_skip, alpha, finalize, gy_dtype, bm, splits,
#           tiles_per_split, stream)
C_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float]
              + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def fused_knn_partials(fx, gy, hx, hy, k: int, *, distance_finalize: str, alpha: float,
                       n_real: int, exclude_self: bool = False,
                       threshold_skip: bool | None = None, gy_scale=None, q_mask=None):
    """The fused kernel's own output: partial sets (values [S, m, K], ids
    [S, m, K]), split s over the s-th range of database tiles of ``plan``.

    ``fx`` [m, d], ``hx`` [m, 1], ``hy`` [1, n] fp32; ``gy`` [n, d] fp32,
    bf16 or int8, with ``gy_scale`` [1, n] fp32 or None; all contiguous.
    Dead database rows carry ``hy = +inf``.  CPU tensors run the plain
    version, as one split; CUDA tensors launch the kernel (d % 4 == 0).
    """
    global LAUNCHES
    if q_mask is not None:
        raise NotImplementedError("q_mask (per-query filters) comes with the filtered slice")
    m, d = fx.shape
    n = gy.shape[0]
    K = T.next_pow2(k)
    B.require(K <= MAX_K, f"K = next_pow2(k) = {K} exceeds the kernel's {MAX_K}")
    B.require(distance_finalize in FINALIZE_CODES, f"unknown finalizer {distance_finalize!r}")
    B.require(0 <= n_real <= n, f"n_real={n_real} outside [0, {n}]")
    SC.check_scan_operands(fx, gy, hx, hy, gy_scale)
    if not B.on_cuda(fx, gy, hx, hy, *([] if gy_scale is None else [gy_scale])):
        v, i = fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize=distance_finalize,
                               n_real=n_real, exclude_self=exclude_self, gy_scale=gy_scale)
        return v[None], i[None]
    B.require_vec4(d, fx, gy)
    dev = fx.device
    if m == 0 or n == 0:
        return (torch.full((1, m, K), T.POS_INF, device=dev),
                torch.full((1, m, K), -1, dtype=torch.int32, device=dev))
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    bm, splits, tps = plan(m, n, K, dev, gy.dtype, gy_scale is not None)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=dev)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
    B.launch("fused_knn", "fused_knn", C_ARGTYPES, dev,
             B.ptr(fx), B.ptr(gy), B.ptr(gy_scale), B.ptr(hx), B.ptr(hy), B.ptr(vals),
             B.ptr(idx), m, n, d, K, n_real, int(exclude_self), int(skip), float(alpha),
             FINALIZE_CODES[distance_finalize], SC.GY_CODES[gy.dtype], bm, splits, tps)
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
