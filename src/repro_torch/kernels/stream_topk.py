"""Phase 2 of the paper: per-row k smallest of a matrix, as a CUDA kernel.

Replaces ``repro/kernels/stream_topk.py::stream_topk_pallas`` (bodies
``_kernel`` and ``_tile_reduce_topk``).  Source: ``csrc/stream_topk.cu``,
selection in ``csrc/select.cuh``.

Bound on the H100: bytes (each element of x is read once for a few
compares).  One warp streams one row with coalesced loads and keeps the
row's ascending K-buffer in shared memory; the threshold skip is a ballot
over 32 candidates, uniform across the warp.

Result contract: the K = next_pow2(k) smallest of each row by (value,
column), ascending, with ``+inf`` slots carrying id ``-1``.
``stream_topk_plain`` is that contract in plain PyTorch (a stable sort).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B

LAUNCHES = 0
MAX_K = 256
# The plain version sorts this many elements at a time, to bound its memory.
_PLAIN_CHUNK = 1 << 27


def sorted_prefix(x: torch.Tensor, K: int):
    """First K of each row of ``x`` by (value, column); +inf -> id -1."""
    m, n = x.shape
    if n < K:
        x = torch.cat([x, torch.full((m, K - n), T.POS_INF, dtype=x.dtype,
                                     device=x.device)], dim=1)
    rows = max(1, _PLAIN_CHUNK // max(n, 1))
    vals, idx = [], []
    for r0 in range(0, m, rows):
        v, i = torch.sort(x[r0 : r0 + rows], dim=1, stable=True)
        vals.append(v[:, :K])
        idx.append(i[:, :K])
    v = torch.cat(vals) if vals else x[:, :K]
    i = torch.cat(idx) if idx else torch.zeros((0, K), dtype=torch.int64, device=x.device)
    i = torch.where(v < T.POS_INF, i, torch.full_like(i, -1))
    return v, i.to(torch.int32)


def stream_topk_plain(x: torch.Tensor, k: int):
    """(values [m, K], ids [m, K]), K = next_pow2(k), by a stable sort."""
    return sorted_prefix(x, T.next_pow2(k))


# stream_topk_f32(x, out_v, out_i, m, n, K, threshold_skip, stream)
C_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]



def stream_topk(x: torch.Tensor, k: int, *, threshold_skip: bool | None = None):
    """Ascending K = next_pow2(k) smallest of each row of ``x`` [m, n].

    Returns (values [m, K] fp32, ids [m, K] int32).  ``threshold_skip``
    (default on) changes the work, never the result.  CPU tensors run the
    plain version; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    m, n = x.shape
    K = T.next_pow2(k)
    B.require(K <= MAX_K, f"K = next_pow2(k) = {K} exceeds the kernel's {MAX_K}")
    B.require_f32("x", x, (m, n))
    if not B.on_cuda(x):
        return stream_topk_plain(x, k)
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((m, K), dtype=torch.float32, device=x.device)
    idx = torch.empty((m, K), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return vals.fill_(T.POS_INF), idx.fill_(-1)
    B.launch("stream_topk", "stream_topk_f32", C_ARGTYPES, x.device,
             B.ptr(x), B.ptr(vals), B.ptr(idx), m, n, K, int(skip))
    LAUNCHES += 1
    return vals, idx
