"""Phase 2 of the paper: per-row k smallest of a matrix, as a CUDA kernel.

Replaces ``repro/kernels/stream_topk.py::stream_topk_pallas`` (bodies
``_kernel`` and ``_tile_reduce_topk``).  Source: ``csrc/stream_topk.cu``,
selection in ``csrc/select.cuh``.

Bound on the H100: bytes (each element of x is read once for a few
compares).  One warp streams one row with coalesced loads and keeps the
row's ascending K-buffer in shared memory; the threshold skip is a ballot
over 32 candidates, uniform across the warp.

K: up to ``MAX_SELECT_K`` = 4096 on the card, the cap of every selection
kernel.  Up to ``MAX_K`` = 256 the K-buffer sits in shared memory; a wider
K runs the kernel's wide instantiation, whose K-buffer is the output's row
in device memory.  A CPU tensor serves any K.

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
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)
# The width of the shared-memory K-buffer (csrc/select.cuh kMaxK): past it a
# kernel switches to its wide instantiation, K-buffers in device memory.
MAX_K = 256
# The widest K any selection kernel takes on the card (select.cuh kMaxSelectK).
MAX_SELECT_K = 4096
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


def require_card_k(K: int, kernel: str) -> None:
    """Refuse a fetch width past ``MAX_SELECT_K`` on the card, naming the
    cap, which every selection kernel shares; a CPU tensor's plain version
    serves any K."""
    B.require(K <= MAX_SELECT_K, lambda: f"K = next_pow2(k) = {K} exceeds the {kernel} kernel's "
              f"{MAX_SELECT_K} on the card (CPU tensors serve any K)")


def stream_topk_plain(x: torch.Tensor, k: int):
    """(values [m, K], ids [m, K]), K = next_pow2(k), by a stable sort."""
    return sorted_prefix(x, T.next_pow2(k))


# stream_topk_f32(x, out_v, out_i, m, n, K, threshold_skip, stream)
C_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]



def stream_topk(x: torch.Tensor, k: int, *, threshold_skip: bool | None = None):
    """Ascending K = next_pow2(k) smallest of each row of ``x`` [m, n].

    Returns (values [m, K] fp32, ids [m, K] int32).  ``threshold_skip``
    (default on) changes the work, never the result.  CPU tensors run the
    plain version at any K; CUDA tensors launch the kernel (K <= 4096).
    """
    global LAUNCHES, WIDE_LAUNCHES
    m, n = x.shape
    K = T.next_pow2(k)
    B.require_f32("x", x, (m, n))
    if not B.on_cuda(x):
        return stream_topk_plain(x, k)
    require_card_k(K, "stream_topk")
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    vals = torch.empty((m, K), dtype=torch.float32, device=x.device)
    idx = torch.empty((m, K), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return vals.fill_(T.POS_INF), idx.fill_(-1)
    B.launch("stream_topk", "stream_topk_f32", C_ARGTYPES, x.device,
             B.ptr(x), B.ptr(vals), B.ptr(idx), m, n, K, int(skip))
    LAUNCHES += 1
    WIDE_LAUNCHES += K > MAX_K
    return vals, idx
