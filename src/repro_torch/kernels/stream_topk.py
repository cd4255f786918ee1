"""Phase 2 of the paper: per-row k smallest of a matrix, as a CUDA kernel.

Replaces ``repro/kernels/stream_topk.py::stream_topk_pallas`` (bodies
``_kernel`` and ``_tile_reduce_topk``).  Source: ``csrc/stream_topk.cu``,
selection in ``csrc/select.cuh`` (the staged bulk merge).

Bound on the H100: bytes (each element of x is read once for a compare).
A CTA streams a row through a ring of shared-memory stages filled by
``cp.async`` and keeps the row's ascending K-buffer and a staging area in
shared memory: a column that beats the K-th entry is staged, and the CTA
sorts and merges the staging area into the buffer when it nears full.
When the rows are too few to fill the card, each row's columns are split
across CTAs (``plan``) and the partial sets merged by ``merge_partials``.

K: up to ``MAX_SELECT_K`` = 4096 on the card, the cap of every selection
kernel, for one kernel at every K (``MAX_K`` = 256 is where the other
selection kernels switch to their wide instantiation; ``WIDE_LAUNCHES``
counts this kernel's launches past it).  A CPU tensor serves any K.

Result contract: the K = next_pow2(k) smallest of each row by (value,
column), ascending, with ``+inf`` slots carrying id ``-1``.
``stream_topk_plain`` is that contract in plain PyTorch (a stable sort).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels import scan as SC

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


# stream_topk_occupancy(K, out[4])
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_void_p]
# stream_topk_f32(x, out_v, out_i, m, n, K, threshold_skip, vec, splits, cols_per_split, stream)
C_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
STAGE_COLS = 1024  # columns a stage of the ring (csrc/stream_topk.cu kStStage)
_SHAPES: dict = {}


def kernel_shape(device: torch.device, K: int) -> dict:
    """The kernel as compiled for K: CTAs resident per SM, shared-memory
    bytes per CTA, stages in the ring and bytes a stage, from the CUDA
    occupancy calculator."""
    key = (torch.device(device).index, K)
    if key not in _SHAPES:
        out = (ctypes.c_int * 4)()
        B.call("stream_topk", "stream_topk_occupancy", OCCUPANCY_ARGTYPES, device, K, out)
        B.require(out[0] > 0, lambda: f"the stream_topk kernel does not fit an SM at K={K}")
        _SHAPES[key] = {"ctas_per_sm": out[0], "smem_bytes": out[1], "ring_stages": out[2],
                        "stage_bytes": out[3]}
    return _SHAPES[key]


def split_columns(m: int, n: int, K: int, resident: int) -> tuple[int, int]:
    """(splits, columns per split) of each row: the columns are split while
    the rows cannot fill the card's ``resident`` CTAs, each split at least
    max(8 stages, 2 K) columns, a whole number of stages."""
    unit = max(8 * STAGE_COLS, 2 * K)
    splits, per = SC.split_plan(m, n, 1, unit, resident)
    return splits, per * unit


def plan(m: int, n: int, K: int, device: torch.device) -> tuple[int, int]:
    """(splits, columns per split) of a launch over ``[m, n]`` at K."""
    ctas = kernel_shape(device, K)["ctas_per_sm"] * B.sm_count(device)
    return split_columns(m, n, K, ctas)


def stream_topk(x: torch.Tensor, k: int, *, threshold_skip: bool | None = None):
    """Ascending K = next_pow2(k) smallest of each row of ``x`` [m, n].

    Returns (values [m, K] fp32, ids [m, K] int32).  ``threshold_skip``
    (default on) changes the work, never the result.  CPU tensors run the
    plain version at any K; CUDA tensors launch the kernel (K <= 4096), and
    the merge kernel where the columns were split.
    """
    m, n = x.shape
    K = T.next_pow2(k)
    B.require_f32("x", x, (m, n))
    if B.on_meta(x):
        require_card_k(K, "stream_topk")
        v, i = B.meta_topk((m,), K)
        B.shape_call("stream_topk", flops=1.0 * m * n, nbytes=B.nbytes(x, v, i))
        return v, i
    if not B.on_cuda(x):
        return stream_topk_plain(x, k)
    require_card_k(K, "stream_topk")
    skip = T.resolve_threshold_skip(threshold_skip, kernel=True)
    if m == 0 or n == 0:
        return (torch.full((m, K), T.POS_INF, device=x.device),
                torch.full((m, K), -1, dtype=torch.int32, device=x.device))
    splits, per = plan(m, n, K, x.device)
    vals = torch.empty((splits, m, K), dtype=torch.float32, device=x.device)
    idx = torch.empty((splits, m, K), dtype=torch.int32, device=x.device)
    vec = n % 4 == 0 and x.data_ptr() % 16 == 0
    B.launch("stream_topk", "stream_topk_f32", C_ARGTYPES, x.device,
             B.ptr(x), B.ptr(vals), B.ptr(idx), m, n, K, int(skip), int(vec), splits, per)
    B.count_launch(__name__, LAUNCHES=1, WIDE_LAUNCHES=K > MAX_K)
    if splits == 1:
        return vals[0], idx[0]
    from repro_torch.kernels.merge_partials import merge_partials  # it imports this module

    return merge_partials(vals, idx)
