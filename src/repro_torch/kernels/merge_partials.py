"""Merge of partial top-K sets, as a CUDA kernel.

The second kernel of a split fused kNN call: when ``fused_knn.plan`` splits
the database axis across CTAs (a serving batch has too few query tiles to
fill the card), split s holds each row's K smallest of the s-th range of
columns, and this kernel merges the S sets into one.  It is part of the
port of ``repro/kernels/fused_knn.py::fused_knn_pallas``, whose one program
walks the whole database axis; the JAX package's counterpart of the merge
itself is ``core/topk.py::merge_many_sorted``.  Source:
``csrc/merge_partials.cu``, selection in ``csrc/select.cuh``.

Bound on the H100: bytes (each partial entry is read at most once, each
output written once).  One warp owns a row and keeps its K-buffer in shared
memory; a list is read only until its first batch of 32 that does not beat
the K-th entry.

Result contract: the K smallest of the union by (value, column), ascending,
``+inf`` slots carrying id ``-1``; since lower splits hold lower columns,
lower splits win ties.  ``merge_partials_plain`` is that contract in plain
PyTorch: the splits side by side, a stable sort, take K.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.kernels import _backend as B
from repro_torch.kernels.stream_topk import MAX_K

LAUNCHES = 0


def merge_partials_plain(part_v: torch.Tensor, part_i: torch.Tensor):
    """[S, m, K] partial sets -> (values [m, K], ids [m, K]) by a stable sort.

    The splits lie side by side in order, so a stable sort by value orders
    equal values by split, and within a split by column: (value, column).
    """
    S, m, K = part_v.shape
    v = part_v.permute(1, 0, 2).reshape(m, S * K)
    i = part_i.permute(1, 0, 2).reshape(m, S * K)
    v, pos = torch.sort(v, dim=1, stable=True)
    v = v[:, :K]
    i = i.gather(1, pos[:, :K])
    return v, torch.where(v < T.POS_INF, i, torch.full_like(i, -1))


# merge_partials_f32(part_v, part_i, out_v, out_i, m, S, K, stream)
C_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def merge_partials(part_v: torch.Tensor, part_i: torch.Tensor):
    """Merge ``[S, m, K]`` ascending partial sets (fp32 values, int32 ids,
    split s over lower columns than split s + 1) into ``[m, K]``.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    global LAUNCHES
    B.require(part_v.dim() == 3, f"part_v: want [S, m, K], got {tuple(part_v.shape)}")
    S, m, K = part_v.shape
    B.require(K == T.next_pow2(K) and K <= MAX_K, f"K = {K}: want a power of 2 <= {MAX_K}")
    B.require_f32("part_v", part_v, (S, m, K))
    B.require(part_i.dtype == torch.int32 and tuple(part_i.shape) == (S, m, K)
              and part_i.is_contiguous(), "part_i: want contiguous int32 of part_v's shape")
    if not B.on_cuda(part_v, part_i):
        return merge_partials_plain(part_v, part_i)
    vals = torch.empty((m, K), dtype=torch.float32, device=part_v.device)
    idx = torch.empty((m, K), dtype=torch.int32, device=part_v.device)
    if m == 0 or S == 0:
        return vals.fill_(T.POS_INF), idx.fill_(-1)
    B.launch("merge_partials", "merge_partials_f32", C_ARGTYPES, part_v.device,
             B.ptr(part_v), B.ptr(part_i), B.ptr(vals), B.ptr(idx), m, S, K)
    LAUNCHES += 1
    return vals, idx
