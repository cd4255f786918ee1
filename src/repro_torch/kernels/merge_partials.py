"""Merge of partial top-K sets, as a CUDA kernel.

The second kernel of a split scan: when ``fused_knn.plan`` (or the plan of
``ivf_scan`` or ``pq_scan``) splits the scanned axis across CTAs (a serving
batch has too few query tiles to fill the card), split s holds each row's K
smallest of the s-th range of columns, and this kernel merges the S sets
into one.  It is part of the port of
``repro/kernels/fused_knn.py::fused_knn_pallas``, whose one program walks
the whole database axis; the JAX package's counterpart of the merge itself
is ``core/topk.py::merge_many_sorted``, a bitonic tree.  Source:
``csrc/merge_partials.cu``.

Bound on the H100: bytes (each partial entry read once, each output written
once); a row is a few KB, so latency is what costs.  The kernel is a merge
tree: a row's S lists are read at once, with coalesced loads, and merged
pairwise in log2 S rounds, each a bitonic merge-and-truncate (one list
reversed, the element-wise minimum, log2 K clean-up stages).  A warp owns a
row where next_pow2(S) * K <= 512 entries, else a CTA; K up to
``MAX_SELECT_K`` = 4096 on the card (at K = 4096 a CTA merges four lists a
group, the running result one of them).  A CPU tensor serves any power of 2.

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
from repro_torch.kernels.stream_topk import MAX_K, require_card_k

LAUNCHES = 0
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)


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
    B.require(part_v.dim() == 3, lambda: f"part_v: want [S, m, K], got {tuple(part_v.shape)}")
    S, m, K = part_v.shape
    B.require(K == T.next_pow2(K), lambda: f"K = {K}: want a power of 2")
    B.require_f32("part_v", part_v, (S, m, K))
    B.require(part_i.dtype == torch.int32 and part_i.shape == part_v.shape
              and part_i.is_contiguous(), "part_i: want contiguous int32 of part_v's shape")
    if B.on_meta(part_v, part_i):
        require_card_k(K, "merge_partials")
        v, i = B.meta_topk((m,), K)
        B.shape_call("merge_partials", flops=0.0, nbytes=B.nbytes(part_v, part_i, v, i))
        return v, i
    if not B.on_cuda(part_v, part_i):
        return merge_partials_plain(part_v, part_i)
    require_card_k(K, "merge_partials")
    vals = torch.empty((m, K), dtype=torch.float32, device=part_v.device)
    idx = torch.empty((m, K), dtype=torch.int32, device=part_v.device)
    if m == 0 or S == 0:
        return vals.fill_(T.POS_INF), idx.fill_(-1)
    B.launch("merge_partials", "merge_partials_f32", C_ARGTYPES, part_v.device,
             B.ptr(part_v), B.ptr(part_i), B.ptr(vals), B.ptr(idx), m, S, K)
    B.count_launch(__name__, LAUNCHES=1, WIDE_LAUNCHES=K > MAX_K)
    return vals, idx
