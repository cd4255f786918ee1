"""Top-k selection primitives: the sorted K-buffer and the bitonic merge.

PyTorch port of ``repro/core/topk.py``.  The running "heap" of the paper is
an ascending length-K buffer per row (K = next_pow2(k)); a tile is reduced
with a bitonic network and folded in with the bitonic top-k merge.  These
functions are the plain tensor form of the selection: the torch kNN path
runs them, and the parity tests hold them against the JAX package.

Tie rules, as in the reference:

* inside the network, the lower POSITION wins an equal-value compare;
* in ``merge_topk_sorted`` the first (running) buffer wins ties;
* ``tile_topk`` returns the lower index first on ties, from a stable sort;
* a ``+inf`` slot carries id ``-1``.

The CUDA kernels do not run this network: they keep the same result
contract (the K smallest by (value, global column), ascending) with a
per-row sorted insertion, see ``kernels/csrc/select.cuh``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

POS_INF = float("inf")


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def resolve_threshold_skip(flag: bool | None, *, kernel: bool) -> bool:
    """The repo-wide default of the paper's heap-top filter.

    ``None`` resolves per substrate: on inside a hand-written kernel, where
    the skip is one warp-uniform branch, off on the plain tensor path, where
    a data-dependent branch needs a host round trip.  An explicit bool wins.
    """
    if flag is None:
        return kernel
    return bool(flag)


# ---------------------------------------------------------------------------
# Bitonic compare-exchange stage via reshape/flip (partner index = i XOR j).
# ---------------------------------------------------------------------------


def _partner(x: Tensor, j: int) -> Tensor:
    """Value at index (i XOR j) along the last axis, as reshape+flip."""
    L = x.shape[-1]
    xr = x.reshape(*x.shape[:-1], L // (2 * j), 2, j)
    return torch.flip(xr, dims=(-2,)).reshape(x.shape)


def _stage(vals: Tensor, idx: Tensor, j: int, up: Tensor):
    """One compare-exchange stage; ties broken by position (lower wins)."""
    L = vals.shape[-1]
    pos = torch.arange(L, device=vals.device)
    pvals = _partner(vals, j)
    pidx = _partner(idx, j)
    is_lower = (pos & j) == 0
    ppos = pos ^ j
    self_lt = (vals < pvals) | ((vals == pvals) & (pos < ppos))
    take_min = up == is_lower
    take_self = torch.where(take_min, self_lt, ~self_lt)
    return torch.where(take_self, vals, pvals), torch.where(take_self, idx, pidx)


def bitonic_sort_kv(vals: Tensor, idx: Tensor, ascending: bool = True):
    """Full bitonic sort of (vals, idx) along the last axis (length 2^p)."""
    L = vals.shape[-1]
    assert L & (L - 1) == 0, f"bitonic sort needs pow2 length, got {L}"
    if L == 1:
        return vals, idx
    pos = torch.arange(L, device=vals.device)
    size = 2
    while size <= L:
        up = (pos & size) == 0
        if size == L:
            up = torch.full((L,), ascending, dtype=torch.bool, device=vals.device)
        elif not ascending:
            up = ~up
        j = size // 2
        while j >= 1:
            vals, idx = _stage(vals, idx, j, up)
            j //= 2
        size *= 2
    return vals, idx


def bitonic_merge_ascending(vals: Tensor, idx: Tensor):
    """Sort a bitonic sequence ascending: the final log-L merge network."""
    L = vals.shape[-1]
    up = torch.ones((L,), dtype=torch.bool, device=vals.device)
    j = L // 2
    while j >= 1:
        vals, idx = _stage(vals, idx, j, up)
        j //= 2
    return vals, idx


def merge_topk_sorted(av: Tensor, ai: Tensor, bv: Tensor, bi: Tensor):
    """Merge two ascending length-K (value, index) sets, keep the K smallest.

    ``min(a_i, reverse(b)_i)`` holds the K smallest of the union and is
    bitonic; one merge network sorts it.  ``a`` wins ties.
    """
    rbv = torch.flip(bv, dims=(-1,))
    rbi = torch.flip(bi, dims=(-1,))
    a_wins = av <= rbv
    lo_v = torch.where(a_wins, av, rbv)
    lo_i = torch.where(a_wins, ai, rbi)
    return bitonic_merge_ascending(lo_v, lo_i)


# ---------------------------------------------------------------------------
# Tile reduction + streaming scan (the plain path used by core.knn).
# ---------------------------------------------------------------------------


def tile_topk(tile: Tensor, K: int, col_offset: int) -> tuple[Tensor, Tensor]:
    """Ascending top-K (smallest) of each row of ``tile`` [m, bn], global ids.

    A stable sort gives the reference's ``lax.top_k`` order: on equal
    values the lower column comes first.
    """
    m, bn = tile.shape
    if bn < K:
        pad = torch.full((m, K - bn), POS_INF, dtype=tile.dtype, device=tile.device)
        tile = torch.cat([tile, pad], dim=1)
    vals, loc = torch.sort(tile, dim=1, stable=True)
    vals, loc = vals[:, :K], loc[:, :K]
    idx = torch.where(vals < POS_INF, loc + col_offset, torch.full_like(loc, -1))
    return vals, idx.to(torch.int32)


def init_running(m: int, k: int, *, device, dtype=torch.float32):
    K = next_pow2(k)
    return (
        torch.full((m, K), POS_INF, dtype=dtype, device=device),
        torch.full((m, K), -1, dtype=torch.int32, device=device),
    )


def update_running(run_v, run_i, tile, col_offset, *, threshold_skip: bool = True):
    """Fold one distance tile into the running top-K state.

    ``threshold_skip``: the paper's heap-top filter; if no element of the
    tile beats the current k-th best of its row, the merge is skipped.
    """
    K = run_v.shape[-1]
    if threshold_skip and not bool((tile < run_v[:, -1:]).any()):
        return run_v, run_i
    tv, ti = tile_topk(tile, K, col_offset)
    return merge_topk_sorted(run_v, run_i, tv, ti)


def finalize_topk(run_v, run_i, k: int):
    return run_v[:, :k], run_i[:, :k]


def topk_smallest(x: Tensor, k: int):
    """Ascending k smallest of each row + int32 indices (stable order)."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def pad_topk(vals: Tensor, idx: Tensor, K: int):
    """Pad ascending top-k sets [..., k] out to width ``K`` (+inf, -1)."""
    k = vals.shape[-1]
    if k == K:
        return vals, idx
    assert K > k, (K, k)
    shape = vals.shape[:-1] + (K - k,)
    pv = torch.full(shape, POS_INF, dtype=vals.dtype, device=vals.device)
    pi = torch.full(shape, -1, dtype=idx.dtype, device=idx.device)
    return torch.cat([vals, pv], dim=-1), torch.cat([idx, pi], dim=-1)


def merge_many_sorted(vals: Tensor, idx: Tensor, k: int):
    """Merge ``[S, m, K]`` stacked ascending partial top-K sets -> ``[m, k]``.

    Binary tree of pairwise bitonic merges, in log2(S) rounds.
    """
    S = vals.shape[0]
    while S > 1:
        half = S // 2
        mv, mi = merge_topk_sorted(
            vals[:half], idx[:half], vals[half : 2 * half], idx[half : 2 * half]
        )
        if S % 2:
            mv = torch.cat([mv, vals[-1:]], dim=0)
            mi = torch.cat([mi, idx[-1:]], dim=0)
        vals, idx = mv, mi
        S = vals.shape[0]
    return finalize_topk(vals[0], idx[0], k)
