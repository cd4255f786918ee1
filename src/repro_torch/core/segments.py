"""Deterministic segmented sums: rows summed per group in an order fixed by
the group ids alone.

On the card the obvious primitives (``index_add_``, ``scatter_add_``,
``index_put_(accumulate=True)``) sum float rows by atomics, in an order
that the hardware's timing sets, so two runs differ in their last bits.
Here the rows are sorted stably by group and each group is summed in that
order (``torch.segment_reduce``: one thread a segment), which on the CPU is
the sequential ``index_add_`` bit for bit.  k-means' re-centring
(``core.kmeans``), the pooled lookups (``models.recsys.embedding_bag``) and
the table gradients' coalescing (``train.optim.coalesce_rows``) all sum
this way.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_PIECE = 64  # rows a thread sums in the first pass of ``segment_sums`` on the card


def group_sums(g: Tensor, a: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(sums [k, d], counts [k] int64) of the rows ``g`` [n, d] per group
    ``a`` [n] in ``[0, k)``: the rows sorted stably by group, then
    ``segment_sums``.  An empty group sums to 0."""
    cnt = torch.bincount(a, minlength=k)
    return segment_sums(g[torch.argsort(a, stable=True)], cnt), cnt


def segment_sums(rows: Tensor, cnt: Tensor) -> Tensor:
    """The sums of consecutive segments of ``rows`` [n, d], ``cnt[i]`` rows
    the i-th, each summed in row order.

    On the CPU each segment is summed whole.  On the card one thread sums
    one segment, so a few large segments (PQ's 256 codewords over a million
    rows, the hottest ids of a batch) would leave the card idle: each
    segment is cut into pieces of ``_PIECE`` rows, the pieces summed, then
    each segment's pieces in order.
    """
    if rows.device.type != "cuda":
        return torch.segment_reduce(rows, "sum", lengths=cnt, axis=0)
    return _piecewise_sums(rows, cnt)


def _piecewise_sums(rows: Tensor, cnt: Tensor) -> Tensor:
    pieces = (cnt + _PIECE - 1) // _PIECE
    n_pieces = int(pieces.sum())
    seg = torch.repeat_interleave(torch.arange(len(cnt), device=rows.device), pieces,
                                  output_size=n_pieces)
    first = torch.cumsum(pieces, 0) - pieces  # integers: exact in any order
    j = torch.arange(n_pieces, device=rows.device) - first[seg]
    piece_len = torch.clamp(cnt[seg] - j * _PIECE, max=_PIECE)
    partial = torch.segment_reduce(rows, "sum", lengths=piece_len, axis=0)
    return torch.segment_reduce(partial, "sum", lengths=pieces, axis=0)
