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

``torch.segment_reduce`` has no second derivative, and a force field needs
one (forces are a gradient, and training differentiates them again).
``segment_sum`` and ``gather`` are autograd functions over a ``Segments``
(an index vector sorted once) whose backwards are each other: the GNN's
message sums (``models.gnn``) are built of them.  ``one_thread_backward``
keeps autograd's own sums of gradient parts in a fixed order too.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

_PIECE = 64  # rows a thread sums in the first pass of ``segment_sums`` on the card


def counts(idx: Tensor, n: int) -> Tensor:
    """``torch.bincount(idx, minlength=n)`` for ``idx`` in ``[0, n)``: int64
    [n].  On the meta device (a dry run's trace) the length is that static
    n, as every id is below it; ``bincount`` itself has no meta kernel."""
    if idx.device.type == "meta":
        return torch.empty((n,), dtype=torch.int64, device="meta")
    return torch.bincount(idx, minlength=n)


def group_sums(g: Tensor, a: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(sums [k, d], counts [k] int64) of the rows ``g`` [n, d] per group
    ``a`` [n] in ``[0, k)``: the rows sorted stably by group, then
    ``segment_sums``.  An empty group sums to 0."""
    cnt = counts(a, k)
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


# -- sums that autograd can differentiate, twice and more ---------------------


class Segments:
    """An index vector ``idx`` [E] into ``n`` segments, sorted once: the
    stable order of ``idx`` and each segment's count.  ``segment_sum`` and
    ``gather`` over it are each other's gradient, so a model built of them
    differentiates any number of times, and every sum, backward ones
    included, runs in the order ``idx`` fixes."""

    __slots__ = ("idx", "n", "order", "counts")

    def __init__(self, idx, n: int):
        self.idx = torch.as_tensor(idx).long()
        self.n = int(n)
        self.order = torch.argsort(self.idx, stable=True)
        self.counts = counts(self.idx, self.n)


def _sum_rows(seg: Segments, rows: Tensor) -> Tensor:
    flat = rows.reshape(rows.shape[0], -1)
    out = segment_sums(flat.index_select(0, seg.order), seg.counts)
    return out.reshape((seg.n,) + tuple(rows.shape[1:]))


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, seg):
        ctx.seg = seg
        return _sum_rows(seg, rows)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.seg), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seg):
        ctx.seg = seg
        return x.index_select(0, seg.idx)

    @staticmethod
    def backward(ctx, g):
        return _SegmentSum.apply(g.contiguous(), ctx.seg), None


def segment_sum(rows: Tensor, seg: Segments) -> Tensor:
    """``out[i] = sum of rows[e] where seg.idx[e] == i`` ([n, ...]), summed in
    ``seg``'s order; its gradient is ``gather``."""
    return _SegmentSum.apply(rows, seg)


def gather(x: Tensor, seg: Segments) -> Tensor:
    """``x[seg.idx]`` ([E, ...]); its gradient is ``segment_sum``, so the
    gradient of a gather never sums by atomics either."""
    return _Gather.apply(x, seg)


def one_thread_backward():
    """Run a backward pass on the calling thread alone.

    By default autograd runs a CUDA graph's nodes on a worker thread of the
    device and the rest on the caller's, and a gradient that several nodes
    feed is summed in the order their parts arrive.  On a graph that
    differentiates a gradient again (the GNN's forces), that order varied
    between runs on the card: 1 run in 4 gave other last bits in every
    leaf (3.7e-7 relative), and with one thread 8 runs in 8 were equal.
    One thread sums in the graph's own order, so a step repeats byte for
    byte."""
    return torch.autograd.set_multithreading_enabled(False)
