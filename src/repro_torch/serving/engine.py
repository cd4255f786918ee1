"""Batched query engine over a RetrievalIndex.

Port of ``repro/serving/engine.py``.  Online traffic arrives as single
queries with ragged batch sizes; the engine serves them at a small closed
set of shapes:

* **pow2 padding**: a flush of ``m`` queries runs at batch
  ``next_pow2(max(m, min_batch))``, capped at ``max_batch``; larger flushes
  split into ``max_batch`` chunks.  Padding rows are zero vectors whose
  results are sliced off; every query row is independent.
* **micro-batch queue**: ``submit()`` enqueues (request_id, vector) pairs,
  ``flush()`` drains them in one padded batch.
* **metering**: each batch is timed from before the search to after the
  serving stream has finished it (``accounting.stream_clock``: work that a
  background retrain has in flight on another stream is not the batch's)
  and recorded in a ``ServingMeter``; the first batch at a shape is tagged
  as a compile batch, as in the reference, so that steady-state p50/p99/qps
  stay clean (here it carries the kernels' first build and load).
* **shard fleets**: a ``serving.shards.ShardRouter`` has the same surface;
  its per-query ``coverage`` is padded, chunked and concatenated with the
  rows, and its per-shard status folds worst-wins over the chunks.
* **batch boundary**: an index with a ``before_batch`` hook (the crash-safe
  lifecycle, ``serving.lifecycle``) has it called at the top of every
  ``search``, before anything is read of the index: a ready background
  epoch swaps in there, never inside a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import accounting
from repro_torch.core import topk as T
from repro_torch.serving import filters as F
from repro_torch.serving.index import SearchResult


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    k: int = 10
    min_batch: int = 8  # smallest batch shape (tiny flushes pad up to it)
    max_batch: int = 1024  # largest batch shape (bigger flushes chunk)

    def __post_init__(self):
        assert self.min_batch & (self.min_batch - 1) == 0, self.min_batch
        assert self.max_batch & (self.max_batch - 1) == 0, self.max_batch
        assert self.min_batch <= self.max_batch


class QueryEngine:
    """Batches queries onto anything with the index search surface:
    ``search(q, k) -> SearchResult``, ``shape_signature(k)``, ``dim`` and
    ``device``."""

    def __init__(self, index, cfg: EngineConfig = EngineConfig(),
                 meter: accounting.ServingMeter | None = None):
        self.index = index
        self.cfg = cfg
        self.meter = meter if meter is not None else accounting.ServingMeter()
        # Keyed on request_id: re-submitting an id before flush replaces the
        # pending vector (latest wins, scored once).
        self._queue: dict[object, np.ndarray] = {}
        # (batch, k, index shape signature) keys already served.  Keys whose
        # main size no longer matches the live main are dropped at a compact.
        self._seen_shapes: set = set()
        self._live_main: int | None = None

    def rebind(self, index) -> None:
        """Point the engine at a replacement index; drops the shape keys."""
        assert index.dim == self.index.dim, (index.dim, self.index.dim)
        self.index = index
        self._seen_shapes = set()
        self._live_main = None

    # -- batched search -----------------------------------------------------

    def _bucket(self, m: int) -> int:
        return min(self.cfg.max_batch, T.next_pow2(max(m, self.cfg.min_batch)))

    def search(self, queries, k: int | None = None, *, filter=None) -> SearchResult:
        """Exact top-k for [m, d] queries, padded/chunked to engine shapes.

        ``queries``: numpy or a tensor; a tensor is padded where it lies, so
        one on the index's device reaches the scan with no host copy.

        ``filter``: a ``serving.filters.QueryFilter`` (DESIGN.md §17).  Its
        per-query rows (tenant tags, exclusion lists) are chunked and padded
        with the query rows; pad rows get tenant 0 and no exclusions, and
        their results are sliced off.
        """
        k = self.cfg.k if k is None else int(k)
        hook = getattr(self.index, "before_batch", None)
        if hook is not None:
            hook()
        q = torch.as_tensor(queries, dtype=torch.float32)
        assert q.ndim == 2, q.shape
        if len(q) == 0:
            dev = self.index.device
            return SearchResult(torch.zeros((0, k), device=dev),
                                torch.zeros((0, k), dtype=torch.int32, device=dev))
        f = F.normalize(filter, len(q)) if filter is not None else None
        out_v, out_i, out_c, out_s = [], [], [], []
        for s in range(0, len(q), self.cfg.max_batch):
            chunk = q[s : s + self.cfg.max_batch]
            r = self._search_padded(chunk, k, F.slice_rows(f, s, s + len(chunk)))
            out_v.append(r.distances)
            out_i.append(r.ids)
            if r.coverage is not None:
                out_c.append(r.coverage)
            if r.shard_status is not None:
                out_s.append(r.shard_status)
        # A shard fleet's accounting rides along: per-query coverage
        # concatenates chunk by chunk, per-shard status folds worst-wins.
        coverage = np.concatenate(out_c) if len(out_c) == len(out_v) else None
        status = None
        if out_s:
            from repro_torch.serving.shards import merge_shard_status

            status = merge_shard_status(out_s)
        return SearchResult(torch.cat(out_v), torch.cat(out_i), coverage=coverage,
                            shard_status=status)

    def _search_padded(self, chunk: torch.Tensor, k: int, f=None) -> SearchResult:
        m = len(chunk)
        mp = self._bucket(m)
        qp = chunk.new_zeros((mp, chunk.shape[1]))
        qp[:m] = chunk
        sig = self.index.shape_signature(k)
        if sig[0] != self._live_main:  # new packed main: old keys stranded
            self._seen_shapes = {s for s in self._seen_shapes if s[2][0] == sig[0]}
            self._live_main = sig[0]
        # The filter's part of the shapes: which predicates exist, the mode,
        # and the exclusion width.
        fkey = None if f is None else (f.mode, f.tenant is not None, f.allowed_ids is not None,
                                       F.exclusion_width(f))
        shape_key = (mp, k, sig, fkey)
        cold = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        device = self.index.device
        t0 = accounting.stream_clock(device)
        if f is None:
            res = self.index.search(qp, k)
        else:
            res = self.index.search(qp, k, filter=F.pad_rows(f, mp))
        self.meter.record(m, accounting.stream_clock(device) - t0, compile_batch=cold)
        cov = None if res.coverage is None else res.coverage[:m]
        return SearchResult(res.distances[:m], res.ids[:m], coverage=cov,
                            shard_status=res.shard_status)

    # -- micro-batch queue --------------------------------------------------

    def submit(self, request_id, vector) -> None:
        v = np.asarray(vector, np.float32).ravel()
        assert v.shape == (self.index.dim,), v.shape
        self._queue[request_id] = v

    @property
    def pending(self) -> int:
        return len(self._queue)

    def flush(self, k: int | None = None) -> dict:
        """Drain the queue in one padded batch; {request_id: (dists, ids)}."""
        if not self._queue:
            return {}
        reqs, vecs = zip(*self._queue.items())
        self._queue = {}
        res = self.search(np.stack(vecs), k)
        dv = res.distances.cpu().numpy()
        di = res.ids.cpu().numpy()
        return {r: (dv[i], di[i]) for i, r in enumerate(reqs)}
