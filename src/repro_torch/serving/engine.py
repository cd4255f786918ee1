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
  device has finished it (``accounting.device_clock``) and recorded in a
  ``ServingMeter``; the first batch at a shape is tagged as a compile batch,
  as in the reference, so that steady-state p50/p99/qps stay clean (here
  it carries the kernels' first build and load).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import accounting
from repro_torch.core import topk as T
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
        """Exact top-k for [m, d] queries, padded/chunked to engine shapes."""
        if filter is not None:
            raise NotImplementedError("filters come with the filtered slice")
        k = self.cfg.k if k is None else int(k)
        q = np.asarray(queries, np.float32)
        assert q.ndim == 2, q.shape
        if len(q) == 0:
            dev = self.index.device
            return SearchResult(torch.zeros((0, k), device=dev),
                                torch.zeros((0, k), dtype=torch.int32, device=dev))
        out_v, out_i = [], []
        for s in range(0, len(q), self.cfg.max_batch):
            r = self._search_padded(q[s : s + self.cfg.max_batch], k)
            out_v.append(r.distances)
            out_i.append(r.ids)
        return SearchResult(torch.cat(out_v), torch.cat(out_i))

    def _search_padded(self, chunk: np.ndarray, k: int) -> SearchResult:
        m = len(chunk)
        mp = self._bucket(m)
        qp = np.zeros((mp, chunk.shape[1]), np.float32)
        qp[:m] = chunk
        sig = self.index.shape_signature(k)
        if sig[0] != self._live_main:  # new packed main: old keys stranded
            self._seen_shapes = {s for s in self._seen_shapes if s[2][0] == sig[0]}
            self._live_main = sig[0]
        shape_key = (mp, k, sig)
        cold = shape_key not in self._seen_shapes
        self._seen_shapes.add(shape_key)
        device = self.index.device
        t0 = accounting.device_clock(device)
        res = self.index.search(qp, k)
        self.meter.record(m, accounting.device_clock(device) - t0, compile_batch=cold)
        return SearchResult(res.distances[:m], res.ids[:m])

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
