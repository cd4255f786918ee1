"""RetrievalIndex: an exact-kNN index with an online update path (flat fp32).

Port of ``repro/serving/index.py`` for the flat fp32 scan.  The design is
the reference's two-segment split:

* **main segment**: an immutable packed ``[n, d]`` array; deletes tombstone
  rows instead of repacking, so the device copy stays valid;
* **delta segment**: an append-only array with power-of-two capacity
  doubling (at least ``_MIN_DELTA_CAP`` rows); rows past the write head are
  dead;
* **tombstones as a live-row mask**: dead rows score ``+inf`` inside the
  scorer (``db_live`` rides the kernel's rank-1 ``hy`` term), so a result is
  exact however many rows are dead;
* **compact()**: re-packs the live main + delta rows into a fresh main.

Each segment is scored by ``core.knn.knn_query`` (the fused kernel by
default) for its ``next_pow2(k)`` best; the two candidate sets merge with
the bitonic merge, main winning ties.  External ids are caller-chosen int32
keys; rows past the live count come back as ``+inf`` / ``-1``.

The index's vectors live on ``device`` (default ``"cuda"``; asking for CUDA
on a machine without it raises).  The main rows are uploaded once per
main epoch (build / compact); a tombstone re-uploads only the live mask.

The quantized, IVF and IVF-PQ tiers, mesh sharding, filters, tenants and
snapshots come with later slices of the port and raise here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as T
from repro_torch.core.knn import knn_query
from repro_torch.kernels._backend import resolve_device

Tensor = torch.Tensor

_MIN_DELTA_CAP = 64


class SearchResult(NamedTuple):
    distances: Tensor  # [m, k] ascending
    ids: Tensor  # [m, k] int32 external ids, -1 past the live count


def _externalize(vals, idx, ids, k_out):
    """Row indices -> external ids, padded out to fetch width ``k_out``."""
    safe = idx.clamp(0, max(ids.shape[0] - 1, 0)).long()
    ext = torch.where(idx >= 0, ids[safe], torch.full_like(idx, -1))
    if vals.shape[-1] < k_out:  # the scorer clamps k to the row count
        vals, ext = T.pad_topk(vals, ext, k_out)
    return vals, ext


def _segment_candidates(q, vecs, live, ids, *, k_out, distance, impl):
    """Top-``k_out`` live candidates of one segment, ascending, padded."""
    vals, idx = knn_query(q, vecs, k_out, distance=distance, impl=impl, db_live=live)
    return _externalize(vals, idx, ids, k_out)


def _merge_candidates(av, ai, bv, bi, *, k):
    """Merge two ascending equal-width candidate sets, keep k smallest."""
    mv, mi = T.merge_topk_sorted(av, ai, bv, bi)
    return T.finalize_topk(mv, mi, k)


def _unported(name: str):
    raise NotImplementedError(f"{name} is not ported yet: the flat fp32 index only")


class RetrievalIndex:
    """Mutable exact-kNN index over (id, vector) rows.  See module docstring.

    ``impl``: ``"fused"`` (default), ``"kernel"`` or ``"torch"``, forwarded
    to the per-segment scorer.  ``device``: where the segments live.
    """

    def __init__(self, dim: int, *, distance: str = "sqeuclidean",
                 impl: str = "fused", device="cuda", scan_dtype: str = "float32",
                 ivf_cells: int = 0, pq_m: int = 0, mesh=None):
        if scan_dtype not in ("float32", "fp32", "f32"):
            _unported(f"scan_dtype={scan_dtype!r}")
        if ivf_cells:
            _unported("ivf_cells")
        if pq_m:
            _unported("pq_m")
        if mesh is not None:
            _unported("mesh")
        self.dim = int(dim)
        self.distance = distance
        self.impl = impl
        self.device = resolve_device(device)
        self._main_epoch = 0
        self._main_vecs = np.zeros((0, dim), np.float32)
        self._main_ids = np.zeros((0,), np.int32)
        self._main_live = np.zeros((0,), bool)
        self._delta_vecs = np.zeros((0, dim), np.float32)
        self._delta_ids = np.zeros((0,), np.int32)
        self._delta_live = np.zeros((0,), bool)
        self._delta_n = 0  # write head; rows past it are dead capacity
        self._loc: dict[int, tuple[str, int]] = {}  # id -> (segment, row)
        # Per-segment versions: a delta append must not re-upload the main.
        self._version = {"main": 0, "delta": 0}
        self._dev_version: dict[str, object] = {}
        self._dev: dict[str, object] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, ids, vectors, *, tenants=None, **kw) -> "RetrievalIndex":
        """Pack (ids, vectors) straight into the main segment."""
        if tenants is not None:
            _unported("tenants")
        vectors = np.asarray(vectors, np.float32)
        idx = cls(vectors.shape[1], **kw)
        ids = idx._check_ids(ids, vectors)
        idx._main_vecs = np.ascontiguousarray(vectors)
        idx._main_ids = ids.copy()
        idx._main_live = np.ones(len(ids), bool)
        idx._loc = {int(i): ("main", r) for r, i in enumerate(ids)}
        idx._bump("main")
        idx._main_epoch += 1
        return idx

    @classmethod
    def from_arrays(cls, main_vecs, main_ids, main_live, delta_vecs, delta_ids,
                    delta_live, delta_n, *, distance: str = "sqeuclidean",
                    impl: str = "fused", device="cuda") -> "RetrievalIndex":
        """An index with exactly this segment state (e.g. the reference's).

        Arrays are numpy: the main segment's rows, external ids and live
        mask, and the delta segment's rows, ids and live mask at full
        capacity with its write head ``delta_n``.
        """
        main_vecs = np.ascontiguousarray(main_vecs, np.float32)
        idx = cls(main_vecs.shape[1], distance=distance, impl=impl, device=device)
        idx._main_vecs = main_vecs
        idx._main_ids = np.asarray(main_ids, np.int32).copy()
        idx._main_live = np.asarray(main_live, bool).copy()
        idx._delta_vecs = np.array(delta_vecs, np.float32).reshape(-1, idx.dim)
        idx._delta_ids = np.asarray(delta_ids, np.int32).copy()
        idx._delta_live = np.asarray(delta_live, bool).copy()
        idx._delta_n = int(delta_n)
        assert len(idx._main_ids) == len(idx._main_live) == len(main_vecs)
        assert len(idx._delta_ids) == len(idx._delta_live) == len(idx._delta_vecs)
        assert idx._delta_n <= len(idx._delta_vecs)
        idx._delta_live[idx._delta_n:] = False
        for r in np.flatnonzero(idx._main_live):
            idx._loc[int(idx._main_ids[r])] = ("main", int(r))
        for r in np.flatnonzero(idx._delta_live):
            idx._loc[int(idx._delta_ids[r])] = ("delta", int(r))
        idx._bump("main")
        idx._bump("delta")
        idx._main_epoch += 1
        return idx

    def save(self, directory: str, **kw) -> str:
        _unported("save")

    @classmethod
    def restore(cls, directory: str, **kw) -> "RetrievalIndex":
        _unported("restore")

    def _check_ids(self, ids, vectors) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        assert vectors.shape == (len(ids), self.dim), (vectors.shape, len(ids))
        assert (ids >= 0).all() and (ids < 2**31).all(), "ids must fit int32"
        assert len(np.unique(ids)) == len(ids), "duplicate ids in one call"
        return ids.astype(np.int32)

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._loc)

    def __contains__(self, item_id: int) -> bool:
        return int(item_id) in self._loc

    @property
    def n_dead(self) -> int:
        """Tombstoned + unfilled-capacity rows (wasted score work until compact)."""
        return (int(len(self._main_live) - self._main_live.sum())
                + int(len(self._delta_live) - self._delta_live.sum()))

    # -- mutation -----------------------------------------------------------

    def insert(self, ids, vectors, *, tenants=None) -> None:
        """Append new rows; error on an id that already exists (use upsert)."""
        if tenants is not None:
            _unported("tenants")
        vectors = np.asarray(vectors, np.float32)
        ids = self._check_ids(ids, vectors)
        for i in ids:
            if int(i) in self._loc:
                raise KeyError(f"id {int(i)} already indexed (use upsert)")
        self._append_delta(ids, vectors)

    def upsert(self, ids, vectors, *, tenants=None) -> None:
        """Insert-or-replace: an existing id is tombstoned, then re-appended."""
        if tenants is not None:
            _unported("tenants")
        vectors = np.asarray(vectors, np.float32)
        ids = self._check_ids(ids, vectors)
        for i in ids:
            self._tombstone(int(i))
        self._append_delta(ids, vectors)

    def delete(self, ids) -> int:
        """Tombstone ids; returns how many existed."""
        return sum(self._tombstone(int(i)) for i in np.asarray(ids).ravel())

    def _tombstone(self, item_id: int) -> int:
        loc = self._loc.pop(item_id, None)
        if loc is None:
            return 0
        seg, row = loc
        (self._main_live if seg == "main" else self._delta_live)[row] = False
        self._bump(seg)
        return 1

    def _append_delta(self, ids: np.ndarray, vectors: np.ndarray) -> None:
        need = self._delta_n + len(ids)
        if need > len(self._delta_vecs):
            cap = max(_MIN_DELTA_CAP, T.next_pow2(need))
            grown = np.zeros((cap, self.dim), np.float32)
            grown[: self._delta_n] = self._delta_vecs[: self._delta_n]
            self._delta_vecs = grown
            for name in ("_delta_ids", "_delta_live"):
                old = getattr(self, name)
                fresh = np.zeros((cap,), old.dtype)
                fresh[: self._delta_n] = old[: self._delta_n]
                setattr(self, name, fresh)
        r0 = self._delta_n
        self._delta_vecs[r0 : r0 + len(ids)] = vectors
        self._delta_ids[r0 : r0 + len(ids)] = ids
        self._delta_live[r0 : r0 + len(ids)] = True
        for off, i in enumerate(ids):
            self._loc[int(i)] = ("delta", r0 + off)
        self._delta_n = r0 + len(ids)
        self._bump("delta")

    def _live_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Live (vecs, ids) in compact order: main rows, then delta rows."""
        n = self._delta_n
        vecs = np.concatenate([self._main_vecs[self._main_live],
                               self._delta_vecs[:n][self._delta_live[:n]]], axis=0)
        ids = np.concatenate([self._main_ids[self._main_live],
                              self._delta_ids[:n][self._delta_live[:n]]], axis=0)
        return np.ascontiguousarray(vecs), ids

    def compact(self) -> None:
        """Re-pack live rows into a fresh immutable main segment."""
        vecs, ids = self._live_rows()
        self._main_vecs = vecs
        self._main_ids = ids
        self._main_live = np.ones(len(ids), bool)
        self._delta_vecs = np.zeros((0, self.dim), np.float32)
        self._delta_ids = np.zeros((0,), np.int32)
        self._delta_live = np.zeros((0,), bool)
        self._delta_n = 0
        self._loc = {int(i): ("main", r) for r, i in enumerate(ids)}
        self._bump("main")
        self._bump("delta")
        self._main_epoch += 1

    def _bump(self, seg: str) -> None:
        self._version[seg] += 1

    # -- search -------------------------------------------------------------

    def _upload(self, key: str, version, make) -> None:
        if self._dev_version.get(key) != version:
            self._dev[key] = make()
            self._dev_version[key] = version

    def _device_state(self) -> dict:
        """Device copies of both segments: (vecs, live, ids) per segment.

        The main rows are keyed on the main epoch (they change only at build
        and compact), the main mask and ids on the main version (tombstones);
        the delta, small by construction, on its version.
        """
        dev = self.device
        self._upload("main_vecs", self._main_epoch,
                     lambda: torch.from_numpy(self._main_vecs).to(dev))
        self._upload("main_mask", self._version["main"], lambda: (
            torch.from_numpy(self._main_live).to(dev),
            torch.from_numpy(self._main_ids).to(dev)))
        self._upload("delta", self._version["delta"], lambda: tuple(
            torch.from_numpy(a).to(dev)
            for a in (self._delta_vecs, self._delta_live, self._delta_ids)))
        return {"main": (self._dev["main_vecs"], *self._dev["main_mask"]),
                "delta": self._dev["delta"]}

    def shape_signature(self, k: int) -> tuple:
        """Everything that fixes the shapes of a k-search: the segment row
        counts (main size, delta capacity), never the number of dead rows.
        The third entry is the reference's cell-packed size, 0 without IVF.
        """
        del k  # fetch width is next_pow2(k), already part of the batch key
        return (len(self._main_vecs), len(self._delta_vecs) if self._delta_n else 0, 0)

    def search(self, queries, k: int, *, filter=None) -> SearchResult:
        """Exact k nearest live rows for each query row.

        Result width is exactly ``k``; rows beyond the live count carry +inf
        distance and id -1 (same convention as ``core.knn``).
        """
        if filter is not None:
            _unported("filter")
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        assert q.ndim == 2 and q.shape[1] == self.dim, q.shape
        k = int(k)
        assert k >= 1
        k_out = T.next_pow2(k)
        dev = self._device_state()
        sets = []
        if len(self._main_vecs):
            sets.append(_segment_candidates(q, *dev["main"], k_out=k_out,
                                            distance=self.distance, impl=self.impl))
        if self._delta_n:
            sets.append(_segment_candidates(q, *dev["delta"], k_out=k_out,
                                            distance=self.distance, impl=self.impl))
        if not sets:
            m = q.shape[0]
            return SearchResult(torch.full((m, k), T.POS_INF, device=self.device),
                                torch.full((m, k), -1, dtype=torch.int32, device=self.device))
        if len(sets) == 1:
            return SearchResult(*T.finalize_topk(*sets[0], k))
        (av, ai), (bv, bi) = sets
        return SearchResult(*_merge_candidates(av, ai, bv, bi, k=k))
