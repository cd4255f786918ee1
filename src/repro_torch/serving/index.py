"""RetrievalIndex: a kNN index with an online update path.

Port of ``repro/serving/index.py`` for the flat fp32 scan and its three
compressed tiers: the two-stage quantized scan (``scan_dtype``,
``overfetch``), the IVF cell-probed scan (``ivf_cells``, ``nprobe``) and
IVF-PQ (``pq_m``, ``pq_nbits``).
The design is the reference's two-segment split:

* **main segment**: an immutable packed ``[n, d]`` array; deletes tombstone
  rows instead of repacking, so the device copy stays valid;
* **delta segment**: an append-only array with power-of-two capacity
  doubling (at least ``_MIN_DELTA_CAP`` rows); rows past the write head are
  dead;
* **tombstones as a live-row mask**: dead rows score ``+inf`` inside the
  scorer (``db_live`` rides the kernel's rank-1 ``hy`` term), so a result is
  exact however many rows are dead;
* **compact()**: re-packs the live main + delta rows into a fresh main.

Each segment is scored for its ``next_pow2(k)`` best; the two candidate
sets merge with the bitonic merge, main winning ties.  External ids are
caller-chosen int32 keys; rows past the live count come back as ``+inf`` /
``-1``.  The delta is always scanned flat in fp32 (``core.knn.knn_query``,
the fused kernel by default).  The main segment is scanned

* flat (``scan_dtype="float32"``, ``ivf_cells=0``): ``knn_query``, exact;
* two-stage (``scan_dtype`` bf16/int8): a low-precision replica of the main
  rows is scanned for ``overfetch * next_pow2(k)`` candidates, which are
  rescored exactly against the fp32 rows (``core.knn.two_stage_query``);
* IVF (``ivf_cells > 0``): k-means cells over the main rows, a scan of the
  ``nprobe`` nearest cells of the cell-packed replica (quantized to
  ``scan_dtype``), then the exact rescore (``core.knn.ivf_query``);
* IVF-PQ (``ivf_cells > 0`` and ``pq_m > 0``): the same cells, with
  residual product-quantized codes of the packed rows (``pq_m`` bytes a
  row) in place of the scan replica, scanned by ADC, then the exact
  rescore (``core.knn.ivfpq_query``).  A main segment with fewer than
  ``2^pq_nbits`` rows cannot train a codebook and is served by the IVF scan.

The replicas, the IVF structure and the PQ codes are keyed on the main
EPOCH (build and compact), not the main version: a tombstone flips the live
mask and never requantizes or retrains; compact does both.

The index's vectors live on ``device`` (default ``"cuda"``; asking for CUDA
on a machine without it raises).  The main rows are uploaded once per
main epoch (build / compact); a tombstone re-uploads only the live mask.

Mesh sharding, filters, tenants and snapshots come with later slices of
the port and raise here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import QUANTIZABLE, canonical_scan_dtype, quantize_rows
from repro_torch.core.ivf import IVFCells, build_ivf
from repro_torch.core.knn import ivf_query, ivfpq_query, knn_query, two_stage_query
from repro_torch.core.pq import PQCodebook, PQCodes, _check_pq_geometry, build_ivfpq
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


def _segment_candidates_ivfpq(q, vecs, ivf, pq_cb, pq_codes, live, ids, *, k_out, nprobe,
                              overfetch, distance, impl):
    """IVF-PQ top-``k_out`` of one segment (DESIGN.md §PQ): the segment's
    epoch-keyed residual PQ replica over its packed rows, the live mask
    riding the packing permutation, the rescore exact in fp32."""
    vals, idx = ivfpq_query(q, vecs, ivf, pq_cb, pq_codes, k_out, nprobe=nprobe,
                            distance=distance, impl=impl, overfetch=overfetch, db_live=live)
    return _externalize(vals, idx, ids, k_out)


def _merge_candidates(av, ai, bv, bi, *, k):
    """Merge two ascending equal-width candidate sets, keep k smallest."""
    mv, mi = T.merge_topk_sorted(av, ai, bv, bi)
    return T.finalize_topk(mv, mi, k)


def _unported(name: str):
    raise NotImplementedError(f"{name} is not ported yet: the flat, quantized, IVF and "
                              "IVF-PQ index only")


class RetrievalIndex:
    """Mutable kNN index over (id, vector) rows.  See module docstring.

    ``impl``: ``"fused"`` (default), ``"kernel"`` or ``"torch"``, forwarded
    to the per-segment scorers.  ``device``: where the segments live.
    ``scan_dtype`` / ``overfetch``: the two-stage tier ("float32" is the
    exact flat scan).  ``ivf_cells`` / ``nprobe``: the IVF tier (0 cells is
    off; ``nprobe >= ivf_cells`` probes every cell, exact with a float32
    scan).  ``pq_m`` / ``pq_nbits``: the IVF-PQ tier (needs ``ivf_cells >
    0``; ``pq_m`` divides ``dim``; codes of ``pq_nbits`` <= 8 bits, a byte
    each).  k-means (cells and codebooks) is seeded from the main epoch,
    through a ``torch.Generator``, so a rebuild of one epoch trains the same
    cells and codes.
    """

    def __init__(self, dim: int, *, distance: str = "sqeuclidean",
                 impl: str = "fused", device="cuda", scan_dtype: str = "float32",
                 overfetch: int = 4, ivf_cells: int = 0, nprobe: int = 8, pq_m: int = 0,
                 pq_nbits: int = 8, mesh=None):
        if mesh is not None:
            _unported("mesh")
        self.dim = int(dim)
        self.distance = distance
        self.impl = impl
        self.device = resolve_device(device)
        self.scan_dtype = canonical_scan_dtype(scan_dtype)
        self.overfetch = int(overfetch)
        self.ivf_cells = int(ivf_cells)
        self.nprobe = int(nprobe)
        self.pq_m = int(pq_m)
        self.pq_nbits = int(pq_nbits)
        assert self.overfetch >= 1, overfetch
        assert self.ivf_cells >= 0 and self.nprobe >= 1, (ivf_cells, nprobe)
        if (self.scan_dtype != "float32" or self.ivf_cells) and distance not in QUANTIZABLE:
            raise ValueError(f"scan_dtype={scan_dtype!r} / ivf_cells need a distance with a "
                             f"row-local gy map; {distance!r} is not in {QUANTIZABLE}")
        if self.pq_m:
            if not self.ivf_cells:
                raise ValueError("pq_m needs a coarse quantizer: set ivf_cells > 0 "
                                 "(the IVFADC composition, DESIGN.md §PQ)")
            _check_pq_geometry(self.dim, self.pq_m, self.pq_nbits)
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
                    impl: str = "fused", device="cuda", ivf: IVFCells | None = None,
                    pq: tuple[PQCodebook, PQCodes] | None = None,
                    scan_dtype: str = "float32", overfetch: int = 4,
                    nprobe: int = 8) -> "RetrievalIndex":
        """An index with exactly this segment state (e.g. the reference's).

        Arrays are numpy: the main segment's rows, external ids and live
        mask, and the delta segment's rows, ids and live mask at full
        capacity with its write head ``delta_n``.  ``ivf``: trained cells
        over the main rows (e.g. the reference's, through
        ``core.ivf.ivf_from_arrays``); the index then serves the IVF tier
        with them until the next compact retrains.  ``pq``: a (codebook,
        codes) replica of those cells' packed rows, with residual codes
        (e.g. the reference's, through ``core.pq.pq_from_arrays``); the
        index then serves the IVF-PQ tier with it, ``pq_m`` and
        ``pq_nbits`` taken from its codebook.
        """
        main_vecs = np.ascontiguousarray(main_vecs, np.float32)
        if pq is not None and ivf is None:
            raise ValueError("a PQ replica needs the cells it codes (ivf=...)")
        pq_m, pq_nbits = (0, 8) if pq is None else (pq[0].m, pq[0].ncodes.bit_length() - 1)
        idx = cls(main_vecs.shape[1], distance=distance, impl=impl, device=device,
                  scan_dtype=scan_dtype, overfetch=overfetch,
                  ivf_cells=0 if ivf is None else ivf.ncells, nprobe=nprobe, pq_m=pq_m,
                  pq_nbits=pq_nbits)
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
        if ivf is not None:
            if ivf.slot_of_row.shape[0] != len(main_vecs):
                raise ValueError(f"the cells cover {ivf.slot_of_row.shape[0]} rows, the main "
                                 f"segment has {len(main_vecs)}")
            if pq is not None:
                if pq[1].codes.shape[0] != ivf.packed.shape[0] or not idx._use_pq():
                    raise ValueError(f"the PQ replica codes {pq[1].codes.shape[0]} slots; the "
                                     f"cells pack {ivf.packed.shape[0]} and the main segment "
                                     f"has {len(main_vecs)} rows (>= {2 ** pq_nbits} needed)")
                pq = (PQCodebook(pq[0].codebooks.to(idx.device)),
                      PQCodes(*(t.to(idx.device) for t in pq[1])))
            idx._install_ivf(IVFCells(*(t.to(idx.device) for t in ivf)), pq)
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
            self._dev.pop(key, None)  # drop the stale copy first: one on the card at a time
            self._dev[key] = make()
            self._dev_version[key] = version

    def _device_state(self) -> dict:
        """Device copies of both segments: (vecs, live, ids) per segment.

        The main rows are keyed on the main epoch (they change only at build
        and compact), the main mask and ids on the main version (tombstones);
        the delta, small by construction, on its version.  The quantized
        replica (``main_q``) and the IVF cells with their scan replica
        (``main_ivf``, ``main_ivf_q``) or their PQ replica (``main_pq``) are
        keyed on the main epoch too.
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
        if self.scan_dtype != "float32" and not self._use_ivf():
            self._upload("main_q", self._main_epoch, lambda: quantize_rows(
                self._dev["main_vecs"], self.scan_dtype, distance=self.distance))
        if self._use_ivf() and self._dev_version.get("main_ivf") != self._main_epoch:
            # The stale epoch's cells go before the new ones are built: the
            # cell-packed copy can be many times the corpus (pow2 cell_cap).
            for key in ("main_ivf", "main_ivf_q", "main_pq"):
                self._dev.pop(key, None)
            self._install_ivf(build_ivf(
                self._dev["main_vecs"], self._effective_ncells(), distance=self.distance,
                impl=self.impl, generator=torch.Generator().manual_seed(self._main_epoch)))
        return {"main": (self._dev["main_vecs"], *self._dev["main_mask"]),
                "delta": self._dev["delta"]}

    def _install_ivf(self, ivf: IVFCells, pq: tuple[PQCodebook, PQCodes] | None = None) -> None:
        """The main epoch's cells and the scan replica of their packed rows
        (built for float32 too, so that no search re-derives it), or, for
        the IVF-PQ tier, their residual PQ replica (``pq``, else trained
        here), which then replaces the scan replica."""
        self._dev["main_ivf"] = ivf
        if self._use_pq():
            self._dev["main_pq"] = pq if pq is not None else build_ivfpq(
                self._dev["main_vecs"], ivf, self.pq_m, nbits=self.pq_nbits,
                distance=self.distance, impl=self.impl,
                generator=torch.Generator().manual_seed(self._main_epoch))
        else:
            self._dev["main_ivf_q"] = quantize_rows(ivf.packed, self.scan_dtype,
                                                    distance=self.distance)
        self._dev_version["main_ivf"] = self._main_epoch

    def _use_ivf(self) -> bool:
        return bool(self.ivf_cells) and self._effective_ncells() > 0

    def _use_pq(self) -> bool:
        """The IVF-PQ tier, unless the main segment has fewer rows than a
        codebook has codewords: then the IVF scan serves it, never a
        truncated codebook."""
        return (bool(self.pq_m) and self._use_ivf()
                and len(self._main_vecs) >= 2 ** self.pq_nbits)

    def _effective_ncells(self) -> int:
        """``ivf_cells`` clamped so that a cell expects at least ~4 rows; 0
        (the flat scan) for an empty main segment."""
        n = len(self._main_vecs)
        if n == 0:
            return 0
        return max(1, min(self.ivf_cells, n // 4 or 1))

    def effective_nprobe(self) -> int:
        """``nprobe`` clamped to the trained cell count: a larger value means
        "probe every cell"."""
        if not self._use_ivf():
            return self.nprobe
        self._device_state()
        return min(self.nprobe, self._dev["main_ivf"].ncells)

    def shape_signature(self, k: int) -> tuple:
        """Everything that fixes the shapes of a k-search: the segment row
        counts (main size, delta capacity), never the number of dead rows,
        and with IVF the cell-packed size (``ncells * cell_cap``; cell_cap
        can move with the largest cell at a compact; the PQ codes, one row a
        slot, have the same size).  Before this epoch's cells are built it
        is a per-epoch marker, so the first batch after a compact is tagged
        cold.
        """
        del k  # fetch width is next_pow2(k), already part of the batch key
        packed = 0
        if self._use_ivf():
            if self._dev_version.get("main_ivf") == self._main_epoch:
                packed = int(self._dev["main_ivf"].packed.shape[0])
            else:
                packed = -(self._main_epoch + 1)
        return (len(self._main_vecs), len(self._delta_vecs) if self._delta_n else 0, packed)

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
            sets.append(self._main_candidates(q, k_out, dev))
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

    def _main_candidates(self, q, k_out: int, dev: dict):
        """Top-``k_out`` live candidates of the main segment, by its tier."""
        vecs, live, ids = dev["main"]
        kw = dict(distance=self.distance, impl=self.impl, overfetch=self.overfetch,
                  db_live=live)
        if self._use_pq():
            return _segment_candidates_ivfpq(
                q, vecs, self._dev["main_ivf"], *self._dev["main_pq"], live, ids, k_out=k_out,
                nprobe=self.effective_nprobe(), overfetch=self.overfetch,
                distance=self.distance, impl=self.impl)
        if self._use_ivf():
            vals, idx = ivf_query(q, vecs, self._dev["main_ivf"], k_out,
                                  nprobe=self.effective_nprobe(),
                                  packed_q=self._dev["main_ivf_q"], **kw)
        elif self.scan_dtype != "float32":
            vals, idx = two_stage_query(q, vecs, self._dev["main_q"], k_out, **kw)
        else:
            return _segment_candidates(q, vecs, live, ids, k_out=k_out,
                                       distance=self.distance, impl=self.impl)
        return _externalize(vals, idx, ids, k_out)
