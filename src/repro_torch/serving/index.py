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

Filtered and multi-tenant search (DESIGN.md §17): every row carries an
int32 tenant tag (default 0) through insert, upsert and compact, and
``search(filter=)`` takes a ``serving.filters.QueryFilter``.  Its row
predicates (tenant, allow-list) become the fused kernel's bit-packed
bitmap, built from per-tenant rows of words cached per segment and ANDed
with the allow-list's row, and applied inside the scan ("pre") or to the
scanned candidates ("post"); exclusions are dropped by external id on the
merged candidates, at a fetch widened by their count.  A trivially-true
filter runs the unfiltered code.

Snapshots (``save`` / ``restore``, ``serving.snapshot``) are the
reference's on-disk format; the crash-safe lifecycle around the index
(``serving.lifecycle``) trains each new epoch off the serving thread, and
``_forbid_sync_train`` makes a search that would train instead raise.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``; DESIGN.md §1, §8) the
main segment is scored by ``core.distributed``'s sharded scorers: queries
over ``query_axis``, the main rows (or their cell blocks) over ``db_axis``,
tombstones as the shards' live masks before the butterfly merge.  The main
rows are padded to a multiple of the db axis' size, the padding dead; the
IVF cell count rounds down to a multiple of it, so cell blocks never
straddle shards.  The delta is scored on ``device``, and the two segments
merge there.  Filters are always post-filtered on a mesh, as the
reference's are: the sharded scorers take no per-query bitmap, and their
rows meet the filter's packed words before they are externalized.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import QUANTIZABLE, canonical_scan_dtype, quantize_rows
from repro_torch.core.ivf import IVFCells, _tensor, build_ivf
from repro_torch.core.knn import (
    _mask_excluded_rows,
    ivf_query,
    ivfpq_query,
    knn_query,
    two_stage_query,
)
from repro_torch.core.pq import PQCodebook, PQCodes, _check_pq_geometry, build_ivfpq
from repro_torch.kernels._backend import resolve_device
from repro_torch.kernels.fused_knn import mask_bits_at, pack_mask
from repro_torch.launch.mesh import Mesh
from repro_torch.serving import filters as F

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


def _segment_candidates(q, vecs, live, ids, allowed=None, *, k_out, distance, impl,
                        post=False):
    """Top-``k_out`` live candidates of one segment, ascending, padded.

    ``allowed``: the per-query filter bitmap over the segment's rows (packed
    words, DESIGN.md §17) or None; ``post=False`` masks inside the scan,
    ``post=True`` scans unfiltered and drops disallowed candidates after
    (the caller widens ``k_out``)."""
    vals, idx = knn_query(q, vecs, k_out, distance=distance, impl=impl, db_live=live,
                          q_allowed=None if post else allowed)
    return _scored(vals, idx, ids, k_out, allowed if post else None)


def _scored(vals, idx, ids, k_out, drop=None):
    """A scorer's (values, rows) -> (values, external ids) at width
    ``k_out``, after the post-filter ``drop`` (a bitmap, or None)."""
    if drop is not None:
        vals, idx = _drop_disallowed(vals, idx, drop)
    return _externalize(vals, idx, ids, k_out)


def _drop_disallowed(vals, idx, allowed):
    """Post-filter scored candidates by the bitmap; re-sorts.  Disallowed
    entries become +inf / -1 behind every survivor (a stable sort keeps the
    survivors' order): the scorers' ascending, -1-padded contract."""
    ok = mask_bits_at(allowed, idx)
    vals = torch.where(ok, vals, T.POS_INF)
    idx = torch.where(ok, idx, -1)
    order = torch.sort(vals, dim=1, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def _members(ids, allowed):
    """bool [n]: which of ``ids`` (int32 [n]) are in ``allowed`` (int32,
    sorted and unique, as ``filters.normalize`` leaves an allow-list)."""
    if allowed.numel() == 0:
        return torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    pos = torch.searchsorted(allowed, ids).clamp_(max=allowed.numel() - 1)
    return allowed[pos] == ids


def _finalize_filtered(vals, ids, exclude_ids, *, k):
    """Drop per-query external-id exclusions and cut to width ``k``.

    ``exclude_ids`` [m, E] int32, -1 padded, or None.  The candidates
    arriving here are at least k + E wide (``_search_filtered`` widens the
    fetch), so k exact survivors remain.  The lookup is ``core.knn``'s
    (each row's list sorted once, where the reference compares [m, K, E]);
    the same stable re-sort as ``_drop_disallowed``.
    """
    if exclude_ids is not None:
        kept = _mask_excluded_rows(ids, exclude_ids)
        vals = torch.where(kept != ids, T.POS_INF, vals)
        ids = kept
        order = torch.sort(vals, dim=1, stable=True).indices
        vals, ids = vals.gather(1, order), ids.gather(1, order)
    return vals[:, :k], ids[:, :k]


def _merge_candidates(av, ai, bv, bi, *, k):
    """Merge two ascending equal-width candidate sets, keep k smallest."""
    mv, mi = T.merge_topk_sorted(av, ai, bv, bi)
    return T.finalize_topk(mv, mi, k)


class RetrievalIndex:
    """Mutable kNN index over (id, vector) rows.  See module docstring.

    ``impl``: ``"fused"`` (default), ``"kernel"`` or ``"torch"``, forwarded
    to the per-segment scorers.  ``device``: where the segments live, and
    where results come back.  ``mesh`` / ``db_axis`` / ``query_axis``: the
    sharded main segment (module docstring); the mesh is runtime state,
    never saved.
    ``scan_dtype`` / ``overfetch``: the two-stage tier ("float32" is the
    exact flat scan).  ``ivf_cells`` / ``nprobe``: the IVF tier (0 cells is
    off; ``nprobe >= ivf_cells`` probes every cell, exact with a float32
    scan).  ``pq_m`` / ``pq_nbits``: the IVF-PQ tier (needs ``ivf_cells >
    0``; ``pq_m`` divides ``dim``; codes of ``pq_nbits`` <= 8 bits, a byte
    each).  k-means (cells and codebooks) is seeded from the main epoch,
    through a ``torch.Generator``, and is deterministic on every device
    (``core.kmeans``), so a rebuild of one epoch trains the same cells and
    codes, bit for bit, on the card too.
    """

    def __init__(self, dim: int, *, distance: str = "sqeuclidean",
                 impl: str = "fused", device="cuda", scan_dtype: str = "float32",
                 overfetch: int = 4, ivf_cells: int = 0, nprobe: int = 8, pq_m: int = 0,
                 pq_nbits: int = 8, mesh=None, db_axis: str = "model",
                 query_axis: str = "data"):
        self.dim = int(dim)
        self.mesh = mesh
        self.db_axis = db_axis
        self.query_axis = query_axis
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            mesh.axes((db_axis, query_axis))  # both must name axes of the mesh
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
        # Per-row namespace tags (DESIGN.md §17): int32, default tenant 0.
        self._main_tenant = np.zeros((0,), np.int32)
        self._delta_vecs = np.zeros((0, dim), np.float32)
        self._delta_ids = np.zeros((0,), np.int32)
        self._delta_live = np.zeros((0,), bool)
        self._delta_tenant = np.zeros((0,), np.int32)
        self._delta_n = 0  # write head; rows past it are dead capacity
        self._loc: dict[int, tuple[str, int]] = {}  # id -> (segment, row)
        # Per-segment versions: a delta append must not re-upload the main.
        self._version = {"main": 0, "delta": 0}
        self._dev_version: dict[str, object] = {}
        self._dev: dict[str, object] = {}
        # The lifecycle's tripwire (DESIGN.md §16): when set, a search that
        # would train IVF/PQ on the serving thread raises instead.
        self._forbid_sync_train = False

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, ids, vectors, *, tenants=None, **kw) -> "RetrievalIndex":
        """Pack (ids, vectors) straight into the main segment.

        ``tenants``: per-row int32 namespace tags (DESIGN.md §17); None tags
        every row tenant 0.
        """
        vectors = np.asarray(vectors, np.float32)
        idx = cls(vectors.shape[1], **kw)
        ids = idx._check_ids(ids, vectors)
        idx._main_vecs = np.ascontiguousarray(vectors)
        idx._main_ids = ids.copy()
        idx._main_live = np.ones(len(ids), bool)
        idx._main_tenant = idx._check_tenants(tenants, len(ids))
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
                    nprobe: int = 8, main_tenant=None, delta_tenant=None, mesh=None,
                    db_axis: str = "model", query_axis: str = "data") -> "RetrievalIndex":
        """An index with exactly this segment state (e.g. the reference's).

        Arrays are numpy: the main segment's rows, external ids and live
        mask, and the delta segment's rows, ids and live mask at full
        capacity with its write head ``delta_n``; ``main_tenant`` /
        ``delta_tenant`` their tenant tags (None: tenant 0).  ``ivf``: trained cells
        over the main rows (e.g. the reference's, through
        ``core.ivf.ivf_from_arrays``); the index then serves the IVF tier
        with them until the next compact retrains.  ``pq``: a (codebook,
        codes) replica of those cells' packed rows, with residual codes
        (e.g. the reference's, through ``core.pq.pq_from_arrays``); the
        index then serves the IVF-PQ tier with it, ``pq_m`` and
        ``pq_nbits`` taken from its codebook.  ``mesh`` / ``db_axis`` /
        ``query_axis`` as the constructor takes them; on a mesh the cells
        must be the count the index derives (a multiple of the db axis).
        """
        main_vecs = np.ascontiguousarray(main_vecs, np.float32)
        if pq is not None and ivf is None:
            raise ValueError("a PQ replica needs the cells it codes (ivf=...)")
        pq_m, pq_nbits = (0, 8) if pq is None else (pq[0].m, pq[0].ncodes.bit_length() - 1)
        idx = cls(main_vecs.shape[1], distance=distance, impl=impl, device=device,
                  scan_dtype=scan_dtype, overfetch=overfetch,
                  ivf_cells=0 if ivf is None else ivf.ncells, nprobe=nprobe, pq_m=pq_m,
                  pq_nbits=pq_nbits, mesh=mesh, db_axis=db_axis, query_axis=query_axis)
        idx._main_vecs = main_vecs
        idx._main_ids = np.asarray(main_ids, np.int32).copy()
        idx._main_live = np.asarray(main_live, bool).copy()
        idx._delta_vecs = np.array(delta_vecs, np.float32).reshape(-1, idx.dim)
        idx._delta_ids = np.asarray(delta_ids, np.int32).copy()
        idx._delta_live = np.asarray(delta_live, bool).copy()
        idx._delta_n = int(delta_n)
        idx._main_tenant = idx._check_tenants(main_tenant, len(main_vecs))
        idx._delta_tenant = idx._check_tenants(delta_tenant, len(idx._delta_vecs))
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
            if mesh is not None and ivf.ncells != idx._effective_ncells():
                raise ValueError(f"{ivf.ncells} cells on a mesh whose db axis derives "
                                 f"{idx._effective_ncells()}: cell blocks cannot be resharded")
            if pq is not None:
                if pq[1].codes.shape[0] != ivf.packed.shape[0] or not idx._use_pq():
                    raise ValueError(f"the PQ replica codes {pq[1].codes.shape[0]} slots; the "
                                     f"cells pack {ivf.packed.shape[0]} and the main segment "
                                     f"has {len(main_vecs)} rows (>= {2 ** pq_nbits} needed)")
                pq = (PQCodebook(pq[0].codebooks.to(idx.device)),
                      PQCodes(*(t.to(idx.device) for t in pq[1])))
            idx._install_ivf(IVFCells(*(t.to(idx.device) for t in ivf)), pq)
        return idx

    def save(self, directory: str, *, include_replicas: bool = True,
             extra: dict | None = None, wal: bool = False) -> str:
        """Snapshot the index under ``directory`` (``serving.snapshot``):
        versioned, atomic, CRC-stamped, in the reference's format.
        ``include_replicas=False`` leaves out the scalar scan replicas (a
        restore recomputes them); trained IVF/PQ state is always saved.
        ``extra`` rides in the manifest verbatim; ``wal=True`` stamps the
        journal as a verified prefix for ``lifecycle.WalWriter``."""
        from repro_torch.serving.snapshot import save_index

        return save_index(self, directory, include_replicas=include_replicas, extra=extra,
                          wal=wal)

    @classmethod
    def restore(cls, directory: str, *, device="cuda", mesh=None, db_axis: str = "model",
                query_axis: str = "data", impl: str | None = None) -> "RetrievalIndex":
        """An index from a snapshot of either package, on ``device`` (and
        ``mesh``), with no training; a mismatch raises
        ``serving.snapshot.SnapshotError``, and a search is bit-identical to
        the source's on the same device."""
        from repro_torch.serving.snapshot import restore_index

        return restore_index(directory, device=device, mesh=mesh, db_axis=db_axis,
                             query_axis=query_axis, impl=impl)

    def _check_ids(self, ids, vectors) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        assert vectors.shape == (len(ids), self.dim), (vectors.shape, len(ids))
        assert (ids >= 0).all() and (ids < 2**31).all(), "ids must fit int32"
        assert len(np.unique(ids)) == len(ids), "duplicate ids in one call"
        return ids.astype(np.int32)

    @staticmethod
    def _check_tenants(tenants, n: int) -> np.ndarray:
        if tenants is None:
            return np.zeros((n,), np.int32)
        tenants = np.asarray(tenants, np.int64)
        assert tenants.shape == (n,), (tenants.shape, n)
        assert (tenants >= 0).all() and (tenants < 2**31).all(), "tenant tags must fit int32"
        return tenants.astype(np.int32)

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
        vectors = np.asarray(vectors, np.float32)
        ids = self._check_ids(ids, vectors)
        for i in ids:
            if int(i) in self._loc:
                raise KeyError(f"id {int(i)} already indexed (use upsert)")
        self._append_delta(ids, vectors, self._check_tenants(tenants, len(ids)))

    def upsert(self, ids, vectors, *, tenants=None) -> None:
        """Insert-or-replace: an existing id is tombstoned, then re-appended."""
        vectors = np.asarray(vectors, np.float32)
        ids = self._check_ids(ids, vectors)
        for i in ids:
            self._tombstone(int(i))
        self._append_delta(ids, vectors, self._check_tenants(tenants, len(ids)))

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

    def _append_delta(self, ids: np.ndarray, vectors: np.ndarray,
                      tenants: np.ndarray | None = None) -> None:
        if tenants is None:
            tenants = np.zeros((len(ids),), np.int32)
        need = self._delta_n + len(ids)
        if need > len(self._delta_vecs):
            cap = max(_MIN_DELTA_CAP, T.next_pow2(need))
            grown = np.zeros((cap, self.dim), np.float32)
            grown[: self._delta_n] = self._delta_vecs[: self._delta_n]
            self._delta_vecs = grown
            for name in ("_delta_ids", "_delta_live", "_delta_tenant"):
                old = getattr(self, name)
                fresh = np.zeros((cap,), old.dtype)
                fresh[: self._delta_n] = old[: self._delta_n]
                setattr(self, name, fresh)
        r0 = self._delta_n
        self._delta_vecs[r0 : r0 + len(ids)] = vectors
        self._delta_ids[r0 : r0 + len(ids)] = ids
        self._delta_live[r0 : r0 + len(ids)] = True
        self._delta_tenant[r0 : r0 + len(ids)] = tenants
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

    def _live_tenants(self) -> np.ndarray:
        """Live tenant tags in the ``_live_rows`` order (DESIGN.md §17)."""
        n = self._delta_n
        return np.concatenate([self._main_tenant[self._main_live],
                               self._delta_tenant[:n][self._delta_live[:n]]])

    def config_kwargs(self) -> dict:
        """Constructor keywords that reproduce this index's search config:
        ``RetrievalIndex(self.dim, **idx.config_kwargs())`` scans alike.  The
        lifecycle builds each background epoch with them."""
        return {"distance": self.distance, "impl": self.impl, "device": self.device,
                "scan_dtype": self.scan_dtype, "overfetch": self.overfetch,
                "ivf_cells": self.ivf_cells, "nprobe": self.nprobe, "pq_m": self.pq_m,
                "pq_nbits": self.pq_nbits}

    def compact(self) -> None:
        """Re-pack live rows into a fresh immutable main segment."""
        vecs, ids = self._live_rows()
        tenants = self._live_tenants()
        self._main_vecs = vecs
        self._main_ids = ids
        self._main_live = np.ones(len(ids), bool)
        self._main_tenant = tenants
        self._delta_vecs = np.zeros((0, self.dim), np.float32)
        self._delta_ids = np.zeros((0,), np.int32)
        self._delta_live = np.zeros((0,), bool)
        self._delta_tenant = np.zeros((0,), np.int32)
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
        self._upload("main_vecs", self._main_epoch, lambda: _tensor(self._main_vecs, dev))
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
            self._check_may_train()
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
            if pq is None:
                self._check_may_train()
                pq = build_ivfpq(self._dev["main_vecs"], ivf, self.pq_m, nbits=self.pq_nbits,
                                 distance=self.distance, impl=self.impl,
                                 generator=torch.Generator().manual_seed(self._main_epoch))
            self._dev["main_pq"] = pq
        else:
            self._dev["main_ivf_q"] = quantize_rows(ivf.packed, self.scan_dtype,
                                                    distance=self.distance)
        self._dev_version["main_ivf"] = self._main_epoch

    def _check_may_train(self) -> None:
        if self._forbid_sync_train:
            raise RuntimeError(
                f"synchronous IVF/PQ training tripwire: epoch {self._main_epoch} has no "
                f"trained structure and _forbid_sync_train is set — the lifecycle layer "
                f"must train it in the background worker (serving.lifecycle, DESIGN.md §16)")

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
        (the flat scan) for an empty main segment.  On a mesh the count
        rounds down to a multiple of the db axis' size, so cell blocks shard
        evenly; 0 there (fewer than ~4 P rows) means the flat scan."""
        n = len(self._main_vecs)
        if n == 0:
            return 0
        ncells = max(1, min(self.ivf_cells, n // 4 or 1))
        if self.mesh is not None:
            P = int(self.mesh.shape[self.db_axis])
            ncells = (ncells // P) * P
        return ncells

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

        ``filter``: a ``serving.filters.QueryFilter`` (DESIGN.md §17): tenant
        isolation, an allow-list, per-query exclusions.  None or a
        trivially-true filter runs this unfiltered code.
        """
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        assert q.ndim == 2 and q.shape[1] == self.dim, q.shape
        k = int(k)
        assert k >= 1
        if filter is not None:
            f = F.normalize(filter, q.shape[0])
            if f is not None:
                return self._search_filtered(q, k, f)
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

    # -- filtered search (DESIGN.md §17) ------------------------------------

    def _search_filtered(self, q, k: int, f) -> SearchResult:
        """Search under a canonical, non-trivial ``QueryFilter``.

        The filter's live selectivity ``s`` is counted exactly, on the card,
        for every search, and resolves the mode ("auto": pre below 0.5).
        The fetch is widened by the exclusion width E (dropping E rows
        leaves k exact survivors), and in post mode by ~1/s too
        (``filters.widen``).  The row predicates become a bitmap per
        segment, applied inside the main scan (pre) or to its candidates
        (post); the delta, small by construction, is always pre-filtered.
        Exclusions are dropped once, by external id, on the merged
        candidates.
        """
        m = q.shape[0]
        dev = self._device_state()
        in_allowed = self._memberships(f, dev)
        E = F.exclusion_width(f)
        s = self._selectivity(f, dev, in_allowed)
        mode = F.resolve_mode(f.mode, s)
        if self.mesh is not None:
            mode = "post"  # the sharded scorers take no per-query bitmap
        k_fetch = k + E
        if mode == "post":
            k_fetch = max(k_fetch, F.widen(k, s) + E)
        if self._use_ivf() and self.impl == "fused" and len(self._main_vecs):
            # The cell-probed kernels bound the fetch by the cell block:
            # clamp the widening rather than refuse it.
            k_fetch = max(k, min(k_fetch, int(self._dev["main_ivf"].cell_cap)))
        k_out = T.next_pow2(k_fetch)
        sets = []
        if "main" in in_allowed:
            sets.append(self._main_candidates(
                q, k_out, dev, self._allowed_bitmap("main", f, m, in_allowed["main"]),
                post=mode == "post"))
        if "delta" in in_allowed:
            sets.append(_segment_candidates(
                q, *dev["delta"], self._allowed_bitmap("delta", f, m, in_allowed["delta"]),
                k_out=k_out, distance=self.distance, impl=self.impl))
        if not sets:
            return SearchResult(torch.full((m, k), T.POS_INF, device=self.device),
                                torch.full((m, k), -1, dtype=torch.int32, device=self.device))
        vals, ids = sets[0] if len(sets) == 1 else T.merge_topk_sorted(*sets[0], *sets[1])
        ex = None if f.exclude_ids is None else torch.from_numpy(f.exclude_ids).to(self.device)
        return SearchResult(*_finalize_filtered(vals, ids, ex, k=k))

    def _memberships(self, f, dev: dict) -> dict:
        """{segment: its rows' allow-list membership, bool [n_seg] on the
        card, or None without an allow-list}, for the segments that hold
        rows; computed for each search."""
        segs = [seg for seg, rows in (("main", len(self._main_vecs)), ("delta", self._delta_n))
                if rows]
        if f.allowed_ids is None:
            return dict.fromkeys(segs)
        allowed = torch.from_numpy(f.allowed_ids).to(self.device)
        return {seg: _members(dev[seg][2], allowed) for seg in segs}

    def _selectivity(self, f, dev: dict, in_allowed: dict) -> float:
        """``filters.selectivity`` over both segments' rows, counted on the
        card: the live rows that the allow-list (``in_allowed``, a
        segment's membership or None) and the batch's most selective tenant
        allow, over the live rows.  One read back to the host."""
        uniq = None if f.tenant is None else np.unique(f.tenant)
        n_live, allowed = 0, 0
        for seg, ok in in_allowed.items():
            live = dev[seg][1]
            base = live if ok is None else live & ok
            n_live = n_live + live.sum()
            if uniq is None:
                allowed = allowed + base.sum()
                continue
            tags, _, tag_of_row = self._tenant_words(seg)
            pos = np.searchsorted(tags, uniq).clip(0, len(tags) - 1)
            rows = np.where(tags[pos] == uniq, pos, len(tags))
            # Rows of each tag that the live mask and allow-list pass; the
            # last bin (rows that do not pass, and tags absent here) reads 0.
            per_tag = torch.bincount(torch.where(base, tag_of_row, len(tags)),
                                     minlength=len(tags) + 1)
            per_tag[-1] = 0
            allowed = allowed + per_tag[torch.from_numpy(rows).to(self.device)]
        if not in_allowed:
            return 1.0
        n_live, *counts = torch.cat([n_live.reshape(1), allowed.reshape(-1)]).tolist()
        if n_live == 0:
            return 1.0
        return min(counts) / n_live

    def _tenant_words(self, seg: str):
        """(the segment's distinct tenant tags, sorted; their packed rows
        [T + 1, ceil(n_seg / 32)] on the card, row t the bitmap of the rows
        tagged with tag t, the last row all zero; each row's tag as an index
        into the tags, int64 [n_seg] on the card), kept per segment version:
        the main epoch (tags change only at build and compact), the delta's
        version."""
        if seg == "main":
            tenants, key = self._main_tenant, self._main_epoch
        else:
            tenants, key = self._delta_tenant, self._version["delta"]

        def make():
            tags = np.unique(tenants)
            col = torch.from_numpy(tenants).to(self.device)
            tags_t = torch.from_numpy(tags).to(self.device)
            words = pack_mask(col[None, :] == tags_t[:, None])
            zero = torch.zeros((1, words.shape[1]), dtype=torch.int32, device=self.device)
            return tags, torch.cat([words, zero]), torch.searchsorted(tags_t, col)

        self._upload(seg + "_tenant_words", key, make)
        return self._dev[seg + "_tenant_words"]

    def _allowed_bitmap(self, seg: str, f, m: int, in_allowed=None):
        """The filter's row predicates over a segment's rows as the fused
        kernel's packed bitmap on the card: [m, W] with a tenant predicate,
        one shared row [1, W] for an allow-list alone (``in_allowed``, the
        rows' membership), None for neither.

        Built packed, never as [m, n] bools: the per-tenant rows
        (``_tenant_words``) gathered by the batch's tags, ANDed with the
        allow-list's row.  Dead and capacity rows may come out allowed: the
        live mask already kills them.
        """
        ok = None if in_allowed is None else pack_mask(in_allowed[None, :])
        if f.tenant is not None:
            tags, words, _ = self._tenant_words(seg)
            pos = np.searchsorted(tags, f.tenant).clip(0, len(tags) - 1)
            rows = np.where(tags[pos] == f.tenant, pos, len(tags))
            t_ok = words[torch.from_numpy(rows).to(self.device)]
            ok = t_ok if ok is None else t_ok & ok
        return ok

    # -- main-segment scoring -------------------------------------------------

    def _main_candidates(self, q, k_out: int, dev: dict, allowed=None, post: bool = False):
        """Top-``k_out`` live candidates of the main segment, by its tier;
        ``allowed`` / ``post`` as ``_segment_candidates`` takes them."""
        vecs, live, ids = dev["main"]
        if self.mesh is not None:
            return self._main_candidates_sharded(q, k_out, dev, allowed)
        if not self._use_ivf() and self.scan_dtype == "float32":
            return _segment_candidates(q, vecs, live, ids, allowed, k_out=k_out,
                                       distance=self.distance, impl=self.impl, post=post)
        kw = dict(distance=self.distance, impl=self.impl, overfetch=self.overfetch,
                  db_live=live, q_allowed=None if post else allowed)
        if self._use_pq():
            vals, idx = ivfpq_query(q, vecs, self._dev["main_ivf"], *self._dev["main_pq"],
                                    k_out, nprobe=self.effective_nprobe(), **kw)
        elif self._use_ivf():
            vals, idx = ivf_query(q, vecs, self._dev["main_ivf"], k_out,
                                  nprobe=self.effective_nprobe(),
                                  packed_q=self._dev["main_ivf_q"], **kw)
        else:
            vals, idx = two_stage_query(q, vecs, self._dev["main_q"], k_out, **kw)
        return _scored(vals, idx, ids, k_out, allowed if post else None)

    def _main_candidates_sharded(self, q, k_out: int, dev: dict, allowed=None):
        """Score the main segment over the mesh (``core.distributed``).

        Tombstones shard over ``db_axis`` beside the rows, so dead rows are
        +inf before the butterfly merge and its payload stays ``k_out`` a
        row.  The flat tier pads the rows to a multiple of the db axis
        (kept per main epoch, the padded live mask per main version); with
        a quantized ``scan_dtype`` each shard scans its slice of the padded
        replica (kept per (epoch, padded size)) and rescores, and the merge
        wire is bf16.  The IVF and IVF-PQ tiers shard the cell-packed
        arrays; the live mask rides the packing (kept per main version and
        epoch); IVF-PQ's wire is bf16, as the reference's.  ``allowed``,
        the filter's packed words, is always applied after the scorer.
        """
        from repro_torch.core import distributed as KD
        from repro_torch.core.ivf import packed_live

        _, live, ids = dev["main"]
        P_q = int(self.mesh.shape[self.query_axis])
        m = q.shape[0]
        qp = KD.pad_rows_to(q, P_q)
        common = dict(query_axis=self.query_axis, db_axis=self.db_axis, k=k_out,
                      distance=self.distance, impl=self.impl, overfetch=self.overfetch)
        quant = self.scan_dtype != "float32"
        if self._use_ivf():
            ivf = self._dev["main_ivf"]
            self._upload("main_ivf_live", (self._version["main"], self._main_epoch),
                         lambda: packed_live(ivf, live))
            live_p = self._dev["main_ivf_live"]
            nprobe = self.effective_nprobe()
            if self._use_pq():
                fn = KD.make_ivfpq_query_sharded(self.mesh, nprobe=nprobe,
                                                 cell_cap=ivf.cell_cap,
                                                 wire_dtype=torch.bfloat16, **common)
                vals, idx = fn(qp, ivf.centroids, *self._dev["main_pq"], ivf.packed,
                               ivf.row_of_slot, live_p)
            else:
                fn = KD.make_ivf_query_sharded(self.mesh, nprobe=nprobe, cell_cap=ivf.cell_cap,
                                               scan_dtype=self.scan_dtype,
                                               wire_dtype=torch.bfloat16 if quant else None,
                                               **common)
                vals, idx = fn(qp, ivf.centroids, ivf.packed, ivf.row_of_slot, live_p,
                               self._dev["main_ivf_q"])
        else:
            n = len(self._main_vecs)
            n_pad = n + (-n) % int(self.mesh.shape[self.db_axis])
            self._upload("main_padded", (self._main_epoch, n_pad), lambda: KD.pad_rows_to(
                dev["main"][0], int(self.mesh.shape[self.db_axis])))
            self._upload("main_padded_live", (self._version["main"], n_pad),
                         lambda: torch.cat([live, live.new_zeros(n_pad - n)]))
            db_q = None
            if quant:
                self._upload("main_padded_q", (self._main_epoch, n_pad), lambda: quantize_rows(
                    self._dev["main_padded"], self.scan_dtype, distance=self.distance))
                db_q = self._dev["main_padded_q"]
            fn = KD.make_query_sharded(self.mesh, scan_dtype=self.scan_dtype,
                                       wire_dtype=torch.bfloat16 if quant else None, **common)
            vals, idx = fn(qp, self._dev["main_padded"], n, self._dev["main_padded_live"],
                           db_q)
        return _scored(vals[:m], idx[:m], ids, k_out, allowed)
