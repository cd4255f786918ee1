"""Versioned snapshot/restore of a RetrievalIndex (DESIGN.md §12).

Port of ``repro/serving/snapshot.py``, format version 2, in the reference's
on-disk format: a snapshot written by either package restores in the other
without arguments.  At serving scale the cold-start cost is not loading
bytes but re-running what is derived from them: the k-means that trains the
IVF cells and the PQ codebooks and codes.  A snapshot carries that trained
state, so a restore is a read, a check and an upload.

Layout on disk::

    <dir>/manifest.json     format version, config signature, per-file byte
                            counts and CRCs (written LAST)
    <dir>/main.npz          main segment: vecs, ids, live mask, tenant tags
    <dir>/journal.bin       delta segment as an append-only framed journal
    <dir>/ivf.npz           the trained IVFCells (centroids, packed rows,
                            both permutations, counts), when configured
    <dir>/pq.npz            PQ codebooks, codes and decoded-row hy, when
                            configured
    <dir>/replica.npz       scalar scan replicas (optional: without them a
                            restore recomputes them; quantization is a
                            deterministic map, not training)

Guarantees, as the reference's:

* **Atomic**: written to ``<dir>.tmp-<pid>`` and renamed in; the manifest,
  written last, says ``complete: true``.  Each file is fsynced before the
  rename (the reference's are not): the image's seconds of writeback are
  paid where it is written (by the lifecycle's worker, off the serving
  thread), not by the next small fsync that lands behind them (a WAL ack,
  the swap's journal tail).
* **Hard-fail on mismatch**: format version, config signature and a CRC32
  and byte count per file are checked before anything is built; a
  mismatch raises ``SnapshotError``.
* **Zero training on restore**: cells, codebooks and codes are loaded,
  ``core.kmeans.lloyd`` is never entered, and the epoch counter resumes
  from the manifest.
* **Bit-identical search**: every array the scan reads comes back byte for
  byte (or from a deterministic map), so a restored index returns the
  source's values and ids.

The journal's framing (``write_record``, ``read_journal``) is the WAL of
``serving.lifecycle``: a snapshot saved with ``wal=True`` stamps its journal
as a verified prefix, a ``WalWriter`` appends fsync-acked records after it,
and a restore replays the prefix strictly and the appended tail leniently
(a torn in-flight frame at the end is dropped: it was never acked).

The port's side of the format:

* Trained state is read off the device (``ivf_to_arrays``,
  ``pq_to_arrays``) and uploaded to ``device`` on restore.
* A bf16 replica is written as its raw 2-byte words (numpy has no bf16:
  ``int16`` bits viewed as ``V2``) and read back through ``int16``.  The
  reference writes the same bytes (``<V2``; the port's header says
  ``|V2``), and cannot read them back itself (ROADMAP, deliberate
  differences).
* The manifest's ``impl`` carries the reference's names: the port writes
  ``torch``/``kernel``/``fused`` as ``jnp``/``pallas``/``fused`` and reads
  them back the other way (``IMPL_TO_REFERENCE``).

The per-shard images of the reference (``save_shards`` ... ``restore_shard``)
come with ``serving/shards.py``.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import zlib
from typing import IO

import numpy as np
import torch

from repro_torch.core.ivf import _np, _tensor

# Version 2: journals carry the RPJL0002 magic, whose record CRCs are
# seeded with the record tag, and manifests may carry the ``wal`` marker.
# Version-1 snapshots restore unchanged.
FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
_MANIFEST = "manifest.json"
_MAIN = "main.npz"
_JOURNAL = "journal.bin"
_IVF = "ivf.npz"
_PQ = "pq.npz"
_REPLICA = "replica.npz"

_JOURNAL_MAGIC_V1 = b"RPJL0001"  # record CRC covers the payload only
_JOURNAL_MAGIC = b"RPJL0002"  # record CRC seeded with the tag
_REC_HEADER = struct.Struct("<4sII")  # tag, payload bytes, payload crc32

# The knobs that determine what a search computes: two indexes with equal
# signatures scan identically.  Recorded in the manifest, checked on restore.
_CONFIG_KEYS = ("dim", "distance", "scan_dtype", "overfetch", "ivf_cells",
                "nprobe", "pq_m", "pq_nbits")

# The manifest's ``impl``: the port's scorer names and the reference's.
IMPL_TO_REFERENCE = {"torch": "jnp", "kernel": "pallas", "fused": "fused"}
IMPL_FROM_REFERENCE = {v: k for k, v in IMPL_TO_REFERENCE.items()}


class SnapshotError(RuntimeError):
    """A snapshot that must not be served: version/signature/integrity."""


# -- journal framing ---------------------------------------------------------


def write_record(f: IO[bytes], tag: bytes, arrays: dict) -> int:
    """Append one framed record (CRC seeded with the tag); returns the bytes
    written, the WAL's unit of durability."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    f.write(_REC_HEADER.pack(tag, len(payload), zlib.crc32(payload, zlib.crc32(tag))))
    f.write(payload)
    return _REC_HEADER.size + len(payload)


def read_journal(path: str, *, verified_bytes: int | None = None,
                 allow_torn_tail: bool = False,
                 ) -> tuple[list[tuple[bytes, dict, int]], int, int]:
    """Parse a journal into ``(records, valid_bytes, torn_bytes)``.

    ``records`` entries are ``(tag, arrays, end_offset)`` in append order.
    Frames are strict by default: a torn or CRC-failing frame raises
    ``SnapshotError``.  A WAL journal passes its stamped prefix length as
    ``verified_bytes`` and ``allow_torn_tail=True``; past the prefix, an
    incomplete frame, or a CRC-failing one that reaches the end of the file,
    is a torn in-flight append and parsing stops at the last valid frame
    boundary; a CRC-failing frame with more journal after it is corruption
    and raises.
    """
    with open(path, "rb") as f:
        data = f.read()
    magic = data[: len(_JOURNAL_MAGIC)]
    if magic == _JOURNAL_MAGIC:
        seed_tag = True
    elif magic == _JOURNAL_MAGIC_V1:
        seed_tag = False
    else:
        raise SnapshotError(f"journal magic mismatch in {path}: {magic!r}")
    pos, out = len(_JOURNAL_MAGIC), []
    ver = len(data) if verified_bytes is None else int(verified_bytes)
    while pos < len(data):
        in_tail = allow_torn_tail and pos >= ver
        if pos + _REC_HEADER.size > len(data):
            if in_tail:
                return out, pos, len(data) - pos
            raise SnapshotError(f"truncated journal header at byte {pos}")
        tag, nbytes, crc = _REC_HEADER.unpack_from(data, pos)
        end = pos + _REC_HEADER.size + nbytes
        if end > len(data):
            if in_tail:
                return out, pos, len(data) - pos
            raise SnapshotError(f"truncated journal payload at byte {pos}")
        payload = data[pos + _REC_HEADER.size : end]
        want = zlib.crc32(payload, zlib.crc32(tag)) if seed_tag else zlib.crc32(payload)
        if want != crc:
            if in_tail and end == len(data):
                return out, pos, len(data) - pos
            raise SnapshotError(f"journal record CRC mismatch at byte {pos}")
        with np.load(io.BytesIO(payload)) as z:
            out.append((tag, {k: z[k] for k in z.files}, end))
        pos = end
    return out, pos, 0


# -- save --------------------------------------------------------------------


def _npz_atomic(path: str, arrays: dict) -> None:
    # np.savez appends .npz to names without it; write the exact path.
    with open(path, "wb") as f:
        np.savez(f, **arrays)
        _sync(f)


def _sync(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _file_stamp(path: str, limit: int | None = None) -> dict:
    """Byte count and streaming CRC32, never the whole file in memory;
    ``limit`` stamps only the first ``limit`` bytes (a WAL journal's
    verified prefix)."""
    crc, nbytes = 0, 0
    left = limit
    with open(path, "rb") as f:
        while True:
            want = 1 << 22 if left is None else min(1 << 22, left)
            if not want:
                break
            chunk = f.read(want)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            nbytes += len(chunk)
            if left is not None:
                left -= len(chunk)
    return {"bytes": nbytes, "crc32": crc}


def _replace_dir(directory: str, tmp: str, *, keep_old: bool = False) -> str | None:
    """Swap ``tmp`` into ``directory`` by renames: the old image moves aside,
    the new one renames in, and only then is the old one removed, so a crash
    between the two leaves a restorable image (at ``.old-<pid>``).
    ``keep_old=True`` leaves the old image there and returns its path, for
    the caller to remove (the lifecycle does so off the serving thread:
    removing a 10 GB image takes seconds)."""
    old = None
    if os.path.exists(directory):
        old = directory.rstrip("/") + f".old-{os.getpid()}"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.rename(directory, old)
    os.rename(tmp, directory)
    if old is not None and not keep_old:
        shutil.rmtree(old)
        old = None
    return old


def _host(t: torch.Tensor) -> np.ndarray:
    """A replica tensor's bytes as numpy: bf16 as its 2-byte words (``V2``)."""
    if t.dtype == torch.bfloat16:
        return _np(t.view(torch.int16)).view(np.dtype("V2"))
    return _np(t)


def _device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """The inverse of ``_host``: ``V2`` words come back as bf16."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return _tensor(np.ascontiguousarray(a).view(np.int16), device).view(torch.bfloat16)
    return _tensor(np.ascontiguousarray(a), device)


def save_index(idx, directory: str, *, include_replicas: bool = True,
               extra: dict | None = None, wal: bool = False) -> str:
    """Snapshot ``idx`` (a ``serving.index.RetrievalIndex``) under ``directory``.

    Returns the snapshot path.  Atomic (tmp + rename): an existing snapshot
    there is replaced only once the new one is complete on disk.  ``extra``
    is caller metadata carried verbatim in the manifest.  ``wal=True`` stamps
    the journal as a verified prefix, which a ``lifecycle.WalWriter`` may
    extend in place.  Trained state is taken from the device cache when it
    is current, else trained here once: a snapshot never carries a stale
    epoch's quantizer.
    """
    from repro_torch.core.ivf import ivf_to_arrays
    from repro_torch.core.pq import pq_to_arrays

    tmp = directory.rstrip("/") + f".tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    files: dict[str, dict] = {}

    _npz_atomic(os.path.join(tmp, _MAIN), {
        "vecs": idx._main_vecs, "ids": idx._main_ids, "live": idx._main_live,
        "tenant": idx._main_tenant,
    })
    files[_MAIN] = _file_stamp(os.path.join(tmp, _MAIN))

    # The delta as one bulk ADD in write-head order, liveness per row (an id
    # upserted twice inside the delta owns a dead and a live row).
    n = idx._delta_n
    with open(os.path.join(tmp, _JOURNAL), "wb") as f:
        f.write(_JOURNAL_MAGIC)
        if n:
            write_record(f, b"ADD\0", {
                "ids": idx._delta_ids[:n], "vecs": idx._delta_vecs[:n],
                "live": idx._delta_live[:n], "tenant": idx._delta_tenant[:n],
            })
        _sync(f)
    files[_JOURNAL] = _file_stamp(os.path.join(tmp, _JOURNAL))

    if len(idx._main_vecs):
        idx._device_state()
    dev = idx._dev
    if idx._use_ivf():
        _npz_atomic(os.path.join(tmp, _IVF), ivf_to_arrays(dev["main_ivf"]))
        files[_IVF] = _file_stamp(os.path.join(tmp, _IVF))
    if idx._use_pq():
        _npz_atomic(os.path.join(tmp, _PQ), pq_to_arrays(*dev["main_pq"]))
        files[_PQ] = _file_stamp(os.path.join(tmp, _PQ))
    if include_replicas:
        reps = {}
        for key in ("main_q", "main_ivf_q"):
            q = dev.get(key)
            if q is not None:
                reps[f"{key}.data"] = _host(q.data)
                reps[f"{key}.hy"] = _host(q.hy)
                if q.scale is not None:
                    reps[f"{key}.scale"] = _host(q.scale)
        if reps:
            _npz_atomic(os.path.join(tmp, _REPLICA), reps)
            files[_REPLICA] = _file_stamp(os.path.join(tmp, _REPLICA))

    manifest = {
        "format_version": FORMAT_VERSION,
        "config": config_signature(idx),
        "impl": IMPL_TO_REFERENCE[idx.impl],
        "main_epoch": idx._main_epoch,
        "rows": {"main": len(idx._main_vecs), "delta": int(n), "live": len(idx)},
        "include_replicas": bool(include_replicas),
        "extra": dict(extra) if extra else {},
        "files": files,
        "complete": True,
    }
    if wal:
        manifest["wal"] = True
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        _sync(f)
    _replace_dir(directory, tmp)
    return directory


def checkpoint_journal(directory: str, *, rows: dict | None = None) -> dict:
    """Fold a WAL snapshot's appended journal tail into its verified prefix.

    Restamps ``journal.bin`` at its current length and rewrites only
    ``manifest.json`` (tmp + ``os.replace``); ``main.npz`` is untouched.
    ``rows`` updates the manifest's row counts.  Returns the new stamp.
    """
    manifest = read_manifest(directory, verify=False)
    _expect(bool(manifest.get("wal")),
            f"{directory} is not a WAL snapshot — checkpoint_journal extends "
            f"journal stamps in place; use save_index for full images")
    stamp = _file_stamp(os.path.join(directory, _JOURNAL))
    manifest["files"][_JOURNAL] = stamp
    if rows is not None:
        manifest["rows"] = {k: int(v) for k, v in rows.items()}
    mpath = os.path.join(directory, _MANIFEST)
    tmp = mpath + f".tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        _sync(f)
    os.replace(tmp, mpath)
    return stamp


def config_signature(idx) -> dict:
    """The search-determining knobs of ``idx`` (the manifest's ``config``)."""
    return {k: getattr(idx, k) for k in _CONFIG_KEYS}


# -- restore -----------------------------------------------------------------


def read_manifest(directory: str, *, verify: bool = True) -> dict:
    """Load and version-check a snapshot manifest; ``verify=True`` also
    CRC-checks every file (streaming; a WAL journal up to its stamp)."""
    path = os.path.join(directory, _MANIFEST)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SnapshotError(f"unreadable snapshot manifest {path}: {e}") from e
    if not manifest.get("complete"):
        raise SnapshotError(f"incomplete snapshot (torn save?) at {directory}")
    ver = manifest.get("format_version")
    if ver not in SUPPORTED_VERSIONS:
        raise SnapshotError(
            f"snapshot format_version {ver} not in supported {SUPPORTED_VERSIONS}; "
            f"re-save the index with this tree (no silent cross-version read)")
    if not verify:
        return manifest
    wal = bool(manifest.get("wal"))
    for name, stamp in manifest["files"].items():
        limit = stamp["bytes"] if wal and name == _JOURNAL else None
        try:
            got = _file_stamp(os.path.join(directory, name), limit)
        except OSError as e:
            raise SnapshotError(f"missing snapshot segment {name}: {e}") from e
        if got != stamp:
            raise SnapshotError(f"snapshot segment {name} corrupted/truncated: "
                                f"expected {stamp}, found {got}")
    return manifest


def replay_record(idx, tag: bytes, rec: dict) -> None:
    """Apply one journal record through the index's own mutation path.

    Shared by restore and the lifecycle's handoff replay.  A bulk ADD is one
    vectorized append, its live mask one slice write, checked against the
    record before returning.
    """
    if tag == b"ADD\0":
        _expect(all(k in rec for k in ("ids", "vecs", "live")),
                f"ADD journal record missing fields: has {sorted(rec)}")
        rids = rec["ids"].astype(np.int32)
        _expect(rec["vecs"].shape == (len(rids), idx.dim),
                f"journal vecs shape {rec['vecs'].shape} != ({len(rids)}, {idx.dim})")
        live = rec["live"].astype(bool)
        _expect(live.shape == (len(rids),),
                f"journal live-mask shape {live.shape} != ({len(rids)},)")
        r0 = idx._delta_n
        # Records without tenant tags (WAL records, older images) replay
        # with tenant 0 (DESIGN.md §17).
        ten = rec.get("tenant")
        idx._append_delta(rids, rec["vecs"].astype(np.float32),
                          None if ten is None else ten.astype(np.int32))
        if not live.all():
            # An id leaves ``_loc`` only while it still points at its dead row.
            idx._delta_live[r0 : r0 + len(rids)] = live
            for off in np.nonzero(~live)[0]:
                if idx._loc.get(int(rids[off])) == ("delta", r0 + int(off)):
                    del idx._loc[int(rids[off])]
        _expect(idx._delta_n == r0 + len(rids),
                f"vectorized ADD replay grew delta to {idx._delta_n}, "
                f"expected {r0 + len(rids)}")
        _expect(np.array_equal(idx._delta_live[r0 : r0 + len(rids)], live),
                "vectorized ADD replay live-mask bits differ from record")
    elif tag == b"UPS\0":
        _expect(all(k in rec for k in ("ids", "vecs")),
                f"UPS journal record missing fields: has {sorted(rec)}")
        _expect(rec["vecs"].shape == (len(rec["ids"]), idx.dim),
                f"journal vecs shape {rec['vecs'].shape} != ({len(rec['ids'])}, {idx.dim})")
        idx.upsert(rec["ids"].astype(np.int64), rec["vecs"].astype(np.float32))
    elif tag == b"DEL\0":
        _expect("ids" in rec, f"DEL journal record missing ids: has {sorted(rec)}")
        idx.delete(rec["ids"].astype(np.int64))
    else:
        raise SnapshotError(f"unknown journal record tag {tag!r}")


def restore_index(directory: str, *, device="cuda", mesh=None, db_axis: str = "model",
                  query_axis: str = "data", impl: str | None = None,
                  recovery: dict | None = None):
    """Rebuild a ``RetrievalIndex`` from a snapshot on ``device`` (the card
    unless the caller asks for the CPU), with no training.

    ``mesh`` (runtime state, never saved) serves the restored index
    sharded over ``db_axis``; a mesh whose db axis derives another cell
    count than the snapshot trained raises, since a cell layout cannot be
    resharded without retraining.  ``impl`` overrides the scorer
    (``torch``/``kernel``/``fused``); by default the manifest's, mapped
    from the reference's names.  ``recovery``, when given, is filled with
    what the journal replay saw (stamped, valid and torn bytes; prefix and
    tail records).
    """
    from repro_torch.serving.index import RetrievalIndex

    manifest = read_manifest(directory)
    _expect("shard" not in manifest,
            f"{directory} is a per-shard image; shard images are not ported yet")
    cfg = dict(manifest["config"])
    dim = cfg.pop("dim")
    if impl is None:
        stored = manifest.get("impl", "jnp")
        _expect(stored in IMPL_FROM_REFERENCE, f"unknown scorer impl {stored!r} in manifest")
        impl = IMPL_FROM_REFERENCE[stored]
    idx = RetrievalIndex(dim, impl=impl, device=device, mesh=mesh, db_axis=db_axis,
                         query_axis=query_axis, **cfg)

    with np.load(os.path.join(directory, _MAIN)) as z:
        vecs, ids, live = z["vecs"], z["ids"], z["live"]
        # Images from before tenant tags restore as all-tenant-0.
        tenant = z["tenant"] if "tenant" in z.files else np.zeros(len(ids), np.int32)
    _expect(vecs.shape == (len(ids), dim) and vecs.dtype == np.float32,
            f"main segment shape/dtype mismatch: {vecs.shape} {vecs.dtype} vs dim={dim}")
    _expect(live.shape == (len(ids),) and live.dtype == bool,
            f"main live-mask mismatch: {live.shape} {live.dtype}")
    _expect(tenant.shape == (len(ids),),
            f"main tenant column shape {tenant.shape} != ({len(ids)},)")
    _expect(len(ids) == manifest["rows"]["main"],
            f"main rows {len(ids)} != manifest {manifest['rows']['main']}")
    idx._main_vecs = np.ascontiguousarray(vecs)
    idx._main_ids = ids.astype(np.int32)
    idx._main_live = live.copy()
    idx._main_tenant = tenant.astype(np.int32)
    idx._loc = {int(i): ("main", r) for r, i in enumerate(ids) if live[r]}
    idx._bump("main")
    # Resume the epoch: it keys the device caches and seeds the next retrain.
    idx._main_epoch = int(manifest["main_epoch"])

    wal = bool(manifest.get("wal"))
    stamped = int(manifest["files"][_JOURNAL]["bytes"])
    records, valid_bytes, torn_bytes = read_journal(
        os.path.join(directory, _JOURNAL), verified_bytes=stamped if wal else None,
        allow_torn_tail=wal)
    n_prefix = sum(1 for _, _, end in records if end <= stamped)
    for tag, rec, _ in records[:n_prefix]:
        replay_record(idx, tag, rec)
    # The manifest's row counts are the state at the stamp: checked between
    # the prefix and the tail (acked after the last checkpoint).
    _expect(idx._delta_n == manifest["rows"]["delta"],
            f"journal replay produced {idx._delta_n} delta rows, manifest says "
            f"{manifest['rows']['delta']}")
    _expect(len(idx) == manifest["rows"]["live"],
            f"restored live count {len(idx)} != manifest {manifest['rows']['live']}")
    for tag, rec, _ in records[n_prefix:]:
        replay_record(idx, tag, rec)
    if recovery is not None:
        recovery.update({
            "wal": wal, "stamped_bytes": stamped, "valid_bytes": int(valid_bytes),
            "torn_bytes": int(torn_bytes), "prefix_records": n_prefix,
            "tail_records": len(records) - n_prefix, "rows_live": len(idx),
            "rows_delta": int(idx._delta_n),
        })

    _preload_trained(idx, directory, manifest)
    return idx


def _expect(ok: bool, msg: str) -> None:
    if not ok:
        raise SnapshotError(msg)


def _preload_trained(idx, directory: str, manifest: dict) -> None:
    """Install the persisted IVF/PQ/replica state into the device cache,
    stamped with the restored epoch, so that ``_device_state`` finds it
    current and never trains.  A replica the snapshot lacks is recomputed
    (``quantize_rows``, a deterministic map)."""
    from repro_torch.core.distances import QuantizedRows, quantize_rows
    from repro_torch.core.ivf import ivf_from_arrays
    from repro_torch.core.pq import pq_from_arrays

    files, dev = manifest["files"], idx.device
    replicas: dict = {}
    if _REPLICA in files:
        with np.load(os.path.join(directory, _REPLICA)) as z:
            loaded = {k: z[k] for k in z.files}
        for key in ("main_q", "main_ivf_q"):
            if f"{key}.data" in loaded:
                replicas[key] = QuantizedRows(
                    _device(loaded[f"{key}.data"], dev),
                    (_device(loaded[f"{key}.scale"], dev) if f"{key}.scale" in loaded
                     else None),
                    _device(loaded[f"{key}.hy"], dev))

    if idx._use_ivf():
        _expect(_IVF in files, "manifest configures IVF but has no ivf.npz")
        with np.load(os.path.join(directory, _IVF)) as z:
            ivf = ivf_from_arrays({k: z[k] for k in z.files}, device=dev)
        _expect(ivf.packed.shape[1] == idx.dim,
                f"IVF packed dim {ivf.packed.shape[1]} != index {idx.dim}")
        _expect(ivf.slot_of_row.shape[0] == len(idx._main_vecs),
                f"IVF permutation covers {ivf.slot_of_row.shape[0]} rows, main has "
                f"{len(idx._main_vecs)}")
        _expect(ivf.ncells == idx._effective_ncells(),
                f"snapshot trained {ivf.ncells} cells; this config/mesh derives "
                f"{idx._effective_ncells()} — a cell layout cannot be resharded without "
                f"retraining")
        idx._dev["main_ivf"] = ivf
        if idx._use_pq():
            _expect(_PQ in files, "manifest configures PQ but has no pq.npz")
            with np.load(os.path.join(directory, _PQ)) as z:
                cb, codes = pq_from_arrays({k: z[k] for k in z.files}, device=dev)
            _expect(cb.m == idx.pq_m and cb.ncodes == 2 ** idx.pq_nbits,
                    f"PQ geometry ({cb.m}, {cb.ncodes}) != configured "
                    f"({idx.pq_m}, {2 ** idx.pq_nbits})")
            _expect(codes.codes.shape[0] == ivf.packed.shape[0],
                    f"PQ codes cover {codes.codes.shape[0]} slots, packed has "
                    f"{ivf.packed.shape[0]}")
            idx._dev["main_pq"] = (cb, codes)
        else:
            q = replicas.get("main_ivf_q")
            if q is None:
                q = quantize_rows(ivf.packed, idx.scan_dtype, distance=idx.distance)
            _expect(q.data.shape == ivf.packed.shape,
                    f"packed replica shape {tuple(q.data.shape)} != "
                    f"{tuple(ivf.packed.shape)}")
            idx._dev["main_ivf_q"] = q
        idx._dev_version["main_ivf"] = idx._main_epoch
    else:
        _expect(_IVF not in files, "snapshot carries ivf.npz but this config derives no IVF")

    q = replicas.get("main_q")
    if q is not None and idx.scan_dtype != "float32" and not idx._use_ivf():
        _expect(tuple(q.data.shape) == idx._main_vecs.shape,
                f"flat replica shape {tuple(q.data.shape)} != {idx._main_vecs.shape}")
        idx._dev["main_q"] = q
        idx._dev_version["main_q"] = idx._main_epoch
