"""Crash-safe online index lifecycle (DESIGN.md §16).

Port of ``repro/serving/lifecycle.py``.  ``RetrievalIndex`` absorbs churn
correctly but neither durably (an acked insert lives in memory until a full
save) nor smoothly (the first search after ``build()`` / ``compact()``
trains IVF/PQ on the serving thread).  Three pieces close both gaps:

* **WalWriter, a durable write-ahead journal.**  Every mutation is applied
  in memory, appended to the snapshot's ``journal.bin`` as one CRC-framed
  record (``snapshot.write_record``) and fsynced before the call returns:
  the ack is the durability point.  ``checkpoint()`` folds the appended
  tail into the manifest's verified prefix by rewriting ``manifest.json``
  alone.
* **Torn-tail recovery.**  ``recover()`` restores the snapshot, replays the
  stamped prefix strictly and the appended tail leniently: an in-flight
  record torn by a crash is dropped at the last valid frame boundary (it
  was never acked) and truncated before the WAL reopens; mid-file
  corruption is refused.
* **Background retrain with epoch handoff.**  ``compact()`` cuts the live
  rows (``RetrievalIndex._live_rows``, the order a synchronous compact
  packs) and builds epoch N+1 in a daemon thread, as a new
  ``RetrievalIndex(**config_kwargs())`` seeded with the new epoch, while
  epoch N keeps serving; the result is bit-identical to a synchronous
  ``compact()`` and first-search train (k-means is deterministic on the
  card too, ``core.kmeans``).  The swap happens at a batch boundary
  (``before_batch``, called by ``QueryEngine``): post-cut WAL records are
  copied into the next image's journal and replayed in memory, the
  directories swap, the WAL reopens on the new image; the old image is
  removed by a thread of its own (seconds for a 10 GB image, which the
  reference spends on the serving thread; a crash leaves it for
  ``_reap_stale``).
  ``RetrievalIndex._forbid_sync_train`` stays set throughout, so a search
  that would train raises instead of stalling.
* **Admission control.**  A mutation that would grow the delta past
  ``delta_budget`` raises ``BackpressureError`` before anything is applied
  or logged.

On the card the worker runs on a CUDA stream of its own, so its kernels
overlap the serving batches instead of queueing behind them; it records an
event on that stream when the epoch is complete, and the swap makes the
serving stream wait on that event before any of its kernels reads the new
epoch (and marks the new epoch's tensors as used by the serving stream, so
the allocator never hands their memory back to the worker's stream while
a batch may still read it).  The old epoch's device state is dropped at
the swap: both epochs are on the card only during the training window.
The worker counts its kernel launches in a tally of its own
(``kernels._backend.launch_tally``; ``stats()["worker_launches"]``), never
in the wrappers' counters that the serving thread reads.

States: ``serve`` (no pending epoch) -> ``train`` (worker building N+1) ->
``handoff`` (worker done, swap at the next batch boundary) -> ``serve``.
A crash anywhere recovers the last image plus the WAL: acked mutations
survive every window, mid-swap included.
"""
from __future__ import annotations

import contextlib
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.kernels._backend import launch_tally
from repro_torch.serving.snapshot import (
    _JOURNAL,
    _JOURNAL_MAGIC,
    SnapshotError,
    _replace_dir,
    checkpoint_journal,
    read_journal,
    replay_record,
    restore_index,
    save_index,
    write_record,
)
from repro_torch.serving.transport import BackpressureError

__all__ = ["LifecycleConfig", "LifecycleIndex", "RecoveryStats", "WalWriter"]


@dataclass(frozen=True)
class LifecycleConfig:
    """Knobs of the crash-safe lifecycle (DESIGN.md §16)."""

    snapshot_dir: str
    # Max delta rows before mutations raise BackpressureError; 0 = unbounded.
    delta_budget: int = 0
    # False: compact() repacks, retrains and re-images synchronously (the
    # latency cliff, kept as a baseline); True: epoch N+1 trains in a
    # background worker and swaps in at a batch boundary.
    background_retrain: bool = True
    # False skips the per-record fsync (framing cost without the disk
    # barrier; the durability contract needs True).
    fsync: bool = True
    include_replicas: bool = True
    # Carried verbatim in every manifest this lifecycle writes.
    extra: dict | None = None


@dataclass(frozen=True)
class RecoveryStats:
    """What a ``recover()`` found in the journal.

    ``torn_bytes > 0``: the crash hit mid-append and the in-flight record
    was dropped (never acked).  ``tail_records``: acked records replayed
    from past the manifest's stamp.
    """

    wal: bool = False
    stamped_bytes: int = 0
    valid_bytes: int = 0
    torn_bytes: int = 0
    prefix_records: int = 0
    tail_records: int = 0
    rows_live: int = 0
    rows_delta: int = 0

    def as_dict(self) -> dict:
        return {
            "wal": self.wal, "stamped_bytes": self.stamped_bytes,
            "valid_bytes": self.valid_bytes, "torn_bytes": self.torn_bytes,
            "prefix_records": self.prefix_records, "tail_records": self.tail_records,
            "rows_live": self.rows_live, "rows_delta": self.rows_delta,
        }


class WalWriter:
    """Appends fsync-acked records to a WAL snapshot's ``journal.bin``.

    Refuses journals without the current magic (a version-1 journal's CRCs
    are not tag-seeded); ``LifecycleIndex.recover`` re-saves old images
    before it opens a writer.
    """

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self._fsync = bool(fsync)
        self._f = open(path, "r+b")
        magic = self._f.read(len(_JOURNAL_MAGIC))
        if magic != _JOURNAL_MAGIC:
            self._f.close()
            raise SnapshotError(
                f"cannot append to journal {path}: magic {magic!r} is not "
                f"{_JOURNAL_MAGIC!r} (old-format journals need a full re-save first)")
        self._f.seek(0, os.SEEK_END)
        self.nbytes = self._f.tell()
        self.records = 0

    def append(self, tag: bytes, arrays: dict) -> int:
        """Frame, append, flush and fsync one record; returns the bytes
        written.  When this returns the record survives power loss: the
        mutation is acked."""
        n = write_record(self._f, tag, arrays)
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
        self.nbytes += n
        self.records += 1
        return n

    def tell(self) -> int:
        """Current journal length, always a frame boundary."""
        return self.nbytes

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


@dataclass
class _Pending:
    """One in-flight background epoch (train -> handoff)."""

    thread: threading.Thread | None
    epoch: int
    cut_offset: int  # WAL length at the cut: later records replay onto N+1
    next_dir: str
    out: dict = field(default_factory=dict)  # index, train_s, ready, launches; or error


class LifecycleIndex:
    """A ``RetrievalIndex`` wrapped in the crash-safe lifecycle.

    Offers the surface ``QueryEngine`` uses (``search``, ``shape_signature``,
    ``dim``, ``device``, ``before_batch``) and the mutation verbs, each
    WAL-logged and fsync-acked.  Construct with ``attach`` (a fresh index)
    or ``recover`` (after a crash or restart), never directly.
    """

    def __init__(self, idx, config: LifecycleConfig, *, meter=None, _token: object = None):
        if _token is not _CTOR:
            raise TypeError(
                "use LifecycleIndex.attach(idx, cfg) or LifecycleIndex.recover(cfg) — the "
                "snapshot/WAL state must exist before a writer opens")
        self._idx = idx
        self.cfg = config
        self.meter = meter
        self._pending: _Pending | None = None
        self._dirty_main = False  # compacted since the last full image?
        self._rejected = 0
        self._handoffs: list[float] = []
        self._wal_stats = [0, 0, 0.0]  # records, bytes, seconds
        self._worker_launches: dict[str, int] = {}
        self._reaper: threading.Thread | None = None  # removes the last old image
        idx._forbid_sync_train = bool(config.background_retrain)
        self._wal = WalWriter(os.path.join(config.snapshot_dir, _JOURNAL), fsync=config.fsync)

    # -- construction --------------------------------------------------------

    @classmethod
    def attach(cls, idx, config: LifecycleConfig, *, meter=None) -> "LifecycleIndex":
        """Write the initial full WAL image of ``idx`` and start journaling.
        ``idx`` trains here if it has not yet (an admin path, not a query):
        from the first ack on, no search trains synchronously.  A
        mesh-sharded index is refused, as the reference refuses it: the
        shard fleet has its own persistence tier (DESIGN.md §13)."""
        if idx.mesh is not None:
            raise ValueError("LifecycleIndex does not manage mesh-sharded indexes; the "
                             "shard fleet has its own persistence tier (DESIGN.md §13)")
        _reap_stale(config.snapshot_dir)
        save_index(idx, config.snapshot_dir, wal=True, extra=config.extra,
                   include_replicas=config.include_replicas)
        return cls(idx, config, meter=meter, _token=_CTOR)

    @classmethod
    def recover(cls, config: LifecycleConfig, *, meter=None, impl: str | None = None,
                device="cuda") -> tuple["LifecycleIndex", RecoveryStats]:
        """Restore snapshot and WAL on ``device`` after a crash or restart and
        resume journaling: the verified prefix replays strictly, the acked
        tail leniently, torn in-flight bytes are truncated, and a non-WAL or
        version-1 image is re-saved once.  Returns the lifecycle and what
        the journal held."""
        _reap_stale(config.snapshot_dir)
        rec: dict = {}
        idx = restore_index(config.snapshot_dir, device=device, recovery=rec, impl=impl)
        stats = RecoveryStats(**rec)
        if not rec["wal"]:
            save_index(idx, config.snapshot_dir, wal=True, extra=config.extra,
                       include_replicas=config.include_replicas)
        elif rec["torn_bytes"]:
            # The writer only ever appends at a verified frame boundary.
            with open(os.path.join(config.snapshot_dir, _JOURNAL), "r+b") as f:
                f.truncate(rec["valid_bytes"])
                f.flush()
                os.fsync(f.fileno())
        return cls(idx, config, meter=meter, _token=_CTOR), stats

    # -- index surface (QueryEngine) -----------------------------------------

    @property
    def dim(self) -> int:
        return self._idx.dim

    @property
    def device(self) -> torch.device:
        return self._idx.device

    @property
    def index(self):
        """The ``RetrievalIndex`` epoch serving now."""
        return self._idx

    @property
    def handoff_pending(self) -> bool:
        return self._pending is not None

    def __len__(self) -> int:
        return len(self._idx)

    def __contains__(self, item_id: int) -> bool:
        return item_id in self._idx

    @property
    def n_dead(self) -> int:
        return self._idx.n_dead

    def shape_signature(self, k: int) -> tuple:
        return self._idx.shape_signature(k)

    def before_batch(self) -> None:
        """Batch-boundary hook (``QueryEngine.search``): the only place on
        the query path where a ready epoch swaps in."""
        p = self._pending
        if p is not None and not p.thread.is_alive():
            self._finish_handoff()

    def search(self, queries, k: int, *, filter=None):
        return self._idx.search(queries, k, filter=filter)

    # -- mutation: apply, then fsync-ack -------------------------------------

    def insert(self, ids, vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        ids = self._idx._check_ids(ids, vectors)
        self._admit(len(ids))
        self._idx.insert(ids, vectors)
        self._log(b"ADD\0", {"ids": ids, "vecs": vectors, "live": np.ones(len(ids), bool)})

    def upsert(self, ids, vectors) -> None:
        vectors = np.asarray(vectors, np.float32)
        ids = self._idx._check_ids(ids, vectors)
        self._admit(len(ids))
        self._idx.upsert(ids, vectors)
        self._log(b"UPS\0", {"ids": ids, "vecs": vectors})

    def delete(self, ids) -> int:
        ids = np.asarray(ids, np.int64).ravel()
        n = self._idx.delete(ids)
        self._log(b"DEL\0", {"ids": ids})
        return n

    def _admit(self, n_new: int) -> None:
        budget = self.cfg.delta_budget
        if budget and self._idx._delta_n + n_new > budget:
            self._rejected += 1
            raise BackpressureError(
                f"delta budget exhausted: {self._idx._delta_n} rows + {n_new} new > budget "
                f"{budget} — compact() (or wait for the pending handoff) before ingesting more")

    def _log(self, tag: bytes, arrays: dict) -> None:
        t0 = time.perf_counter()
        n = self._wal.append(tag, arrays)
        dt = time.perf_counter() - t0
        self._wal_stats[0] += 1
        self._wal_stats[1] += n
        self._wal_stats[2] += dt
        if self.meter is not None:
            self.meter.record_wal(1, n, dt)

    # -- persistence ---------------------------------------------------------

    def checkpoint(self) -> dict:
        """Fold the acked WAL tail into the manifest's verified prefix: one
        manifest rewrite, ``main.npz`` untouched.  After a synchronous
        compact the image must be re-based first (``save(full=True)``)."""
        if self._dirty_main:
            raise SnapshotError(
                "main segment changed since the last full image — checkpoint() extends "
                "journals, it cannot re-base them; call save(full=True)")
        idx = self._idx
        return checkpoint_journal(self.cfg.snapshot_dir, rows={
            "main": len(idx._main_vecs), "delta": int(idx._delta_n), "live": len(idx)})

    def save(self, *, full: bool = False) -> None:
        """Persist: the cheap journal checkpoint, or a full re-image."""
        if not full:
            self.checkpoint()
            return
        self._join_reaper()
        self._wal.close()
        save_index(self._idx, self.cfg.snapshot_dir, wal=True, extra=self.cfg.extra,
                   include_replicas=self.cfg.include_replicas)
        self._dirty_main = False
        self._wal = WalWriter(os.path.join(self.cfg.snapshot_dir, _JOURNAL),
                              fsync=self.cfg.fsync)

    # -- compaction and epoch handoff ----------------------------------------

    def compact(self, *, wait: bool = False) -> None:
        """Fold the delta into a fresh main epoch.

        Background mode: cut the live rows now, train epoch N+1 in a worker,
        keep serving (and mutating) epoch N, swap at a batch boundary, or at
        once with ``wait=True``.  Synchronous mode: the blocking repack,
        retrain and full save.
        """
        if not self.cfg.background_retrain:
            self._idx.compact()
            self._dirty_main = True
            self.save(full=True)
            return
        if self._pending is not None:
            self._finish_handoff()  # at most one epoch in flight
        idx = self._idx
        vecs, ids = idx._live_rows()
        tenants = idx._live_tenants()
        epoch = idx._main_epoch + 1
        next_dir = self.cfg.snapshot_dir.rstrip("/") + f".next-{os.getpid()}"
        if os.path.exists(next_dir):
            shutil.rmtree(next_dir)
        pend = _Pending(thread=None, epoch=epoch, cut_offset=self._wal.tell(),
                        next_dir=next_dir)
        pend.thread = threading.Thread(target=self._train, args=(vecs, ids, tenants, pend),
                                       name=f"lifecycle-train-{epoch}", daemon=True)
        self._pending = pend
        pend.thread.start()
        if wait:
            self._finish_handoff()

    def finish_handoff(self, *, wait: bool = True) -> bool:
        """Swap a ready epoch in off the query path; True if it swapped."""
        p = self._pending
        if p is None:
            return False
        if not wait and p.thread.is_alive():
            return False
        self._finish_handoff()
        return True

    def _train(self, vecs: np.ndarray, ids: np.ndarray, tenants: np.ndarray,
               pend: _Pending) -> None:
        """Worker: build, train and image epoch N+1 (runs in ``pend.thread``).

        The new epoch number is set before ``_device_state`` so that k-means
        seeds as a synchronous compact would.  On the card everything runs
        on the worker's own stream, ending with the event the swap waits on.
        """
        from repro_torch.serving.index import RetrievalIndex

        try:
            dev = self._idx.device
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
            with launch_tally() as tally, (torch.cuda.stream(stream) if stream is not None
                                           else contextlib.nullcontext()):
                t0 = time.perf_counter()
                new = RetrievalIndex(self._idx.dim, **self._idx.config_kwargs())
                if len(ids):
                    new._main_vecs = vecs
                    new._main_ids = ids.astype(np.int32)
                    new._main_live = np.ones(len(ids), bool)
                    new._main_tenant = tenants.astype(np.int32)
                    new._loc = {int(i): ("main", r) for r, i in enumerate(ids)}
                    new._bump("main")
                new._main_epoch = pend.epoch
                if len(new._main_vecs):
                    new._device_state()  # the training this module moves off the query path
                new._forbid_sync_train = True
                if stream is not None:
                    stream.synchronize()
                pend.out["train_s"] = time.perf_counter() - t0
                save_index(new, pend.next_dir, wal=True, extra=self.cfg.extra,
                           include_replicas=self.cfg.include_replicas)
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                    pend.out["ready"] = ready
            pend.out["launches"] = dict(tally)
            pend.out["index"] = new
        except BaseException as e:  # surfaced on the serving thread
            pend.out["error"] = e

    def _finish_handoff(self) -> None:
        """Join the worker and swap epoch N+1 in (serving thread only).

        Post-cut WAL records are copied verbatim into the next image's
        journal (one fsync) and replayed in memory; only then do the
        directories swap, so every crash window leaves a restorable image
        holding every acked mutation.
        """
        p = self._pending
        p.thread.join()
        self._join_reaper()
        if "error" in p.out:
            self._pending = None
            shutil.rmtree(p.next_dir, ignore_errors=True)
            raise RuntimeError(f"background retrain for epoch {p.epoch} failed") from p.out["error"]
        new = p.out["index"]
        if "ready" in p.out:
            serving = torch.cuda.current_stream(new.device)
            serving.wait_event(p.out["ready"])
            for t in _tensors(new._dev):
                t.record_stream(serving)
        cur_j = os.path.join(self.cfg.snapshot_dir, _JOURNAL)
        records, _, _ = read_journal(cur_j)  # strict: everything in it is acked
        with open(cur_j, "rb") as f:
            f.seek(p.cut_offset)
            tail_bytes = f.read()
        if tail_bytes:
            with open(os.path.join(p.next_dir, _JOURNAL), "ab") as f:
                f.write(tail_bytes)
                f.flush()
                os.fsync(f.fileno())
        for tag, rec, end in records:
            if end > p.cut_offset:
                replay_record(new, tag, rec)
        self._wal.close()
        old = _replace_dir(self.cfg.snapshot_dir, p.next_dir, keep_old=True)
        if old is not None:
            self._reaper = threading.Thread(target=shutil.rmtree, args=(old,),
                                            kwargs={"ignore_errors": True},
                                            name="lifecycle-reap", daemon=True)
            self._reaper.start()
        # Stamp the copied tail at once: lenient parsing then only ever
        # applies to frames genuinely in flight.
        checkpoint_journal(self.cfg.snapshot_dir, rows={
            "main": len(new._main_vecs), "delta": int(new._delta_n), "live": len(new)})
        self._idx = new  # the old epoch's device state goes with it
        self._pending = None
        self._dirty_main = False
        self._wal = WalWriter(cur_j, fsync=self.cfg.fsync)
        for key, n in p.out.get("launches", {}).items():
            self._worker_launches[key] = self._worker_launches.get(key, 0) + n
        train_s = float(p.out.get("train_s", 0.0))
        self._handoffs.append(train_s)
        if self.meter is not None:
            self.meter.record_handoff(train_s)

    # -- introspection / teardown --------------------------------------------

    def stats(self) -> dict:
        p = self._pending
        state = "serve"
        if p is not None:
            state = "train" if p.thread.is_alive() else "handoff"
        return {
            "epoch": int(self._idx._main_epoch),
            "rows": len(self._idx),
            "delta_rows": int(self._idx._delta_n),
            "delta_budget": int(self.cfg.delta_budget),
            "rejected": int(self._rejected),
            "dirty_main": bool(self._dirty_main),
            "state": state,
            "handoffs": len(self._handoffs),
            "last_train_s": self._handoffs[-1] if self._handoffs else 0.0,
            "worker_launches": dict(self._worker_launches),
            "wal": {"records": self._wal_stats[0], "bytes": self._wal_stats[1],
                    "seconds": self._wal_stats[2], "tell": self._wal.tell()},
        }

    def close(self) -> None:
        """Finish a pending handoff (its image is on disk already), wait for
        the old image's removal and release the journal."""
        if self._pending is not None:
            self._finish_handoff()
        self._join_reaper()
        self._wal.close()

    def _join_reaper(self) -> None:
        """Wait for the last old image's removal (the next swap or save
        moves an image to the same ``.old-<pid>`` path)."""
        if self._reaper is not None:
            self._reaper.join()
            self._reaper = None


_CTOR = object()


def _tensors(obj):
    """Every tensor inside the (nested tuple / dict) device cache ``obj``."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, tuple):
        for v in obj:
            yield from _tensors(v)


def _reap_stale(snapshot_dir: str) -> None:
    """Remove orphaned ``.tmp-*`` / ``.next-*`` / ``.old-*`` siblings, which
    a crash mid-save or mid-handoff can strand: never restorable state."""
    base = snapshot_dir.rstrip("/")
    parent, name = os.path.dirname(base) or ".", os.path.basename(base)
    if not os.path.isdir(parent):
        return
    for entry in os.listdir(parent):
        if entry.startswith((f"{name}.tmp-", f"{name}.next-", f"{name}.old-")):
            shutil.rmtree(os.path.join(parent, entry), ignore_errors=True)
