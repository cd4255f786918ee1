"""End-to-end two-tower retrieval service (the paper's recommender workload).

Port of ``repro/serving/service.py``.  Offline: embed the item corpus with
the item tower in fixed ``embed_batch`` chunks, written into one
preallocated tensor on the service's device, and pack it into a
``RetrievalIndex``.  Online: embed users through the LRU embedding cache
(rows stay on the device), run the batched query engine, return item ids
and similarity scores.  Item ingest, update and delete flow through the
index's delta segment; ``compact()`` folds them into the packed main
segment.  Snapshots, the crash-safe lifecycle and shard fleets carry a
CRC32 of the tower params, the reference's exact string, and refuse a
service whose towers differ.

The service lives on ``device`` (default ``"cuda"``; asking for CUDA on a
machine without it raises, and the towers' params must already lie there):
the towers, the index, the lifecycle's recovery and the shard workers all
run on it.  This is the subsystem behind ``python -m
repro_torch.launch.serve``.
"""
from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from repro_torch.accounting import ServingMeter
from repro_torch.core.topk import next_pow2
from repro_torch.kernels._backend import resolve_device
from repro_torch.models import recsys as R
from repro_torch.serving.cache import EmbeddingCache
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.index import RetrievalIndex

# Bytes of a parameter leaf copied off the card per step of the fingerprint.
CRC_BLOCK_BYTES = 32 << 20


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    k: int = 10
    impl: str = "fused"  # "torch" | "kernel" | "fused" segment scorer
    distance: str = "neg_dot"  # towers L2-normalize, so -dot == cosine ranking
    embed_batch: int = 1024  # fixed item-tower batch of the corpus sweep
    cache_capacity: int = 4096
    min_batch: int = 8
    max_batch: int = 1024
    # Two-stage quantized scan of the main segment (DESIGN.md §Quantized):
    # "float32" (exact) | "bfloat16" | "int8" + the candidate overfetch.
    scan_dtype: str = "float32"
    overfetch: int = 4
    # IVF cell-probed scan of the main segment (DESIGN.md §IVF): 0 = flat
    # scan; > 0 trains that many k-means cells and probes ``nprobe`` per
    # query (composes with scan_dtype).
    ivf_cells: int = 0
    nprobe: int = 8
    # Product-quantized ADC scan of the main segment (DESIGN.md §PQ):
    # 0 = off; > 0 stores pq_m uint8 codes per row (requires ivf_cells > 0).
    pq_m: int = 0
    pq_nbits: int = 8
    # Default snapshot location for save_index()/restore_index() (DESIGN.md
    # §Persistence); None = callers pass a directory explicitly.
    snapshot_dir: str | None = None
    # Shard-routed serving (DESIGN.md §13): the number of cell-range shard
    # images save_shards() cuts (requires ivf_cells > 0).
    shards: int = 0
    # Fault tolerance (DESIGN.md §14): workers per cell range, what a shard
    # with every replica exhausted costs ("refuse" | "partial"), and the
    # per-dispatch wall budget (None = unbounded).
    replicas: int = 1
    degraded: str = "refuse"
    deadline_s: float | None = None
    # Process isolation (DESIGN.md §15): "inproc" hosts the restored fleet
    # in this process; "proc" spawns one supervised process per replica.
    workers: str = "inproc"
    heartbeat_s: float = 5.0
    queue_depth: int = 8
    # Crash-safe lifecycle (DESIGN.md §16): ``wal`` journals every mutation
    # fsync-acked into the snapshot dir; ``delta_budget`` bounds the delta
    # (0 = unbounded); ``background_retrain`` trains each post-compact
    # epoch in a worker and swaps at a batch boundary.
    wal: bool = False
    delta_budget: int = 0
    background_retrain: bool = True
    # Filtered retrieval (DESIGN.md §17): "auto" | "pre" | "post" for
    # queries that carry a QueryFilter.
    filter_mode: str = "auto"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def tensor_crc32(t: torch.Tensor, crc: int = 0, *, block_bytes: int = CRC_BLOCK_BYTES,
                 stages=None) -> int:
    """``zlib.crc32`` of ``t``'s bytes (row-major), continuing ``crc``.

    Read in blocks of ``block_bytes``; a CUDA tensor's blocks come off the
    card through two pinned host buffers (``stages``: two uint8 tensors of
    ``block_bytes``, allocated here if None), one block's copy in flight
    while the block before it is summed.  No whole host copy is made.
    """
    flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
    n = flat.numel()
    if flat.device.type != "cuda":
        a = flat.numpy()
        for s in range(0, n, block_bytes):
            crc = zlib.crc32(a[s : s + block_bytes], crc)
        return crc
    if n == 0:
        return crc
    if stages is None:
        stages = _pinned_stages(block_bytes)
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def fetch(j: int, s: int) -> int:
        nb = min(block_bytes, n - s)
        stages[j][:nb].copy_(flat[s : s + nb], non_blocking=True)
        done[j].record()
        return nb

    sizes = [fetch(0, 0), 0]
    for i, s in enumerate(range(0, n, block_bytes)):
        j = i % 2
        if s + block_bytes < n:
            sizes[1 - j] = fetch(1 - j, s + block_bytes)
        done[j].synchronize()
        crc = zlib.crc32(stages[j][: sizes[j]].numpy(), crc)
    return crc


def _pinned_stages(block_bytes: int):
    return [torch.empty(block_bytes, dtype=torch.uint8, pin_memory=True) for _ in range(2)]


def params_crc32(params, *, block_bytes: int = CRC_BLOCK_BYTES) -> str:
    """The reference's params fingerprint (``service.py``'s
    ``_params_fingerprint``): CRC32 chained over each leaf's
    ``str((shape, dtype))`` and then its bytes, in ``param_leaves`` order,
    as 8 hex digits."""
    crc = 0
    stages = None
    for leaf in R.param_leaves(params):
        crc = zlib.crc32(str((tuple(leaf.shape), _dtype_name(leaf.dtype))).encode(), crc)
        if leaf.device.type == "cuda" and stages is None:
            stages = _pinned_stages(block_bytes)
        crc = tensor_crc32(leaf, crc, block_bytes=block_bytes, stages=stages)
    return f"{crc:08x}"


def _same_device(t: torch.Tensor, dev: torch.device) -> bool:
    return t.device.type == dev.type and (dev.index is None or t.device.index == dev.index)


class TwoTowerRetrievalService:
    """Binds tower params + RetrievalIndex + QueryEngine + EmbeddingCache.

    ``params``: the towers (``models.recsys``: ``init_two_tower`` or
    ``params_from_reference``) on ``device``.  ``mesh``: a
    ``launch.mesh.Mesh`` the index's main segment is sharded over.
    """

    def __init__(self, params, model_cfg, svc: ServiceConfig = ServiceConfig(), *,
                 mesh=None, device="cuda"):
        self.device = resolve_device(device)
        elsewhere = sorted({str(leaf.device) for leaf in R.param_leaves(params)
                            if not _same_device(leaf, self.device)})
        if elsewhere:
            raise ValueError(f"the towers' params lie on {elsewhere}, the service on "
                             f"{self.device}: move them there first")
        self.params = params
        self.model_cfg = model_cfg
        self.svc = svc
        self.meter = ServingMeter()  # engine-only: the kNN scan
        # End-to-end: embedding (cache hits/misses) + scan + merge, the
        # number a caller actually waits for.
        self.e2e_meter = ServingMeter()
        self.user_cache = EmbeddingCache(svc.cache_capacity)
        self._seen_embed_shapes: set = set()
        self._last_embed_cold = False
        self.index = RetrievalIndex(model_cfg.tower_mlp[-1], device=self.device,
                                    **self._index_kw(mesh))
        self.engine = QueryEngine(
            self.index, EngineConfig(k=svc.k, min_batch=svc.min_batch, max_batch=svc.max_batch),
            meter=self.meter)
        # Crash-safe lifecycle (DESIGN.md §16), armed by enable_lifecycle()
        # or recover_lifecycle(); mutations then flow WAL-acked through it.
        self.lifecycle = None
        self.router = None  # the shard fleet, after restore_shards()

    def _index_kw(self, mesh) -> dict:
        s = self.svc
        return dict(distance=s.distance, impl=s.impl, mesh=mesh, scan_dtype=s.scan_dtype,
                    overfetch=s.overfetch, ivf_cells=s.ivf_cells, nprobe=s.nprobe,
                    pq_m=s.pq_m, pq_nbits=s.pq_nbits)

    # -- offline: corpus embedding + index build ----------------------------

    def _embed(self, tower: str, fields, *, online: bool = False) -> torch.Tensor:
        """Run the ``"user"`` or ``"item"`` tower over [n, f] id-features.

        Offline (corpus sweeps) runs every chunk at the full ``embed_batch``;
        ``online`` buckets to ``next_pow2`` of the request count instead (a
        2-row cache-miss fill must not pay for a 1024-row tower pass).  A
        short chunk is zero-padded to its bucket.  Returns [n, dim] on the
        service's device.
        """
        fn = R.user_embedding if tower == "user" else R.item_embedding
        ids = torch.from_numpy(np.ascontiguousarray(fields, np.int64)).to(self.device)
        n = ids.shape[0]
        b = (min(self.svc.embed_batch, next_pow2(max(n, self.svc.min_batch)))
             if online else self.svc.embed_batch)
        # A never-seen (tower, bucket) shape: recommend() tags the batch cold,
        # as the reference does for the compile such a shape costs there.
        shape_key = (tower, b)
        self._last_embed_cold = shape_key not in self._seen_embed_shapes
        self._seen_embed_shapes.add(shape_key)
        out = torch.empty((n, self.index.dim), device=self.device)
        for s in range(0, n, b):
            chunk = ids[s : s + b]
            if len(chunk) < b:
                padded = chunk.new_zeros((b, ids.shape[1]))
                padded[: len(chunk)] = chunk
                chunk = padded
            out[s : s + b] = fn(self.params, chunk)[: min(b, n - s)]
        return out

    def build_corpus(self, item_ids, item_fields) -> torch.Tensor:
        """Embed the corpus and (re)build the packed main segment.

        Returns the [n, dim] corpus embeddings on the service's device
        (callers wanting them, e.g. an all-pairs item-to-item pass, should
        use this instead of reaching into the index's segment storage).
        """
        vecs = self._embed("item", item_fields)
        self._drop_lifecycle()
        self.index = RetrievalIndex.build(item_ids, vecs.cpu().numpy(), device=self.device,
                                          **self._index_kw(self.index.mesh))
        self.engine.rebind(self.index)
        return vecs

    # -- persistence: skip re-embedding + retraining on restart -------------

    def _params_fingerprint(self) -> str:
        """CRC32 over the tower params, leaf by leaf (``params_crc32``).

        A corpus snapshot is only meaningful against the towers that
        embedded it; the fingerprint rides in the snapshot manifest and is
        hard-checked at restore time.
        """
        return params_crc32(self.params)

    _IMAGE_NOUNS = {"snapshot": ("snapshot config", "snapshot was"),
                    "shards": ("shard images' config", "shard images were")}

    def _check_image(self, config: dict, extra: dict, kind: str) -> None:
        """Refuse an image (``kind`` "snapshot" or "shards") whose retrieval
        config or params fingerprint differs from this service's: it would
        serve other results than a fresh ``build_corpus``."""
        from repro_torch.serving.snapshot import SnapshotError, config_signature

        config_noun, fp_noun = self._IMAGE_NOUNS[kind]
        want = dict(config_signature(self.index))
        if config != want:
            diff = {k: (config.get(k), want[k]) for k in want if config.get(k) != want[k]}
            raise SnapshotError(f"{config_noun} does not match ServiceConfig "
                                f"({kind}, service): {diff}")
        stored_fp = (extra or {}).get("params_crc32")
        if stored_fp is not None:
            mine = self._params_fingerprint()
            if stored_fp != mine:
                raise SnapshotError(
                    f"{fp_noun} embedded by a different model: params fingerprint "
                    f"{stored_fp} != this service's {mine} (same --seed / checkpoint?)")

    def _dir(self, directory: str | None) -> str:
        directory = directory if directory is not None else self.svc.snapshot_dir
        if not directory:
            raise ValueError("pass a directory or set ServiceConfig.snapshot_dir")
        return directory

    def save_index(self, directory: str | None = None) -> str:
        """Snapshot the index (DESIGN.md §Persistence); default location is
        ``ServiceConfig.snapshot_dir``.  The manifest records this service's
        params fingerprint.  With an active lifecycle the image is re-written
        through it (the WAL handle follows the new image)."""
        directory = self._dir(directory)
        if self.lifecycle is not None:
            if directory != self.lifecycle.cfg.snapshot_dir:
                raise ValueError("lifecycle journals into its own snapshot dir; save "
                                 "elsewhere by disabling the lifecycle first")
            self.lifecycle.save(full=True)
            return directory
        return self.index.save(directory, extra={"params_crc32": self._params_fingerprint()})

    def restore_index(self, directory: str | None = None) -> None:
        """Swap in an index restored from a snapshot of either package, on
        this service's device: no embedding pass, no k-means/PQ training.
        A snapshot whose config or params fingerprint differs raises
        ``SnapshotError``."""
        from repro_torch.serving.snapshot import read_manifest

        directory = self._dir(directory)
        # Manifest-only peek: the full CRC pass runs once, inside restore.
        manifest = read_manifest(directory, verify=False)
        self._check_image(manifest["config"], manifest.get("extra", {}), "snapshot")
        self._drop_lifecycle()
        self.index = RetrievalIndex.restore(directory, device=self.device,
                                            mesh=self.index.mesh, impl=self.svc.impl)
        self.engine.rebind(self.index)

    # -- crash-safe lifecycle (DESIGN.md §16) --------------------------------

    def _lifecycle_config(self, directory: str):
        from repro_torch.serving.lifecycle import LifecycleConfig

        return LifecycleConfig(
            snapshot_dir=directory, delta_budget=self.svc.delta_budget,
            background_retrain=self.svc.background_retrain,
            extra={"params_crc32": self._params_fingerprint()})

    def _drop_lifecycle(self) -> None:
        if self.lifecycle is not None:
            self.lifecycle.close()
            self.lifecycle = None

    def enable_lifecycle(self, directory: str | None = None):
        """Arm the crash-safe lifecycle over the current index: write the
        initial full WAL image under ``directory`` and rebind the engine
        onto the ``LifecycleIndex``.  From here every ingest/delete is
        fsync-acked into the journal, ``compact()`` trains the next epoch in
        the background, and a crash recovers via ``recover_lifecycle``."""
        from repro_torch.serving.lifecycle import LifecycleIndex

        directory = self._dir(directory)
        self._drop_lifecycle()
        self.lifecycle = LifecycleIndex.attach(
            self.index, self._lifecycle_config(directory), meter=self.meter)
        self.engine.rebind(self.lifecycle)
        return self.lifecycle

    def recover_lifecycle(self, directory: str | None = None):
        """Restore snapshot + WAL on this service's device after a crash or
        restart and resume serving; the same config/params contract as
        ``restore_index``.  Returns the ``RecoveryStats``."""
        from repro_torch.serving.lifecycle import LifecycleIndex
        from repro_torch.serving.snapshot import read_manifest

        directory = self._dir(directory)
        manifest = read_manifest(directory, verify=False)
        self._check_image(manifest["config"], manifest.get("extra", {}), "snapshot")
        self._drop_lifecycle()
        self.lifecycle, recovery = LifecycleIndex.recover(
            self._lifecycle_config(directory), meter=self.meter, impl=self.svc.impl,
            device=self.device)
        self.index = self.lifecycle.index
        self.engine.rebind(self.lifecycle)
        return recovery

    def _live_index(self):
        """The currently-serving RetrievalIndex epoch (lifecycle-aware)."""
        return self.lifecycle.index if self.lifecycle is not None else self.index

    # -- persistence: shard-routed serving (DESIGN.md §13) ------------------

    def save_shards(self, directory: str | None = None, n_shards: int | None = None,
                    *, replicas: int | None = None) -> list[str]:
        """Cut the index into per-shard images under ``directory``.

        Defaults: ``ServiceConfig.snapshot_dir`` / ``shards`` / ``replicas``
        (recorded in the fleet manifest; images are stored once).  Each
        shard manifest carries this service's params fingerprint.
        """
        from repro_torch.serving.snapshot import save_shards

        directory = self._dir(directory)
        n_shards = n_shards if n_shards is not None else self.svc.shards
        if n_shards < 1:
            raise ValueError("pass n_shards or set ServiceConfig.shards")
        replicas = replicas if replicas is not None else self.svc.replicas
        return save_shards(self.index, directory, n_shards, replicas=replicas,
                           extra={"params_crc32": self._params_fingerprint()})

    def restore_shards(self, directory: str | None = None, *, wire_dtype: str | None = None,
                       replicas: int | None = None) -> None:
        """Rebind the engine onto a ShardRouter over a restored shard fleet,
        its workers on this service's device.

        Same hard-fail contract as ``restore_index``.  The fleet manifest's
        replication factor (override with ``replicas``) expands each image
        into R workers; the router runs this service's degraded policy and
        per-dispatch deadline and feeds its per-worker attempts into the
        engine meter.
        """
        from repro_torch.serving.health import CallPolicy
        from repro_torch.serving.shards import load_fleet

        directory = self._dir(directory)
        supervisor_cfg = None
        if self.svc.workers == "proc":
            from repro_torch.serving.supervisor import SupervisorConfig

            supervisor_cfg = SupervisorConfig(heartbeat_s=self.svc.heartbeat_s,
                                              queue_depth=self.svc.queue_depth)
        router = load_fleet(
            directory, impl=self.svc.impl, wire_dtype=wire_dtype, replicas=replicas,
            degraded=self.svc.degraded, call_policy=CallPolicy(deadline_s=self.svc.deadline_s),
            meter=self.meter, workers=self.svc.workers, supervisor_cfg=supervisor_cfg,
            device=self.device)
        try:
            self._check_image(router.config, router.extra, "shards")
        except BaseException:
            # A refused fleet must not leak its worker processes.
            if router.supervisor is not None:
                router.supervisor.shutdown(drain=False)
            raise
        self.router = router
        self.engine.rebind(router)

    def shutdown_shards(self, *, drain: bool = True) -> None:
        """Stop a proc-backend fleet's worker processes (no-op otherwise)."""
        if self.router is not None and self.router.supervisor is not None:
            self.router.supervisor.shutdown(drain=drain)

    # -- online: item ingest (delta segment) --------------------------------

    def ingest_items(self, item_ids, item_fields) -> None:
        """Upsert items through the delta segment, WAL-acked when the
        lifecycle is armed (the ack implies the write survives a crash)."""
        vecs = self._embed("item", item_fields)
        target = self.lifecycle if self.lifecycle is not None else self.index
        target.upsert(item_ids, vecs.cpu().numpy())

    def delete_items(self, item_ids) -> int:
        target = self.lifecycle if self.lifecycle is not None else self.index
        return target.delete(item_ids)

    def compact(self, *, wait: bool = False) -> None:
        """Fold the delta into a fresh main epoch: in the background with
        the lifecycle armed and ``background_retrain`` on (``wait=True``
        blocks for the swap), else the synchronous repack."""
        if self.lifecycle is not None:
            self.lifecycle.compact(wait=wait)
            self.index = self.lifecycle.index
        else:
            self.index.compact()

    # -- online: user retrieval ---------------------------------------------

    def embed_users(self, user_keys, user_fields) -> torch.Tensor:
        """User-tower embeddings [m, dim] on the service's device,
        LRU-cached on ``user_keys``: the hits in one gather from the cache's
        slab, the misses through the tower and into the slab in one scatter."""
        keys = [int(key) for key in user_keys]
        slots = np.asarray(self.user_cache.lookup(keys), np.int64)
        sel = np.flatnonzero(slots < 0)
        if len(sel) == 0:
            return self.user_cache.gather(slots)
        fresh = self._embed("user", np.asarray(user_fields, np.int32)[sel], online=True)
        # A key that misses twice in a batch is served its last row, the one
        # the cache keeps.
        last = {keys[i]: j for j, i in enumerate(sel)}
        rows = fresh
        if len(last) < len(sel):
            rows = fresh[torch.as_tensor([last[keys[i]] for i in sel], device=self.device)]
        if len(sel) == len(keys):
            out = rows
        else:
            hit = np.flatnonzero(slots >= 0)
            out = fresh.new_empty((len(keys), fresh.shape[1]))
            # The hits are read before the put below may reuse their slots.
            out[torch.from_numpy(hit).to(self.device)] = self.user_cache.gather(slots[hit])
            out[torch.from_numpy(sel).to(self.device)] = rows
        self.user_cache.put_many([keys[i] for i in sel], fresh)
        return out

    def recommend(self, user_keys, user_fields, k: int | None = None, *,
                  exclude_ids=None, tenant=None, allowed_ids=None):
        """Top-k items per user: (item_ids [m, k] int32, scores [m, k]
        descending), numpy.

        ``exclude_ids``: per-user seen-item lists (ragged or [m, E] with -1
        padding); ``tenant``: namespace tag (scalar or per-user);
        ``allowed_ids``: batch-wide allow-list.  They build a
        ``serving.filters.QueryFilter`` under ``ServiceConfig.filter_mode``
        (DESIGN.md §17); all None is the unfiltered path.
        """
        filt = None
        if exclude_ids is not None or tenant is not None or allowed_ids is not None:
            from repro_torch.serving.filters import QueryFilter

            filt = QueryFilter(tenant=tenant, allowed_ids=allowed_ids, exclude_ids=exclude_ids,
                               mode=self.svc.filter_mode)
        t0 = time.perf_counter()
        n_cold0 = self.meter.summary()["compile_batches"]
        self._last_embed_cold = False  # set by _embed iff misses were embedded
        u = self.embed_users(user_keys, user_fields)
        res = self.engine.search(u, k, filter=filt)
        cold = (self.meter.summary()["compile_batches"] > n_cold0 or self._last_embed_cold)
        self.e2e_meter.record(len(u), time.perf_counter() - t0, compile_batch=cold)
        return res.ids.cpu().numpy(), -res.distances.cpu().numpy()  # neg_dot -> similarity

    def stats(self) -> dict:
        live = self._live_index()
        out = {
            "index_rows": len(live),
            "index_dead": live.n_dead,
            "cache": self.user_cache.stats(),
            "serving": self.e2e_meter.summary(),
            "engine": self.meter.summary(),
        }
        if self.lifecycle is not None:
            out["lifecycle"] = self.lifecycle.stats()
        router = self.router
        if router is not None:
            out["fleet"] = {
                "n_shards": router.n_shards,
                "replicas": router.n_replicas,
                "degraded": router.degraded,
                "workers": "proc" if router.supervisor is not None else "inproc",
                "health": router.health.summary(),
                "dispatch": self.meter.shard_summary(),
            }
            if router.supervisor is not None:
                out["fleet"]["supervisor"] = router.supervisor.summary()
        return out
