"""Shard-routed serving: cell-range sharding + probe-set routing + top-k merge.

Port of ``repro/serving/shards.py``: the scale-out tier of the serving stack
(DESIGN.md §13) and its fault-tolerance tier (DESIGN.md §14).  The
single-host IVF index stores its main segment *cell-packed*: cell ``c`` owns
the slot range ``[c*cap, (c+1)*cap)``.  A shard is a contiguous CELL RANGE
``[cell_lo, cell_hi)``, a pure slice of the packed rows, the per-slot
ids/live masks and the PQ codes, with no retraining: the coarse quantizer
(the centroids) replicates to every shard, as the mesh's sharded IVF
queries (``core.distributed``) partition it, lifted to process granularity.

Pieces:

* ``ShardWorker``: one shard's local query.  Its body is the mesh's
  per-position body, ``core.distributed.ivf_shard_topk``, without the
  collectives: the global shortlist minus ``cell_lo``, the ``ivf_scan`` /
  ``pq_scan`` kernel with ``impl="fused"`` (out-of-range probes are dropped
  from each query tile's union, ``core.ivf.tile_probe_lists``; the
  reference's worker takes the plain probe mask there, which the port's
  ``impl="torch"`` is), the exact rescore, slots mapped to EXTERNAL ids.
* routing: each query's probe set (the router's own shortlist over the
  replicated centroids, on its device) maps to owning REPLICA GROUPS
  through a dense cell -> group table; a batch is dispatched only to groups
  some query in it probes, one group after another.  Within a group the
  replica is chosen load-aware (least outstanding, then health rank, then
  a round-robin rotation), and every dispatch runs through the
  deadline/retry/backoff failover wrapper (``serving.health``) with
  per-worker health state and torn-result validation (``validate_run``).
* degradation: a probed cell owned by no loaded shard, or a shard whose
  replicas are ALL exhausted within the deadline budget, follows the
  ``degraded`` policy: ``"refuse"`` (default) raises a structured
  ``MissingShardError`` / ``ShardUnavailableError`` with the cells, shard
  ids and per-replica attempts; ``"partial"`` serves the surviving shards'
  merge and reports ``SearchResult.coverage`` (per query, the fraction of
  probed cells served) and ``SearchResult.shard_status``.
* ``aggregate_topk``: the XOR butterfly of ``topk.merge_topk_sorted`` over
  the pow2-padded shard axis, the round structure, tie rule and optional
  bf16 wire of ``core.distributed.tree_merge_topk``.  Merge order is a
  function of shard position alone (undispatched or failed shards are
  +inf runs), so the merged (values, ids) do not depend on which subset
  of shards computed: failover is bit-invisible and a dead shard's run is
  the merge identity.

``ShardRouter`` has the index surface ``QueryEngine`` needs (``search``,
``shape_signature``, ``dim``, ``device``), so the engine serves a fleet as
it serves an index.
"""
from __future__ import annotations

import random
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import ivf as IVF
from repro_torch.core import topk as T
from repro_torch.core.distances import quantize_rows
from repro_torch.core.distributed import ivf_shard_topk
from repro_torch.core.knn import KNNResult
from repro_torch.kernels._backend import resolve_device
from repro_torch.serving.health import (
    Attempt,
    CallPolicy,
    HealthConfig,
    HealthState,
    HealthTracker,
    run_with_failover,
)
from repro_torch.serving.index import SearchResult
from repro_torch.serving.snapshot import SnapshotError

Tensor = torch.Tensor

DEGRADED_POLICIES = ("refuse", "partial")

# Worker backends a fleet restores onto (DESIGN.md §15): "inproc" hosts every
# ShardWorker in the router's process (the default, and the test oracle);
# "proc" spawns one supervised OS process per replica behind the RPC
# transport: the same routing, health and merge code, real process death.
WORKER_BACKENDS = ("inproc", "proc")

_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


class MissingShardError(RuntimeError):
    """A query's probe set touched a cell the fleet cannot serve.

    ``cells`` are the offending probed cell ids, ``shard_ids`` the shard
    positions involved, ``attempts`` the per-replica ``health.Attempt``
    records of the failover tried before giving up (empty when no shard
    owned the cells at all).
    """

    def __init__(self, message: str, *, cells: Sequence[int] = (),
                 shard_ids: Sequence[int] = (), attempts: Sequence[Attempt] = ()):
        super().__init__(message)
        self.cells = tuple(int(c) for c in cells)
        self.shard_ids = tuple(int(s) for s in shard_ids)
        self.attempts = tuple(attempts)


class ShardUnavailableError(MissingShardError):
    """Every replica of a dispatched shard failed within the deadline."""


class TornResultError(RuntimeError):
    """A worker reply failed result validation (garbage/torn run)."""


class ShardSpec(NamedTuple):
    """One worker's slot in a replicated cell-range partition of
    ``[0, ncells)``: replica ``replica`` (of ``n_replicas``) of cell range
    ``[cell_lo, cell_hi)``; all replicas of a range serve identical data."""

    shard_id: int
    n_shards: int
    cell_lo: int
    cell_hi: int  # exclusive
    replica: int = 0
    n_replicas: int = 1

    @property
    def ncells_local(self) -> int:
        return self.cell_hi - self.cell_lo


def plan_shards(ncells: int, n_shards: int, replicas: int = 1) -> list[ShardSpec]:
    """Balanced contiguous cell ranges covering ``[0, ncells)`` exactly,
    each owned by ``replicas`` workers: ranges differ by at most one cell,
    every cell belongs to exactly one range, and the ``n_shards * replicas``
    specs are ordered by (shard_id, replica)."""
    if not 1 <= n_shards <= ncells:
        raise ValueError(
            f"need 1 <= n_shards <= ncells, got n_shards={n_shards} "
            f"ncells={ncells} (a shard must own at least one cell)")
    if replicas < 1:
        raise ValueError(f"need replicas >= 1, got {replicas}")
    bounds = [(i * ncells) // n_shards for i in range(n_shards + 1)]
    return [ShardSpec(i, n_shards, bounds[i], bounds[i + 1], r, replicas)
            for i in range(n_shards) for r in range(replicas)]


# ---------------------------------------------------------------------------
# Per-shard local query (the worker side of the mesh shard body).
# ---------------------------------------------------------------------------


class ShardWorker:
    """One restored shard image: a cell-range slice + the replicated quantizer.

    Self-contained: a worker process needs nothing but its own shard
    directory (``snapshot.restore_shard``) to answer ``topk``; the probe
    against the global centroids runs locally, so no worker talks to
    another.  Its arrays live on ``device`` (the card unless the caller
    asks for the CPU).
    """

    def __init__(self, spec: ShardSpec, *, centroids, packed, ids_of_slot, live,
                 config: dict, parent: dict, pq_cb=None, pq_codes=None,
                 extra: dict | None = None, impl: str = "fused", device="cuda"):
        self.spec = spec
        self.config = dict(config)
        self.parent = dict(parent)
        self.extra = dict(extra or {})
        self.impl = impl
        self.device = resolve_device(device)
        dev = self.device
        self.centroids = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
        self.packed = torch.as_tensor(packed, dtype=torch.float32, device=dev)
        self.ids_of_slot = torch.as_tensor(ids_of_slot, dtype=torch.int32, device=dev)
        self.live = torch.as_tensor(live, dtype=torch.bool, device=dev)
        if self.packed.shape[0] % max(spec.ncells_local, 1):
            raise SnapshotError(
                f"shard {spec.shard_id}: {self.packed.shape[0]} slots do not "
                f"tile over {spec.ncells_local} cells")
        self.cell_cap = self.packed.shape[0] // spec.ncells_local
        self.pq_cb = pq_cb
        self.pq_codes = pq_codes
        # Scalar path: the scan replica is a deterministic map of the packed
        # slice (never training), the same policy as a snapshot restore.
        self._scan_rep = (pq_codes if pq_codes is not None else quantize_rows(
            self.packed, self.config["scan_dtype"], distance=self.config["distance"]))

    @property
    def key(self) -> str:
        """Stable worker identity for health/metering: shard + replica."""
        return f"s{self.spec.shard_id}r{self.spec.replica}"

    @property
    def dim(self) -> int:
        return int(self.packed.shape[1])

    @property
    def n_slots(self) -> int:
        """Packed slots this shard serves (a ``ProcWorker`` knows its count
        without holding rows)."""
        return int(self.packed.shape[0])

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    def topk(self, queries, k: int, *, nprobe: int | None = None,
             overfetch: int | None = None, allowed_ids=None) -> KNNResult:
        """Sorted ascending [m, next_pow2(k)] local top-k (values, external ids).

        ``nprobe`` / ``overfetch`` default to the parent config and stay
        query-time tunable (they change the fetch, not stored state).

        ``allowed_ids``: an optional batch-wide EXTERNAL-id allow-list
        (DESIGN.md §17), folded into the live mask before the scan, so
        disallowed slots die as tombstones do.
        """
        if isinstance(queries, np.ndarray) and not queries.flags.writeable:
            queries = queries.copy()  # a frame's read-only view: torch wants its own
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        nprobe = self.config["nprobe"] if nprobe is None else int(nprobe)
        nprobe = min(nprobe, int(self.centroids.shape[0]))
        overfetch = self.config["overfetch"] if overfetch is None else int(overfetch)
        live = self.live
        if allowed_ids is not None:
            allowed = torch.as_tensor(np.asarray(allowed_ids, np.int32), device=self.device)
            live = live & torch.isin(self.ids_of_slot, allowed)
        vals, ids = ivf_shard_topk(
            q, self.centroids, self.packed, self.ids_of_slot, live, self._scan_rep,
            k=int(k), nprobe=nprobe, cell_lo=self.spec.cell_lo, cell_cap=self.cell_cap,
            distance=self.config["distance"], impl=self.impl,
            scan_dtype=self.config["scan_dtype"], pq_cb=self.pq_cb, overfetch=overfetch)
        return KNNResult(vals, ids)


def validate_run(run: KNNResult, m: int, K: int) -> KNNResult:
    """Reject torn/garbage worker replies before they reach the merge.

    A worker that returns a half-written or corrupt buffer would serve wrong
    neighbours silently.  Checks: both legs exactly [m, K], integral ids,
    NaN-free values, each row ascending (the sorted-run contract of the
    bitonic merge).  Violations raise ``TornResultError``, which the
    failover wrapper treats as a worker failure.  +inf padding (id -1) is
    valid by construction.
    """
    vals = torch.as_tensor(run.distances)
    ids = torch.as_tensor(run.indices)
    if tuple(vals.shape) != (m, K) or tuple(ids.shape) != (m, K):
        raise TornResultError(
            f"run geometry {tuple(vals.shape)}/{tuple(ids.shape)} != ({m}, {K})")
    if ids.dtype not in _INT_DTYPES:
        raise TornResultError(f"run ids dtype {ids.dtype} is not integral")
    if bool(torch.isnan(vals).any()):
        raise TornResultError("run values contain NaN")
    if K > 1 and not bool((vals[:, 1:] >= vals[:, :-1]).all()):
        raise TornResultError("run values are not ascending-sorted")
    return run


# ---------------------------------------------------------------------------
# Thin aggregator: the butterfly merge, shard-position-stable.
# ---------------------------------------------------------------------------


def _wire_dtype(wire_dtype: str | None):
    """The merge wire's storage type: None (fp32), or ``"bfloat16"``."""
    if wire_dtype is None:
        return None
    if wire_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"wire_dtype {wire_dtype!r}: only bfloat16 (or None) is a merge wire")


def aggregate_topk(vals: Tensor, ids: Tensor, k: int, *,
                   wire_dtype: str | None = None) -> KNNResult:
    """Merge stacked per-shard sorted runs ``[S, m, K]`` -> global ``[m, k]``.

    The XOR butterfly of ``tree_merge_topk`` with the shard axis in place of
    the device axis: log2(S) rounds, position ``i`` merging with ``i ^ d``
    through ``merge_topk_sorted`` (the lower position wins ties).  Only
    position 0's result is returned, so each round computes the merges it
    reads: position ``i`` (a multiple of ``2d``) with ``i + d``, its own run
    first, as every position's own run goes first in the butterfly.
    ``wire_dtype="bfloat16"``: the running buffer is STORED in bf16 between
    rounds while merges compare in fp32, the mesh merge's wire.  Non-pow2
    shard counts pad with +inf runs, the identity of the merge.
    """
    S, m, K = vals.shape
    Sp = T.next_pow2(S)
    run_v = vals.float()
    run_i = ids.to(torch.int32)
    if Sp > S:
        run_v = torch.cat([run_v, run_v.new_full((Sp - S, m, K), T.POS_INF)])
        run_i = torch.cat([run_i, run_i.new_full((Sp - S, m, K), -1)])
    wd = _wire_dtype(wire_dtype)
    if wd is not None:
        run_v = run_v.to(wd)
    while run_v.shape[0] > 1:
        mv, mi = T.merge_topk_sorted(run_v[0::2].float(), run_i[0::2],
                                     run_v[1::2].float(), run_i[1::2])
        run_v = mv if wd is None else mv.to(wd)
        run_i = mi
    return KNNResult(run_v[0].float()[:, :k], run_i[0][:, :k])


# ---------------------------------------------------------------------------
# Router: probe-set -> owning replica groups, failover dispatch, aggregate.
# ---------------------------------------------------------------------------

_STATUS_RANK = {"failed": 3, "missing": 2, "ok": 1, "skipped": 0}


def merge_shard_status(statuses: Sequence[tuple]) -> tuple:
    """Fold per-chunk ``shard_status`` tuples into one (worst status wins):
    a shard that failed in ANY chunk reads as failed, one skipped
    everywhere stays skipped."""
    worst: dict[int, str] = {}
    for chunk in statuses:
        for sid, st in chunk:
            if _STATUS_RANK[st] > _STATUS_RANK.get(worst.get(sid, "skipped"), 0):
                worst[sid] = st
    return tuple(sorted(worst.items()))


class ShardRouter:
    """Routes query batches to the replica groups owning their probe sets.

    Assembly is the first fault barrier: worker specs must form pairwise
    disjoint cell ranges (replicas of a range agree on it exactly), agree on
    the parent snapshot signature and config, and (unless ``strict=False``)
    cover every cell; ALL violations are collected and raised together in
    one ``SnapshotError`` before anything serves.

    Query time is the second (DESIGN.md §14): every dispatch runs through
    the deadline/retry failover wrapper with per-worker health state,
    torn-result validation and load-aware replica choice; a lost shard
    costs what the ``degraded`` policy says.  The router probes and merges
    on its workers' device (the first worker's).
    """

    def __init__(self, workers: Sequence, *, strict: bool = True, wire_dtype: str | None = None,
                 degraded: str = "refuse", call_policy: CallPolicy | None = None,
                 health_cfg: HealthConfig | None = None, meter=None, seed: int = 0,
                 clock=time.monotonic, sleep=time.sleep, supervisor=None):
        if not workers:
            raise SnapshotError("ShardRouter needs at least one shard worker")
        if degraded not in DEGRADED_POLICIES:
            raise ValueError(f"degraded={degraded!r} not in {DEGRADED_POLICIES}")
        workers = sorted(workers, key=lambda w: (w.spec.cell_lo, w.spec.replica))
        w0 = workers[0]
        self.config = dict(w0.config)
        self.parent = dict(w0.parent)
        self.extra = dict(w0.extra)
        self.ncells = int(w0.centroids.shape[0])
        self.n_shards = w0.spec.n_shards
        self.strict = bool(strict)
        self.degraded = degraded
        self.call_policy = call_policy if call_policy is not None else CallPolicy()
        self.health = HealthTracker(health_cfg if health_cfg is not None else HealthConfig())
        self.meter = meter
        # Process workers (DESIGN.md §15): the supervisor's crash-detect /
        # heartbeat / respawn pass runs once per search batch, before dispatch.
        self.supervisor = supervisor
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._clock = clock
        self._sleep = sleep
        problems: list[str] = []
        seen_ids: set[tuple[int, int]] = set()
        for w in workers:
            wid = (w.spec.shard_id, w.spec.replica)
            if wid in seen_ids:
                problems.append(f"duplicate shard id {w.spec.shard_id} replica "
                                f"{w.spec.replica} in fleet")
            seen_ids.add(wid)
            if w.spec.n_shards != self.n_shards:
                problems.append(f"shard {w.spec.shard_id} belongs to a {w.spec.n_shards}"
                                f"-way partition, fleet is {self.n_shards}-way")
            if dict(w.config) != self.config:
                problems.append(f"shard {w.spec.shard_id} config {w.config} != fleet "
                                f"config {self.config}")
            if w.parent.get("fingerprint") != self.parent.get("fingerprint"):
                problems.append(
                    f"shard {w.spec.shard_id} (replica {w.spec.replica}) parent snapshot "
                    f"signature {w.parent.get('fingerprint')} != fleet's "
                    f"{self.parent.get('fingerprint')} — shards from different parent "
                    f"snapshots cannot serve together")
            if not 0 <= w.spec.cell_lo < w.spec.cell_hi <= self.ncells:
                problems.append(f"shard {w.spec.shard_id} cell range "
                                f"[{w.spec.cell_lo}, {w.spec.cell_hi}) outside "
                                f"[0, {self.ncells})")
        # Replica groups: workers sharing an identical cell range.  Distinct
        # ranges must be pairwise disjoint; a partial overlap is a torn fleet.
        self.workers = list(workers)
        groups: list[list[int]] = []
        ranges: list[tuple[int, int]] = []
        for i, w in enumerate(workers):
            rng_ = (w.spec.cell_lo, w.spec.cell_hi)
            if ranges and rng_ == ranges[-1]:
                groups[-1].append(i)
            else:
                ranges.append(rng_)
                groups.append([i])
        for (alo, ahi), (blo, bhi) in zip(ranges, ranges[1:]):
            if blo < ahi:
                problems.append(f"shard cell ranges overlap: [{alo}, {ahi}) vs "
                                f"[{blo}, {bhi})")
        covered = sum(hi - lo for lo, hi in ranges)
        if strict and covered != self.ncells:
            problems.append(
                f"shard set covers {covered}/{self.ncells} cells — an incomplete fleet "
                f"cannot serve (pass strict=False to route around missing shards and "
                f"fail per-query instead)")
        if problems:
            raise SnapshotError(f"{len(problems)} fleet assembly violation(s):\n  "
                                + "\n  ".join(problems))
        self.groups = groups
        self.n_replicas = max(len(g) for g in groups)
        self.wire_dtype = wire_dtype
        _wire_dtype(wire_dtype)  # refuse an unknown wire at assembly
        self.centroids = w0.centroids
        self.device = self.centroids.device
        self.dim = w0.dim
        self.impl = w0.impl
        # Dense cell -> replica-group table; -1 marks an unowned cell
        # (possible only under strict=False).
        owner = np.full(self.ncells, -1, np.int32)
        for gid, (lo, hi) in enumerate(ranges):
            owner[lo:hi] = gid
        self._owner = owner
        self._outstanding = {w.key: 0 for w in self.workers}
        self._rr = [0] * len(groups)

    @property
    def n_live(self) -> int:
        # Replicas serve identical rows: count each range once.
        return sum(self.workers[g[0]].n_live for g in self.groups)

    # -- routing ------------------------------------------------------------

    def _group_of(self, cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(owning group per cell, bad-cell mask); raises nothing."""
        cells = np.asarray(cells)
        gid = self._owner[np.clip(cells, 0, self.ncells - 1)]
        bad = (gid < 0) | (cells < 0) | (cells >= self.ncells)
        return np.where(bad, -1, gid), bad

    def owners_of(self, cells: np.ndarray) -> np.ndarray:
        """Worker position (the group's first replica) owning each probed
        cell; loud on unowned cells whatever the degraded policy."""
        cells = np.asarray(cells)
        gid, bad = self._group_of(cells)
        if bad.any():
            missing = np.unique(cells[bad])
            loaded = [(w.spec.shard_id, w.spec.cell_lo, w.spec.cell_hi) for w in self.workers]
            raise MissingShardError(
                f"probe set hits cells {missing.tolist()} owned by no loaded shard "
                f"(loaded shard (id, lo, hi) ranges: {loaded}); refusing to serve a "
                f"silently partial result", cells=missing)
        return np.asarray([self.groups[g][0] for g in gid.ravel()],
                          np.int32).reshape(gid.shape)

    def probe(self, queries) -> np.ndarray:
        """[m, nprobe] global probed cell ids: the shortlist over the
        replicated centroids on the router's device (the fused kernel on
        the card)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        nprobe = min(self.config["nprobe"], self.ncells)
        return IVF.shortlist(q, self.centroids, nprobe, distance=self.config["distance"],
                             impl=self.impl).cpu().numpy()

    # -- replica choice + failover dispatch ---------------------------------

    def _replica_order(self, gid: int) -> list[int]:
        """Admitted replicas of group ``gid``, best first: least outstanding
        calls, then health rank (healthy, probation, degraded), then a
        per-group round-robin rotation so equal replicas share traffic."""
        group = self.groups[gid]
        n = len(group)
        rot = self._rr[gid]
        self._rr[gid] = (rot + 1) % n
        rank = {HealthState.HEALTHY: 0, HealthState.PROBATION: 1, HealthState.DEGRADED: 2}
        admitted = []
        for j, widx in enumerate(group):
            key = self.workers[widx].key
            if not self.health.admissible(key):
                continue
            admitted.append((self._outstanding[key], rank[self.health.state(key)],
                             (j - rot) % n, widx))
        return [widx for *_, widx in sorted(admitted)]

    def _dispatch(self, gid: int, q, k: int, m: int, K: int,
                  allowed=None) -> tuple[KNNResult | None, list[Attempt]]:
        """One group's failover call: ordered replicas through the
        deadline/retry wrapper, replies validated before acceptance."""
        candidates = []
        for widx in self._replica_order(gid):
            w = self.workers[widx]

            def thunk(w=w):
                self._outstanding[w.key] += 1
                try:
                    return validate_run(w.topk(q, k, allowed_ids=allowed), m, K)
                finally:
                    self._outstanding[w.key] -= 1

            candidates.append((w.key, thunk))
        out, attempts = run_with_failover(
            candidates, policy=self.call_policy, tracker=self.health,
            clock=self._clock, sleep=self._sleep, uniform=self._rng.random)
        if self.meter is not None:
            for a in attempts:
                self.meter.record_shard_call(a.worker, a.seconds, ok=a.error is None,
                                             error=a.error)
        return out, attempts

    # -- search -------------------------------------------------------------

    def search(self, queries, k: int, *, filter=None) -> SearchResult:
        """Routed top-k: probe -> failover dispatch -> butterfly merge.

        Dispatch is batch-granular and one group after another: a replica
        group runs iff ANY query in the batch probes a cell it owns; the
        rest contribute +inf runs, so the merge's shape (and the result
        bits) never depends on the dispatch pattern.  Failover inside a
        group is bit-invisible; a group that fails outright follows the
        ``degraded`` policy.

        ``filter``: an optional ``serving.filters.QueryFilter`` (DESIGN.md
        §17).  Allow-lists pre-filter inside every worker; exclusions widen
        every shard's fetch by E and apply ONCE by external id after the
        merge, so the wire never changes.  Tenant predicates are refused:
        shard images carry no per-row tenant tags.
        """
        from repro_torch.serving import filters as F
        from repro_torch.serving.index import _finalize_filtered

        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        m = q.shape[0]
        f = F.normalize(filter, int(m)) if filter is not None else None
        if f is not None and f.tenant is not None:
            raise NotImplementedError(
                "ShardRouter does not support tenant filters: shard images carry no "
                "per-row tenant tags (DESIGN.md §17) — serve one fleet per tenant, or "
                "use a single-host RetrievalIndex")
        allowed = None if f is None else f.allowed_ids
        if allowed is not None:
            no = [w.key for w in self.workers if not getattr(w, "supports_allow_filter", True)]
            if no:
                raise NotImplementedError(
                    f"allow-list filters are not supported by worker(s) {no} (proc "
                    f"transport carries no allow-list payload); use the inproc backend "
                    f"or exclusion-only filters")
        k_w = int(k) + (0 if f is None else F.exclusion_width(f))
        K = T.next_pow2(k_w)
        self.health.tick()
        if self.supervisor is not None:
            # Crash-detect + heartbeat + respawn BEFORE dispatch: a worker
            # that died since the last batch re-enters as PROBATION.
            self.supervisor.poll(self.health)
        probe = self.probe(q)
        gid, bad = self._group_of(probe)
        if bad.any() and self.degraded == "refuse":
            self.owners_of(probe)  # raises the structured MissingShardError
        dispatched = set(int(g) for g in np.unique(gid) if g >= 0)
        runs_v, runs_i = [], []
        status: list[str] = []
        failed: dict[int, list[Attempt]] = {}
        inf_v = torch.full((m, K), T.POS_INF, device=self.device)
        inf_i = torch.full((m, K), -1, dtype=torch.int32, device=self.device)
        for g in range(len(self.groups)):
            if g not in dispatched:
                status.append("skipped")
                runs_v.append(inf_v)
                runs_i.append(inf_i)
                continue
            r, attempts = self._dispatch(g, q, k_w, int(m), K, allowed=allowed)
            if r is None:
                status.append("failed")
                failed[g] = attempts
                runs_v.append(inf_v)
                runs_i.append(inf_i)
            else:
                status.append("ok")
                runs_v.append(torch.as_tensor(r.distances, device=self.device))
                runs_i.append(torch.as_tensor(r.indices, device=self.device))
        if failed and self.degraded == "refuse":
            sids = sorted(self.workers[self.groups[g][0]].spec.shard_id for g in failed)
            cells = np.unique(probe[np.isin(gid, list(failed))])
            attempts = [a for ats in failed.values() for a in ats]
            raise ShardUnavailableError(
                f"all replicas of shard(s) {sids} exhausted within the deadline budget "
                f"(probed cells {cells.tolist()}; {len(attempts)} attempt(s): "
                f"{[(a.worker, a.error) for a in attempts]}); degraded='refuse' — pass "
                f"degraded='partial' to serve surviving shards with explicit coverage",
                cells=cells, shard_ids=sids, attempts=attempts)
        # Per-query coverage: the fraction of probed cells actually served.
        served = (gid >= 0) & ~bad
        if failed:
            served &= ~np.isin(gid, list(failed))
        coverage = served.mean(axis=1).astype(np.float32)
        vals, ids = aggregate_topk(torch.stack(runs_v), torch.stack(runs_i), k_w,
                                   wire_dtype=self.wire_dtype)
        if f is not None and f.exclude_ids is not None:
            vals, ids = _finalize_filtered(
                vals, ids, torch.as_tensor(f.exclude_ids, device=self.device), k=int(k))
        elif k_w != int(k):
            vals, ids = vals[:, :k], ids[:, :k]
        shard_status = tuple((int(self.workers[g[0]].spec.shard_id), status[i])
                             for i, g in enumerate(self.groups))
        return SearchResult(vals, ids, coverage=coverage, shard_status=shard_status)

    def shape_signature(self, k: int) -> tuple:
        """Engine shape key: static once a fleet is loaded."""
        return (tuple(int(self.workers[g[0]].n_slots) for g in self.groups), 0,
                ("shards", self.n_shards, self.n_replicas, T.next_pow2(k)))


def load_router(shard_dirs: Sequence[str], *, impl: str | None = None, strict: bool = True,
                wire_dtype: str | None = None, device="cuda", **router_kw) -> ShardRouter:
    """Restore every shard image in ``shard_dirs`` onto ``device`` and
    assemble the router.  Each directory gives ONE worker (replica 0 of its
    range); ``load_fleet`` restores a replicated fleet.  Extra keyword
    arguments (``degraded``, ``call_policy``, ``health_cfg``, ``meter``,
    ...) pass through to ``ShardRouter``."""
    from repro_torch.serving.snapshot import restore_shard

    return ShardRouter([restore_shard(d, impl=impl, device=device) for d in shard_dirs],
                       strict=strict, wire_dtype=wire_dtype, **router_kw)


def load_fleet(directory: str, *, replicas: int | None = None, impl: str | None = None,
               strict: bool = True, wire_dtype: str | None = None, workers: str = "inproc",
               supervisor_cfg=None, device="cuda", **router_kw) -> ShardRouter:
    """Restore a replicated fleet from a ``save_shards`` root.

    ``fleet.json`` records the partition arity and replication factor;
    ``replicas`` overrides the recorded factor.  Roots without one load as
    R=1.  ``workers`` selects the backend (DESIGN.md §15): ``"inproc"``
    restores every replica independently into this process, onto
    ``device``; ``"proc"`` spawns one supervised OS process per replica
    over the RPC transport (``serving.supervisor``), each worker on
    ``device`` too (a worker asked for CUDA on a machine without it
    raises through its HELLO; none serves from the CPU), and the router
    gets ``ProcWorker`` handles plus the supervisor hook.
    ``supervisor_cfg`` (a ``supervisor.SupervisorConfig``) sets
    heartbeat / queue depth / timeouts; the router's
    ``call_policy.deadline_s`` bounds the real socket waits.  Shut a proc
    fleet down with ``router.supervisor.shutdown()``.
    """
    from repro_torch.serving.snapshot import read_fleet_manifest, restore_shard, shard_dirs

    if workers not in WORKER_BACKENDS:
        raise ValueError(f"workers={workers!r} not in {WORKER_BACKENDS}")
    if workers == "proc":
        from repro_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

        policy = router_kw.get("call_policy")
        sup = WorkerSupervisor(
            supervisor_cfg if supervisor_cfg is not None else SupervisorConfig(),
            impl=impl, wire_dtype=wire_dtype, device=device,
            deadline_s=policy.deadline_s if policy is not None else None)
        try:
            fleet = sup.spawn_fleet(directory, replicas=replicas)
            return ShardRouter(fleet, strict=strict, wire_dtype=wire_dtype, supervisor=sup,
                               **router_kw)
        except BaseException:
            # A fleet that failed to spawn or assemble must not leak its
            # already-started worker processes.
            sup.shutdown(drain=False)
            raise
    manifest = read_fleet_manifest(directory)
    R = int(manifest.get("replicas", 1)) if replicas is None else int(replicas)
    if R < 1:
        raise SnapshotError(f"fleet needs replicas >= 1, got {R}")
    fleet = []
    for d in shard_dirs(directory):
        for r in range(R):
            w = restore_shard(d, impl=impl, device=device)
            w.spec = w.spec._replace(replica=r, n_replicas=R)
            fleet.append(w)
    return ShardRouter(fleet, strict=strict, wire_dtype=wire_dtype, **router_kw)
