"""The port's fault tier (``repro_torch.serving.health`` and ``faults``, the
router's failover and degraded paths) against the JAX package's.

The cases of ``tests/test_faults.py`` on the port's fleet, on the CPU, at
their shape (n 1024, d 16, 8 cells, 4 shards, R = 2); the case that drives
``serving/service.py`` waits for the port of the service.  The reference
runs once, in the module-scoped fixture ``R``: the health state machine and
``CallPolicy.backoff_s`` driven by one sequence of events, every
``FaultPolicy`` constructor's schedule, ``inject_faults`` over a reference
fleet restored from the port's own shard images (its crc32-keyed seeds),
and the fleet models of ``accounting``; the port must walk the same states,
sleep the same delays and inject the same faults, call by call.

The port's own contract, as the reference's: failover with one replica of
every shard dead is bit-identical to the healthy fleet; with both replicas
of a shard dead ``"refuse"`` raises ``ShardUnavailableError`` with cells,
shard ids and attempts, and ``"partial"`` serves the flat sort of the
surviving shards' runs with coverage < 1; every garbage kind is caught by
``validate_run``; deadlines, backoff, ejection and probation walk as pinned.
"""
import json
import os
import shutil
from collections import Counter
from types import SimpleNamespace

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from repro_torch.accounting import (
    ServingMeter,
    replicated_fleet_model,
    shard_bytes_per_query,
)
from repro_torch.core import topk as T
from repro_torch.core.knn import KNNResult
from repro_torch.serving import (
    CallPolicy,
    FaultInjectionError,
    FaultPolicy,
    FaultyWorker,
    HealthConfig,
    HealthState,
    HealthTracker,
    MissingShardError,
    RetrievalIndex,
    ShardRouter,
    ShardUnavailableError,
    SnapshotError,
    TornResultError,
    VirtualClock,
    aggregate_topk,
    inject_faults,
    load_fleet,
    load_router,
    read_fleet_manifest,
    run_with_failover,
    validate_run,
)
from repro_torch.serving.faults import GARBAGE_KINDS, _garbage_result
from repro_torch.serving.snapshot import save_shards, shard_dirs

N, D, K, NCELLS, NSHARDS = 1024, 16, 10, 8, 4
CFG = dict(ivf_cells=NCELLS, nprobe=4, overfetch=8)
CPU = dict(device="cpu")
WALK_CFG = dict(degrade_after=1, eject_after=3, probation_after=2, recover_after=2)
# One event sequence for both trackers: (event, key).
WALK = ([("fail", "w"), ("ok", "w"), ("ok", "w")] + [("fail", "w")] * 3
        + [("tick", None), ("admit", "w"), ("tick", None), ("admit", "w"), ("fail", "w"),
           ("tick", None), ("tick", None), ("admit", "w"), ("ok", "w"), ("fail", "v"),
           ("respawn", "v"), ("admit", "v"), ("ok", "v"), ("fail", "w"), ("fail", "w")])
BACKOFF = [dict(backoff_base_s=0.01, backoff_mult=2.0, backoff_max_s=0.05, jitter_frac=0.0),
           dict(backoff_base_s=0.01, jitter_frac=0.5), dict()]
SCHEDULES = {
    "none": ("none", (), {}),
    "fail_next": ("fail_next", (2,), {}),
    "die_at": ("die_at", (2,), {}),
    "latency": ("latency", (0.5,), dict(every=2, start=1)),
    "garbage": ("garbage", ("unsorted",), dict(at=3)),
    "kill_at": ("kill_at", (2,), {}),
    "bernoulli": ("bernoulli", (0.5,), dict(seed=3)),
    "bernoulli_kill": ("bernoulli", (1.0,), dict(seed=1, kinds=("kill",))),
    "bernoulli_all": ("bernoulli", (0.3,), dict(seed=9, kinds=("fail", "die", "latency",
                                                               "garbage", "kill"))),
}
CALLS = 48


def _walk(tracker_cls, cfg_cls, policy_cls):
    t = tracker_cls(cfg_cls(**WALK_CFG))
    trace = []
    for ev, key in WALK:
        if ev == "fail":
            t.record_failure(key)
        elif ev == "ok":
            t.record_success(key)
        elif ev == "tick":
            t.tick()
        elif ev == "admit":
            trace.append(("admit", t.admissible(key)))
        elif ev == "respawn":
            t.mark_respawned(key)
        if key is not None:
            trace.append((str(t.state(key)), key))
    delays = [[policy_cls(**kw).backoff_s(a, u) for a in range(1, 9) for u in (0.0, 0.3, 1.0)]
              for kw in BACKOFF]
    return trace, t.summary(), delays


def _schedule(policy):
    return [None if f is None else (f.kind, f.latency_s, f.garbage)
            for f in map(policy.next_fault, range(CALLS))]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The port's IVF index, its R=2 shard fleet root, the healthy baseline."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((NCELLS, D)).astype(np.float32) * 4
    vecs = (centers[rng.integers(0, NCELLS, N)]
            + rng.standard_normal((N, D)).astype(np.float32))
    q = (centers[rng.integers(0, NCELLS, 24)] + rng.standard_normal((24, D))).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(N), vecs, **CPU, **CFG)
    root = str(tmp_path_factory.mktemp("torch_faults") / "fleet")
    save_shards(idx, root, NSHARDS, replicas=2)
    base = load_fleet(root, replicas=1, **CPU).search(q, K)
    return SimpleNamespace(idx=idx, vecs=vecs, q=q, root=root, base=base)


@pytest.fixture(scope="module")
def R(fleet):
    """The reference's side, run once: walks, schedules, injected seeds and
    the fleet models (its fleet restored from the port's images)."""
    from repro.accounting import replicated_fleet_model as rfleet_model
    from repro.accounting import shard_bytes_per_query as rshard_bytes
    from repro.serving import CallPolicy as RPolicy
    from repro.serving import FaultPolicy as RFaultPolicy
    from repro.serving import HealthConfig as RConfig
    from repro.serving import HealthTracker as RTracker
    from repro.serving import inject_faults as rinject
    from repro.serving import load_fleet as rload_fleet

    out = {"walk": _walk(RTracker, RConfig, RPolicy)}
    out["schedules"] = {name: _schedule(getattr(RFaultPolicy, ctor)(*a, **kw))
                        for name, (ctor, a, kw) in SCHEDULES.items()}
    injected = rinject(rload_fleet(fleet.root), rate=0.3, seed=7,
                       kinds=("fail", "latency", "garbage", "kill"))
    out["injected"] = {w.key: _schedule(w.policy) for w in injected.workers}
    out["models"] = [rfleet_model(4, r, shards_dispatched=3.0, fault_rate=f)
                     for r in (1, 2, 3) for f in (0.0, 0.1, 0.5)]
    out["shard_bytes"] = [rshard_bytes(1 << 20, 256, s, ncells=4096, nprobe=p, pq_m=32, k=10,
                                       overfetch=8) for s in (1, 4, 16) for p in (8, 4096)]
    return out


def _assert_bit_identical(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)


def _router(root, *, replicas=1, degraded="refuse", policy=None, vc=None, meter=None,
            kill=(), fault=None):
    """A fleet router on a VirtualClock, optionally with workers dead from
    call 0 or given a FaultPolicy each."""
    vc = vc if vc is not None else VirtualClock()
    policy = policy if policy is not None else CallPolicy()
    r = load_fleet(root, replicas=replicas, degraded=degraded, call_policy=policy,
                   meter=meter, clock=vc.now, sleep=vc.sleep, **CPU)
    if kill or fault:
        workers = []
        for w in r.workers:
            if w.key in kill:
                workers.append(FaultyWorker(w, FaultPolicy.die_at(0), clock=vc))
            elif fault is not None and w.key in fault:
                workers.append(FaultyWorker(w, fault[w.key], clock=vc))
            else:
                workers.append(w)
        r = ShardRouter(workers, strict=True, degraded=degraded, call_policy=policy,
                        meter=meter, clock=vc.now, sleep=vc.sleep)
    return r, vc


# -- the same states, delays and faults as the reference ----------------------


def test_health_walk_and_backoff_equal_the_reference(R):
    trace, summary, delays = _walk(HealthTracker, HealthConfig, CallPolicy)
    rtrace, rsummary, rdelays = R["walk"]
    assert trace == rtrace
    assert summary == rsummary
    assert delays == rdelays


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_fault_schedules_equal_the_reference_call_by_call(R, name):
    ctor, a, kw = SCHEDULES[name]
    assert _schedule(getattr(FaultPolicy, ctor)(*a, **kw)) == R["schedules"][name]


def test_inject_faults_seeds_equal_the_reference(R, fleet):
    injected = inject_faults(load_fleet(fleet.root, **CPU), rate=0.3, seed=7,
                             kinds=("fail", "latency", "garbage", "kill"))
    got = {w.key: _schedule(w.policy) for w in injected.workers}
    assert got == R["injected"]
    assert len(got) == 2 * NSHARDS


def test_fleet_models_equal_the_reference(R):
    got = [replicated_fleet_model(4, r, shards_dispatched=3.0, fault_rate=f)
           for r in (1, 2, 3) for f in (0.0, 0.1, 0.5)]
    assert got == R["models"]
    got = [shard_bytes_per_query(1 << 20, 256, s, ncells=4096, nprobe=p, pq_m=32, k=10,
                                 overfetch=8) for s in (1, 4, 16) for p in (8, 4096)]
    assert got == R["shard_bytes"]


# -- replica failover is bit-invisible -----------------------------------------


def test_failover_bit_identical_with_one_replica_killed(fleet):
    kill = {f"s{s}r0" for s in range(NSHARDS)}
    router, _ = _router(fleet.root, replicas=2, kill=kill)
    got = router.search(fleet.q, K)
    _assert_bit_identical(fleet.base, got)
    assert np.all(got.coverage == 1.0)
    assert all(s in ("ok", "skipped") for _, s in got.shard_status)
    for _ in range(3):
        _assert_bit_identical(fleet.base, router.search(fleet.q, K))
    h = router.health.summary()
    assert all(h[k]["state"] in ("degraded", "ejected") for k in kill if k in h)
    assert all(h[f"s{s}r1"]["state"] == "healthy" for s in range(NSHARDS) if f"s{s}r1" in h)


def test_healthy_fleet_reports_full_coverage(fleet):
    router, _ = _router(fleet.root, replicas=2)
    got = router.search(fleet.q, K)
    _assert_bit_identical(fleet.base, got)
    assert got.coverage.shape == (len(fleet.q),) and np.all(got.coverage == 1.0)
    assert dict(got.shard_status).keys() == set(range(NSHARDS))


# -- degraded serving: refuse vs partial ---------------------------------------


def test_all_replicas_dead_refuse_raises_structured(fleet):
    router, _ = _router(fleet.root, replicas=2, kill={"s1r0", "s1r1"})
    with pytest.raises(ShardUnavailableError) as ei:
        router.search(fleet.q, K)
    e = ei.value
    assert e.shard_ids == (1,)
    spec = router.workers[router.groups[1][0]].spec
    assert e.cells and all(spec.cell_lo <= c < spec.cell_hi for c in e.cells)
    assert len(e.attempts) >= 2
    assert {a.worker for a in e.attempts} == {"s1r0", "s1r1"}
    assert all(a.error for a in e.attempts)
    assert isinstance(e, MissingShardError)


def test_all_replicas_dead_partial_serves_the_survivors(fleet):
    router, _ = _router(fleet.root, replicas=2, degraded="partial", kill={"s1r0", "s1r1"})
    got = router.search(fleet.q, K)
    assert got.coverage.shape == (len(fleet.q),) and got.coverage.min() < 1.0
    assert dict(got.shard_status)[1] == "failed"
    probe = router.probe(fleet.q)
    gid, _ = router._group_of(probe)
    untouched = ~np.any(gid == 1, axis=1)
    assert np.all(got.coverage[untouched] == 1.0)
    assert torch.equal(got.ids[torch.from_numpy(untouched)],
                       fleet.base.ids[torch.from_numpy(untouched)])
    # The served result is the flat sort of the surviving shards' runs.
    alive = [router.workers[g[0]].topk(fleet.q, K) for i, g in enumerate(router.groups)
             if i != 1]
    vals = torch.cat([r.distances for r in alive], 1)
    order = torch.sort(vals, dim=1, stable=True).indices[:, :K]
    assert torch.equal(got.distances, vals.gather(1, order))
    ids = torch.cat([r.indices for r in alive], 1).gather(1, order)
    assert torch.equal(got.ids, ids)


def test_degraded_policy_validated(fleet):
    with pytest.raises(ValueError, match="degraded"):
        load_fleet(fleet.root, degraded="shrug", **CPU)


def test_unowned_cells_structured_error(fleet):
    dirs = shard_dirs(fleet.root)
    router = load_router(dirs[:-1], strict=False, **CPU)
    with pytest.raises(MissingShardError, match="owned by no loaded shard") as ei:
        router.search(fleet.q, K)
    assert ei.value.cells
    assert all(c >= router.workers[-1].spec.cell_hi for c in ei.value.cells)


# -- the call path: retries, deadlines, torn results --------------------------


def test_transient_failures_recover_via_retry(fleet):
    meter = ServingMeter()
    router, _ = _router(fleet.root, meter=meter, fault={"s0r0": FaultPolicy.fail_next(2)})
    got = router.search(fleet.q, K)
    _assert_bit_identical(fleet.base, got)
    sh = meter.shard_summary()["workers"]["s0r0"]
    assert sh["calls"] == 3 and sh["failures"] == 2
    assert "FaultInjectionError" in sh["last_error"]
    assert meter.summary()["shard_failures"] == 2
    assert router.health.state("s0r0") is HealthState.DEGRADED
    router.search(fleet.q, K)
    router.search(fleet.q, K)
    assert router.health.state("s0r0") is HealthState.HEALTHY


@pytest.mark.parametrize("kind", GARBAGE_KINDS)
def test_garbage_replies_fail_over_like_errors(fleet, kind):
    meter = ServingMeter()
    router, _ = _router(fleet.root, meter=meter, fault={"s2r0": FaultPolicy.garbage(kind)})
    _assert_bit_identical(fleet.base, router.search(fleet.q, K))
    sh = meter.shard_summary()["workers"]["s2r0"]
    assert sh["failures"] == 1 and "TornResultError" in sh["last_error"]


@pytest.mark.parametrize("kind", GARBAGE_KINDS)
def test_validate_run_catches_each_garbage_kind(kind):
    m, Kp = 3, T.next_pow2(K)
    bad = _garbage_result(kind, m, Kp, "cpu")
    assert bad.distances.device.type == "cpu"
    with pytest.raises(TornResultError):
        validate_run(bad, m, Kp)


def test_validate_run_passes_a_padded_run():
    m, Kp = 3, T.next_pow2(K)
    vals = torch.arange(Kp, dtype=torch.float32).repeat(m, 1)
    vals[:, -3:] = float("inf")
    ok = KNNResult(vals, torch.zeros((m, Kp), dtype=torch.int32))
    assert validate_run(ok, m, Kp) is ok
    with pytest.raises(TornResultError, match="integral"):
        validate_run(KNNResult(vals, vals), m, Kp)


def test_deadline_discards_late_reply():
    vc = VirtualClock()
    tracker = HealthTracker()

    def slow():
        vc.advance(0.1)
        return "late"

    out, attempts = run_with_failover(
        [("w", slow)], policy=CallPolicy(deadline_s=0.05, max_attempts=3),
        tracker=tracker, clock=vc.now, sleep=vc.sleep)
    assert out is None
    assert len(attempts) == 1 and attempts[0].error == "deadline exceeded"
    assert tracker.state("w") is HealthState.DEGRADED


def test_deadline_budget_stops_backoff():
    vc = VirtualClock()

    def failing():
        raise RuntimeError("nope")

    policy = CallPolicy(deadline_s=0.001, max_attempts=10, backoff_base_s=0.01,
                        jitter_frac=0.0)
    out, attempts = run_with_failover([("w", failing)], policy=policy,
                                      tracker=HealthTracker(), clock=vc.now, sleep=vc.sleep)
    assert out is None and len(attempts) == 1 and vc.now() == 0.0


def test_latency_spike_fails_batch_then_routes_around(fleet):
    policy = CallPolicy(deadline_s=0.04, max_attempts=4)
    router, vc = _router(fleet.root, replicas=2, degraded="partial", policy=policy,
                         fault={"s0r0": FaultPolicy.latency(0.05)})
    got = router.search(fleet.q, K)
    assert dict(got.shard_status)[0] == "failed"
    assert got.coverage.min() < 1.0
    assert router.health.state("s0r0") is HealthState.DEGRADED
    got2 = router.search(fleet.q, K)
    _assert_bit_identical(fleet.base, got2)
    assert np.all(got2.coverage == 1.0)


def test_ejected_worker_rejoins_through_probation(fleet):
    cfg = HealthConfig(degrade_after=1, eject_after=2, probation_after=2, recover_after=1)
    vc = VirtualClock()
    kw = dict(degraded="partial", health_cfg=cfg, call_policy=CallPolicy(max_attempts=1),
              clock=vc.now, sleep=vc.sleep)
    r = load_fleet(fleet.root, replicas=1, **kw, **CPU)
    workers = [FaultyWorker(w, FaultPolicy.fail_next(2), clock=vc) if w.key == "s0r0" else w
               for w in r.workers]
    router = ShardRouter(workers, **kw)
    faulty = next(w for w in router.workers if w.key == "s0r0")
    assert router.search(fleet.q, K).coverage.min() < 1.0
    assert router.health.state("s0r0") is HealthState.DEGRADED
    router.search(fleet.q, K)
    assert router.health.state("s0r0") is HealthState.EJECTED
    calls = faulty.calls
    router.search(fleet.q, K)
    assert faulty.calls == calls and router.health.state("s0r0") is HealthState.EJECTED
    got = router.search(fleet.q, K)
    assert router.health.state("s0r0") is HealthState.HEALTHY
    _assert_bit_identical(fleet.base, got)
    assert np.all(got.coverage == 1.0)


def test_seeded_chaos_is_reproducible(fleet):
    def run_once():
        vc = VirtualClock()
        meter = ServingMeter()
        router, _ = _router(fleet.root, replicas=2, degraded="partial",
                            policy=CallPolicy(deadline_s=0.04), vc=vc, meter=meter)
        router = inject_faults(router, rate=0.3, seed=7, clock=vc)
        out = []
        for _ in range(4):
            r = router.search(fleet.q, K)
            out.append((r.ids.clone(), r.coverage.copy(), r.shard_status))
        return out, router.health.summary(), vc.now(), meter.shard_summary()["failures"]

    a, ah, at, af = run_once()
    b, bh, bt, bf = run_once()
    for (ai, ac, as_), (bi, bc, bs_) in zip(a, b):
        assert torch.equal(ai, bi)
        np.testing.assert_array_equal(ac, bc)
        assert as_ == bs_
    assert ah == bh and at == bt and af == bf


def test_kill_fault_requires_a_process_to_kill(fleet):
    router = load_fleet(fleet.root, replicas=1, **CPU)
    w = FaultyWorker(router.workers[0], FaultPolicy.kill_at(0))
    with pytest.raises(FaultInjectionError, match="no process to kill"):
        w.topk(fleet.q, K)


# -- torn fleets report everything ---------------------------------------------


def test_torn_fleet_reports_all_inconsistent_shards(fleet, tmp_path):
    other = RetrievalIndex.build(np.arange(N), fleet.vecs[::-1].copy(), **CPU, **CFG)
    old_root = str(tmp_path / "old")
    save_shards(other, old_root, NSHARDS)
    root = str(tmp_path / "torn")
    shutil.copytree(fleet.root, root)
    for i in (1, 2, 3):
        shutil.rmtree(os.path.join(root, f"shard-{i:03d}"))
        shutil.copytree(os.path.join(old_root, f"shard-{i:03d}"),
                        os.path.join(root, f"shard-{i:03d}"))
    with pytest.raises(SnapshotError, match="parent snapshot signature") as ei:
        load_router(shard_dirs(root), **CPU)
    msg = str(ei.value)
    assert msg.count("parent snapshot signature") == 3
    for i in (1, 2, 3):
        assert f"shard {i} " in msg
    assert "3 fleet assembly violation(s)" in msg


def test_assembly_collects_mixed_violation_kinds(fleet, tmp_path):
    root = str(tmp_path / "multi")
    shutil.copytree(fleet.root, root)
    dirs = shard_dirs(root)

    def tamper(sd, fn):
        path = os.path.join(sd, "manifest.json")
        with open(path) as f:
            m = json.load(f)
        fn(m)
        with open(path, "w") as f:
            json.dump(m, f)

    tamper(dirs[1], lambda m: m["shard"].update(cell_lo=1, cell_hi=3))
    tamper(dirs[3], lambda m: m["parent"].update(fingerprint="deadbeef"))
    with pytest.raises(SnapshotError) as ei:
        load_router(dirs, strict=False, **CPU)
    assert "overlap" in str(ei.value) and "parent snapshot signature" in str(ei.value)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(n_shards=st.integers(2, 6), m=st.integers(1, 3),
                  k=st.sampled_from([1, 3, 7, 10]), seed=st.integers(0, 100_000),
                  wire=st.booleans(), drop_seed=st.integers(0, 100_000))
def test_aggregate_degraded_subset_is_flat_sort_of_survivors(n_shards, m, k, seed, wire,
                                                             drop_seed):
    """A dropped shard's +inf run is the merge identity: the merge of any
    subset is the flat-sort top-k of the surviving runs, ties and the bf16
    wire included (the drawn values are bf16-exact)."""
    Kp = T.next_pow2(k)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, size=(n_shards, m, Kp)).astype(np.float32)
    ids = (np.arange(n_shards)[:, None, None] * 1000 + np.arange(m)[None, :, None] * 100
           + np.arange(Kp)[None, None, :]).astype(np.int32)
    dead = rng.random((n_shards, m, Kp)) < 0.3
    vals[dead], ids[dead] = np.inf, -1
    order = np.argsort(vals, axis=-1, kind="stable")
    vals = np.take_along_axis(vals, order, -1)
    ids = np.take_along_axis(ids, order, -1)
    drop = np.random.default_rng(drop_seed).random(n_shards) < 0.5
    mv, mi = vals.copy(), ids.copy()
    mv[drop], mi[drop] = np.inf, -1
    got = aggregate_topk(torch.from_numpy(mv), torch.from_numpy(mi), k,
                         wire_dtype="bfloat16" if wire else None)
    gv, gi = got.distances.numpy(), got.indices.numpy()
    surv = vals[~drop]
    for j in range(m):
        flat = np.sort(surv[:, j, :].ravel(), kind="stable") if len(surv) else np.empty(0)
        want = np.full(k, np.inf, np.float32)
        want[: min(k, len(flat))] = flat[:k]
        np.testing.assert_array_equal(gv[j], want)
        pool = Counter(zip(mv[:, j, :].ravel().tolist(), mi[:, j, :].ravel().tolist()))
        pool[(float("inf"), -1)] += k
        for v, i in zip(gv[j].tolist(), gi[j].tolist()):
            assert pool[(v, i)] > 0, (v, i)
            pool[(v, i)] -= 1


# -- the replicated fleet's manifest -----------------------------------------


def test_fleet_manifest_roundtrip(fleet):
    m = read_fleet_manifest(fleet.root)
    assert m["n_shards"] == NSHARDS and m["replicas"] == 2
    router = load_fleet(fleet.root, **CPU)
    assert router.n_replicas == 2 and len(router.workers) == 2 * NSHARDS
    assert {w.key for w in router.workers} == {f"s{s}r{r}" for s in range(NSHARDS)
                                               for r in range(2)}
    g0 = [router.workers[i] for i in router.groups[0]]
    assert torch.equal(g0[0].packed, g0[1].packed) and g0[0].packed is not g0[1].packed
    assert router.n_live == len(fleet.idx)
    assert load_fleet(fleet.root, replicas=1, **CPU).n_replicas == 1
    assert load_fleet(fleet.root, replicas=3, **CPU).n_replicas == 3


def test_fleet_manifest_torn_root_raises(fleet, tmp_path):
    root = str(tmp_path / "torn")
    shutil.copytree(fleet.root, root)
    shutil.rmtree(os.path.join(root, f"shard-{NSHARDS - 1:03d}"))
    with pytest.raises(SnapshotError, match="torn fleet"):
        read_fleet_manifest(root)


def test_fleet_root_without_manifest_loads_unreplicated(fleet, tmp_path):
    root = str(tmp_path / "legacy")
    shutil.copytree(fleet.root, root)
    os.remove(os.path.join(root, "fleet.json"))
    assert read_fleet_manifest(root)["replicas"] == 1
    router = load_fleet(root, **CPU)
    assert router.n_replicas == 1
    _assert_bit_identical(fleet.base, router.search(fleet.q, K))


def test_replicated_fleet_model_sanity():
    m1, m2, m3 = (replicated_fleet_model(4, r, shards_dispatched=3.0, fault_rate=0.1)
                  for r in (1, 2, 3))
    assert m1["p_query_complete"] < m2["p_query_complete"] < m3["p_query_complete"]
    assert m1["expected_coverage"] == pytest.approx(0.9)
    assert m2["expected_coverage"] == pytest.approx(0.99)
    assert m2["storage_factor"] == 2.0
    healthy = replicated_fleet_model(4, 2, shards_dispatched=3.0)
    assert healthy["p_query_complete"] == 1.0 and healthy["dispatch_factor"] == 1.0
