"""Deterministic fault injection for the shard fleet (DESIGN.md §14).

Port of ``repro/serving/faults.py``.  The schedules are the reference's
call by call: every draw comes from ``random.Random(seed)`` in call order,
and ``inject_faults`` seeds each worker with ``zlib.crc32(f"{seed}:{key}")``,
so one seed injects the same faults in both packages.  A garbage reply is
made of tensors on the worker's device.

Chaos testing is only useful when a failing run can be replayed bit-for-bit:
every fault here is a pure function of ``(seed, worker key, call index)``,
never of wall time or arrival order.  Three pieces:

* ``VirtualClock`` — a logical time source the router's deadline/backoff
  machinery (serving/health.py) and the latency faults share.  ``sleep``
  advances it instead of blocking, so a chaos test that exercises
  multi-second latency spikes and retry backoff runs in microseconds and
  always observes the same timeline.
* ``FaultPolicy`` — a seeded per-worker fault schedule.  Constructors cover
  the failure taxonomy a real fleet sees:

  - ``fail_next(n)``      — the next ``n`` calls raise (transient fault:
                            the retry path's bread and butter);
  - ``die_at(call)``      — every call from index ``call`` on raises
                            (permanent worker death: the failover +
                            ejection path);
  - ``latency(spike_s, every=k)`` — every ``k``-th call takes ``spike_s``
                            extra (virtual) seconds before answering (the
                            deadline path: a slow reply must be discarded,
                            not served);
  - ``garbage(kinds, at)`` — the reply is TORN: wrong shape, unsorted
                            values, NaNs, or mismatched id geometry.  These
                            must be caught by the router's result
                            validation (``shards.validate_run``) and fail
                            over exactly like a raised error — a silent
                            wrong answer is the one failure mode worse
                            than downtime;
  - ``bernoulli(rate, seed, kinds)`` — each call draws a fault of a random
                            kind with probability ``rate`` from a
                            per-policy ``random.Random(seed)`` (call-index
                            keyed, so the schedule is reproducible).

* ``FaultyWorker`` — wraps a ``ShardWorker`` (attribute-transparent via
  ``__getattr__``), consulting the policy once per ``topk`` call.
  ``inject_faults`` rebuilds a router's fleet with wrapped workers for
  CLI/bench use (``launch.serve --fault-rate``).
"""
from __future__ import annotations

import random
import time
import zlib
from typing import NamedTuple, Sequence

import torch

from repro_torch.core.knn import KNNResult
from repro_torch.core.topk import next_pow2


class FaultInjectionError(RuntimeError):
    """An injected worker failure (distinguishable from real bugs in logs)."""


class VirtualClock:
    """Deterministic logical clock: ``now()`` / ``sleep`` / ``advance``."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0, dt
        self._t += float(dt)

    def sleep(self, dt: float) -> None:  # signature-compatible with time.sleep
        self.advance(dt)


class Fault(NamedTuple):
    kind: str  # "fail" | "die" | "latency" | "garbage" | "kill"
    latency_s: float = 0.0
    garbage: str = ""  # for kind="garbage": shape|unsorted|nan|ids


GARBAGE_KINDS = ("shape", "unsorted", "nan", "ids")

# "kill" SIGKILLs a live worker PROCESS mid-batch (DESIGN.md §15) — it needs
# a worker with a real pid (the proc backend's ProcWorker.kill); the other
# kinds simulate failures in-process and work on any backend.
FAULT_KINDS = ("fail", "die", "latency", "garbage", "kill")


class FaultPolicy:
    """Seeded, call-indexed fault schedule for one worker.

    The policy is consulted once per ``topk`` call with a monotonically
    increasing call index; whatever randomness it uses comes from its own
    ``random.Random(seed)`` drawn in call order, so two runs over the same
    dispatch sequence observe identical faults.
    """

    def __init__(self, schedule: dict[int, Fault] | None = None, *,
                 rate: float = 0.0, seed: int = 0,
                 kinds: Sequence[str] = ("fail",),
                 latency_s: float = 0.0, die_from: int | None = None):
        self.schedule = dict(schedule or {})
        self.rate = float(rate)
        self.kinds = tuple(kinds)
        self.latency_s = float(latency_s)
        self.die_from = die_from
        self._rng = random.Random(seed)
        assert 0.0 <= self.rate <= 1.0, self.rate
        for k in self.kinds:
            assert k in FAULT_KINDS, k

    # -- constructors (the failure taxonomy) --------------------------------

    @classmethod
    def none(cls) -> "FaultPolicy":
        return cls()

    @classmethod
    def fail_next(cls, n: int) -> "FaultPolicy":
        """The next ``n`` calls raise; the worker is healthy afterwards."""
        return cls({i: Fault("fail") for i in range(n)})

    @classmethod
    def die_at(cls, call: int = 0) -> "FaultPolicy":
        """Permanent death: every call from index ``call`` on raises."""
        return cls(die_from=int(call))

    @classmethod
    def latency(cls, spike_s: float, *, every: int = 1,
                start: int = 0) -> "FaultPolicy":
        """Every ``every``-th call (from ``start``) takes ``spike_s`` extra."""
        p = cls()
        p._latency_every = (int(every), int(start), float(spike_s))
        return p

    @classmethod
    def garbage(cls, kind: str = "shape", *, at: int = 0) -> "FaultPolicy":
        """Call ``at`` returns a torn/garbage result of the given kind."""
        assert kind in GARBAGE_KINDS, kind
        return cls({int(at): Fault("garbage", garbage=kind)})

    @classmethod
    def kill_at(cls, call: int = 0) -> "FaultPolicy":
        """Call ``call`` SIGKILLs the worker PROCESS mid-batch, then lets
        the (now doomed) call proceed — the wire discovers the death as a
        broken pipe, the failure mode a simulated exception cannot reach."""
        return cls({int(call): Fault("kill")})

    @classmethod
    def bernoulli(cls, rate: float, *, seed: int = 0,
                  kinds: Sequence[str] = ("fail", "latency", "garbage"),
                  latency_s: float = 0.05) -> "FaultPolicy":
        """Each call faults with probability ``rate``, kind drawn uniformly."""
        return cls(rate=rate, seed=seed, kinds=kinds, latency_s=latency_s)

    # -- schedule -----------------------------------------------------------

    def next_fault(self, call: int) -> Fault | None:
        if self.die_from is not None and call >= self.die_from:
            return Fault("die")
        le = getattr(self, "_latency_every", None)
        if le is not None:
            every, start, spike = le
            if call >= start and (call - start) % every == 0:
                return Fault("latency", latency_s=spike)
        if call in self.schedule:
            return self.schedule[call]
        if self.rate > 0.0:
            # Two draws per call regardless of outcome: the rng stream stays
            # aligned with the call index, so the schedule does not shift
            # when a threshold changes.
            u, pick = self._rng.random(), self._rng.random()
            if u < self.rate:
                kind = self.kinds[int(pick * len(self.kinds)) % len(self.kinds)]
                if kind == "garbage":
                    g = GARBAGE_KINDS[int(pick * 977) % len(GARBAGE_KINDS)]
                    return Fault("garbage", garbage=g)
                if kind == "latency":
                    return Fault("latency", latency_s=self.latency_s)
                return Fault(kind)
        return None


def _garbage_result(kind: str, m: int, K: int, device="cpu") -> KNNResult:
    """A torn reply of the requested flavor, on ``device``; every one of
    these MUST be rejected by ``shards.validate_run``."""
    vals = torch.zeros((m, K), dtype=torch.float32, device=device)
    ids = torch.zeros((m, K), dtype=torch.int32, device=device)
    if kind == "shape":  # truncated row axis: a half-written buffer
        return KNNResult(vals[: max(m - 1, 0)], ids[: max(m - 1, 0)])
    if kind == "unsorted":  # descending run: a broken local merge
        v = torch.arange(K, 0, -1, dtype=torch.float32, device=device).repeat(m, 1)
        return KNNResult(v, ids)
    if kind == "nan":
        return KNNResult(torch.full((m, K), float("nan"), device=device), ids)
    if kind == "ids":  # value/id geometry mismatch: torn K axis
        return KNNResult(vals, ids[:, : max(K - 1, 1)])
    raise AssertionError(kind)


class FaultyWorker:
    """A ``ShardWorker`` proxy that injects the policy's faults into ``topk``.

    Everything except ``topk`` (spec/config/centroids/...) delegates to the
    wrapped worker, so routers, snapshots and meters see a normal worker.
    Latency faults advance the shared ``VirtualClock`` when one is given
    (chaos tests) and block for real otherwise (the ``--fault-rate`` demo).
    """

    def __init__(self, worker, policy: FaultPolicy,
                 clock: VirtualClock | None = None):
        self.inner = worker
        self.policy = policy
        self.clock = clock
        self.calls = 0
        self.faults_injected = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def topk(self, queries, k: int, **kw) -> KNNResult:
        call, self.calls = self.calls, self.calls + 1
        fault = self.policy.next_fault(call)
        if fault is None:
            return self.inner.topk(queries, k, **kw)
        self.faults_injected += 1
        if fault.kind in ("fail", "die"):
            raise FaultInjectionError(
                f"injected {fault.kind} on {self.inner.key} call {call}")
        if fault.kind == "kill":
            # Real process death, not a simulated raise: SIGKILL the live
            # worker, then forward the call — the transport layer finds a
            # corpse (broken pipe / EOF mid-frame) exactly as an uncommanded
            # crash would present, and the supervisor respawns at the next
            # poll.  Only proc-backend workers expose kill().
            kill = getattr(self.inner, "kill", None)
            if kill is None:
                raise FaultInjectionError(
                    f"kill fault on {self.inner.key}: worker has no process "
                    f"to kill (use the workers='proc' backend)")
            kill()
            return self.inner.topk(queries, k, **kw)
        if fault.kind == "latency":
            if self.clock is not None:
                self.clock.advance(fault.latency_s)
            else:
                time.sleep(fault.latency_s)
            return self.inner.topk(queries, k, **kw)
        assert fault.kind == "garbage", fault
        return _garbage_result(fault.garbage, int(queries.shape[0]), next_pow2(int(k)),
                               getattr(self.inner, "device", "cpu"))


def inject_faults(router, *, rate: float, seed: int = 0,
                  latency_s: float = 0.05,
                  kinds: Sequence[str] = ("fail", "latency", "garbage"),
                  clock: VirtualClock | None = None):
    """Rebuild ``router`` with every worker behind a seeded Bernoulli policy.

    Each worker gets an independent stream seeded by ``(seed, worker key)``
    so the fleet-wide schedule is reproducible yet uncorrelated across
    workers.  Returns a NEW router with the same routing/health/degraded
    configuration; the input router is not mutated.
    """
    from repro_torch.serving.shards import ShardRouter

    # crc32, not hash(): str hashing is salted per process, and a chaos
    # schedule must replay bit-for-bit across runs.
    wrapped = [
        FaultyWorker(
            w,
            FaultPolicy.bernoulli(
                rate, seed=zlib.crc32(f"{int(seed)}:{w.key}".encode()),
                kinds=kinds, latency_s=latency_s),
            clock=clock)
        for w in router.workers
    ]
    return ShardRouter(
        wrapped, strict=router.strict, wire_dtype=router.wire_dtype,
        degraded=router.degraded, call_policy=router.call_policy,
        health_cfg=router.health.cfg, meter=router.meter, seed=router.seed,
        clock=clock.now if clock is not None else router._clock,
        sleep=clock.sleep if clock is not None else router._sleep,
        supervisor=router.supervisor)
