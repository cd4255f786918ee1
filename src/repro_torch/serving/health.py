"""Per-worker health tracking + the deadline/retry failover call wrapper.

Port of ``repro/serving/health.py``, line for line: pure Python with an
injected clock and sleep, so both packages walk the same states and sleep
the same delays on the same events.

The fault-tolerance tier of shard-routed serving (DESIGN.md §14).  A
`ShardRouter` dispatches every ``ShardWorker.topk`` through this module:

* ``HealthTracker`` — one state machine per worker key::

      HEALTHY --f--> DEGRADED --f--> EJECTED --cooldown--> PROBATION
         ^              |                ^                    |
         +---successes--+                +------failure-------+
         +------------------trial success--------------------+

  Failure counts are CONSECUTIVE: any success resets them.  A DEGRADED
  worker still takes traffic (it sorts behind healthy replicas); an
  EJECTED worker takes none until ``probation_after`` router ticks have
  elapsed, at which point it is admitted for a single trial call —
  success re-admits it, failure re-ejects it for another cooldown.  Time
  is a LOGICAL clock (router search batches), not wall time, so every
  transition is deterministic under the seeded fault harness
  (serving/faults.py) and reproducible bit-for-bit in tests.

* ``run_with_failover`` — the call path every dispatch takes: cycle
  through the (router-ordered) replica candidates, bounded by
  ``CallPolicy.max_attempts`` total attempts and an optional per-batch
  ``deadline_s`` budget, with exponential backoff + deterministic seeded
  jitter between consecutive attempts.  A result that lands AFTER the
  deadline is discarded and counted as that worker's failure — a reply
  the caller has stopped waiting for is not a success.  Every attempt is
  recorded against the tracker and returned to the caller (the router
  feeds them to the per-shard meter and to the structured degraded-path
  errors).

The clock and sleep are injectable (``faults.VirtualClock``) so chaos
tests advance time deterministically instead of sleeping.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, NamedTuple, Sequence


class HealthState(str, enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"  # failing recently; deprioritized, still serving
    EJECTED = "ejected"  # out of rotation until probation
    PROBATION = "probation"  # one trial call decides re-admission

    def __str__(self) -> str:  # "healthy", not "HealthState.HEALTHY"
        return self.value


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds of the per-worker state machine (consecutive counts)."""

    degrade_after: int = 1  # consecutive failures -> DEGRADED
    eject_after: int = 3  # consecutive failures -> EJECTED
    probation_after: int = 8  # router ticks ejected before one trial call
    recover_after: int = 2  # consecutive successes DEGRADED -> HEALTHY

    def __post_init__(self):
        assert 1 <= self.degrade_after <= self.eject_after, self
        assert self.probation_after >= 1 and self.recover_after >= 1, self


@dataclasses.dataclass(frozen=True)
class CallPolicy:
    """Deadline + bounded-retry budget for one shard's dispatch.

    ``deadline_s`` is the wall (or virtual) budget for ALL attempts of one
    search batch against one shard — ``None`` means unbounded, the healthy
    single-replica default (a first batch legitimately pays multi-second
    XLA compiles; production fleets set a real budget and a warmup).
    ``max_attempts`` bounds total attempts ACROSS replicas per dispatch;
    backoff before retry ``i`` (i >= 2) is
    ``min(backoff_base_s * backoff_mult**(i-2), backoff_max_s)`` scaled by
    ``1 + jitter_frac * u``, u drawn from the router's seeded RNG — jitter
    de-synchronizes retry storms without sacrificing reproducibility.
    """

    deadline_s: float | None = None
    max_attempts: int = 4
    backoff_base_s: float = 0.002
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.1
    jitter_frac: float = 0.5

    def __post_init__(self):
        assert self.max_attempts >= 1, self.max_attempts
        assert self.deadline_s is None or self.deadline_s > 0, self.deadline_s

    def backoff_s(self, attempt: int, u: float) -> float:
        """Backoff before attempt number ``attempt`` (1-based; 1 = none)."""
        if attempt <= 1:
            return 0.0
        base = min(self.backoff_base_s * self.backoff_mult ** (attempt - 2),
                   self.backoff_max_s)
        return base * (1.0 + self.jitter_frac * u)


class Attempt(NamedTuple):
    """One dispatch attempt's outcome (router -> meter / degraded errors)."""

    worker: str  # worker key, e.g. "s1r0"
    seconds: float
    error: str | None  # None = success


class _WorkerStats:
    __slots__ = ("state", "consec_fail", "consec_ok", "ejected_tick",
                 "failures", "successes")

    def __init__(self):
        self.state = HealthState.HEALTHY
        self.consec_fail = 0
        self.consec_ok = 0
        self.ejected_tick = -1
        self.failures = 0
        self.successes = 0


class HealthTracker:
    """Per-worker-key health state, driven by a logical router clock."""

    def __init__(self, cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self._w: dict[str, _WorkerStats] = {}
        self._tick = 0

    def _get(self, key: str) -> _WorkerStats:
        return self._w.setdefault(str(key), _WorkerStats())

    def tick(self) -> None:
        """Advance the logical clock — one tick per router search batch."""
        self._tick += 1

    def state(self, key: str) -> HealthState:
        return self._get(key).state

    def admissible(self, key: str) -> bool:
        """May this worker receive traffic right now?

        EJECTED workers come back as PROBATION once ``probation_after``
        ticks have passed since ejection (the transition happens here, so
        merely ASKING admits at most one trial — the next failure
        re-ejects with a fresh cooldown).
        """
        w = self._get(key)
        if w.state is HealthState.EJECTED:
            if self._tick - w.ejected_tick >= self.cfg.probation_after:
                w.state = HealthState.PROBATION
                return True
            return False
        return True

    def record_success(self, key: str) -> None:
        w = self._get(key)
        w.successes += 1
        w.consec_fail = 0
        w.consec_ok += 1
        if w.state is HealthState.PROBATION:  # trial passed
            w.state = HealthState.HEALTHY
        elif (w.state is HealthState.DEGRADED
              and w.consec_ok >= self.cfg.recover_after):
            w.state = HealthState.HEALTHY

    def record_failure(self, key: str) -> None:
        w = self._get(key)
        w.failures += 1
        w.consec_ok = 0
        w.consec_fail += 1
        if w.state is HealthState.PROBATION:  # trial failed: straight back
            w.state = HealthState.EJECTED
            w.ejected_tick = self._tick
        elif w.consec_fail >= self.cfg.eject_after:
            w.state = HealthState.EJECTED
            w.ejected_tick = self._tick
        elif w.consec_fail >= self.cfg.degrade_after:
            w.state = HealthState.DEGRADED

    def mark_respawned(self, key: str) -> None:
        """A supervisor replaced this worker's process: re-admit on trial.

        A fresh process restored from snapshot serves the same bits as its
        predecessor but has an unproven runtime (cold caches, possibly the
        same environmental cause that killed it), so it enters PROBATION —
        one trial call decides re-admission, exactly like a replica
        returning from ejection — rather than jumping straight to HEALTHY.
        Consecutive counters reset (they described the dead process);
        lifetime failure/success totals are kept for the summary.
        """
        w = self._get(key)
        w.state = HealthState.PROBATION
        w.consec_fail = 0
        w.consec_ok = 0

    def summary(self) -> dict:
        return {
            key: {"state": str(w.state), "failures": w.failures,
                  "successes": w.successes, "consec_fail": w.consec_fail}
            for key, w in sorted(self._w.items())
        }


def run_with_failover(
    candidates: Sequence[tuple[str, Callable[[], object]]],
    *,
    policy: CallPolicy,
    tracker: HealthTracker,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    uniform: Callable[[], float] = lambda: 0.0,
) -> tuple[object | None, list[Attempt]]:
    """Call replicas in order with retries/backoff under a deadline budget.

    ``candidates`` is the router-ordered [(key, thunk)] replica list
    (healthiest / least-loaded first); attempts cycle through it — first a
    failover pass across replicas, then renewed retries — until a thunk
    returns, ``policy.max_attempts`` is spent, or the deadline budget
    cannot fit the next backoff.  Returns ``(result, attempts)``;
    ``result is None`` means the shard is exhausted for this batch (the
    degraded path decides what that costs).  Exceptions from thunks are
    failures by definition — the thunk wraps result validation too, so a
    torn/garbage reply fails over exactly like a raised error.
    """
    attempts: list[Attempt] = []
    if not candidates:
        return None, attempts
    deadline = (None if policy.deadline_s is None
                else clock() + policy.deadline_s)
    for attempt in range(1, policy.max_attempts + 1):
        key, thunk = candidates[(attempt - 1) % len(candidates)]
        delay = policy.backoff_s(attempt, uniform())
        if delay > 0.0:
            if deadline is not None and clock() + delay >= deadline:
                break  # the budget cannot even fit the backoff
            sleep(delay)
        t0 = clock()
        try:
            out = thunk()
        except Exception as e:  # noqa: BLE001 — the fault barrier
            tracker.record_failure(key)
            attempts.append(Attempt(key, clock() - t0,
                                    f"{type(e).__name__}: {e}"))
            continue
        dt = clock() - t0
        if deadline is not None and clock() > deadline:
            # The reply landed after the caller's budget: a slow worker is
            # a failed worker, and the result is discarded, not served.
            tracker.record_failure(key)
            attempts.append(Attempt(key, dt, "deadline exceeded"))
            break
        tracker.record_success(key)
        attempts.append(Attempt(key, dt, None))
        return out, attempts
    return None, attempts
