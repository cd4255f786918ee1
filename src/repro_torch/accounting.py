"""Serving accounting: the per-batch latency meter of the query engine, and
the bytes model of the scan.

Port of ``repro/accounting.py``: ``ServingMeter`` (the batch samples, the
lifecycle's WAL and handoff counters, the shard fleet's per-worker dispatch
counters, and their summary), ``scan_bytes_per_query`` for the flat,
quantized, IVF and IVF-PQ scans, and the fleet's models:
``shard_bytes_per_query``, ``rpc_bytes_per_batch`` and
``replicated_fleet_model``.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.topk import next_pow2

# itemsize of the database stream per scan dtype (core.distances.SCAN_DTYPES).
_SCAN_ITEMSIZE = {"float32": 4, "bfloat16": 2, "int8": 1}


def scan_bytes_per_query(n_rows: int, d: int, *, scan_dtype: str = "float32", k: int = 10,
                         overfetch: int = 4, ncells: int | None = None,
                         nprobe: int | None = None, pq_m: int | None = None,
                         pq_nbits: int = 8) -> dict:
    """Analytic device bytes one query's corpus scan moves (a model, not a probe).

    * ``centroids``: the IVF shortlist reads the [ncells, d] fp32 centroids
      (zero for a flat scan);
    * ``scan``: the database stream over the scanned rows, all n for a flat
      scan or ``nprobe`` average cells (nprobe * n / ncells) for IVF, at d
      times the scan dtype's width, or ``pq_m`` code bytes a row with PQ
      (one byte a code for any ``pq_nbits`` <= 8);
    * ``epilogue``: ``hy`` (fp32) over the scanned rows, plus the int8 scales;
    * ``rescore``: stage 2's K' = overfetch * next_pow2(k) fp32 rows (zero
      only for the flat fp32 scan, which has no second stage).

    Query-side operands and the [*, K] outputs are O(d + k) per query and
    left out, identically for every configuration.  So is the PQ table
    build, as the reference leaves it out: it reads the [2^nbits, d] fp32
    codebook once per query batch, and each query's table
    (``pq_m * 2^nbits`` floats) is built and read on the chip.
    """
    ivf = ncells is not None and ncells > 0
    pq = pq_m is not None and pq_m > 0
    centroids = ncells * d * 4 if ivf else 0
    if ivf:
        nprobe = min(ncells if nprobe is None else nprobe, ncells)
        scanned_rows = min(n_rows, -(-n_rows // ncells) * nprobe)
    else:
        scanned_rows = n_rows
    if pq:
        if not 1 <= pq_nbits <= 8:
            raise ValueError(f"pq_nbits={pq_nbits} must be in [1, 8]")
        scan, scaled = scanned_rows * pq_m, False
    else:
        scan, scaled = scanned_rows * d * _SCAN_ITEMSIZE[scan_dtype], scan_dtype == "int8"
    epilogue = scanned_rows * 4 * (2 if scaled else 1)
    two_stage = ivf or pq or scan_dtype != "float32"
    rescore = min(n_rows, overfetch * next_pow2(k)) * d * 4 if two_stage else 0
    return {"centroids": centroids, "scan": scan, "epilogue": epilogue, "rescore": rescore,
            "total": centroids + scan + epilogue + rescore}



def shard_bytes_per_query(n_rows: int, d: int, n_shards: int, *, scan_dtype: str = "float32",
                          k: int = 10, overfetch: int = 4, ncells: int = 0,
                          nprobe: int | None = None, pq_m: int | None = None,
                          pq_nbits: int = 8, wire_bytes_per_value: int = 2) -> dict:
    """Analytic per-shard traffic of the shard-routed path (DESIGN.md §13).

    ``scan_bytes_per_query`` over a fleet of ``n_shards`` cell-range
    shards: ``nprobe`` distinct probed cells land on an expected
    ``shards_dispatched`` = S (1 - C(ncells - c, nprobe) / C(ncells,
    nprobe)) shards (c = ncells / S cells a shard).  Each dispatched shard
    reads the whole replicated centroid table, streams its share of the
    probed rows (the scan and epilogue bytes split over the dispatched
    shards), rescores its own overfetch window (not divided: each worker
    overfetches), and ships one sorted run of K = next_pow2(k) entries,
    ``wire_bytes_per_value`` + 4 id bytes each.
    """
    assert n_shards >= 1 and ncells >= n_shards, (n_shards, ncells)
    whole = scan_bytes_per_query(n_rows, d, scan_dtype=scan_dtype, k=k, overfetch=overfetch,
                                 ncells=ncells, nprobe=nprobe, pq_m=pq_m, pq_nbits=pq_nbits)
    nprobe_eff = min(ncells if nprobe is None else nprobe, ncells)
    free = ncells - ncells / n_shards
    # P(one shard owns none of the probed cells); 0 where the probe is exhaustive.
    if nprobe_eff > free:
        p_none = 0.0
    else:
        p_none = math.exp(math.lgamma(free + 1) - math.lgamma(free - nprobe_eff + 1)
                          - math.lgamma(ncells + 1) + math.lgamma(ncells - nprobe_eff + 1))
    dispatched = n_shards * (1.0 - p_none)
    per_shard = {
        "centroids": whole["centroids"],
        "scan": whole["scan"] / dispatched,
        "epilogue": whole["epilogue"] / dispatched,
        "rescore": whole["rescore"],
        "wire": next_pow2(k) * (wire_bytes_per_value + 4),
    }
    per_shard["total"] = sum(per_shard.values())
    return {"shards_dispatched": dispatched, "per_shard": per_shard,
            "aggregator_wire": dispatched * per_shard["wire"],
            "fleet_total": dispatched * per_shard["total"],
            "single_host_total": whole["total"]}


def rpc_bytes_per_batch(m: int, d: int, *, k: int = 10, shards_dispatched: float = 1.0,
                        wire_bytes_per_value: int = 4) -> dict:
    """Analytic wire bytes of the RPC hop per search batch (DESIGN.md §15).

    Per dispatched shard: one QUERY frame (header and meta, from the
    transport's own framing, plus the [m, d] fp32 queries: every dispatched
    shard gets the whole batch and probes locally) and one RESULT frame
    (overhead plus the sorted [m, K] run, ``wire_bytes_per_value`` value
    bytes, 4 for fp32 or 2 for bf16, plus 4 id bytes an entry).
    """
    from repro_torch.serving.transport import frame_overhead_bytes

    assert m >= 1 and d >= 1 and shards_dispatched >= 0.0, (m, d)
    K = next_pow2(k)
    req_overhead = frame_overhead_bytes(
        {"seq": 10 ** 9, "k": int(k), "nprobe": 10 ** 4, "overfetch": 10 ** 4}, n_arrays=1)
    rep_overhead = frame_overhead_bytes({"seq": 10 ** 9}, n_arrays=2)
    request = req_overhead + m * d * 4
    reply = rep_overhead + m * K * (wire_bytes_per_value + 4)
    return {"request": request, "reply": reply, "per_shard": request + reply,
            "fleet_request": shards_dispatched * request,
            "fleet_reply": shards_dispatched * reply,
            "fleet_total": shards_dispatched * (request + reply),
            "per_query": shards_dispatched * (request + reply) / m}


def replicated_fleet_model(n_shards: int, replicas: int, *, shards_dispatched: float,
                           fault_rate: float = 0.0) -> dict:
    """Availability and storage of an R-replicated fleet (DESIGN.md §14)
    under independent per-call worker failures at probability
    ``fault_rate``: a dispatched shard is lost only when all R replicas
    fail (f^R); a query is complete when every dispatched shard is served;
    storage scales by R; a served call takes 1 / (1 - f) attempts."""
    assert replicas >= 1 and 0.0 <= fault_rate < 1.0, (replicas, fault_rate)
    f = float(fault_rate)
    p_lost = f ** replicas
    return {"p_shard_served": 1.0 - p_lost,
            "p_query_complete": (1.0 - p_lost) ** shards_dispatched,
            "expected_coverage": 1.0 - p_lost,
            "storage_factor": float(replicas),
            "dispatch_factor": 1.0 / (1.0 - f)}

def stream_clock(device: torch.device) -> float:
    """Host seconds, read after the calling thread's current stream on
    ``device`` has finished its queued work, and no other stream's.

    Kernels are asynchronous: without the synchronise, a timer around a
    search would measure the enqueue, not the search.  The engine times its
    batches with this clock, so a batch is charged with the work it queued
    and not with kernels that another thread (the lifecycle's background
    retrain, on its own stream) has in flight on the same card.  With one
    stream in use it reads what a whole-device synchronise would.
    """
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return time.perf_counter()


class ServingMeter:
    """Accumulates (batch_size, wall_seconds) samples from the query engine."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sizes: list[int] = []
        self._secs: list[float] = []
        self._compile_secs: list[float] = []
        # Lifecycle accounting (DESIGN.md §16): fsync-acked WAL appends
        # [records, bytes, seconds] and each ack's seconds; the background
        # retrain's training seconds per handoff.
        self._wal: list = [0, 0, 0.0]
        self._wal_secs: list[float] = []
        self._handoffs: list[float] = []
        # Per-worker dispatch accounting (the shard router's failover path):
        # worker key -> [calls, failures, total seconds, last error].
        self._shard: dict[str, list] = {}

    def record(self, batch_size: int, seconds: float, *, compile_batch: bool = False) -> None:
        """One batch; ``compile_batch`` keeps a cold shape out of the stats."""
        if compile_batch:
            self._compile_secs.append(float(seconds))
            return
        self._sizes.append(int(batch_size))
        self._secs.append(float(seconds))

    def record_wal(self, records: int, nbytes: int, seconds: float) -> None:
        """One fsync-acked WAL append (``serving.lifecycle``'s durability path)."""
        self._wal[0] += int(records)
        self._wal[1] += int(nbytes)
        self._wal[2] += float(seconds)
        self._wal_secs.append(float(seconds))

    def record_handoff(self, train_seconds: float) -> None:
        """One background-retrain epoch handed off at a batch boundary."""
        self._handoffs.append(float(train_seconds))

    def record_shard_call(self, worker: str, seconds: float, *, ok: bool,
                          error: str | None = None) -> None:
        """One shard-dispatch attempt (failed and retried ones included)."""
        s = self._shard.setdefault(str(worker), [0, 0, 0.0, None])
        s[0] += 1
        s[2] += float(seconds)
        if not ok:
            s[1] += 1
            s[3] = error

    def shard_summary(self) -> dict:
        """Per-worker calls, failures and latency, and the fleet's totals."""
        workers = {
            key: {"calls": c, "failures": f, "error_rate": f / c if c else 0.0,
                  "mean_ms": secs / c * 1e3 if c else float("nan"), "last_error": err}
            for key, (c, f, secs, err) in sorted(self._shard.items())
        }
        calls = sum(w["calls"] for w in workers.values())
        failures = sum(w["failures"] for w in workers.values())
        return {"workers": workers, "calls": calls, "failures": failures,
                "error_rate": failures / calls if calls else 0.0}

    def wal_ack_ms(self, pct: float) -> float:
        """Nearest-rank percentile (0-100) of one WAL ack's seconds, in ms."""
        return _percentile_ms(self._wal_secs, pct)

    @property
    def n_batches(self) -> int:
        return len(self._secs)

    @property
    def n_queries(self) -> int:
        return sum(self._sizes)

    def latency_ms(self, pct: float) -> float:
        """Nearest-rank percentile (0-100) of per-batch wall latency, in ms."""
        return _percentile_ms(self._secs, pct)

    def qps(self) -> float:
        total = sum(self._secs)
        return self.n_queries / total if total > 0 else float("nan")

    def summary(self) -> dict:
        out = {
            "batches": self.n_batches,
            "queries": self.n_queries,
            "qps": self.qps(),
            "p50_ms": self.latency_ms(50),
            "p99_ms": self.latency_ms(99),
            "mean_ms": (sum(self._secs) / len(self._secs) * 1e3
                        if self._secs else float("nan")),
            "compile_batches": len(self._compile_secs),
            "compile_s": sum(self._compile_secs),
        }
        if self._shard:
            sh = self.shard_summary()
            out["shard_calls"] = sh["calls"]
            out["shard_failures"] = sh["failures"]
        if self._wal[0]:
            out["wal_records"] = self._wal[0]
            out["wal_bytes"] = self._wal[1]
            out["wal_fsync_ms"] = self._wal[2] / self._wal[0] * 1e3
        if self._handoffs:
            out["handoffs"] = len(self._handoffs)
            out["handoff_train_s"] = sum(self._handoffs)
        return out


def _percentile_ms(secs: list[float], pct: float) -> float:
    """Nearest-rank percentile (0-100) of ``secs``, in ms; nan when empty."""
    if not secs:
        return float("nan")
    xs = sorted(secs)
    rank = min(len(xs) - 1, max(0, int(round(pct / 100.0 * (len(xs) - 1)))))
    return xs[rank] * 1e3
