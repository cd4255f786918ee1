"""Serving accounting: the per-batch latency meter of the query engine.

Port of ``repro/accounting.py::ServingMeter`` (the batch samples and their
summary; the shard, WAL and handoff counters come with those tiers).
"""
from __future__ import annotations

import time

import torch


def device_clock(device: torch.device) -> float:
    """Host seconds, read after the device's queued work has finished.

    Kernels are asynchronous: without the synchronise, a timer around a
    search would measure the enqueue, not the search.
    """
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class ServingMeter:
    """Accumulates (batch_size, wall_seconds) samples from the query engine."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._sizes: list[int] = []
        self._secs: list[float] = []
        self._compile_secs: list[float] = []

    def record(self, batch_size: int, seconds: float, *, compile_batch: bool = False) -> None:
        """One batch; ``compile_batch`` keeps a cold shape out of the stats."""
        if compile_batch:
            self._compile_secs.append(float(seconds))
            return
        self._sizes.append(int(batch_size))
        self._secs.append(float(seconds))

    @property
    def n_batches(self) -> int:
        return len(self._secs)

    @property
    def n_queries(self) -> int:
        return sum(self._sizes)

    def latency_ms(self, pct: float) -> float:
        """Nearest-rank percentile (0-100) of per-batch wall latency, in ms."""
        if not self._secs:
            return float("nan")
        xs = sorted(self._secs)
        rank = min(len(xs) - 1, max(0, int(round(pct / 100.0 * (len(xs) - 1)))))
        return xs[rank] * 1e3

    def qps(self) -> float:
        total = sum(self._secs)
        return self.n_queries / total if total > 0 else float("nan")

    def summary(self) -> dict:
        return {
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
