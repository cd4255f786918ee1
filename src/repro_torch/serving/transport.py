"""Errors of the process-isolated serving tier (DESIGN.md §15).

Port of the one name of ``repro/serving/transport.py`` that the
single-device index needs today: ``BackpressureError``, which the crash-safe
lifecycle (``serving.lifecycle``) raises when a mutation would grow the
delta past its budget.  The wire protocol itself (framing, array and error
codecs, ``RemoteWorkerError`` with its ``remote_type``) comes with the
shard and supervisor tiers.
"""
from __future__ import annotations


class BackpressureError(RuntimeError):
    """A bounded queue is full (a worker's in-flight requests, or the
    lifecycle's delta budget): the caller sheds, fails over or retries."""
