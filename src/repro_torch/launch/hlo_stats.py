"""Collective-traffic accounting of the port's mesh programs.

Port of ``repro/launch/hlo_stats.py``.  The reference recovers collective
bytes by scanning compiled HLO for collective ops; the port has no HLO.
Its collectives are ``core.distributed``'s ``permute`` and ``all_gather``
(the ring's hops, the butterfly's hops and the triangle's gather go
through them), its ``all_reduce`` and ``reduce_scatter`` (the sharded
train steps' collectives, ``train.optim``'s replica sums among them) and
``train.compression``'s scale all-reduce: each notes one
``Collective`` event (kind, one participant's result, group size, the
positions that took part) in every ``recording()`` block open on the
calling thread, and ``collect_stats`` sums the events as the reference
sums HLO lines.  Per-op wire factors (ring algorithms, P = participants),
the reference's:

  all-gather          result bytes x (P-1)/P
  reduce-scatter      result bytes x (P-1)     (the result is the shard)
  all-reduce          result bytes x 2(P-1)/P  (RS + AG)
  all-to-all          result bytes x (P-1)/P
  collective-permute  result bytes             (one hop)

The reference's HLO is one device's program, which every device runs; the
port runs every position's work from one thread.  So ``collect_stats``
reports one device's share as the reference does: the events of the
position whose wire bytes are largest (events without positions count on
every device).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}
# torch dtypes by their HLO names.
_HLO_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.bfloat16: "bf16", torch.float16: "f16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}

_LOG = threading.local()


def _shape_bytes(dtype, shape) -> int:
    """Bytes of an array of ``dtype`` (an HLO name such as ``"f32"``, or a
    ``torch.dtype``) and ``shape``; a dtype outside the table counts 0, as
    the reference's ``token[]`` does."""
    name = _HLO_NAMES.get(dtype, dtype)
    if name not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[name]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective op: ``kind`` (an HLO collective's name), one
    participant's ``result`` as ``((dtype, shape), ...)``, ``group`` the
    participants (0: every device), ``positions`` the mesh positions that
    took part (empty: every device)."""

    kind: str
    result: tuple
    group: int = 0
    positions: tuple = ()


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict  # raw summed result-shape bytes per op kind
    wire_bytes_per_device: float  # ring-model wire traffic per device

    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())


@contextlib.contextmanager
def recording():
    """Collect the calling thread's collective events while the block runs;
    yields their list."""
    log: list = []
    outer = getattr(_LOG, "logs", ())
    _LOG.logs = (*outer, log)
    try:
        yield log
    finally:
        _LOG.logs = outer


def note(kind: str, results, positions) -> None:
    """Record one collective of ``kind`` over mesh ``positions`` whose
    participant's result is the tensors ``results``, in every open
    ``recording()``."""
    logs = getattr(_LOG, "logs", ())
    if not logs:
        return
    positions = tuple(positions)
    ev = Collective(kind, tuple((t.dtype, tuple(t.shape)) for t in results),
                    len(positions), positions)
    for log in logs:
        log.append(ev)


def _wire(kind: str, b: int, P: int) -> float:
    frac = (P - 1) / max(P, 1)
    if kind == "all-reduce":
        return 2.0 * frac * b
    if kind in ("all-gather", "all-to-all", "ragged-all-to-all"):
        return frac * b
    if kind == "reduce-scatter":
        return frac * b * P  # the result is the scattered shard
    if kind == "collective-permute":
        return float(b)
    raise ValueError(f"unknown collective {kind!r}")


def collect_stats(events, n_devices: int) -> CollectiveStats:
    """The per-device ``CollectiveStats`` of ``events`` (module docstring);
    an event's group defaults to ``n_devices``."""
    every: list = [{}, {}, 0.0]  # counts, result bytes, wire bytes
    per: dict[int, list] = {}
    for ev in events:
        b = sum(_shape_bytes(dt, shape) for dt, shape in ev.result)
        w = _wire(ev.kind, b, ev.group or n_devices)
        sinks = ([per.setdefault(p, [{}, {}, 0.0]) for p in ev.positions] if ev.positions
                 else [every])
        for s in sinks:
            s[0][ev.kind] = s[0].get(ev.kind, 0) + 1
            s[1][ev.kind] = s[1].get(ev.kind, 0) + b
            s[2] += w
    busiest = max((per[p] for p in sorted(per)), key=lambda s: s[2], default=[{}, {}, 0.0])
    counts, rbytes = dict(every[0]), dict(every[1])
    for kind in busiest[0]:
        counts[kind] = counts.get(kind, 0) + busiest[0][kind]
        rbytes[kind] = rbytes.get(kind, 0) + busiest[1][kind]
    return CollectiveStats(counts=counts, result_bytes=rbytes,
                           wire_bytes_per_device=every[2] + busiest[2])
