"""The serving tier: the index and its batching engine, filters, snapshots
and the crash-safe lifecycle."""
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.filters import QueryFilter
from repro_torch.serving.index import RetrievalIndex, SearchResult
from repro_torch.serving.lifecycle import (
    LifecycleConfig,
    LifecycleIndex,
    RecoveryStats,
    WalWriter,
)
from repro_torch.serving.snapshot import SnapshotError
from repro_torch.serving.transport import BackpressureError

__all__ = [
    "BackpressureError",
    "EngineConfig",
    "LifecycleConfig",
    "LifecycleIndex",
    "QueryEngine",
    "QueryFilter",
    "RecoveryStats",
    "RetrievalIndex",
    "SearchResult",
    "SnapshotError",
    "WalWriter",
]
