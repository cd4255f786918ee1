"""The serving tier: the index and its batching engine, filters, snapshots,
the crash-safe lifecycle, and the shard fleet (shard images, the router,
health and failover, the fault harness, the RPC wire, the worker
supervisor)."""
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.faults import (
    FaultInjectionError,
    FaultPolicy,
    FaultyWorker,
    VirtualClock,
    inject_faults,
)
from repro_torch.serving.filters import QueryFilter
from repro_torch.serving.health import (
    CallPolicy,
    HealthConfig,
    HealthState,
    HealthTracker,
    run_with_failover,
)
from repro_torch.serving.index import RetrievalIndex, SearchResult
from repro_torch.serving.lifecycle import (
    LifecycleConfig,
    LifecycleIndex,
    RecoveryStats,
    WalWriter,
)
from repro_torch.serving.shards import (
    MissingShardError,
    ShardRouter,
    ShardSpec,
    ShardUnavailableError,
    ShardWorker,
    TornResultError,
    aggregate_topk,
    load_fleet,
    load_router,
    plan_shards,
    validate_run,
)
from repro_torch.serving.snapshot import (
    SnapshotError,
    read_fleet_manifest,
    restore_shard,
    save_shards,
)
from repro_torch.serving.supervisor import ProcWorker, SupervisorConfig, WorkerSupervisor
from repro_torch.serving.transport import (
    BackpressureError,
    RemoteWorkerError,
    WireError,
    WorkerCrashedError,
    WorkerTimeoutError,
    decode_error,
    encode_error,
)

__all__ = [
    "BackpressureError",
    "CallPolicy",
    "EngineConfig",
    "FaultInjectionError",
    "FaultPolicy",
    "FaultyWorker",
    "HealthConfig",
    "HealthState",
    "HealthTracker",
    "LifecycleConfig",
    "LifecycleIndex",
    "MissingShardError",
    "ProcWorker",
    "QueryEngine",
    "QueryFilter",
    "RecoveryStats",
    "RemoteWorkerError",
    "RetrievalIndex",
    "SearchResult",
    "ShardRouter",
    "ShardSpec",
    "ShardUnavailableError",
    "ShardWorker",
    "SnapshotError",
    "SupervisorConfig",
    "TornResultError",
    "VirtualClock",
    "WalWriter",
    "WireError",
    "WorkerCrashedError",
    "WorkerSupervisor",
    "WorkerTimeoutError",
    "aggregate_topk",
    "decode_error",
    "encode_error",
    "inject_faults",
    "load_fleet",
    "load_router",
    "plan_shards",
    "read_fleet_manifest",
    "restore_shard",
    "run_with_failover",
    "save_shards",
    "validate_run",
]
