"""Training substrate of the port: optimizers and schedules (``optim``),
checkpoints (``checkpoint``) and the fault-tolerant loop (``loop``)."""
from repro_torch.train.optim import (  # noqa: F401
    OPTIMIZERS,
    Optimizer,
    OptState,
    RowGrad,
    adamw,
    clip_by_global_norm,
    coalesce_rows,
    global_norm,
    mixed_table_adamw,
    rsqrt_schedule,
    sgdm,
    warmup_cosine,
)
from repro_torch.train.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore,
    save,
)
from repro_torch.train.loop import TrainLoop, TrainLoopConfig  # noqa: F401
