"""Training substrate of the port: optimizers and schedules (``optim``)."""
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
