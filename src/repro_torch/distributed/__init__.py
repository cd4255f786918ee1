"""Distribution layer of the port: logical-axis sharding rules and the
train and serve step factories (``steps``)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    Sharding,
    axis_rules,
    constrain,
    current_rules,
    logical_to_spec,
    make_rules,
    spec_tree_for_params,
)
