"""``--arch <id>`` lookup over the architectures the port has.

Port of ``repro/configs/registry.py`` for the recsys and GNN families.  The
reference's other architectures wait for their models' port: asking for one
raises a ``KeyError`` that names it.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "nequip": "repro_torch.configs.nequip",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "bst": "repro_torch.configs.bst",
    "two-tower-retrieval": "repro_torch.configs.two_tower",
}

# The reference's language models: their port is item 2d of ROADMAP.md.
LM_ARCHS = ("h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b", "qwen3-moe-30b-a3b")
# The reference's other architectures, not ported yet.
NOT_PORTED = LM_ARCHS + ("knn-paper",)

ASSIGNED = list(_MODULES)


def get(arch_id: str):
    if arch_id in LM_ARCHS:
        raise KeyError(f"arch {arch_id!r} is a language model, not ported yet (ROADMAP.md, "
                       f"item 2d); the port has {sorted(_MODULES)}")
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; the port has {sorted(_MODULES)}")
    try:
        mod = importlib.import_module(_MODULES[arch_id])
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}") from None
    return mod.ARCH


def all_cells():
    """Every (arch_id, shape_name, kind, skip reason) of the ported archs."""
    return [(aid, cell.name, cell.kind, getattr(cell, "reason", None))
            for aid in ASSIGNED for cell in get(aid).shapes]
