"""``--arch <id>`` lookup over the assigned architectures (+ the paper's).

Port of ``repro/configs/registry.py``: the same ids, the same
``ASSIGNED`` and ``all_cells``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube3_4b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "nequip": "repro_torch.configs.nequip",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
    "bst": "repro_torch.configs.bst",
    "two-tower-retrieval": "repro_torch.configs.two_tower",
    "knn-paper": "repro_torch.configs.knn_paper",
}

ASSIGNED = [a for a in _MODULES if a != "knn-paper"]


def get(arch_id: str):
    try:
        mod = importlib.import_module(_MODULES[arch_id])
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}") from None
    return mod.ARCH


def all_cells(include_knn: bool = False):
    """Every (arch_id, shape_name, kind, skip reason); a skip has kind 'skip'."""
    ids = list(_MODULES) if include_knn else ASSIGNED
    return [(aid, cell.name, cell.kind, getattr(cell, "reason", None))
            for aid in ids for cell in get(aid).shapes]
