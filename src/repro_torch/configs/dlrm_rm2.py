"""dlrm-rm2 [recsys]: dot-interaction DLRM at RM2 scale.

Port of ``repro/configs/dlrm_rm2.py``, field for field: n_dense 13,
n_sparse 26, embed_dim 64, bot_mlp 13-512-256-64, top_mlp 512-512-256-1,
interaction dot [arXiv:1906.00091; paper].  Criteo-like skewed table sizes
(about 10^8 rows in all), rows on the "table" axis.
"""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys import DLRMConfig, default_table_sizes


def full_config() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13,
        n_sparse=26,
        embed_dim=64,
        bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1),
        table_sizes=tuple(default_table_sizes(26, lo=10_000, hi=40_000_000)),
    )


def smoke_config() -> DLRMConfig:
    return DLRMConfig(
        n_dense=13, n_sparse=26, embed_dim=16, bot_mlp=(32, 16),
        top_mlp=(32, 16, 1), table_sizes=tuple([256] * 26),
    )


ARCH = RecsysArch("dlrm-rm2", full_config, smoke_config)
