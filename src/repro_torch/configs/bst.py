"""bst [recsys]: Behavior Sequence Transformer (Alibaba).

Port of ``repro/configs/bst.py``, field for field: embed_dim 32, seq_len 20,
n_blocks 1, n_heads 8, mlp 1024-512-256, interaction transformer-seq
[arXiv:1905.06874; paper].
"""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys import BSTConfig, default_table_sizes


def full_config() -> BSTConfig:
    return BSTConfig(
        embed_dim=32,
        seq_len=20,
        n_blocks=1,
        n_heads=8,
        mlp=(1024, 512, 256),
        n_items=4_000_768,  # 4M rounded to a multiple of 1024 (row sharding)
        n_other=8,
        other_sizes=tuple(default_table_sizes(8, lo=1_000, hi=1_000_000)),
    )


def smoke_config() -> BSTConfig:
    return BSTConfig(
        embed_dim=16, seq_len=20, n_blocks=1, n_heads=4, mlp=(32, 16),
        n_items=512, n_other=8, other_sizes=tuple([64] * 8),
    )


ARCH = RecsysArch("bst", full_config, smoke_config)
