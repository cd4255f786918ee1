"""two-tower-retrieval [recsys]: sampled-softmax retrieval (RecSys'19).

Port of ``repro/configs/two_tower.py``, field for field: embed_dim 256,
towers 1024-512-256, interaction dot.  The ``retrieval_cand`` cell (1 query
x 10^6 candidates) runs on the kNN serving engine
(``serving.service.TwoTowerRetrievalService``).
"""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys import TwoTowerConfig, default_table_sizes


def full_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        embed_dim=256,
        tower_mlp=(1024, 512, 256),
        n_user_fields=6,
        n_item_fields=4,
        user_sizes=tuple(default_table_sizes(6, lo=100_000, hi=50_000_000)),
        item_sizes=tuple(default_table_sizes(4, lo=50_000, hi=10_000_000)),
        feat_dim=64,
    )


def smoke_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        embed_dim=32, tower_mlp=(64, 32), n_user_fields=6, n_item_fields=4,
        user_sizes=tuple([256] * 6), item_sizes=tuple([128] * 4), feat_dim=16,
    )


def serving_defaults() -> dict:
    """Default ``serving.service.ServiceConfig`` fields for this arch.

    ``neg_dot``: the towers L2-normalize, so negative dot is cosine ranking,
    the ``retrieval_cand`` cell's scoring.  ``embed_batch`` is the fixed item
    tower batch of the corpus sweep.
    """
    return dict(k=10, distance="neg_dot", embed_batch=1024,
                cache_capacity=4096, min_batch=8, max_batch=1024)


ARCH = RecsysArch("two-tower-retrieval", full_config, smoke_config)
