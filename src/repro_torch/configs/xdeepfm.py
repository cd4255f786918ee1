"""xdeepfm [recsys]: CIN + DNN + linear.

Port of ``repro/configs/xdeepfm.py``, field for field: n_sparse 39,
embed_dim 10, cin_layers 200-200-200, mlp 400-400, interaction cin
[arXiv:1803.05170; paper].
"""
from repro_torch.configs.base import RecsysArch
from repro_torch.models.recsys import XDeepFMConfig, default_table_sizes


def full_config() -> XDeepFMConfig:
    return XDeepFMConfig(
        n_sparse=39,
        embed_dim=10,
        cin_layers=(200, 200, 200),
        mlp=(400, 400),
        table_sizes=tuple(default_table_sizes(39, lo=5_000, hi=10_000_000)),
    )


def smoke_config() -> XDeepFMConfig:
    return XDeepFMConfig(
        n_sparse=39, embed_dim=8, cin_layers=(16, 16), mlp=(32, 32),
        table_sizes=tuple([128] * 39),
    )


ARCH = RecsysArch("xdeepfm", full_config, smoke_config)
