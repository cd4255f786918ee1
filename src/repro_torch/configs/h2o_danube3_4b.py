"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.

Port of ``repro/configs/h2o_danube3_4b.py``, field for field (dtypes as torch's).

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, head_dim=120
[arXiv:2401.16818; unverified].  SWA => sub-quadratic decode cache =>
long_500k runs for this arch.
"""
import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        head_dim=120,
        d_ff=10240,
        vocab=32000,
        act="silu",
        sliding_window=4096,
        rope_theta=10_000.0,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, act="silu", sliding_window=32,
        dtype=torch.float32, remat_policy="none",
    )


ARCH = LMArch("h2o-danube-3-4b", full_config, smoke_config, subquadratic=True)
