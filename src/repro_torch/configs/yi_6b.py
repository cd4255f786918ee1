"""yi-6b [dense] — llama-architecture GQA.

Port of ``repro/configs/yi_6b.py``, field for field (dtypes as torch's).

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 [arXiv:2403.04652; hf].
Pure full attention => long_500k is skipped (see LMArch.shapes reason).
"""
import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab=64000,
        act="silu",
        sliding_window=None,
        rope_theta=5_000_000.0,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, act="silu", dtype=torch.float32,
        remat_policy="none",
    )


ARCH = LMArch("yi-6b", full_config, smoke_config, subquadratic=False)
