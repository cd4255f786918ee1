"""gemma-2b [dense] — GeGLU, head_dim=256, MQA (kv=1), 256k vocab.

Port of ``repro/configs/gemma_2b.py``, field for field (dtypes as torch's).

18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000 [arXiv:2403.08295; hf].
Tied embeddings + sqrt(d_model) embedding scale (gemma specifics).
Full attention => long_500k skipped.
"""
import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256000,
        act="gelu",
        sliding_window=None,
        rope_theta=10_000.0,
        tied_embeddings=True,
        embed_scale=True,
        dtype=torch.bfloat16,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=256, vocab=512, act="gelu", tied_embeddings=True,
        embed_scale=True, dtype=torch.float32, remat_policy="none",
    )


ARCH = LMArch("gemma-2b", full_config, smoke_config, subquadratic=False)
