"""mixtral-8x22b [moe] — 8 experts top-2, SWA, GQA.

Port of ``repro/configs/mixtral_8x22b.py``, field for field (dtypes as torch's).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2
[arXiv:2401.04088; hf].  Expert count (8) < model axis (16) => experts
replicated, per-expert d_ff tensor-sharded ("tp" regime, models/moe.py).
SWA => long_500k runs.
"""
import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=0,
        vocab=32768,
        act="silu",
        sliding_window=4096,
        rope_theta=1_000_000.0,
        dtype=torch.bfloat16,
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_ff=16384,
            capacity_factor=1.25,
            group_size=2048,
            router_norm="softmax_topk",
            sharding="tp",
        ),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab=512, act="silu", sliding_window=32,
        dtype=torch.float32, remat_policy="none",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=96, group_size=64,
                      router_norm="softmax_topk", sharding="tp"),
    )


ARCH = LMArch("mixtral-8x22b", full_config, smoke_config, subquadratic=True)
