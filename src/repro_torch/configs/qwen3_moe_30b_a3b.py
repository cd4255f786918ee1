"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, GQA + QK-norm.

Port of ``repro/configs/qwen3_moe_30b_a3b.py``, field for field (dtypes as torch's).

48L d_model=2048 32H (GQA kv=4) d_ff=768 (per expert), vocab=151936,
MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf].  128 experts % 16 model == 0 =>
true expert parallelism ("ep" regime, GShard all-to-all).
Full attention => long_500k skipped.
"""
import torch

from repro_torch.configs.base import LMArch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def full_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,
        vocab=151936,
        act="silu",
        sliding_window=None,
        rope_theta=1_000_000.0,
        use_qk_norm=True,
        dtype=torch.bfloat16,
        moe=MoEConfig(
            n_experts=128,
            top_k=8,
            d_ff=768,
            capacity_factor=1.25,
            group_size=512,  # small groups bound the [G,S,E,C] dispatch tensor
            router_norm="topk_softmax",
            sharding="ep",
        ),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab=512, act="silu", use_qk_norm=True,
        dtype=torch.float32, remat_policy="none",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, group_size=64,
                      router_norm="topk_softmax", sharding="ep"),
    )


ARCH = LMArch("qwen3-moe-30b-a3b", full_config, smoke_config, subquadratic=False)
