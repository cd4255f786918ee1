"""End to end on the PyTorch port: train a ~100M-param LM for a few hundred
steps with checkpoint/restart fault tolerance.

    PYTHONPATH=src python examples/train_lm_torch.py            # ~20M variant, quick
    PYTHONPATH=src python examples/train_lm_torch.py --full     # ~100M, slower
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

Kill it at any point and rerun: it resumes from the newest checkpoint.
Equivalent CLI: python -m repro_torch.launch.train --preset lm100m --steps 300.
The port of ``examples/train_lm.py``; without ``--device cpu`` it runs on
the card.
"""
import argparse
import sys

import torch

from repro_torch.launch import train as LT
from repro_torch.models.transformer import TransformerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M params")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint-dir", default="build/repro_torch_lm_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    lt_argv = [
        "--preset", "lm100m", "--steps", str(args.steps),
        "--batch", "8" if args.full else "4",
        "--seq-len", "512" if args.full else "128",
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "50",
        "--device", args.device,
    ]
    if not args.full:
        # Shrink the preset to ~20M for the quick path.
        LT.lm100m_config = lambda: TransformerConfig(
            n_layers=6, d_model=384, n_heads=6, n_kv_heads=2, head_dim=64,
            d_ff=1024, vocab=8192, act="silu", dtype=torch.float32,
            remat_policy="none")
    return LT.main(lt_argv)


if __name__ == "__main__":
    sys.exit(main())
