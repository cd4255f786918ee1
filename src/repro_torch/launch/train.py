"""End-to-end training launcher.

Port of ``repro/launch/train.py``, every flag, plus ``--device`` (default
``cuda``, the card; ``cpu`` runs the same steps on the host).  It trains any
registered architecture of the port at ``smoke_config()``, or the ~100M
parameter LM preset (``--preset lm100m``), on synthetic but learnable data
(a pure function of ``--seed`` and the step) through
``train.loop.TrainLoop``: kill it, rerun it with the same
``--checkpoint-dir``, and it resumes from the newest valid checkpoint.

The mesh is ``make_host_mesh(--model-parallel)`` over every visible card,
as the reference's is over ``jax.devices()`` (``--device cpu``: one CPU
position).  On a mesh of more than one position a recommender trains
sharded (``distributed.steps``: its state cut by the rule table, saved and
resumed as such); the other families' steps run whole on the first card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch nequip --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch bst --steps 300 \\
      --checkpoint-dir build/ckpt --metrics build/ckpt.jsonl [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m --steps 300 \\
      --batch 4 --seq-len 128 --checkpoint-dir build/lm_ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch


def lm100m_config():
    """~100M-param llama-style config (the train launcher's LM preset)."""
    from repro_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab=32000, act="silu", dtype=torch.float32,
        remat_policy="none",
    )


def _lm_batch_fn(batch: int, seq_len: int, vocab: int, seed: int, device):
    from repro_torch.data.synthetic import lm_batch

    def batch_fn(step):
        return {k: torch.from_numpy(v.copy()).to(device)
                for k, v in lm_batch(batch, seq_len, vocab, seed, step).items()}

    return batch_fn


def build_lm(cfg, rules, args, device):
    """(step, initial state, batch_fn, state shardings) of the transformer
    ``cfg`` on ``--batch`` x ``--seq-len`` token batches, its params drawn
    from ``--seed`` on ``device``."""
    from repro_torch.distributed import steps as ST
    from repro_torch.models import transformer as Tr

    params = Tr.init_params(cfg, generator=torch.Generator(device).manual_seed(args.seed),
                            device=device)
    loss, baxes = ST.lm_loss(cfg)
    sc = ST.StepConfig(peak_lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps,
                       micro_batches=args.micro_batches)
    _, jitted, st_shard, optimizer = ST.make_train_step(loss, Tr.abstract_params(cfg), rules,
                                                        baxes, sc)
    state = ST.init_state(optimizer, params)
    batch_fn = _lm_batch_fn(args.batch, args.seq_len, cfg.vocab, args.seed, device)
    print(f"[train] LM params: {cfg.n_params / 1e6:.1f}M  "
          f"tokens/step: {args.batch * args.seq_len}")
    return jitted(batch_fn(0)), state, batch_fn, st_shard


def build_arch(arch_id: str, rules, args, device):
    """(step, initial state, batch_fn, state shardings) of ``arch_id`` at
    ``smoke_config()``, its params drawn from ``--seed`` on ``device``; a
    recommender's state cut over ``rules``' mesh where it has more than one
    position (the shardings None where the state is whole)."""
    from repro_torch.configs import registry as REG
    from repro_torch.distributed import steps as ST

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    sc = ST.StepConfig(peak_lr=args.lr, warmup_steps=args.warmup, total_steps=args.steps)
    gen = torch.Generator(device).manual_seed(args.seed)
    if arch.family == "lm":
        params = arch.init_params(cfg, generator=gen, device=device)
        loss, baxes = ST.lm_loss(cfg)
        abstract = arch.abstract_params(cfg)
        batch_fn = _lm_batch_fn(8, 64, cfg.vocab, args.seed, device)
    elif arch.family == "gnn":
        from repro_torch.data.graphs import molecule_batch

        cell = {c.name: c for c in arch.shapes}["molecule"]
        params = arch.init_params(cfg, cell, generator=gen, device=device)
        loss, baxes = ST.gnn_potential_loss(cfg, n_graphs=8)
        abstract = arch.abstract_params(cfg, cell)

        def batch_fn(step):
            mb = molecule_batch(8, 12, 100, n_species=cfg.n_species, seed=args.seed, step=step)
            return {k: (tuple(torch.from_numpy(x).to(device) for x in v) if isinstance(v, tuple)
                        else torch.from_numpy(v).to(device))
                    for k, v in mb.items() if k != "n_graphs"}
    elif arch.family == "recsys":
        from repro_torch.data.synthetic import recsys_batch

        params = arch.init_params(cfg, generator=gen, device=device)
        loss, baxes = ST.recsys_loss(arch_id, cfg)
        abstract = arch.abstract_params(cfg)

        def batch_fn(step):
            return {k: torch.from_numpy(v).to(device) for k, v in
                    recsys_batch(arch_id, args.batch, cfg, args.seed, step).items()}
    else:
        raise KeyError(arch.family)
    _, jitted, st_shard, optimizer = ST.make_train_step(loss, abstract, rules, baxes, sc)
    state = ST.init_state(optimizer, params)
    del params
    if arch.family == "recsys" and len(rules.mesh.devices) > 1:
        from repro_torch.distributed.sharding import shard_tree

        return jitted(batch_fn(0)), shard_tree(state, st_shard), batch_fn, st_shard
    return jitted(batch_fn(0)), state, batch_fn, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--preset", choices=("lm100m",), default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--model-parallel", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels._backend import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig

    if not args.arch and args.preset != "lm100m":
        ap.error("--arch or --preset required")
    dev = resolve_device(args.device)
    mesh = make_host_mesh(args.model_parallel, devices=[dev] if dev.type == "cpu" else None)
    dev = mesh.devices[0]
    rules = make_rules(mesh)
    print(f"[train] mesh: {dict(mesh.shape)} on {sorted({str(d) for d in mesh.devices})}")
    if args.preset == "lm100m":
        fn, state, batch_fn, _ = build_lm(lm100m_config(), rules, args, dev)
        st_shard = None
    else:
        fn, state, batch_fn, st_shard = build_arch(args.arch, rules, args, dev)

    loop = TrainLoop(fn, batch_fn, TrainLoopConfig(
        total_steps=args.steps, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, log_every=max(args.steps // 20, 1),
        metrics_path=args.metrics), state_shardings=st_shard)
    t0 = time.time()
    state, end = loop.run(state)
    dt = time.time() - t0
    hist = [h for h in loop.history if "loss" in h]
    print(f"[train] done: step {end} in {dt:.1f}s ({dt / max(end, 1) * 1e3:.1f} ms/step avg)")
    if hist:
        print(f"[train] loss: first={hist[0]['loss']:.4f} last={hist[-1]['loss']:.4f}")
    if loop.quarantine:
        print(f"[train] straggler events: {len(loop.quarantine)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
