"""NequIP interatomic potential on the PyTorch/CUDA port: train on packed
molecules, then relax a structure with the learned forces, its neighbour
list rebuilt by the paper's kNN solver every five iterations.

    PYTHONPATH=src python examples/potential_md_torch.py             # on the card
    PYTHONPATH=src python examples/potential_md_torch.py --device cpu

The port of ``examples/potential_md.py``, step for step.  On the card the
neighbour lists come from the ``fused_knn`` kernel (``data.graphs.
radius_graph`` over ``knn_allpairs(impl="fused")``); with ``--device cpu``
from its plain version.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry as REG
from repro_torch.data.graphs import molecule_batch, radius_graph
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.kernels._backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import gnn as G

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
dev = resolve_device(ap.parse_args().device)  # asking for CUDA without a card raises

rules = make_rules(make_host_mesh(devices=[dev]))
arch = REG.get("nequip")
cfg = arch.smoke_config()

# -- train on the planted harmonic potential ---------------------------------
params = G.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
loss, baxes = ST.gnn_potential_loss(cfg, n_graphs=8)
_, jitted, _, opt = ST.make_train_step(
    loss, G.abstract_params(cfg), rules, baxes,
    ST.StepConfig(peak_lr=5e-3, warmup_steps=10, total_steps=150))
state = ST.init_state(opt, params)
mb = molecule_batch(8, 12, 100, n_species=cfg.n_species, seed=0)
batch = {k: v for k, v in mb.items() if k != "n_graphs"}
fn = jitted(batch)
first = None
for step in range(100):
    state, m = fn(state, batch)
    first = first if first is not None else float(m["loss"])
    if step % 25 == 0:
        print(f"step {step:3d} loss {float(m['loss']):.4f} "
              f"(E {float(m['e_loss']):.4f} / F {float(m['f_loss']):.4f})")
assert float(m["loss"]) < first, (first, float(m["loss"]))

# -- relax a fresh structure with the learned forces --------------------------
g = np.random.default_rng(1)
pos = torch.from_numpy(g.standard_normal((24, 3), np.float32) * 1.6).to(dev)
species = torch.from_numpy(g.integers(0, cfg.n_species, 24).astype(np.int32)).to(dev)
values = state.params
step_size = 0.02
for it in range(20):
    if it % 5 == 0:  # the neighbour list, rebuilt by the paper's kNN solver
        edges = radius_graph(pos, cutoff=cfg.cutoff, max_neighbors=12)
    e, f = G.energy_and_forces(values, pos, species, edges, cfg)
    pos = pos + step_size * f  # steepest descent on the potential
    if it % 5 == 0:
        print(f"relax it {it:2d}: E = {float(e):+.4f}  max|F| = {float(f.abs().max()):.4f}")
assert bool(torch.isfinite(pos).all())
print("done.")
