"""The port's NequIP model (``repro_torch.models.gnn``), graphs
(``repro_torch.data.graphs``), the GNN steps and configs against the JAX
package's, on the CPU.

The reference runs once, in the module fixture ``R``: its init at a small
config, energies and forces on a drawn graph, the potential loss's gradient
and ten ``make_train_step`` steps on four packed molecules, and its
``radius_graph`` / ``knn_graph`` edges.  Held:

* the port's copies of the 8 cases of ``tests/test_models_gnn.py``, on the
  port's own init (a ``torch.Generator``) and numpy-drawn inputs;
* energies and forces from ``params_from_reference`` against the
  reference's: rtol 1e-5 and atol 1e-5 for energies, atol 1e-4 for forces;
* the potential loss's gradient (a second derivative: forces are one) within
  1e-5 of each leaf's largest entry; ten steps' losses within rtol 1e-4 and
  atol 1e-5, and every param within atol 1e-4 (AdamW's normalised update
  turns the gradients' last-bit differences into up to ~1e-4 over ten steps
  at lr 5e-3);
* ``radius_graph`` and ``knn_graph`` against the reference's edges (ids
  equal except at near-ties), and ``radius_graph`` over molecules spread
  10^4 apart (where the matmul form's rounding passes the cutoff) against a
  numpy brute force;
* ``segment_sum`` / ``gather``: first and second derivatives against
  ``index_add``'s, and ``gradgradcheck``;
* ``molecule_batch``, ``random_graph``, ``neighbor_sample`` and
  ``host_slice`` equal to the reference's; the configs and cells; a step of
  every ``GNNArch.build`` cell at smoke size;
* ``examples/potential_md_torch.py --device cpu`` end to end.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.data import graphs as RGR
from repro.distributed import steps as RST
from repro.models import gnn as RG
from repro.models.nn import split_params as ref_split
from repro_torch.configs import registry as REG
from repro_torch.core.segments import Segments, gather, segment_sum
from repro_torch.data import graphs as GR
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gnn as G
from repro_torch.models.nn import split_params, tree_leaves, tree_map
from repro_torch.train.optim import OptState

CPU = torch.device("cpu")
SMALL = dict(n_layers=2, d_hidden=8, n_rbf=4, cutoff=5.0, n_species=4)
TRAIN = dict(n_layers=2, d_hidden=8, n_rbf=4, cutoff=4.0, n_species=8)
STEP = dict(peak_lr=5e-3, warmup_steps=5, total_steps=60)


def _graph(seed=0, N=24, E=80, n_species=4, scale=2.0):
    g = np.random.default_rng(seed)
    pos = (g.standard_normal((N, 3)) * scale).astype(np.float32)
    species = g.integers(0, n_species, N).astype(np.int32)
    edges = (g.integers(0, N, E).astype(np.int32), g.integers(0, N, E).astype(np.int32))
    return pos, species, edges


def _rules():
    return make_rules(make_mesh((1, 1), ("data", "model"), devices=[CPU]))


@pytest.fixture(scope="module")
def R(rules):
    out = {}
    cfg = RG.GNNConfig(**SMALL)
    params = RG.init_params(jax.random.PRNGKey(0), cfg)
    out["small_init"] = jax.tree.map(np.asarray, ref_split(params)[0])
    pos, species, (src, dst) = _graph()
    # Jitted: the reference's eager dispatch of a derivative takes minutes here.
    e, f = jax.jit(lambda p, x, s, a, b: RG.energy_and_forces(p, x, s, (a, b), cfg))(
        params, jnp.asarray(pos), jnp.asarray(species), jnp.asarray(src), jnp.asarray(dst))
    out["ef"] = (float(e), np.asarray(f))

    cfg = RG.GNNConfig(**TRAIN)
    params = RG.init_params(jax.random.PRNGKey(0), cfg)
    values = ref_split(params)[0]
    out["train_init"] = jax.tree.map(np.asarray, values)
    mb = RGR.molecule_batch(4, 12, 60, n_species=8, seed=0)
    out["mb"] = mb
    batch = {k: jax.tree.map(jnp.asarray, v) for k, v in mb.items() if k != "n_graphs"}
    loss, baxes = RST.gnn_potential_loss(cfg, n_graphs=4)
    grads = jax.jit(jax.grad(lambda v: loss(v, batch)[0]))(values)
    out["grads"] = [np.asarray(g) for g in jax.tree.leaves(grads)]
    _, jitted, _, opt = RST.make_train_step(loss, RG.abstract_params(cfg), rules, baxes,
                                            RST.StepConfig(**STEP))
    state = RST.init_state(opt, params)
    fn = jitted(batch)
    losses = []
    for _ in range(10):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["final"] = [np.asarray(x) for x in jax.tree.leaves(state.params)]

    g = np.random.default_rng(0)
    gpos = g.standard_normal((50, 3)).astype(np.float32) * 2
    out["gpos"] = gpos
    out["radius"] = RGR.radius_graph(gpos, cutoff=2.5, max_neighbors=8)
    out["knn"] = RGR.knn_graph(gpos, 6)
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = G.GNNConfig(**SMALL)
    params = G.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    pos, species, edges = _graph()
    return cfg, params, torch.from_numpy(pos), torch.from_numpy(species), edges


def _rotation(seed):
    g = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(g.standard_normal((3, 3)))
    return torch.from_numpy((Q * np.sign(np.linalg.det(Q))).astype(np.float32))


# -- the reference's 8 cases ----------------------------------------------------


def test_energy_rotation_invariant(setup):
    cfg, params, pos, species, edges = setup
    e0, f0 = G.energy_and_forces(params, pos, species, edges, cfg)
    for seed in range(3):
        Q = _rotation(seed)
        e1, f1 = G.energy_and_forces(params, pos @ Q.T, species, edges, cfg)
        np.testing.assert_allclose(float(e0), float(e1), rtol=1e-4, atol=1e-4)
        # forces are type-1 (vector) equivariant
        np.testing.assert_allclose((f0 @ Q.T).numpy(), f1.numpy(), atol=1e-3)


def test_energy_translation_invariant(setup):
    cfg, params, pos, species, edges = setup
    e0, _ = G.energy_and_forces(params, pos, species, edges, cfg)
    e1, _ = G.energy_and_forces(params, pos + 7.3, species, edges, cfg)
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-4, atol=1e-4)


def test_energy_permutation_invariant(setup):
    cfg, params, pos, species, (src, dst) = setup
    perm = torch.from_numpy(np.random.default_rng(0).permutation(pos.shape[0]))
    inv = torch.argsort(perm)
    e0, _ = G.energy_and_forces(params, pos, species, (src, dst), cfg)
    e1, _ = G.energy_and_forces(params, pos[perm], species[perm],
                                (inv[torch.from_numpy(src).long()],
                                 inv[torch.from_numpy(dst).long()]), cfg)
    np.testing.assert_allclose(float(e0), float(e1), rtol=1e-4, atol=1e-4)


def test_cutoff_smoothness_and_masking(setup):
    cfg, params, pos, species, _ = setup
    # edges beyond the cutoff contribute nothing
    far = (torch.tensor([0, 1]), torch.tensor([2, 3]))
    pos_far = pos.clone()
    pos_far[2:4] += 100.0
    e_with, _ = G.energy_and_forces(params, pos_far, species, far, cfg)
    # a self-loop-only graph is the empty graph's baseline
    e_empty, _ = G.energy_and_forces(params, pos_far, species,
                                     (torch.zeros(2, dtype=torch.int32),) * 2, cfg)
    np.testing.assert_allclose(float(e_with), float(e_empty), rtol=1e-5)


def test_l2_features_change_results():
    """l_max=2 must actually contribute (the t channel is not dead)."""
    pos, species, edges = _graph(seed=1, N=16, E=60, scale=1.5)
    es = []
    for l in (1, 2):
        cfg = G.GNNConfig(n_layers=2, d_hidden=8, n_rbf=4, l_max=l, n_species=4)
        p = G.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        e, _ = G.energy_and_forces(p, pos, species, edges, cfg)
        es.append(float(e))
    assert es[0] != es[1]


def _train(params, cfg, batch, n_steps, n_graphs=4):
    loss, baxes = ST.gnn_potential_loss(cfg, n_graphs=n_graphs)
    step, _, _, opt = ST.make_train_step(loss, G.abstract_params(cfg), _rules(), baxes,
                                         ST.StepConfig(**STEP))
    state = ST.init_state(opt, params)
    losses = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return state, losses


def test_molecule_train_decreases_loss():
    cfg = G.GNNConfig(**TRAIN)
    params = G.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    mb = GR.molecule_batch(4, 12, 60, n_species=8, seed=0)
    batch = {k: v for k, v in mb.items() if k != "n_graphs"}
    _, losses = _train(params, cfg, batch, 40)
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


def test_neighbor_sampler_statistics():
    g = GR.random_graph(5000, 100_000, 0)
    s = GR.neighbor_sample(g, np.arange(64), (15, 10), seed=0)
    assert s["src"].shape == (64 * 15 + 64 * 150,)
    nodes = s["nodes"]
    assert (nodes[s["src"]] >= 0).all() and (nodes[s["dst"]] >= 0).all()
    hop1_src = nodes[s["src"][: 64 * 15]]
    hop1_dst = nodes[s["dst"][: 64 * 15]]
    for e in range(0, 64 * 15, 97):
        u, v = int(hop1_dst[e]), int(hop1_src[e])
        nbrs = g.indices[g.indptr[u]:g.indptr[u + 1]]
        assert v in nbrs or v == u  # == u covers degree-0 self loops


def test_knn_graph_feeds_gnn():
    """The paper's solver builds the NequIP neighbour list."""
    pos = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32) * 2
    src, dst = GR.radius_graph(pos, cutoff=2.5, max_neighbors=8, device="cpu")
    cfg = G.GNNConfig(n_layers=1, d_hidden=4, n_rbf=4, cutoff=2.5, n_species=2)
    params = G.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    e, f = G.energy_and_forces(params, pos, torch.zeros(50, dtype=torch.int32), (src, dst), cfg)
    assert np.isfinite(float(e)) and not bool(torch.isnan(f).any())


# -- against the reference ----------------------------------------------------------


def test_energies_and_forces_match_the_reference(R):
    cfg = G.GNNConfig(**SMALL)
    params = G.params_from_reference(R["small_init"], device="cpu")
    pos, species, edges = _graph()
    e, f = G.energy_and_forces(params, pos, species, edges, cfg)
    np.testing.assert_allclose(float(e), R["ef"][0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.numpy(), R["ef"][1], rtol=0, atol=1e-4)


def test_potential_loss_gradient_matches_the_reference(R):
    cfg = G.GNNConfig(**TRAIN)
    values = G.params_from_reference(R["train_init"], device="cpu")
    loss, _ = ST.gnn_potential_loss(cfg, n_graphs=4)
    batch = {k: v for k, v in R["mb"].items() if k != "n_graphs"}
    leaves = [t.requires_grad_() for t in tree_leaves(values)]
    grads = torch.autograd.grad(loss(values, batch)[0], leaves, allow_unused=True)
    assert len(grads) == len(R["grads"])
    for g, want in zip(grads, R["grads"]):
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(np.abs(want).max(), 1e-3))


def test_ten_potential_steps_match_the_reference(R):
    cfg = G.GNNConfig(**TRAIN)
    batch = {k: v for k, v in R["mb"].items() if k != "n_graphs"}
    state, losses = _train(G.params_from_reference(R["train_init"], device="cpu"), cfg, batch, 10)
    np.testing.assert_allclose(losses, R["losses"], rtol=1e-4, atol=1e-5)
    for got, want in zip(tree_leaves(state.params), R["final"]):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def _edge_sets(src, dst, n):
    s, d = np.asarray(src), np.asarray(dst)
    return [set(s[(d == i) & (s != i)].tolist()) for i in range(n)]


def _assert_edges_agree(pos, got, want, k, cutoff=None, tol=1e-4):
    """Every row's neighbour set equal, except ids at near-ties: a differing
    id's squared distance within ``tol`` of the row's k-th or of the cutoff's."""
    n = len(pos)
    ties = 0
    for i, (a, b) in enumerate(zip(_edge_sets(*got, n), _edge_sets(*want, n))):
        if a == b:
            continue
        d2 = ((pos - pos[i]) ** 2).sum(1)
        d2[i] = np.inf
        edges = [np.sort(d2)[min(k, n - 1) - 1]] + ([cutoff * cutoff] if cutoff else [])
        for j in a ^ b:
            assert min(abs(d2[j] - e) for e in edges) <= tol * max(1.0, d2[j]), (i, j)
            ties += 1
    return ties


def test_radius_and_knn_graphs_match_the_reference(R):
    pos = R["gpos"]
    src, dst = GR.radius_graph(pos, cutoff=2.5, max_neighbors=8, device="cpu")
    assert src.dtype == torch.int32 and src.shape == (50 * 8,)
    assert np.array_equal(dst.numpy(), R["radius"][1])
    _assert_edges_agree(pos, (src, dst), R["radius"], 8, cutoff=2.5)
    src, dst = GR.knn_graph(torch.from_numpy(pos), 6)
    assert np.array_equal(dst.numpy(), R["knn"][1])
    _assert_edges_agree(pos, (src, dst), R["knn"], 6)


def _brute_radius(pos, cutoff, k):
    p = pos.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    near = np.take_along_axis(d2, order, 1) <= cutoff * cutoff
    dst = np.repeat(np.arange(len(p)), k)
    return np.where(near.reshape(-1), order.reshape(-1), dst), dst


def test_radius_graph_over_far_apart_molecules_is_exact():
    """Molecules 100 apart along x (coordinates to 10^4, where fp32's step at
    |x|^2 exceeds the cutoff squared): the groups are solved apart, and the
    edges are those of a float64 brute force."""
    mb = GR.molecule_batch(24, 30, 64, n_species=8, seed=3)
    pos = mb["positions"].copy()
    pos[:, 0] += np.repeat(np.arange(24) * 100.0 + 9000.0, 30).astype(np.float32)
    groups = GR.cutoff_groups(pos, 5.0)
    assert len(groups) == 24 and all(len(g) == 30 for g in groups)
    src, dst = GR.radius_graph(pos, cutoff=5.0, max_neighbors=12, device="cpu")
    want = _brute_radius(pos, 5.0, 12)
    assert np.array_equal(dst.numpy(), want[1])
    ties = _assert_edges_agree(pos, (src, dst), want, 12, cutoff=5.0, tol=1e-5)
    assert ties <= 2
    # Solved as one group, the matmul form cannot tell the neighbours apart.
    one = GR.knn_graph(torch.from_numpy(pos), 12)
    assert not np.array_equal(np.sort(one[0].numpy().reshape(-1, 12), 1),
                              np.sort(want[0].reshape(-1, 12), 1))


def test_graph_data_matches_the_reference():
    for args in ((4, 12, 60, 8, 0, 0), (3, 30, 64, 64, 2, 5)):
        a, b = GR.molecule_batch(*args), RGR.molecule_batch(*args)
        assert sorted(a) == sorted(b)
        for key in a:
            if key == "edges":
                assert all(np.array_equal(x, y) for x, y in zip(a[key], b[key]))
            elif key == "n_graphs":
                assert a[key] == b[key]
            else:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    g, h = GR.random_graph(500, 4000, 3), RGR.random_graph(500, 4000, 3)
    assert np.array_equal(g.indptr, h.indptr) and np.array_equal(g.indices, h.indices)
    s, t = GR.neighbor_sample(g, np.arange(16), (5, 3), seed=1, step=2), \
        RGR.neighbor_sample(h, np.arange(16), (5, 3), seed=1, step=2)
    assert all(np.array_equal(s[k], t[k]) for k in t)
    from repro.data.synthetic import host_slice as ref_host_slice
    from repro_torch.data.synthetic import host_slice

    assert all(host_slice(96, n, i) == ref_host_slice(96, n, i)
               for n in (1, 2, 3, 8) for i in range(n))


# -- the segmented sums ----------------------------------------------------------


def test_segment_sum_second_derivative_matches_index_add():
    g = torch.Generator().manual_seed(0)
    E, N, C = 40, 9, 3
    idx = torch.randint(0, N, (E,), generator=g)
    idx[:3] = 4  # a hot segment; segment 8 may stay empty
    seg = Segments(idx, N)
    x0 = torch.randn((E, C), generator=g, dtype=torch.float64)
    p0 = torch.randn((N, C), generator=g, dtype=torch.float64)
    c = torch.randn((N, C), generator=g, dtype=torch.float64)
    d = torch.randn((E, C), generator=g, dtype=torch.float64)

    def run(ssum, gat):
        x = x0.clone().requires_grad_()
        p = p0.clone().requires_grad_()
        y = ssum(torch.sin(x) * gat(p))
        loss = (y * y * c).sum()
        gx, gp = torch.autograd.grad(loss, (x, p), create_graph=True)
        h = torch.autograd.grad((gx * d).sum() + (gp * gp).sum(), (x, p))
        return [gx.detach(), gp.detach(), *h]

    got = run(lambda r: segment_sum(r, seg), lambda t: gather(t, seg))
    want = run(lambda r: torch.zeros((N, C), dtype=r.dtype).index_add(0, idx, r),
               lambda t: t[idx])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    x = torch.randn((E, C), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradgradcheck(lambda t: segment_sum(t * t, seg), (x,))
    assert torch.autograd.gradgradcheck(lambda t: gather(t * t, seg), (x[:N].detach()
                                                                         .requires_grad_(),))


# -- configs, cells and steps ------------------------------------------------------


def test_configs_and_cells_match_the_reference():
    ref, port = RREG.get("nequip"), REG.get("nequip")
    for which in ("full_config", "smoke_config"):
        a, b = dataclasses.asdict(getattr(port, which)()), dataclasses.asdict(getattr(ref, which)())
        a.pop("feature_dtype"), b.pop("feature_dtype")
        assert a == b, which
    assert [(c.name, c.kind, c.params) for c in port.shapes] == \
        [(c.name, c.kind, c.params) for c in ref.shapes]
    for cell in port.shapes:
        cfg = port._cfg_for(cell, False)
        want_v, want_ax = ref_split(ref.abstract_params(ref._cfg_for(cell, False), cell))
        got_v, got_ax = split_params(port.abstract_params(cfg, cell))
        assert [tuple(t.shape) for t in tree_leaves(got_v)] == \
            [x.shape for x in jax.tree.leaves(want_v)]
        is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
        assert tree_leaves(got_ax, is_leaf=is_ax) == jax.tree.leaves(want_ax, is_leaf=is_ax)
        specs = port.input_specs(cell.name)
        want = ref.input_specs(cell.name)
        assert {k: tuple(v.shape) for k, v in specs.items() if k != "edges"} == \
            {k: v.shape for k, v in want.items() if k != "edges"}


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_build_cells_take_a_step(shape):
    arch = REG.get("nequip")
    step, (spec, specs) = arch.build(_rules(), shape, smoke=True,
                                     step_config=ST.StepConfig(**STEP))
    cell = {c.name: c for c in arch.shapes}[shape]
    cfg = arch._cfg_for(cell, True)
    values, _ = split_params(arch.init_params(cfg, cell, device="cpu"))
    state = ST.TrainState(values, OptState(0, _zeros(spec.opt.m), _zeros(spec.opt.v)))
    batch = arch.smoke_batch(shape, device="cpu")
    before = [t.clone() for t in tree_leaves(values)]
    for _ in range(2):  # the first step's learning rate is 0 (warmup)
        state, m = step(state, batch)
    assert np.isfinite(float(m["loss"])) and state.opt.step == 2
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)))


def _zeros(tree):
    """CPU zeros of a tree of meta tensors (the built state's moments)."""
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), tree)


def test_potential_md_example_runs_on_the_cpu():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # One thread: the suite's workers share the host's cores with this process.
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(repo, "examples", "potential_md_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "relax it 15" in proc.stdout and proc.stdout.strip().endswith("done.")
