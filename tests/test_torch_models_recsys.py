"""The port's recommender models (``repro_torch.models.recsys``), their configs
and registry, and ``recsys_batch`` against the JAX package's, on the CPU.

The reference runs once, in the module fixture ``R``, at each arch's
``smoke_config()``: its init (carried across with ``params_from_reference``),
ten train steps through its ``make_train_step``, each logits function and
``two_tower_loss`` on one batch.  Held:

* the port's copies of the 7 cases of ``tests/test_models_recsys.py``;
* ten train steps from the reference's initial params: the losses within
  rtol 1e-5 and atol 1e-5 of the reference's, every param after them within
  rtol 1e-5 and atol 1e-5 (a step moves a param by up to 5e-3), and every
  table row no batch touched byte-equal to its start in both packages;
* the logits and the in-batch softmax loss on the same params and batch
  within rtol 1e-5 and atol 1e-5;
* the configs field for field, the registry's cells, the param shapes and
  logical axes at ``full_config()`` (on the meta device: no allocation), the
  batch specs, and ``recsys_batch`` array for array.
"""
import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.data.synthetic import recsys_batch as ref_batch
from repro.distributed import steps as RST
from repro.models import recsys as RR
from repro.models.nn import split_params as ref_split
from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import recsys as P
from repro_torch.models.nn import split_params, tree_leaves

RECSYS_ARCHS = ["dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"]
STEP = dict(peak_lr=5e-3, warmup_steps=5, total_steps=100)
N_STEPS, BATCH = 10, 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_rules():
    return make_rules(make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")]))


@pytest.fixture(scope="module")
def R(rules):
    """The reference's init, ten train steps, logits and loss, per arch."""
    out = {}
    for aid in RECSYS_ARCHS:
        arch = RREG.get(aid)
        cfg = arch.smoke_config()
        params = arch.init_params(jax.random.PRNGKey(0), cfg)
        init = jax.tree.map(np.asarray, ref_split(params)[0])
        loss, baxes = RST.recsys_loss(aid, cfg)
        _, jitted, _, opt = RST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                                RST.StepConfig(**STEP))
        batches = [recsys_batch(aid, BATCH, cfg, step=i) for i in range(N_STEPS)]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        if aid == "two-tower-retrieval":
            _, m = RR.two_tower_loss(ref_split(params)[0], jb[0], cfg)
            head = {"loss": float(m["loss"]), "in_batch_acc": float(m["in_batch_acc"])}
        else:
            head = np.asarray(RR.LOGIT_FNS[aid](ref_split(params)[0], jb[0], cfg))
        state = RST.init_state(opt, params)
        fn = jitted(jb[0])
        losses = []
        for b in jb:
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
        out[aid] = {"init": init, "batches": batches, "losses": losses, "head": head,
                    "final": [np.asarray(x) for x in jax.tree.leaves(state.params)],
                    "final_tree": jax.tree.map(np.asarray, state.params)}
    return out


def _touched(aid, batches, cfg):
    """Per table name ("tables", "user_tables", ...): the set of ids each of
    its tables was looked up with, over ``batches``."""
    if aid == "bst":
        items = set()
        for b in batches:
            items |= set(b["hist"].ravel().tolist()) | set(b["target"].tolist())
        return {"items": [items],
                "others": [set(np.concatenate([b["others"][:, i] for b in batches]).tolist())
                           for i in range(cfg.n_other)]}
    if aid == "two-tower-retrieval":
        return {f"{side}_tables": [set(np.concatenate([b[side][:, i] for b in batches]).tolist())
                                   for i in range(batches[0][side].shape[1])]
                for side in ("user", "item")}
    cols = [set(np.concatenate([b["sparse"][:, i] for b in batches]).tolist())
            for i in range(batches[0]["sparse"].shape[1])]
    return {"tables": cols, "lin_tables": cols} if aid == "xdeepfm" else {"tables": cols}


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_arch_smoke_train(arch_id, port_rules):
    """``tests/test_models_recsys.py::test_arch_smoke_train`` on the port
    (its own seeded init): 15 steps at batch 64, the loss falls."""
    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    loss, baxes = ST.recsys_loss(arch_id, cfg)
    _, jitted, _, opt = ST.make_train_step(loss, arch.abstract_params(cfg), port_rules, baxes,
                                           ST.StepConfig(**STEP))
    state = ST.init_state(opt, params)
    fn = jitted(recsys_batch(arch_id, 64, cfg))
    losses = []
    for i in range(15):
        state, m = fn(state, recsys_batch(arch_id, 64, cfg, step=i))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_ten_train_steps_match_the_reference(R, arch_id, port_rules):
    ref = R[arch_id]
    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    params = P.params_from_reference(ref["init"], device="cpu")
    loss, baxes = ST.recsys_loss(arch_id, cfg)
    _, jitted, _, opt = ST.make_train_step(loss, arch.abstract_params(cfg), port_rules, baxes,
                                           ST.StepConfig(**STEP))
    state = ST.init_state(opt, params)
    fn = jitted(ref["batches"][0])
    losses = []
    for b in ref["batches"]:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], **TOL)
    got = [t.numpy() for t in P.param_leaves(state.params)]
    assert len(got) == len(ref["final"])
    for g, w in zip(got, ref["final"]):
        np.testing.assert_allclose(g, w, **TOL)
    n_untouched = 0
    for name, touched in _touched(arch_id, ref["batches"], cfg).items():
        for j, ids in enumerate(touched):
            start = ref["init"][name][j]
            rows = np.setdiff1d(np.arange(len(start)), sorted(ids))
            n_untouched += len(rows)
            assert np.array_equal(state.params[name][j].numpy()[rows], start[rows]), (name, j)
            assert np.array_equal(ref["final_tree"][name][j][rows], start[rows]), (name, j)
    # bst's smoke tables (512 items, 64-row side tables) are all touched by
    # 640 sessions; the other archs leave rows untouched
    assert n_untouched > 0 or arch_id == "bst"


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "xdeepfm", "bst"])
def test_logits_match_the_reference(R, arch_id):
    cfg = REG.get(arch_id).smoke_config()
    params = P.params_from_reference(R[arch_id]["init"], device="cpu")
    got = P.LOGIT_FNS[arch_id](params, R[arch_id]["batches"][0], cfg)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.detach().numpy(), R[arch_id]["head"], **TOL)


def test_two_tower_loss_matches_the_reference(R):
    ref = R["two-tower-retrieval"]
    cfg = REG.get("two-tower-retrieval").smoke_config()
    params = P.params_from_reference(ref["init"], device="cpu")
    loss, m = P.two_tower_loss(params, ref["batches"][0], cfg)
    np.testing.assert_allclose(float(loss), ref["head"]["loss"], **TOL)
    assert float(m["in_batch_acc"]) == ref["head"]["in_batch_acc"]
    # the logQ correction, against the reference's
    logq = np.log(np.linspace(0.01, 0.5, BATCH, dtype=np.float32))
    b = dict(ref["batches"][0], logq=logq)
    want, _ = RR.two_tower_loss(jax.tree.map(jnp.asarray, ref["init"]),
                                {k: jnp.asarray(v) for k, v in b.items()}, cfg)
    got, _ = P.two_tower_loss(params, b, cfg)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_embedding_bag_modes():
    t = P.init_table(50, 8, generator=torch.Generator().manual_seed(0), device="cpu")
    ids = torch.tensor([1, 2, 3, 10, 11, 40])
    bags = torch.tensor([0, 0, 1, 1, 1, 3])
    out = P.embedding_bag(t, ids, bags, 4)
    tv = t.value
    ref = torch.stack([tv[1] + tv[2], tv[3] + tv[10] + tv[11], torch.zeros(8), tv[40]])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6)
    mean = P.embedding_bag(t, ids, bags, 4, mode="mean")
    np.testing.assert_allclose(mean[0].numpy(), ((tv[1] + tv[2]) / 2).numpy(), atol=1e-6)
    w = torch.tensor([2.0, 0.0, 1.0, 1.0, 1.0, 3.0])
    wout = P.embedding_bag(t, ids, bags, 4, weights=w)
    np.testing.assert_allclose(wout[0].numpy(), (2 * tv[1]).numpy(), atol=1e-6)
    # the reference's bags on the same table
    want = RR.embedding_bag(jnp.asarray(tv.numpy()), jnp.asarray(ids.numpy()),
                            jnp.asarray(bags.numpy()), 4, weights=jnp.asarray(w.numpy()),
                            mode="mean")
    np.testing.assert_allclose(P.embedding_bag(t, ids, bags, 4, weights=w, mode="mean").numpy(),
                               np.asarray(want), atol=1e-6)


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(nnz=st.integers(1, 64), n_bags=st.integers(1, 8), seed=st.integers(0, 1000))
def test_embedding_bag_property(nnz, n_bags, seed):
    """The segmented sums equal the dense one-hot matmul oracle."""
    g = np.random.default_rng(seed)
    t = P.init_table(20, 4, generator=torch.Generator().manual_seed(seed), device="cpu")
    ids = g.integers(0, 20, nnz)
    bags = np.sort(g.integers(0, n_bags, nnz))
    out = P.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(bags), n_bags)
    onehot = np.zeros((n_bags, nnz), np.float32)
    onehot[bags, np.arange(nnz)] = 1.0
    np.testing.assert_allclose(out.numpy(), onehot @ t.value.numpy()[ids], atol=1e-5)


def test_cin_matches_reference():
    """The CIN layer equals the explicit outer-product formulation (xDeepFM
    eq. 4) and ``jnp.einsum("bid,bjd,hij->bhd")``, with H_prev != F."""
    B, F, D, H, Hp = 3, 5, 4, 7, 6
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(B, F, D, generator=g)
    xs = torch.randn(B, Hp, D, generator=g)
    W = torch.randn(H, Hp, F, generator=g)
    fast = P.cin_layer(xs, x0, W)
    z = torch.zeros(B, H, D)
    for i in range(Hp):
        for j in range(F):
            z = z + W[:, i, j][None, :, None] * (xs[:, i, :] * x0[:, j, :])[:, None, :]
    np.testing.assert_allclose(fast.numpy(), z.numpy(), atol=1e-4)
    want = jnp.einsum("bid,bjd,hij->bhd", xs.numpy(), x0.numpy(), W.numpy())
    np.testing.assert_allclose(fast.numpy(), np.asarray(want), atol=1e-4)


def test_dlrm_interaction_is_upper_triangle():
    cfg = P.DLRMConfig(n_dense=4, n_sparse=3, embed_dim=8, bot_mlp=(8,), top_mlp=(4, 1),
                       table_sizes=(16, 16, 16))
    p = P.init_dlrm(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    out = P.dlrm_logits(p, {"dense": torch.ones(2, 4),
                            "sparse": torch.zeros(2, 3, dtype=torch.int32)}, cfg)
    assert out.shape == (2,)
    # features into the top MLP: F(F-1)/2 + D with F = n_sparse + 1 = 4
    assert p["top"][0]["w"].value.shape[0] == 6 + 8


def test_two_tower_embeddings_normalized():
    cfg = P.TwoTowerConfig(user_sizes=(64,) * 6, item_sizes=(64,) * 4, tower_mlp=(16, 8),
                           feat_dim=4)
    p = P.init_two_tower(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ids = torch.randint(0, 64, (10, 6), generator=torch.Generator().manual_seed(1))
    u = P.user_embedding(p, ids)
    np.testing.assert_allclose(u.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_bce_loss_extremes():
    loss0, _ = P.bce_loss(torch.tensor([100.0]), torch.tensor([1.0]))
    assert float(loss0) < 1e-4
    loss1, _ = P.bce_loss(torch.tensor([-100.0]), torch.tensor([1.0]))
    assert float(loss1) > 50
    a, _ = P.bce_loss(torch.tensor([2.0]), torch.tensor([0.0]))
    b, _ = P.bce_loss(torch.tensor([-2.0]), torch.tensor([1.0]))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    x = np.linspace(-30, 30, 41, dtype=np.float32)
    y = (np.arange(41) % 2).astype(np.float32)
    want, _ = RR.bce_loss(jnp.asarray(x), jnp.asarray(y))
    got, _ = P.bce_loss(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_configs_and_cells_match_the_reference(arch_id):
    ref, port = RREG.get(arch_id), REG.get(arch_id)
    for name in ("full_config", "smoke_config"):
        want, got = getattr(ref, name)(), getattr(port, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        sizes = "u_sizes" if arch_id == "two-tower-retrieval" else "sizes"
        assert getattr(got, sizes)() == getattr(want, sizes)()
    assert [(c.name, c.kind, c.params) for c in port.shapes] == \
        [(c.name, c.kind, c.params) for c in ref.shapes]
    for cell in ref.shapes:
        for smoke in (True, False):
            want = ref.input_specs(cell.name, smoke=smoke)
            got = port.input_specs(cell.name, smoke=smoke)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape and got[k].device.type == "meta"
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
def test_full_width_params_shapes_and_axes_on_meta(arch_id):
    """The full config's Param tree, drawn on the meta device: the
    reference's leaf order, shapes and logical axes (the row-wise optimizer
    picks its tables by the axes)."""
    ref, port = RREG.get(arch_id), REG.get(arch_id)
    want_v, want_ax = ref_split(ref.abstract_params(ref.full_config()))
    got_v, got_ax = split_params(port.abstract_params(port.full_config()))
    got_leaves = tree_leaves(got_v)
    assert [tuple(t.shape) for t in got_leaves] == [x.shape for x in jax.tree.leaves(want_v)]
    assert all(t.device.type == "meta" for t in got_leaves)
    is_ax = lambda x: isinstance(x, tuple)  # noqa: E731
    assert tree_leaves(got_ax, is_leaf=is_ax) == jax.tree.leaves(want_ax, is_leaf=is_ax)


def test_registry_names_what_is_not_ported():
    """Since the language models and the kNN config were ported, nothing is:
    every id of the reference resolves to an arch of its family, ``ASSIGNED``
    and ``all_cells`` (with and without knn-paper) equal the reference's,
    and an unknown id still raises a ``KeyError`` that names it."""
    assert REG.ASSIGNED == RREG.ASSIGNED
    for aid in RREG.ASSIGNED + ["knn-paper"]:
        arch = REG.get(aid)
        assert arch.id == aid and arch.family == RREG.get(aid).family
    assert REG.all_cells() == RREG.all_cells()
    assert REG.all_cells(include_knn=True) == RREG.all_cells(include_knn=True)
    with pytest.raises(KeyError, match="no-such-arch"):
        REG.get("no-such-arch")


@pytest.mark.parametrize("arch_id", RECSYS_ARCHS)
@pytest.mark.parametrize("step", [0, 3])
def test_recsys_batch_matches_the_reference(arch_id, step):
    for cfg in (REG.get(arch_id).smoke_config(), REG.get(arch_id).full_config()):
        want = ref_batch(arch_id, 257, cfg, seed=5, step=step)
        got = recsys_batch(arch_id, 257, cfg, seed=5, step=step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_init_draws_are_seeded_and_the_reference_distributions():
    cfg = REG.get("dlrm-rm2").smoke_config()
    a = P.init_dlrm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = P.init_dlrm(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for x, y in zip(P.param_leaves(a), P.param_leaves(b)):
        assert torch.equal(x, y)
    tables = torch.cat([t.value.flatten() for t in a["tables"]])
    assert abs(float(tables.std()) - cfg.embed_dim ** -0.5) < 0.01
    for layer in a["bot"] + a["top"]:
        assert not layer["b"].value.any()
