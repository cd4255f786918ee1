"""The port's step factories (``repro_torch.distributed.steps``) and sharding
rules (``repro_torch.distributed.sharding``) against the JAX package's, on
the CPU.

* The port's copies of ``tests/test_steps.py``'s ``test_rowwise_table_optimizer``,
  ``test_grad_clip_reported``, ``test_lr_schedule_in_metrics``,
  ``test_microbatch_equivalence`` and ``test_opt_state_mirrors_param_shardings``,
  on DLRM, with the reference's bounds; and the three LM cases
  (``microbatch_equivalence``, ``grad_clip_reported``,
  ``lr_schedule_in_metrics``) over ``lm_loss`` on the reference's config.
* Micro-batches on the two-tower model, where each slice takes its own
  in-batch softmax: two steps at ``micro_batches=4`` within rtol and atol
  1e-5 of the reference's (loss and every param).
* The rule table's specs equal to the reference's ``PartitionSpec``s, and
  ``spec_tree_for_params`` over each recsys arch's full-width params equal
  to the reference's ``logical_to_spec`` leaf for leaf.
* The serve step's probabilities within 1e-6 of the reference's; the
  retrieval step's ids equal to a brute force and to the reference's step,
  on one CPU position and on four; every cell of ``RecsysArch.build``.
* Every cell of ``LMArch.build`` (the decode cells with and without the
  sequence-parallel variant) and of ``KNNArch.build`` at smoke size, and
  each run: the LM train, prefill and decode cells on real batches, the
  kNN solvers on four CPU positions against a one-device solve.
* ``examples/recommender_torch.py --device cpu`` end to end.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.distributed import sharding as RS
from repro.distributed import steps as RST
from repro.models import nn as RN
from repro.models.nn import split_params as ref_split
from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import sharding as S
from repro_torch.distributed import steps as ST
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import recsys as P
from repro_torch.models import transformer as Tr
from repro_torch.models.nn import split_params, tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _rules(shape=(1, 1)):
    n = int(np.prod(shape))
    return S.make_rules(make_mesh(shape, ("data", "model"), devices=[torch.device("cpu")] * n))


def _dlrm(sc: ST.StepConfig, seed=0):
    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    loss, baxes = ST.recsys_loss("dlrm-rm2", cfg)
    _, jitted, st_shard, opt = ST.make_train_step(loss, arch.abstract_params(cfg), _rules(),
                                                  baxes, sc)
    return cfg, ST.init_state(opt, params), jitted, st_shard


def test_rowwise_table_optimizer():
    """Tables get row-wise Adagrad state [R, 1]; untouched rows never move."""
    cfg, state, jitted, _ = _dlrm(ST.StepConfig(peak_lr=5e-3, warmup_steps=2, total_steps=50))
    R, D = state.params["tables"][0].shape
    assert state.opt.m["tables"][0].shape == (R, 1)
    assert state.opt.m["bot"][0]["w"].shape == state.params["bot"][0]["w"].shape
    before = state.params["tables"][0].clone()
    batches = [recsys_batch("dlrm-rm2", 32, cfg, step=i) for i in range(5)]
    fn = jitted(batches[0])
    for b in batches:
        state, _ = fn(state, b)
    after = state.params["tables"][0]
    touched = set()
    for b in batches:
        touched |= set(int(x) for x in b["sparse"][:, 0])
    untouched = [r for r in range(R) if r not in touched]
    assert untouched, "smoke table too small to leave rows untouched"
    assert torch.equal(before[untouched], after[untouched])
    moved = [r for r in touched if not torch.equal(before[r], after[r])]
    assert len(moved) > 0


def test_grad_clip_reported():
    cfg, state, jitted, _ = _dlrm(ST.StepConfig(grad_clip=1e-6))  # update ~ frozen
    batch = recsys_batch("dlrm-rm2", 16, cfg)
    before = state.params["bot"][0]["w"].clone()
    state, m = jitted(batch)(state, batch)
    assert "grad_norm" in m and float(m["grad_norm"]) > 0
    assert float((state.params["bot"][0]["w"] - before).abs().max()) < 1e-2


def test_lr_schedule_in_metrics():
    cfg, state, jitted, _ = _dlrm(ST.StepConfig(peak_lr=1.0, warmup_steps=10, total_steps=100))
    batch = recsys_batch("dlrm-rm2", 16, cfg)
    fn = jitted(batch)
    lrs = []
    for _ in range(3):
        state, m = fn(state, batch)
        lrs.append(float(m["lr"]))
    np.testing.assert_allclose(lrs, [0.0, 0.1, 0.2], atol=1e-6)  # linear warmup


def test_microbatch_equivalence():
    """DLRM's loss is a mean over rows: 1, 2 and 4 micro-batches agree."""
    batch = recsys_batch("dlrm-rm2", 64, REG.get("dlrm-rm2").smoke_config(), seed=1)
    outs = {}
    for n_micro in (1, 2, 4):
        _, state, jitted, _ = _dlrm(ST.StepConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                                                  micro_batches=n_micro))
        state, m = jitted(batch)(state, batch)
        outs[n_micro] = (float(m["loss"]), [t.clone() for t in P.param_leaves(state.params)])
    for n in (2, 4):
        assert abs(outs[n][0] - outs[1][0]) < 2e-2, (n, outs[n][0], outs[1][0])
        for a, b in zip(outs[n][1], outs[1][1]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)


def test_opt_state_mirrors_param_shardings():
    _, _, _, st_shard = _dlrm(ST.StepConfig())
    p = tree_leaves(st_shard.params)
    m = tree_leaves(st_shard.opt.m)
    assert len(p) == len(m) and all(a.spec == b.spec for a, b in zip(p, m))


def _lm(sc: ST.StepConfig, seed=0):
    cfg = Tr.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                               d_ff=128, vocab=256, dtype=torch.float32)
    loss, baxes = ST.lm_loss(cfg)
    _, jitted, st_shard, opt = ST.make_train_step(loss, Tr.abstract_params(cfg), _rules(),
                                                  baxes, sc)
    params = Tr.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, ST.init_state(opt, params), jitted


def test_lm_microbatch_equivalence():
    g = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(g.integers(0, 256, (8, 32))),
             "labels": torch.from_numpy(g.integers(0, 256, (8, 32)))}
    outs = {}
    for n_micro in (1, 2, 4):
        _, state, jitted = _lm(ST.StepConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                                             micro_batches=n_micro))
        state, m = jitted(batch)(state, batch)
        outs[n_micro] = (float(m["loss"]), tree_leaves(state.params)[0].clone())
    for n in (2, 4):
        assert abs(outs[n][0] - outs[1][0]) < 2e-2, (n, outs[n][0], outs[1][0])
        np.testing.assert_allclose(outs[n][1].numpy(), outs[1][1].numpy(), atol=1e-3)


def test_lm_grad_clip_reported():
    _, state, jitted = _lm(ST.StepConfig(grad_clip=1e-6))  # absurdly tight: update ~ frozen
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
    before = tree_leaves(state.params)[0].clone()
    state, m = jitted(batch)(state, batch)
    assert "grad_norm" in m and float(m["grad_norm"]) > 0
    assert float((tree_leaves(state.params)[0] - before).abs().max()) < 1e-2


def test_lm_lr_schedule_in_metrics():
    _, state, jitted = _lm(ST.StepConfig(peak_lr=1.0, warmup_steps=10, total_steps=100))
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "labels": torch.zeros((2, 16), dtype=torch.int32)}
    fn = jitted(batch)
    lrs = []
    for _ in range(3):
        state, m = fn(state, batch)
        lrs.append(float(m["lr"]))
    np.testing.assert_allclose(lrs, [0.0, 0.1, 0.2], atol=1e-6)  # linear warmup


def test_two_tower_micro_batches_match_the_reference(rules):
    arch_r, arch = RREG.get("two-tower-retrieval"), REG.get("two-tower-retrieval")
    cfg = arch.smoke_config()
    sc = dict(peak_lr=5e-3, warmup_steps=1, total_steps=100, micro_batches=4)
    rparams = arch_r.init_params(jax.random.PRNGKey(1), cfg)
    loss, baxes = RST.recsys_loss("two-tower-retrieval", cfg)
    _, jitted, _, opt = RST.make_train_step(loss, arch_r.abstract_params(cfg), rules, baxes,
                                            RST.StepConfig(**sc))
    batches = [recsys_batch("two-tower-retrieval", 64, cfg, seed=2, step=i) for i in range(2)]
    port = P.params_from_reference(jax.tree.map(np.asarray, ref_split(rparams)[0]), device="cpu")
    whole, _ = P.two_tower_loss(port, batches[0], cfg)  # one softmax over all 64 rows
    state = RST.init_state(opt, rparams)
    fn = jitted({k: jnp.asarray(v) for k, v in batches[0].items()})
    want = []
    for b in batches:
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    loss, baxes = ST.recsys_loss("two-tower-retrieval", cfg)
    step, _, _, popt = ST.make_train_step(loss, arch.abstract_params(cfg), _rules(), baxes,
                                          ST.StepConfig(**sc))
    pstate = ST.init_state(popt, port)
    got = []
    for b in batches:
        pstate, m = step(pstate, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    for a, b in zip(P.param_leaves(pstate.params), jax.tree.leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert abs(float(whole) - want[0]) > 1e-3  # the slices' softmaxes are another loss


@pytest.mark.parametrize("names,shape", [(("data", "model"), (2, 4)), (("data", "model"), (1, 1)),
                                         (("pod", "data", "model"), (2, 2, 4))])
def test_rule_specs_match_the_reference(names, shape):
    mesh = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    ref, port = RS.make_rules(mesh), S.make_rules(mesh)
    assert dict(port.rules) == dict(ref.rules)
    cases = [(("table", None), (4096, 64)), (("table", None), (4098, 64)),
             (("batch", None), (6, 3)), (("batch", "fsdp"), (8, 8)),
             (("tensor", None, None), (200, 39, 39)), ((None, "tensor"), (13, 512)),
             ((None,), (7,)), ((), ()), (("seq", "kv_seq"), (4, 8)),
             (("ring",), (16,)), (("fsdp", "tensor"), None)]
    for axes, dims in cases:
        assert port.spec(axes, dims) == tuple(ref.spec(axes, dims)), (axes, dims)


@pytest.mark.parametrize("arch_id", ["two-tower-retrieval", "dlrm-rm2", "xdeepfm", "bst"])
def test_param_spec_trees_match_the_reference(arch_id):
    """``spec_tree_for_params`` over an arch's full-width params (on meta)
    and over their axes tree: each leaf's spec equal to the reference's
    ``logical_to_spec`` of the same axes and shape, on a (2, 4) mesh."""
    names = ("data", "model")
    mesh = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, (2, 4))))
    ref_rules, rules = RS.make_rules(mesh), S.make_rules(mesh)
    cfg = REG.get(arch_id).full_config()
    ref_leaves = jax.tree.leaves(RREG.get(arch_id).abstract_params(cfg), is_leaf=RN.is_param)
    abstract = REG.get(arch_id).abstract_params(cfg)
    by_shape = tree_leaves(S.spec_tree_for_params(rules, abstract))
    by_axes = tree_leaves(S.spec_tree_for_params(rules, split_params(abstract)[1]))
    assert len(by_shape) == len(by_axes) == len(ref_leaves)
    for got, got_axes, ref in zip(by_shape, by_axes, ref_leaves):
        shape = tuple(ref.value.shape)
        assert got.spec == tuple(RS.logical_to_spec(ref_rules, ref.axes, shape))
        assert got.spec == S.logical_to_spec(rules, ref.axes, shape)
        assert got_axes.spec == tuple(RS.logical_to_spec(ref_rules, ref.axes))
        assert got_axes.spec == S.logical_to_spec(rules, ref.axes)


def test_constrain_is_the_identity_and_checks_the_rank():
    x = torch.ones(3, 4)
    assert S.constrain(x, ("batch",)) is x  # no rules installed
    with S.axis_rules(_rules()):
        assert S.constrain(x, ("batch", None)) is x
        with pytest.raises(ValueError):
            S.constrain(x, ("batch",))
    assert S.current_rules() is None


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "xdeepfm", "bst"])
def test_serve_step_matches_the_reference(rules, arch_id):
    ref, port = RREG.get(arch_id), REG.get(arch_id)
    cfg = port.smoke_config()
    rparams = ref.init_params(jax.random.PRNGKey(0), cfg)
    values = ref_split(rparams)[0]
    batch = ref.smoke_batch("serve_p99")
    _, shard_for, _ = RST.make_recsys_serve_step(arch_id, cfg, rules, ref.abstract_params(cfg))
    want = np.asarray(shard_for(batch)(values, batch))
    _, shard_for, _ = ST.make_recsys_serve_step(arch_id, cfg, _rules(), port.abstract_params(cfg))
    pb = port.smoke_batch("serve_p99", device="cpu")
    assert sorted(pb) == sorted(batch)
    got = shard_for(pb)(P.params_from_reference(jax.tree.map(np.asarray, values), device="cpu"),
                        pb)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    tt = REG.get("two-tower-retrieval")
    with pytest.raises(ValueError, match="make_retrieval_step"):
        ST.make_recsys_serve_step("two-tower-retrieval", tt.smoke_config(), _rules(),
                                  tt.abstract_params(tt.smoke_config()))


@pytest.mark.parametrize("mesh_shape", [(1, 1), (1, 4)])
def test_retrieval_step_matches_brute_force_and_the_reference(rules, mesh_shape):
    ref, port = RREG.get("two-tower-retrieval"), REG.get("two-tower-retrieval")
    cfg = port.smoke_config()
    rparams = ref.init_params(jax.random.PRNGKey(0), cfg)
    values = ref_split(rparams)[0]
    g = np.random.default_rng(0)
    users = g.integers(0, 128, (3, cfg.n_user_fields)).astype(np.int32)
    db = g.standard_normal((1001, cfg.tower_mlp[-1])).astype(np.float32)  # not a multiple of 4
    _, shard_for, _ = RST.make_retrieval_step(cfg, rules, ref.abstract_params(cfg), k=16)
    want_s, want_i = shard_for(users, db)(values, jnp.asarray(users), jnp.asarray(db))
    params = P.params_from_reference(jax.tree.map(np.asarray, values), device="cpu")
    step, _, _ = ST.make_retrieval_step(cfg, _rules(mesh_shape), port.abstract_params(cfg), k=16)
    scores, ids = step(params, torch.from_numpy(users), torch.from_numpy(db))
    u = P.user_embedding(params, users)
    brute = u @ torch.from_numpy(db).T
    top = torch.topk(brute, 16, dim=1)
    assert torch.equal(ids.long(), top.indices)
    np.testing.assert_allclose(scores.numpy(), top.values.numpy(), rtol=1e-5, atol=1e-5)
    assert np.array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"])
def test_every_cell_builds_and_the_train_cell_runs(arch_id):
    arch = REG.get(arch_id)
    rules = _rules()
    for cell in arch.shapes:
        fn, args = arch.build(rules, cell.name, smoke=True)
        assert callable(fn) and all(t.device.type == "meta" for t in tree_leaves(args[-1]))
    fn, (state_spec, specs) = arch.build(rules, "train_batch", smoke=True)
    cfg = arch.smoke_config()
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    _, _, _, opt = ST.make_train_step(ST.recsys_loss(arch_id, cfg)[0], arch.abstract_params(cfg),
                                      rules, {}, ST.StepConfig())
    state = ST.init_state(opt, params)
    assert [t.shape for t in tree_leaves(state.opt.m)] == \
        [t.shape for t in tree_leaves(state_spec.opt.m)]
    batch = arch.smoke_batch("train_batch", device="cpu")
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in specs.items()}
    state, m = fn(state, batch)
    assert np.isfinite(float(m["loss"])) and state.opt.step == 1


@pytest.mark.parametrize("arch_id", ["h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b",
                                     "qwen3-moe-30b-a3b"])
def test_every_lm_cell_builds_and_the_cells_run(arch_id):
    arch = REG.get(arch_id)
    rules = _rules()
    for cell in arch.shapes:
        if cell.kind == "skip":
            with pytest.raises(KeyError, match="skipped"):
                arch.build(rules, cell.name, smoke=True)
            continue
        for variant in ((None, "sp") if cell.kind == "decode" else (None,)):
            fn, args = arch.build(rules, cell.name, smoke=True, variant=variant)
            tensors = [t for a in tree_leaves(args) for t in (a if isinstance(a, tuple) else (a,))
                       if isinstance(t, torch.Tensor)]  # a KVCache's k, v and pos
            assert callable(fn) and tensors and all(t.device.type == "meta" for t in tensors)
    assert set(arch.input_specs("decode_32k")) == {"tokens", "cache"}
    cfg = arch.smoke_config()
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    values = split_params(params)[0]
    batch = arch.smoke_batch("train_4k", device="cpu")
    fn, (state_spec, specs) = arch.build(rules, "train_4k", smoke=True)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: tuple(v.shape) for k, v in specs.items()}
    _, _, _, opt = ST.make_train_step(ST.lm_loss(cfg)[0], arch.abstract_params(cfg), rules, {},
                                      ST.StepConfig())
    state = ST.init_state(opt, params)
    assert [t.shape for t in tree_leaves(state.opt.m)] == \
        [t.shape for t in tree_leaves(state_spec.opt.m)]
    state, m = fn(state, batch)
    assert np.isfinite(float(m["loss"])) and state.opt.step == 1
    fn, (_, tok_spec, cache_spec) = arch.build(rules, "prefill_32k", smoke=True)
    cache = Tr.init_cache(cfg, *tok_spec.shape, device="cpu")
    assert [(t.shape, t.dtype) for t in cache] == [(t.shape, t.dtype) for t in cache_spec]
    logits, cache = fn(values, batch["tokens"], cache)
    assert logits.shape == (4, cfg.vocab) and cache.pos.tolist() == [64] * 4
    cache.pos.fill_(32)  # decode over a half-full cache
    base, _ = arch.build(rules, "decode_32k", smoke=True)
    sp, _ = arch.build(rules, "decode_32k", smoke=True, variant="sp")
    lb, _ = base(values, cache.clone(), batch["tokens"][:, 32])
    ls, _ = sp(values, cache.clone(), batch["tokens"][:, 32])
    np.testing.assert_allclose(ls.numpy(), lb.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cell,variant", [("allpairs_160k", None), ("allpairs_160k", "triangle"),
                                          ("allpairs_2m", "bf16wire"), ("query_1m", None)])
def test_knn_arch_cells_build_and_run(cell, variant):
    from repro_torch.core.knn import knn_allpairs, knn_query

    arch = REG.get("knn-paper")
    assert arch.family == "knn" and arch.full_config() == dict(d=256, k=100,
                                                               distance="sqeuclidean")
    rules = _rules((2, 2))
    fn, args = arch.build(rules, cell, smoke=True, variant=variant)
    k = arch.smoke_config()["k"]
    if cell == "query_1m":
        q_spec, db_spec, n = args
        assert q_spec.shape == (64, 32) and db_spec.shape == (1024, 32) and n == 1024
        g = np.random.default_rng(0)
        q = torch.from_numpy(g.standard_normal(q_spec.shape, np.float32))
        db = torch.from_numpy(g.standard_normal(db_spec.shape, np.float32))
        got, want = fn(q, db, n), knn_query(q, db, k)
    else:
        x_spec, n = args
        assert n == 256 and x_spec.device.type == "meta"
        x = torch.zeros(x_spec.shape)
        x[:n] = arch.smoke_batch(cell, device="cpu")
        got, want = fn(x, n), knn_allpairs(x[:n], k)
    assert got.indices.shape == want.indices.shape
    tol = dict(rtol=2e-2, atol=2e-2) if variant == "bf16wire" else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.distances.numpy(), want.distances.numpy(), **tol)


def test_recommender_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "examples", "recommender_torch.py"),
                           "--device", "cpu"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done." in proc.stdout and "excluded item resurfaced" not in proc.stderr
