"""The recommender's train and serve steps sharded over a (data, model) mesh,
against the reference's sharded ``jax.jit`` steps, on the CPU.

The reference runs once, in the module fixture ``R``, on 8 forced host
devices (``conftest.run_with_devices``): ``make_host_mesh()`` is (4, 2)
there.  For each of the four archs at ``smoke_config()`` it runs ten
jitted ``make_train_step`` steps from its init (the two-tower model at two
micro-batches), keeps the losses, the final params and every leaf's
``addressable_shards`` shape, and scores one batch through
``make_recsys_serve_step`` from the init; and three steps of a DLRM whose
first table's 255 rows do not split, which falls back to replicated.

The port runs the same steps on a (4, 2) mesh of 8 CPU positions from the
reference's init (``params_from_reference``, ``sharding.shard_tree``).  Held:

* the losses and the final params within rtol 1e-5 / atol 1e-5 of the
  reference's, the serve probabilities likewise;
* each leaf's part shape equal to the reference's shard shape;
* every replica of every block (params and optimizer state) byte-equal to
  the others after every step;
* the first forward's looked-up rows bit-equal to the whole lookup;
* on a (1, 1) mesh the sharded step equals the whole step bit for bit;
* the retrieval step over the trained towers' shards equals the whole
  towers' ids and scores;
* a ``TrainLoop`` over the sharded step saves and resumes byte for byte;
* each autograd collective's backward is its exact transpose.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import spmd
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import Sharded, make_rules, shard_tree, unshard_tree
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import recsys as P
from repro_torch.models.nn import split_params, tree_leaves
from repro_torch.train.checkpoint import flatten, unflatten

ARCHS = ["dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"]
STEP = dict(peak_lr=5e-3, warmup_steps=5, total_steps=100)
N_STEPS, BATCH = 10, 64
MICRO = {"two-tower-retrieval": 2}
TOL = dict(rtol=1e-5, atol=1e-5)
ODD = "dlrm-odd"  # DLRM with a 255-row first table: replicated, not row-sharded

REFERENCE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry as RREG
from repro.data.synthetic import recsys_batch
from repro.distributed import steps as RST
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_host_mesh
from repro.models.nn import split_params

mesh = make_host_mesh()
assert dict(mesh.shape) == {"data": 4, "model": 2}, mesh.shape
rules = make_rules(mesh)
out = {}

def flat(prefix, tree):
    for i, x in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}.{i}"] = np.asarray(x)

def shard_shapes(prefix, tree):
    for i, x in enumerate(jax.tree.leaves(tree)):
        shapes = {tuple(s.data.shape) for s in x.addressable_shards}
        assert len(shapes) == 1, shapes
        out[f"{prefix}.{i}"] = np.asarray(shapes.pop(), np.int64)

def run(name, aid, cfg, n_steps, micro):
    arch = RREG.get(aid)
    params = arch.init_params(jax.random.PRNGKey(0), cfg)
    flat(f"{name}.init", split_params(params)[0])
    abstract = arch.abstract_params(cfg)
    if aid != "two-tower-retrieval":
        _, shardings_for, _ = RST.make_recsys_serve_step(aid, cfg, rules, abstract)
        sb = recsys_batch(aid, BATCH, cfg, step=99)
        sb.pop("labels")
        sb = {k: jnp.asarray(v) for k, v in sb.items()}
        out[f"{name}.serve"] = np.asarray(shardings_for(sb)(split_params(params)[0], sb))
    loss, baxes = RST.recsys_loss(aid, cfg)
    sc = RST.StepConfig(**STEP, micro_batches=micro)
    _, jitted, st_shard, opt = RST.make_train_step(loss, abstract, rules, baxes, sc)
    state = RST.init_state(opt, params)
    batches = [{k: jnp.asarray(v) for k, v in recsys_batch(aid, BATCH, cfg, step=i).items()}
               for i in range(n_steps)]
    fn = jitted(batches[0])
    losses = []
    for b in batches:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
    out[f"{name}.losses"] = np.asarray(losses)
    flat(f"{name}.final", state.params)
    for part in ("params", "m", "v"):
        shard_shapes(f"{name}.shapes.{part}",
                     state.params if part == "params" else getattr(state.opt, part))

for aid in ARCHS:
    run(aid, aid, RREG.get(aid).smoke_config(), N_STEPS, MICRO.get(aid, 1))
smoke = RREG.get("dlrm-rm2").smoke_config()
run(ODD, "dlrm-rm2", dataclasses.replace(smoke, table_sizes=(255,) + (256,) * 25), 3, 1)
np.savez(sys.argv[1], **out)
"""


def _cfg(name):
    cfg = REG.get("dlrm-rm2" if name == ODD else name).smoke_config()
    if name == ODD:
        cfg = dataclasses.replace(cfg, table_sizes=(255,) + (256,) * 25)
    return cfg


def _aid(name):
    return "dlrm-rm2" if name == ODD else name


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_recsys") / "ref.npz"
    consts = (f"ARCHS = {ARCHS!r}\nSTEP = {STEP!r}\nN_STEPS, BATCH = {N_STEPS}, {BATCH}\n"
              f"MICRO = {MICRO!r}\nODD = {ODD!r}\n")
    run_with_devices(f"import sys\nsys.argv = ['', {str(path)!r}]\n" + consts + REFERENCE)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _leaves(R, prefix):
    out, i = [], 0
    while f"{prefix}.{i}" in R:
        out.append(R[f"{prefix}.{i}"])
        i += 1
    return out


def _mesh(shape):
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"), devices=[torch.device("cpu")] * n)


def _init_values(R, name):
    """The reference's init as the port's value tree (on the CPU)."""
    cfg = _cfg(name)
    like, _ = split_params(REG.get(_aid(name)).init_params(cfg, device="meta"))
    return unflatten(like, [torch.from_numpy(a.copy()) for a in _leaves(R, f"{name}.init")])


def _replicas_equal(tree) -> bool:
    """Every replica of every block holds the same bytes."""
    for s in tree_leaves(tree):
        if not isinstance(s, Sharded):
            continue
        for group in s.replica_groups():
            first = s.parts[group[0]].reshape(-1).view(torch.uint8)
            if not all(torch.equal(first, s.parts[q].reshape(-1).view(torch.uint8))
                       for q in group[1:]):
                return False
    return True


def _train(R, name, shape, steps, sharded=True):
    """(losses, final values (whole), the state, replicas equal after every
    step) of the port's steps from the reference's init."""
    aid, cfg = _aid(name), _cfg(name)
    rules = make_rules(_mesh(shape))
    loss, baxes = ST.recsys_loss(aid, cfg)
    sc = ST.StepConfig(**STEP, micro_batches=MICRO.get(aid, 1))
    _, jitted, st_shard, opt = ST.make_train_step(
        loss, REG.get(aid).abstract_params(cfg), rules, baxes, sc)
    state = ST.init_state(opt, _init_values(R, name))
    if sharded:
        state = shard_tree(state, st_shard)
    fn = jitted(None)
    losses, equal = [], True
    for i in range(steps):
        state, m = fn(state, recsys_batch(aid, BATCH, cfg, step=i))
        losses.append(float(m["loss"]))
        if sharded:
            equal &= _replicas_equal((state.params, state.opt.m, state.opt.v))
    values = unshard_tree(state.params) if sharded else state.params
    return losses, values, state, equal


@pytest.fixture(scope="module")
def PORT(R):
    """The port's ten sharded steps of each arch on the (4, 2) mesh, run once."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _train(R, name, (4, 2), N_STEPS if name != ODD else 3)
        return cache[name]

    return get


@pytest.mark.parametrize("name", ARCHS + [ODD])
def test_sharded_steps_match_the_reference(R, PORT, name):
    losses, values, _, _ = PORT(name)
    np.testing.assert_allclose(losses, R[f"{name}.losses"], **TOL)
    got = [t.numpy() for t in P.param_leaves(values)]
    want = _leaves(R, f"{name}.final")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", ARCHS + [ODD])
def test_shard_shapes_match_the_reference(R, PORT, name):
    _, _, state, _ = PORT(name)
    for part, tree in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v)):
        got = [tuple(s.parts[0].shape) for s in flatten(tree)]
        want = [tuple(int(x) for x in a) for a in _leaves(R, f"{name}.shapes.{part}")]
        assert got == want, part
        assert all(len({tuple(t.shape) for t in s.parts}) == 1 for s in flatten(tree))
    if name == ODD:  # the 255-row table is whole on every position
        assert state.params["tables"][0].sharding.spec == (None, None)
        assert tuple(state.params["tables"][0].parts[0].shape) == (255, 16)
        assert tuple(state.params["tables"][1].parts[0].shape) == (128, 16)


@pytest.mark.parametrize("name", ARCHS + [ODD])
def test_replicas_stay_byte_equal(PORT, name):
    assert PORT(name)[3]


@pytest.mark.parametrize("name", ["dlrm-rm2", "xdeepfm", "bst", ODD])
def test_sharded_serve_matches_the_reference(R, name):
    aid, cfg = _aid(name), _cfg(name)
    rules = make_rules(_mesh((4, 2)))
    abstract = REG.get(aid).abstract_params(cfg)
    _, shardings_for, p_shard = ST.make_recsys_serve_step(aid, cfg, rules, abstract)
    batch = recsys_batch(aid, BATCH, cfg, step=99)
    batch.pop("labels")
    values = shard_tree(_init_values(R, name), p_shard)
    got = shardings_for(batch)(values, batch)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), R[f"{name}.serve"], **TOL)


@pytest.mark.parametrize("name", ["dlrm-rm2", "bst", ODD])
@pytest.mark.parametrize("tap", [False, True])
def test_first_lookups_are_bit_equal_to_the_whole(R, name, tap):
    """Every position's rows of the masked local gather and all-reduce equal
    the whole table's, bit for bit, in serving and through a train step's
    ``RowTap``."""
    aid, cfg = _aid(name), _cfg(name)
    rules = make_rules(_mesh((4, 2)))
    p_shard, _ = ST.param_shardings(rules, REG.get(aid).abstract_params(cfg))
    whole = _init_values(R, name)
    values = shard_tree(_init_values(R, name), p_shard)
    batch = recsys_batch(aid, BATCH, cfg, step=0)
    session = np.concatenate([batch["hist"], batch["target"][:, None]], 1) if aid == "bst" else None
    tables = ([(values["items"], whole["items"], session)] if aid == "bst" else
              [(values["tables"][i], whole["tables"][i], batch["sparse"][:, i])
               for i in range(cfg.n_sparse)])
    for sh, w, ids in tables:
        t = spmd.Local(sh.parts, sh.sharding)
        with spmd.body(rules.mesh):
            rows = P.embedding_lookup(P.RowTap(t) if tap else t, torch.from_numpy(ids))
        want = w[torch.from_numpy(ids).long()]
        for part in rows.parts:
            assert torch.equal(part.detach().view(torch.int32), want.view(torch.int32))
    assert rows.parts[0].shape == want.shape


@pytest.mark.parametrize("name", ARCHS)
def test_one_by_one_mesh_is_the_whole_step_bit_for_bit(R, name):
    a = _train(R, name, (1, 1), 3, sharded=True)
    b = _train(R, name, (1, 1), 3, sharded=False)
    assert a[0] == b[0]
    for x, y in zip(P.param_leaves(a[1]), P.param_leaves(b[1])):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_retrieval_over_the_sharded_towers(R, PORT):
    """``make_retrieval_step`` takes the trained towers' shards: the same
    ids and scores as over the whole towers, and a brute force's ids."""
    name = "two-tower-retrieval"
    cfg = _cfg(name)
    _, values, state, _ = PORT(name)
    rules = make_rules(_mesh((4, 2)))
    abstract = REG.get(name).abstract_params(cfg)
    fn, shardings_for, _ = ST.make_retrieval_step(cfg, rules, abstract, k=16, impl="torch")
    rng = np.random.default_rng(3)
    items = rng.integers(0, 128, size=(1000, cfg.n_item_fields)).astype(np.int32)
    users = rng.integers(0, 256, size=(3, cfg.n_user_fields)).astype(np.int32)
    db = P.item_embedding(values, items)
    s_sh, i_sh = fn(state.params, users, db)
    s_wh, i_wh = fn(values, users, db)
    assert torch.equal(i_sh, i_wh)
    np.testing.assert_allclose(s_sh.numpy(), s_wh.numpy(), rtol=1e-6, atol=1e-6)
    want = torch.topk(P.user_embedding(values, users) @ db.T, 16, dim=1).indices
    assert torch.equal(torch.sort(i_sh, 1).values, torch.sort(want, 1).values)


def test_train_loop_saves_and_resumes_a_sharded_state(tmp_path):
    """A ``TrainLoop`` over the sharded DLRM step on a (2, 2) mesh, cut at
    its checkpoint and resumed into a fresh draw's parts (in place), ends
    byte-equal to one run straight through."""
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig

    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    rules = make_rules(_mesh((2, 2)))
    loss, baxes = ST.recsys_loss("dlrm-rm2", cfg)
    step, _, st_shard, opt = ST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                                ST.StepConfig(**STEP))

    def fresh(seed):
        params = arch.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                                  device="cpu")
        return shard_tree(ST.init_state(opt, params), st_shard)

    def batch_fn(i):
        return recsys_batch("dlrm-rm2", 32, cfg, step=i)

    straight, _ = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=4)).run(fresh(0))
    d = str(tmp_path / "ckpt")
    TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=2, checkpoint_dir=d),
              state_shardings=st_shard).run(fresh(0))
    like = fresh(7)
    resumed, end = TrainLoop(step, batch_fn, TrainLoopConfig(
        total_steps=4, checkpoint_dir=d, final_save=False), state_shardings=st_shard).run(like)
    assert end == 4 and resumed.opt.step == 4
    assert all(a.data_ptr() == b.data_ptr() for a, b in  # filled in place
               zip(resumed.params["tables"][0].parts, like.params["tables"][0].parts))
    for a, b in zip(flatten(straight), flatten(resumed)):
        if isinstance(a, Sharded):
            for x, y in zip(a.parts, b.parts):
                assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("kind", ["all_reduce", "all_gather", "reduce_scatter"])
def test_collectives_and_their_transposes(kind):
    """``core.distributed``'s autograd collectives on four CPU positions:
    each forward's value, the same bytes on every position, one event noted,
    and each backward the exact transpose (the gradient of ``sum_p <c_p,
    y_p>`` by every part)."""
    from repro_torch.core import distributed as KD
    from repro_torch.launch import hlo_stats

    mesh = make_mesh((4,), ("model",), devices=[torch.device("cpu")] * 4)
    pos = [0, 1, 2, 3]
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(8, 6, generator=g, requires_grad=True) for _ in pos]
    with hlo_stats.recording() as events:
        if kind == "all_reduce":
            ys = KD.all_reduce(mesh, pos, xs)
            want = [sum(x.detach() for x in xs)] * 4
        elif kind == "all_gather":
            ys = KD.all_gather(mesh, pos, xs, dim=1)
            want = [torch.cat([x.detach() for x in xs], 1)] * 4
        else:
            ys = KD.reduce_scatter(mesh, pos, xs, dim=0)
            total = sum(x.detach() for x in xs)
            want = list(total.split(2, 0))
    assert [e.kind for e in events] == [kind.replace("_", "-")]
    for y, w in zip(ys, want):
        torch.testing.assert_close(y, w)
    if kind != "reduce_scatter":
        assert all(torch.equal(ys[0], y) for y in ys)
    cs = [torch.randn(y.shape, generator=g) for y in ys]
    grads = torch.autograd.grad(ys, xs, grad_outputs=cs)
    for q, gq in enumerate(grads):
        if kind == "all_reduce":
            want_g = sum(cs)
        elif kind == "all_gather":
            want_g = sum(c[:, 6 * q : 6 * (q + 1)] for c in cs)
        else:
            want_g = torch.cat(cs, 0)
        torch.testing.assert_close(gq, want_g)
