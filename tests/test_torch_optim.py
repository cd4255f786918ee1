"""The port's optimizers and schedules (``repro_torch.train.optim``) against
the JAX package's, on the CPU.

The reference's optimizers take a dense gradient; the port's take a table's
gradient as rows (``RowGrad``: the touched ids and their summed rows).  On a
lookup batch with many duplicate ids, the reference gets the dense,
scatter-added gradient and the port the per-lookup rows, coalesced.  Held,
over three updates with a clip that binds: the global norm (rtol 1e-6), the
params and moments (rtol 1e-6, atol 1e-7: float32 rounding of the same
formula) and every untouched table row byte-equal to its start.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as RO
from repro_torch.train import optim as O

R_ROWS, D = 40, 8
TOL = dict(rtol=1e-6, atol=1e-7)


def _problem(seed):
    """A table, two dense leaves, and three batches of lookups with hot ids."""
    g = np.random.default_rng(seed)
    params = {"table": g.standard_normal((R_ROWS, D)).astype(np.float32),
              "dense": {"w": g.standard_normal((5, 3)).astype(np.float32),
                        "b": g.standard_normal(3).astype(np.float32)}}
    steps = []
    for _ in range(3):
        ids = (g.random(64) ** 2 * 30).astype(np.int64)  # rows 30..39 never looked up
        rows = g.standard_normal((64, D)).astype(np.float32)
        dense = {"w": g.standard_normal((5, 3)).astype(np.float32),
                 "b": g.standard_normal(3).astype(np.float32)}
        steps.append((ids, rows, dense))
    return params, steps


def _dense_table_grad(ids, rows):
    out = np.zeros((R_ROWS, D), np.float32)
    np.add.at(out, ids, rows)
    return out


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("name", ["mixed_table_adamw", "adamw", "sgdm", "sgdm_nesterov"])
def test_row_sparse_updates_match_the_reference_dense_ones(name):
    params, steps = _problem(0)
    is_table = {"table": True, "dense": {"w": False, "b": False}}
    if name == "mixed_table_adamw":
        ref, port = RO.mixed_table_adamw(is_table), O.mixed_table_adamw(is_table)
    elif name == "adamw":
        ref, port = RO.adamw(), O.adamw()
    else:
        nesterov = name.endswith("nesterov")
        ref, port = RO.sgdm(nesterov=nesterov), O.sgdm(nesterov=nesterov)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref.init(rp)
    pp = _torch_tree(params)
    ps = port.init(pp)
    touched = set()
    for i, (ids, rows, dense) in enumerate(steps):
        lr = 0.05 * (i + 1)
        touched |= set(ids.tolist())
        rg, rnorm = RO.clip_by_global_norm(
            jax.tree.map(jnp.asarray, {"table": _dense_table_grad(ids, rows), "dense": dense}),
            1.0)
        rp, rs = ref.update(rg, rs, rp, jnp.float32(lr))
        pg = {"table": O.coalesce_rows(torch.from_numpy(ids), torch.from_numpy(rows)),
              "dense": _torch_tree(dense)}
        pg, pnorm = O.clip_by_global_norm(pg, 1.0)
        assert float(rnorm) > 1.0  # the clip binds
        np.testing.assert_allclose(float(pnorm), float(rnorm), rtol=1e-6)
        pp, ps = port.update(pg, ps, pp, lr)
        assert ps.step == int(rs.step) == i + 1
        for got, want in zip(jax.tree.leaves(_np(pp)), jax.tree.leaves(rp)):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
        for got, want in zip(jax.tree.leaves(_np(ps.m)), jax.tree.leaves(rs.m)):
            np.testing.assert_allclose(got, np.asarray(want), **TOL)
    untouched = sorted(set(range(R_ROWS)) - touched)
    assert untouched
    if name == "mixed_table_adamw":  # no decay on tables: untouched rows keep their bytes
        assert np.array_equal(pp["table"].numpy()[untouched], params["table"][untouched])
        assert ps.m["table"].shape == (R_ROWS, 1) and ps.v["table"].shape == (R_ROWS, 1)
    elif name == "adamw":  # its weight decay moves every row, as the reference's
        assert not np.array_equal(pp["table"].numpy()[untouched], params["table"][untouched])


def _np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_coalesce_rows_sums_duplicates_in_id_order():
    ids = torch.tensor([5, 0, 5, 2, 0, 5, 9])
    rows = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    rg = O.coalesce_rows(ids, rows)
    assert rg.ids.tolist() == [0, 2, 5, 9] and rg.ids.dtype == torch.int64
    want = np.zeros((10, 3), np.float32)
    np.add.at(want, ids.numpy(), rows.numpy())
    np.testing.assert_array_equal(rg.rows.numpy(), want[[0, 2, 5, 9]])


def test_global_norm_of_rows_is_the_dense_norm():
    g = np.random.default_rng(1)
    ids = g.integers(0, 6, 50)
    rows = g.standard_normal((50, 4)).astype(np.float32)
    dense = np.zeros((6, 4), np.float32)
    np.add.at(dense, ids, rows)
    got = O.global_norm({"t": O.coalesce_rows(torch.from_numpy(ids), torch.from_numpy(rows))})
    want = RO.global_norm({"t": jnp.asarray(dense)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # the raw, uncoalesced rows would give another norm
    assert abs(float(np.linalg.norm(rows)) - float(want)) > 1e-3


def test_a_table_needs_row_gradients():
    opt = O.mixed_table_adamw({"t": True})
    p = {"t": torch.zeros(4, 2)}
    with pytest.raises(TypeError, match="RowGrad"):
        opt.update({"t": torch.ones(4, 2)}, opt.init(p), p, 0.1)


@pytest.mark.parametrize("sched", ["warmup_cosine", "rsqrt"])
def test_schedules_match_the_reference(sched):
    if sched == "warmup_cosine":
        ref, port = RO.warmup_cosine(3e-4, 10, 100), O.warmup_cosine(3e-4, 10, 100)
    else:
        ref, port = RO.rsqrt_schedule(1e-2, 16), O.rsqrt_schedule(1e-2, 16)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        np.testing.assert_allclose(port(step), float(ref(jnp.int32(step))), rtol=1e-6,
                                   atol=1e-12)
    assert O.OPTIMIZERS.keys() == RO.OPTIMIZERS.keys()
