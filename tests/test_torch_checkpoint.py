"""The port's checkpoints (``repro_torch.train.checkpoint``) against the JAX
package's, on the CPU.

* The port's copies of the 8 cases of ``tests/test_checkpoint.py``: the mesh
  case on the port's CPU mesh, the train-state case on DLRM (the reference's
  is on its transformer).
* The leaf order: ``flatten`` equal to ``jax.tree.flatten`` on trees of
  dicts, lists, NamedTuples, ``None`` and ``Param``.
* Across the packages, both ways: a DLRM train state after 3 steps saved by
  one package restores in the other, and 5 more steps there give losses
  within rtol 1e-5 of the saving package's own 5 more steps; a sharded
  DLRM state on a (4, 2) mesh (the reference's on 8 forced devices, the
  port's on 8 CPU positions) restores onto the other's mesh byte for byte.
* Elastic restore: a checkpoint of an 8-position sharded state onto 2 and
  4 positions, each leaf's blocks on its positions.
* A leaf larger than one streamed block (``BLOCK_BYTES`` made small): its
  bytes, the archive's CRCs (``zipfile.testzip``), ``np.load`` and an
  in-place restore; a corrupted byte fails its CRC.
* The async save's bytes are those of the state when ``save`` returned,
  though the state is then overwritten in place.
"""
import json
import os
import zipfile
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.distributed import steps as RST
from repro.models.nn import Param as RParam
from repro.train import checkpoint as RC
from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import Sharded, Sharding, make_rules, shard_tree
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.nn import Param
from repro_torch.train import checkpoint as C
from repro_torch.train.checkpoint import (CheckpointManager, available_steps, latest_step,
                                          restore, save)

CPU = torch.device("cpu")


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones((2, 2), dtype=torch.bfloat16), torch.tensor(7, dtype=torch.int32)],
            "c": {"d": torch.zeros((5,), dtype=torch.int8)}}


def _meta(tree):
    return C.unflatten(tree, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                              if isinstance(t, torch.Tensor) else t for t in C.flatten(tree)])


def test_roundtrip_preserves_values_and_dtypes(tmp_path):
    t = _tree()
    save(str(tmp_path), t, 3)
    out, step, _ = restore(str(tmp_path), _meta(t))
    assert step == 3
    for a, b in zip(C.flatten(t), C.flatten(out)):
        assert a.dtype == b.dtype and b.device == CPU
        assert torch.equal(a, b)


def test_latest_skips_torn_checkpoint(tmp_path):
    t = _tree()
    save(str(tmp_path), t, 1)
    save(str(tmp_path), t, 2)
    # tear step 2 three different ways; each must fall back to step 1
    d2 = tmp_path / "step_00000002"
    (d2 / "manifest.json").unlink()
    assert latest_step(str(tmp_path)) == 1
    save(str(tmp_path), t, 2)
    (d2 / "leaves.npz").unlink()
    assert latest_step(str(tmp_path)) == 1
    save(str(tmp_path), t, 2)
    with open(d2 / "manifest.json", "w") as f:
        f.write("{not json")
    assert latest_step(str(tmp_path)) == 1


def test_save_is_atomic_wrt_existing(tmp_path):
    save(str(tmp_path), _tree(), 1)
    # a stale tmp dir from a crashed writer must not be visible
    os.makedirs(tmp_path / "step_00000005.tmp-999")
    assert latest_step(str(tmp_path)) == 1


def test_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree()
    for s in (10, 20, 30, 40):
        mgr.save(t, s)
    mgr.wait()
    assert available_steps(str(tmp_path)) == [30, 40]


def test_extra_metadata_roundtrip(tmp_path):
    save(str(tmp_path), _tree(), 7, extra={"loss": 1.5, "arch": "yi-6b"})
    _, _, extra = restore(str(tmp_path), _meta(_tree()))
    assert extra == {"loss": 1.5, "arch": "yi-6b"}


def test_leaf_count_mismatch_rejected(tmp_path):
    save(str(tmp_path), _tree(), 1)
    with pytest.raises(AssertionError):
        restore(str(tmp_path), {"a": torch.zeros((3, 4), device="meta")})


def test_elastic_restore_across_meshes(tmp_path):
    """A checkpoint written from an 8-position sharded state restores onto
    2- and 4-position meshes, each leaf's blocks on its positions: rows
    split, columns split, and whole (replicated on every position)."""
    mesh8 = make_mesh((8,), ("data",), devices=[CPU] * 8)
    w = torch.arange(64.0).reshape(8, 8)
    v = torch.arange(32.0).reshape(2, 16)
    src = {"w": Sharding(mesh8, ("data", None)), "v": Sharding(mesh8, (None, "data"))}
    state = shard_tree({"w": w.clone(), "v": v.clone()}, src)
    assert [tuple(t.shape) for t in state["w"].parts] == [(1, 8)] * 8
    save(str(tmp_path), state, 11)
    for n in (2, 4):
        mesh = make_mesh((n,), ("data",), devices=[CPU] * n)
        shd = {"w": Sharding(mesh, ("data", None)), "v": Sharding(mesh, (None, None))}
        like = {"w": torch.empty((8, 8), device="meta"), "v": torch.empty((2, 16), device="meta")}
        out, step, _ = restore(str(tmp_path), like, shardings=shd)
        assert step == 11
        assert isinstance(out["w"], Sharded) and len(out["w"].parts) == n
        for p, part in enumerate(out["w"].parts):
            assert part.device == mesh.devices[p]
            assert torch.equal(part, w[p * 8 // n : (p + 1) * 8 // n])
        assert all(torch.equal(part, v) for part in out["v"].parts)
        assert torch.equal(out["w"].whole(), w)
    assert mesh8.shape == {"data": 8}


def _dlrm(sc=None, seed=0):
    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[CPU]))
    loss, baxes = ST.recsys_loss("dlrm-rm2", cfg)
    _, jitted, _, opt = ST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                           sc or ST.StepConfig(peak_lr=5e-3, warmup_steps=2))
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return cfg, jitted, ST.init_state(opt, params), opt


def test_train_state_checkpoint_roundtrip(tmp_path):
    """A full TrainState (params, the step and the moments) through save and
    an in-place restore into a fresh state's tensors."""
    cfg, jitted, state, _ = _dlrm()
    batch = recsys_batch("dlrm-rm2", 16, cfg)
    state, _ = jitted(batch)(state, batch)
    save(str(tmp_path), state, 1)
    _, _, like, _ = _dlrm(seed=1)
    targets = [t.data_ptr() for t in C.flatten(like) if isinstance(t, torch.Tensor)]
    out, _, _ = restore(str(tmp_path), like)
    assert out.opt.step == state.opt.step == 1
    assert [t.data_ptr() for t in C.flatten(out) if isinstance(t, torch.Tensor)] == targets
    for a, b in zip(C.flatten(state), C.flatten(out)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


class _NT(NamedTuple):
    x: object
    y: object


def test_flatten_is_jax_tree_order():
    def mk(param, t, nt):
        return {"z": [t(1.0), None, nt(t(2.0), {"b": t(3.0), "a": t(4.0)})],
                "a": param(t(5.0), ("x",)), "m": (t(6.0), nt(None, t(7.0)))}

    ref = mk(RParam, lambda v: jnp.float32(v), _NT)
    port = mk(Param, lambda v: torch.tensor(v), _NT)
    assert [float(x) for x in C.flatten(port)] == [float(x) for x in jax.tree.leaves(ref)]
    back = C.unflatten(port, [torch.tensor(float(i)) for i in range(7)])
    assert [float(x) for x in C.flatten(back)] == list(map(float, range(7)))
    assert isinstance(back["m"][1], _NT) and back["m"][1].x is None
    assert isinstance(back["a"], Param) and back["a"].axes == ("x",)


# -- across the packages -----------------------------------------------------


def _ref_dlrm(rules):
    arch = RREG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    loss, baxes = RST.recsys_loss("dlrm-rm2", cfg)
    _, jitted, _, opt = RST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                            RST.StepConfig(peak_lr=5e-3, warmup_steps=2))
    return cfg, arch, jitted, opt


def _ref_steps(jitted, state, cfg, steps):
    losses = []
    for i in steps:
        b = {k: jnp.asarray(v) for k, v in recsys_batch("dlrm-rm2", 32, cfg, step=i).items()}
        state, m = jitted(b)(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(jitted, state, cfg, steps):
    losses = []
    for i in steps:
        b = recsys_batch("dlrm-rm2", 32, cfg, step=i)
        state, m = jitted(b)(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def test_reference_checkpoint_restores_in_the_port(tmp_path, rules):
    cfg, arch, rj, opt = _ref_dlrm(rules)
    state = RST.init_state(opt, arch.init_params(jax.random.PRNGKey(0), cfg))
    state, _ = _ref_steps(rj, state, cfg, range(3))
    RC.save(str(tmp_path), state, 3)
    _, want = _ref_steps(rj, state, cfg, range(3, 8))
    pcfg, pj, like, _ = _dlrm(seed=5)
    got_state, step, _ = restore(str(tmp_path), like)
    assert step == 3 and got_state.opt.step == 3 and isinstance(got_state.opt.step, int)
    _, got = _port_steps(pj, got_state, pcfg, range(3, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_port_checkpoint_restores_in_the_reference(tmp_path, rules):
    from repro.models.nn import split_params as rsplit
    from repro_torch.models import recsys as P

    cfg, arch, rj, opt = _ref_dlrm(rules)
    init = jax.tree.map(np.asarray, rsplit(arch.init_params(jax.random.PRNGKey(0), cfg))[0])
    pcfg, pj, state, popt = _dlrm()
    state = ST.init_state(popt, P.params_from_reference(init, device="cpu"))
    state, _ = _port_steps(pj, state, pcfg, range(3))
    save(str(tmp_path), state, 3)
    _, want = _port_steps(pj, state, pcfg, range(3, 8))
    like = jax.eval_shape(lambda: RST.init_state(opt, arch.init_params(jax.random.PRNGKey(1),
                                                                       cfg)))
    got_state, step, _ = RC.restore(str(tmp_path), like)
    assert step == 3 and int(got_state.opt.step) == 3
    _, got = _ref_steps(rj, got_state, cfg, range(3, 8))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# -- streaming ---------------------------------------------------------------


SHARDED_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry as RREG
from repro.data.synthetic import recsys_batch
from repro.distributed import steps as RST
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_host_mesh
from repro.train import checkpoint as RC

port_dir, ref_dir, out_path = sys.argv[1:4]
mesh = make_host_mesh()
rules = make_rules(mesh)
arch = RREG.get("dlrm-rm2")
cfg = arch.smoke_config()
loss, baxes = RST.recsys_loss("dlrm-rm2", cfg)
_, jitted, st_shard, opt = RST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                               RST.StepConfig(peak_lr=5e-3, warmup_steps=2))
state = RST.init_state(opt, arch.init_params(jax.random.PRNGKey(0), cfg))
# The port's sharded checkpoint, restored onto this (4, 2) mesh.
like = jax.eval_shape(lambda: state)
got, step, _ = RC.restore(port_dir, like, shardings=st_shard)
out = {f"port.{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(got))}
out["port.shards"] = np.asarray([len(x.addressable_shards) for x in jax.tree.leaves(got)])
out["port.step"] = np.asarray(step)
# Two sharded steps of the reference's own, saved.
for i in range(2):
    b = {k: jnp.asarray(v) for k, v in recsys_batch("dlrm-rm2", 32, cfg, step=i).items()}
    state, _ = jitted(b)(state, b)
RC.save(ref_dir, state, 2)
np.savez(out_path, **out)
"""


def test_sharded_checkpoints_cross_the_packages(tmp_path):
    """The port's (4, 2)-sharded DLRM state restores onto the reference's
    (4, 2) mesh of 8 forced devices, and the reference's sharded state onto
    the port's (4, 2) mesh of CPU positions, each leaf byte for byte."""
    from conftest import run_with_devices
    from repro_torch.models.nn import tree_leaves

    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    mesh = make_mesh((4, 2), ("data", "model"), devices=[CPU] * 8)
    rules = make_rules(mesh)
    loss, baxes = ST.recsys_loss("dlrm-rm2", cfg)
    _, jitted, st_shard, opt = ST.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                                  ST.StepConfig(peak_lr=5e-3, warmup_steps=2))
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    state = shard_tree(ST.init_state(opt, params), st_shard)
    for i in range(2):
        state, _ = jitted(None)(state, recsys_batch("dlrm-rm2", 32, cfg, step=i))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    save(str(port_dir), state, 2)
    out = tmp_path / "out.npz"
    run_with_devices(f"import sys\nsys.argv = ['', {str(port_dir)!r}, {str(ref_dir)!r}, "
                     f"{str(out)!r}]\n" + SHARDED_REFERENCE)
    leaves = C.flatten(state)  # the optimizer's step (an int) among them
    with np.load(out) as z:
        assert int(z["port.step"]) == 2
        assert all(n == 8 for n in z["port.shards"])
        arrays = [z[f"port.{i}"] for i in range(len(leaves))]
    for a, x in zip(arrays, leaves):
        assert a.tobytes() == (np.asarray(x, np.int32) if isinstance(x, int)
                               else x.whole().numpy()).tobytes()
    # The reference's sharded state onto the port's mesh.
    like = shard_tree(ST.init_state(opt, arch.init_params(cfg, device="cpu")), st_shard)
    got, step, _ = restore(str(ref_dir), like, shardings=st_shard)
    assert step == 2 and got.opt.step == 2
    with np.load(ref_dir / "step_00000002" / "leaves.npz") as z:
        want = [z[k] for k in sorted(z.files)]
    got_leaves = C.flatten(got)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        if isinstance(g, int):
            assert g == int(w)
            continue
        assert g.whole().numpy().tobytes() == w.tobytes()
        for group in g.replica_groups():
            assert all(torch.equal(g.parts[group[0]], g.parts[q]) for q in group)
    assert all(isinstance(x, Sharded) for x in tree_leaves(got.params))


def test_leaf_larger_than_a_block_streams_and_checks_its_crc(tmp_path, monkeypatch):
    monkeypatch.setattr(C, "BLOCK_BYTES", 4096)
    g = torch.Generator().manual_seed(0)
    big = torch.randn((1000, 7), generator=g)  # 28,000 bytes: 7 blocks
    half = torch.randn((333,), generator=g).to(torch.bfloat16)
    tree = {"big": big, "half": half, "step": 12}
    final = save(str(tmp_path), tree, 4)
    with zipfile.ZipFile(os.path.join(final, "leaves.npz")) as zf:
        assert zf.testzip() is None
    z = np.load(os.path.join(final, "leaves.npz"))
    np.testing.assert_array_equal(z["leaf_00000"], big.numpy())
    np.testing.assert_array_equal(z["leaf_00001"], half.view(torch.int16).numpy().view(np.uint16))
    assert z["leaf_00002"].dtype == np.int32 and int(z["leaf_00002"]) == 12
    with open(os.path.join(final, "manifest.json")) as f:
        assert json.load(f)["meta"]["dtypes"]["leaf_00001"] == "bfloat16"
    like = {"big": torch.zeros_like(big), "half": torch.zeros_like(half), "step": 0}
    ptr = like["big"].data_ptr()
    stats = {}
    out, _, _ = restore(str(tmp_path), like, stats=stats)
    assert out["big"].data_ptr() == ptr and torch.equal(out["big"], big)
    assert torch.equal(out["half"], half) and out["step"] == 12
    assert stats["bytes"] == big.numel() * 4 + half.numel() * 2 + 4
    # One flipped byte inside the third block fails that leaf's CRC.
    with open(os.path.join(final, "leaves.npz"), "r+b") as f:
        data = f.read()
        pos = data.index(big.numpy().tobytes()[:64]) + 3 * 4096 + 5
        f.seek(pos)
        f.write(bytes([data[pos] ^ 0xFF]))
    with pytest.raises(OSError, match="CRC"):
        restore(str(tmp_path), like)


def test_async_save_keeps_the_bytes_of_its_step(tmp_path):
    """The step after ``save(block=False)`` overwrites the state in place;
    the checkpoint holds the state as it was when ``save`` returned."""
    cfg, jitted, state, _ = _dlrm()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for i in range(3):
        b = recsys_batch("dlrm-rm2", 16, cfg, step=i)
        state, _ = jitted(b)(state, b)
        want = [t.clone() for t in C.flatten(state.params)]
        mgr.save(state, i + 1)
        b = recsys_batch("dlrm-rm2", 16, cfg, step=10 + i)
        state, _ = jitted(b)(state, b)  # in place, while the write may still run
        mgr.wait()
        out, _, _ = restore(str(tmp_path), _meta(state), step=i + 1)
        assert all(torch.equal(a, b) for a, b in zip(C.flatten(out.params), want))
    assert available_steps(str(tmp_path)) == [2, 3]
    assert mgr.last_stats["bytes"] > 0 and "fsync_s" in mgr.last_stats
