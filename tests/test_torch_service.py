"""The port's two-tower retrieval service (``repro_torch.serving.service``,
``serving.cache``, ``launch.serve``) against the JAX package's.

At ``smoke_config()`` on the CPU, where every kernel wrapper runs its plain
version.  The reference runs once, in the module fixture ``R``: its towers
on fixed ids, its params fingerprint, and its service through a corpus
build, recommendations (repeat users, then ingest, delete, compact and the
three filters) and a snapshot; everything comes back as numpy.  The port
gets the reference's params through ``params_from_reference``.

Held: the service's embeddings within 1e-5 and its served ids equal except
at near-ties (where they differ, the port's score is its id's own score,
within 1e-5 of the reference's at that slot); cache counts and ``stats()``
keys equal; the fingerprint string equal; the four reference cases that
drive the service (``tests/test_snapshot.py``, ``test_lifecycle.py``,
``test_shards.py``, ``test_faults.py``), on the port; snapshots crossing
the packages both ways with carried params, refused with the port's own
seeded init; the launcher in subprocesses and its flag checks.  The
towers, the cache and the fingerprint alone: ``tests/test_torch_recsys.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as REG
from repro.models.nn import split_params
from repro.serving import ServiceConfig as RServiceConfig
from repro.serving import TwoTowerRetrievalService as RService
from repro_torch.configs.two_tower import smoke_config
from repro_torch.models.recsys import init_two_tower, params_from_reference, user_embedding
from repro_torch.serving import (
    ServiceConfig,
    ShardRouter,
    SnapshotError,
    TwoTowerRetrievalService,
)
from repro_torch.serving.snapshot import read_fleet_manifest

REPO = Path(__file__).resolve().parent.parent
CFG = smoke_config()
N = 512  # corpus rows
K = 5


def _fields(rng, n, lim, f):
    return rng.integers(0, lim, size=(n, f)).astype(np.int32)


def _item_fields(rng, n):
    return _fields(rng, n, min(CFG.i_sizes()), CFG.n_item_fields)


def _user_fields(rng, n):
    return _fields(rng, n, min(CFG.u_sizes()), CFG.n_user_fields)


def _values(seed):
    arch = REG.get("two-tower-retrieval")
    values, _ = split_params(arch.init_params(jax.random.PRNGKey(seed), arch.smoke_config()))
    return values


def _params(values):
    return params_from_reference(jax.tree.map(np.asarray, values), device="cpu")


# The service script run by both packages: (step, call) pairs, each call run
# on either service, and the users each recommendation asks for.
KEYS = np.concatenate([np.arange(24), np.arange(12), np.arange(100, 112)])  # 12 repeats


def _script(rng):
    items = _item_fields(rng, N)
    users = _user_fields(rng, 48)
    keys = KEYS
    new_items = _item_fields(rng, 24)
    exclude = [np.arange(j, j + 7) for j in range(48)]
    allowed = np.sort(rng.choice(N + 24, 300, replace=False))
    return [
        ("build", lambda s: s.build_corpus(np.arange(N), items)),
        ("initial", lambda s: s.recommend(keys, users)),
        ("ingest", lambda s: (s.ingest_items(np.arange(N, N + 24), new_items),
                              s.recommend(keys, users))[1]),
        ("delete", lambda s: (s.delete_items(np.arange(0, N, 17)), s.recommend(keys, users))[1]),
        ("compact", lambda s: (s.compact(), s.recommend(keys, users))[1]),
        ("exclude", lambda s: s.recommend(keys, users, exclude_ids=exclude)),
        ("tenant", lambda s: s.recommend(keys, users, tenant=0)),
        ("allowed", lambda s: s.recommend(keys, users, allowed_ids=allowed)),
        ("k3", lambda s: s.recommend(keys[:5], users[:5], k=3)),
    ], users


def _numpy(out):
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out.cpu() if isinstance(out, torch.Tensor) else out)


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    """Everything the reference computes, once, as numpy."""
    values, values2 = _values(0), _values(1)
    out = {"values": jax.tree.map(np.asarray, values),
           "values2": jax.tree.map(np.asarray, values2)}
    svc = RService(values, CFG, RServiceConfig(k=K))
    out["fingerprint"] = svc._params_fingerprint()
    out["fingerprint2"] = RService(values2, CFG, RServiceConfig(k=K))._params_fingerprint()
    out["steps"] = {name: _numpy(call(svc)) for name, call in
                    _script(np.random.default_rng(1))[0]}
    out["stats"] = svc.stats()
    # A flat snapshot of the reference service (after the script), for the
    # cross-package restore, and the results it must serve.
    snap = str(tmp_path_factory.mktemp("ref") / "snap")
    svc.save_index(snap)
    rng = np.random.default_rng(5)
    out["probe"] = (np.arange(1000, 1007), _user_fields(rng, 7))  # keys no cache holds
    out["snap"] = snap
    out["snap_results"] = _numpy(svc.recommend(*out["probe"]))
    # The reference service restoring a snapshot the test writes with the
    # port: a callable, run inside the test.
    out["restore_in_reference"] = lambda d: _numpy(
        _restored_reference(values, d).recommend(*out["probe"]))
    return out


def _restored_reference(values, directory):
    svc = RService(values, CFG, RServiceConfig(k=K))
    svc.restore_index(directory)
    return svc


def _assert_served_close(got, want, corpus, users, what):
    """Scores within 1e-5; ids equal except at near-ties, where the port's
    id must lie in the corpus at the score it is reported at."""
    ids, scores = got
    wids, wscores = want
    assert ids.shape == wids.shape, what
    np.testing.assert_allclose(scores, wscores, rtol=1e-5, atol=1e-5, err_msg=what)
    for r, j in zip(*np.nonzero(ids != wids)):
        own = float(users[r] @ corpus[int(ids[r, j])])
        assert abs(own - scores[r, j]) <= 1e-5, (what, r, j)


# -- the service against the reference service ----------------------------------


def test_service_matches_reference(R):
    params = _params(R["values"])
    svc = TwoTowerRetrievalService(params, CFG, ServiceConfig(k=K), device="cpu")
    corpus = {}
    steps, users = _script(np.random.default_rng(1))
    u = user_embedding(params, users).numpy()
    for name, call in steps:
        got = call(svc)
        want = R["steps"][name]
        if name == "build":
            assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
            corpus = dict(enumerate(got.numpy()))
            continue
        if name == "ingest":  # the delta's rows, embedded by the item tower
            vecs, ids = svc.index._live_rows()
            corpus.update(zip(ids.tolist(), vecs))
        _assert_served_close(got, want, corpus, u, name)
        if name == "exclude":
            excluded = [set(range(j, j + 7)) for j in range(len(KEYS))]
            assert not any(set(row.tolist()) & ex for row, ex in zip(got[0], excluded))
    st, want = svc.stats(), R["stats"]
    assert set(st) == set(want)
    assert set(st["serving"]) == set(want["serving"])
    for key in ("index_rows", "index_dead"):
        assert st[key] == want[key], key
    for key in ("size", "capacity", "hits", "misses"):
        assert st["cache"][key] == want["cache"][key], key


def test_service_needs_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    params = init_two_tower(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TwoTowerRetrievalService(params, CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_two_tower(CFG)


def test_service_refuses_params_on_another_device():
    params = init_two_tower(CFG, device="meta")
    with pytest.raises(ValueError, match="meta"):
        TwoTowerRetrievalService(params, CFG, device="cpu")


# -- the reference's service cases, on the port ----------------------------------


def test_service_restore_checks_config_and_serves(R, tmp_path):
    """ServiceConfig <-> snapshot signature mismatch hard-fails; match serves
    (``tests/test_snapshot.py::test_service_restore_checks_config_and_serves``)."""
    params = _params(R["values"])
    snap = str(tmp_path / "snap")
    svc = TwoTowerRetrievalService(params, CFG, ServiceConfig(k=5, snapshot_dir=snap),
                                   device="cpu")
    rng = np.random.default_rng(1)
    n = 256
    svc.build_corpus(np.arange(n), _item_fields(rng, n))
    ukeys, ufields = np.arange(7), _user_fields(rng, 7)
    want_ids, want_scores = svc.recommend(ukeys, ufields)
    svc.save_index()

    svc2 = TwoTowerRetrievalService(params, CFG, ServiceConfig(k=5, snapshot_dir=snap),
                                    device="cpu")
    svc2.restore_index()
    got_ids, got_scores = svc2.recommend(ukeys, ufields)
    np.testing.assert_array_equal(want_ids, got_ids)
    np.testing.assert_array_equal(want_scores, got_scores)

    svc3 = TwoTowerRetrievalService(
        params, CFG, ServiceConfig(k=5, scan_dtype="int8", snapshot_dir=snap), device="cpu")
    with pytest.raises(SnapshotError, match="does not match"):
        svc3.restore_index()

    svc4 = TwoTowerRetrievalService(_params(R["values2"]), CFG,
                                    ServiceConfig(k=5, snapshot_dir=snap), device="cpu")
    with pytest.raises(SnapshotError, match="different model"):
        svc4.restore_index()


def test_service_lifecycle_end_to_end(R, tmp_path):
    """``tests/test_lifecycle.py::test_service_lifecycle_end_to_end``."""
    params = _params(R["values"])
    snap = str(tmp_path / "snap")
    sc = ServiceConfig(k=5, snapshot_dir=snap, wal=True, delta_budget=64)
    svc = TwoTowerRetrievalService(params, CFG, sc, device="cpu")
    rng = np.random.default_rng(1)
    n = 256
    svc.build_corpus(np.arange(n), _item_fields(rng, n))
    svc.enable_lifecycle()
    svc.ingest_items(np.arange(n, n + 24), _item_fields(rng, 24))
    svc.delete_items(np.arange(0, n, 31))
    svc.compact(wait=True)
    assert svc.stats()["lifecycle"]["handoffs"] == 1
    ukeys, ufields = np.arange(7), _user_fields(rng, 7)
    want_ids, want_scores = svc.recommend(ukeys, ufields)

    svc2 = TwoTowerRetrievalService(params, CFG, sc, device="cpu")
    rec = svc2.recover_lifecycle()
    assert rec.wal and rec.torn_bytes == 0
    got_ids, got_scores = svc2.recommend(ukeys, ufields)
    np.testing.assert_array_equal(want_ids, got_ids)
    np.testing.assert_array_equal(want_scores, got_scores)
    svc2.lifecycle.close()

    svc3 = TwoTowerRetrievalService(_params(R["values2"]), CFG, sc, device="cpu")
    with pytest.raises(SnapshotError, match="different model"):
        svc3.recover_lifecycle()
    svc.lifecycle.close()


def test_service_shards_roundtrip_and_config_mismatch(R, tmp_path):
    """``tests/test_shards.py::test_service_shards_roundtrip_and_config_mismatch``."""
    params = _params(R["values"])
    root = str(tmp_path / "shards")
    svc = TwoTowerRetrievalService(
        params, CFG, ServiceConfig(k=5, ivf_cells=8, nprobe=8, shards=2, snapshot_dir=root),
        device="cpu")
    rng = np.random.default_rng(1)
    n = 512
    fields = _item_fields(rng, n)
    svc.build_corpus(np.arange(n), fields)
    ukeys, ufields = np.arange(7), _user_fields(rng, 7)
    paths = svc.save_shards()
    assert len(paths) == 2
    svc.restore_shards()
    assert isinstance(svc.engine.index, ShardRouter)
    ids, scores = svc.recommend(ukeys, ufields)
    assert ids.shape == (7, 5) and np.all(ids >= 0)

    svc2 = TwoTowerRetrievalService(
        params, CFG, ServiceConfig(k=5, ivf_cells=8, nprobe=4, snapshot_dir=root),
        device="cpu")
    svc2.build_corpus(np.arange(n), fields)
    with pytest.raises(SnapshotError, match="config does not match"):
        svc2.restore_shards()

    # Images embedded by other towers are refused too.
    svc3 = TwoTowerRetrievalService(
        _params(R["values2"]), CFG,
        ServiceConfig(k=5, ivf_cells=8, nprobe=8, shards=2, snapshot_dir=root), device="cpu")
    with pytest.raises(SnapshotError, match="different model"):
        svc3.restore_shards()


def test_service_restores_replicated_fleet(R, tmp_path):
    """``tests/test_faults.py::test_service_restores_replicated_fleet``."""
    params = _params(R["values"])
    root = str(tmp_path / "shards")
    svc = TwoTowerRetrievalService(
        params, CFG, ServiceConfig(k=5, ivf_cells=8, nprobe=8, shards=2, replicas=2,
                                   degraded="partial", snapshot_dir=root), device="cpu")
    rng = np.random.default_rng(1)
    n = 512
    svc.build_corpus(np.arange(n), _item_fields(rng, n))
    svc.save_shards()
    assert read_fleet_manifest(root)["replicas"] == 2
    svc.restore_shards()
    assert svc.router.n_replicas == 2
    assert svc.router.degraded == "partial"
    ids, scores = svc.recommend(np.arange(7), _user_fields(rng, 7))
    assert ids.shape == (7, 5) and np.all(ids >= 0)
    st_ = svc.stats()
    assert st_["fleet"]["replicas"] == 2
    assert st_["fleet"]["dispatch"]["calls"] > 0
    assert all(h["state"] == "healthy" for h in st_["fleet"]["health"].values())


# -- snapshots across the packages ---------------------------------------------


def test_reference_snapshot_restores_in_the_port(R):
    svc = TwoTowerRetrievalService(_params(R["values"]), CFG, ServiceConfig(k=K),
                                   device="cpu")
    svc.restore_index(R["snap"])
    ids, scores = svc.recommend(*R["probe"])
    wids, wscores = R["snap_results"]
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_allclose(scores, wscores, rtol=1e-5, atol=1e-5)
    # The port's own seeded towers did not embed that corpus.
    own = TwoTowerRetrievalService(init_two_tower(CFG, device="cpu"), CFG,
                                   ServiceConfig(k=K), device="cpu")
    with pytest.raises(SnapshotError, match="different model"):
        own.restore_index(R["snap"])


def test_port_snapshot_restores_in_the_reference(R, tmp_path):
    svc = TwoTowerRetrievalService(_params(R["values"]), CFG, ServiceConfig(k=K),
                                   device="cpu")
    svc.restore_index(R["snap"])
    snap = str(tmp_path / "port-snap")
    svc.save_index(snap)
    ids, scores = R["restore_in_reference"](snap)
    wids, wscores = svc.recommend(*R["probe"])
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_allclose(scores, wscores, rtol=1e-5, atol=1e-5)
    # And the port's own init refuses the port's snapshot of those towers.
    own = TwoTowerRetrievalService(init_two_tower(CFG, device="cpu"), CFG,
                                   ServiceConfig(k=K), device="cpu")
    with pytest.raises(SnapshotError, match="different model"):
        own.restore_index(snap)


# -- the launcher ------------------------------------------------------------------


def _serve(*argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                           *argv], capture_output=True, text=True, env=env, cwd=tmp_path,
                          timeout=300)


def test_launcher_wal_crash_restart(tmp_path):
    snap = str(tmp_path / "snap")
    proc = _serve("--corpus", "2048", "--queries", "32", "--batches", "6", "--churn", "16",
                  "--compact-every", "3", "--repeat-frac", "0.5", "--snapshot-dir", snap,
                  "--wal", tmp_path=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "post-recovery results bit-identical" in proc.stdout
    assert "1 background handoff(s)" in proc.stdout
    # ... and a second run starts by recovering that snapshot + WAL.
    again = _serve("--corpus", "2048", "--queries", "32", "--batches", "2", "--snapshot-dir",
                   snap, "--restore", "--wal", tmp_path=tmp_path)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "recovered 2144 rows from snapshot + WAL" in again.stdout


def test_launcher_shards(tmp_path):
    proc = _serve("--corpus", "2048", "--queries", "32", "--batches", "4", "--shards", "2",
                  "--ivf-cells", "8", tmp_path=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "2 shard images" in proc.stdout
    assert "s0r0: cells [0, 4)" in proc.stdout and "s1r0: cells [4, 8)" in proc.stdout
    assert "index: 2048 rows, 0 dead" in proc.stdout


@pytest.mark.parametrize("argv, message", [
    (["--restore"], "--restore needs --snapshot-dir"),
    (["--wal"], "--wal needs --snapshot-dir"),
    (["--wal", "--snapshot-dir", "d", "--mesh"], "--wal is the single-host lifecycle tier"),
    (["--delta-budget", "4"], "--delta-budget/--sync-compact need --wal"),
    (["--sync-compact"], "--delta-budget/--sync-compact need --wal"),
    (["--wal", "--snapshot-dir", "d", "--delta-budget", "-1"], "--delta-budget must be >= 0"),
    (["--shards", "2"], "--shards needs --ivf-cells > 0"),
    (["--shards", "2", "--ivf-cells", "8", "--mesh"], "--shards and --mesh are alternative"),
    (["--shards", "2", "--ivf-cells", "8", "--churn", "4"], "--shards serves immutable"),
    (["--replicas", "2"], "--replicas/--fault-rate need --shards"),
    (["--fault-rate", "0.1"], "--replicas/--fault-rate need --shards"),
    (["--workers", "proc"], "--workers proc needs --shards"),
    (["--queue-depth", "0"], "--queue-depth must be >= 1"),
    (["--heartbeat-s", "-1"], "--heartbeat-s must be >= 0"),
    (["--shards", "2", "--ivf-cells", "8", "--replicas", "0"], "--replicas must be >= 1"),
    (["--shards", "2", "--ivf-cells", "8", "--fault-rate", "1.0"], "--fault-rate must be in"),
    (["--device", "tpu"], "--device must be"),
    (["--impl", "jnp"], "invalid choice"),
])
def test_launcher_flag_checks(argv, message, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err
