"""The port's snapshots (``repro_torch.serving.snapshot``) against the JAX
package's.

The cases of ``tests/test_snapshot.py`` on the port's index, on the CPU,
at the reference tests' sizes (n 1024, d 32): a restored index returns
bit-identical values and ids for every tier (flat fp32, int8 and bf16
two-stage, IVF, IVF-PQ) after churn, restores with no k-means
(``repro_torch.core.kmeans.lloyd`` made a tripwire) and resumes its
epochs; anything that cannot be served exactly raises ``SnapshotError``.
Then the two packages' snapshots restore in each other, without
arguments: ids identical, values allclose (rtol 1e-5, atol 1e-4: fp32
matmuls blocked differently), bit-identical within one package.  The
reference cannot read its own bf16 replica back (``TypeError`` on the
``V2`` bytes); the port reads those bytes as the reference's
``quantize_rows`` wrote them.

The case that drives ``serving/service.py``
(``test_service_restore_checks_config_and_serves``) waits for the port of
the service.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.distances import quantize_rows as rquantize
from repro.serving import RetrievalIndex as RIndex
from repro_torch.serving import EngineConfig, QueryEngine, RetrievalIndex, SnapshotError
from repro_torch.serving.snapshot import (
    FORMAT_VERSION,
    IMPL_FROM_REFERENCE,
    IMPL_TO_REFERENCE,
    read_manifest,
)

CPU = dict(device="cpu")
CONFIGS = {
    "flat": {},
    "int8": {"scan_dtype": "int8"},
    "bf16": {"scan_dtype": "bfloat16"},
    "ivf": {"ivf_cells": 16, "nprobe": 4},
    "ivfpq": {"ivf_cells": 16, "nprobe": 8, "pq_m": 8},
}


def _churn(idx, rng, n, d):
    """Main tombstones, delta rows, and an id upserted twice inside the
    delta (a dead and a live row under one id)."""
    idx.delete(np.arange(0, n, 13))
    idx.upsert(np.arange(n, n + 48), rng.standard_normal((48, d)).astype(np.float32))
    idx.upsert(np.arange(n, n + 6), rng.standard_normal((6, d)).astype(np.float32))
    idx.delete([n + 2])


def _churned_index(kw, n=1024, d=32, seed=0, cls=RetrievalIndex, **extra):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    idx = cls.build(np.arange(n), vecs, **kw, **extra)
    _churn(idx, rng, n, d)
    q = rng.standard_normal((24, d)).astype(np.float32)
    return idx, q


def _port(kw, **more):
    return _churned_index(kw, **CPU, **more)


def _cpu_mesh(shape):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), devices=[torch.device("cpu")] * int(np.prod(shape)))


def _assert_bit_identical(a, b):
    assert torch.equal(a.ids, b.ids)
    assert torch.equal(a.distances, b.distances)


def _assert_same_as_reference(port_res, ref_res):
    np.testing.assert_array_equal(port_res.ids.numpy(), np.asarray(ref_res.ids))
    np.testing.assert_allclose(port_res.distances.numpy(), np.asarray(ref_res.distances),
                               rtol=1e-5, atol=1e-4)


@pytest.fixture
def no_training(monkeypatch):
    """Make k-means a tripwire (every trainer looks it up when it runs)."""
    import repro_torch.core.kmeans as KM

    def tripwire(*a, **kw):
        raise AssertionError("kmeans.lloyd entered on the restore path")

    monkeypatch.setattr(KM, "lloyd", tripwire)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_roundtrip_bit_identical_after_churn(name, tmp_path):
    idx, q = _port(CONFIGS[name])
    want = idx.search(q, 10)
    snap = str(tmp_path / name)
    idx.save(snap)
    _assert_bit_identical(want, RetrievalIndex.restore(snap, **CPU).search(q, 10))


def test_restore_does_zero_training_and_resumes_epochs(tmp_path, monkeypatch):
    idx, q = _port(CONFIGS["ivfpq"])
    idx.compact()  # epoch 2: the resumed counter must survive the trip
    want = idx.search(q, 10)
    sig = idx.shape_signature(10)
    snap = str(tmp_path / "snap")
    idx.save(snap)
    import repro_torch.core.kmeans as KM

    def tripwire(*a, **kw):
        raise AssertionError("kmeans.lloyd entered on the restore path")

    monkeypatch.setattr(KM, "lloyd", tripwire)
    restored = RetrievalIndex.restore(snap, **CPU)
    _assert_bit_identical(want, restored.search(q, 10))
    assert restored._main_epoch == idx._main_epoch == 2
    assert restored.shape_signature(10) == sig
    # The tripwire is live: a compact's retrain would enter it.
    restored.compact()
    with pytest.raises(AssertionError, match="lloyd"):
        restored.search(q, 10)


def test_restored_index_keeps_working_through_the_lifecycle(tmp_path):
    """Post-restore mutations and a compact behave as on the source."""
    idx, q = _port(CONFIGS["ivf"], seed=3)
    snap = str(tmp_path / "snap")
    idx.save(snap)
    restored = RetrievalIndex.restore(snap, **CPU)
    fresh = np.random.default_rng(9).standard_normal((20, idx.dim)).astype(np.float32)
    for i in (idx, restored):
        i.delete(np.arange(100, 140))
        i.insert(np.arange(5000, 5020), fresh)
        i.compact()  # epochs resumed equal: the k-means seed matches too
    _assert_bit_identical(idx.search(q, 10), restored.search(q, 10))


@pytest.mark.parametrize("name", ["int8", "bf16", "ivf"])
def test_restore_without_replicas_is_still_bit_identical(name, tmp_path):
    idx, q = _port(CONFIGS[name], seed=5)
    want = idx.search(q, 10)
    snap = str(tmp_path / "snap")
    idx.save(snap, include_replicas=False)
    assert not os.path.exists(os.path.join(snap, "replica.npz"))
    _assert_bit_identical(want, RetrievalIndex.restore(snap, **CPU).search(q, 10))


def test_save_over_existing_snapshot_replaces_atomically(tmp_path):
    idx, q = _port(CONFIGS["flat"], seed=13)
    snap = str(tmp_path / "snap")
    idx.save(snap)
    idx.insert([77777], np.zeros((1, idx.dim), np.float32))
    want = idx.search(q, 10)
    idx.save(snap)  # replace in place
    _assert_bit_identical(want, RetrievalIndex.restore(snap, **CPU).search(q, 10))
    leftovers = [p for p in os.listdir(tmp_path) if ".tmp-" in p or ".old-" in p]
    assert leftovers == [], leftovers


def test_empty_delta_and_no_churn_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(300), vecs, **CPU)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    snap = str(tmp_path / "snap")
    idx.save(snap)
    restored = RetrievalIndex.restore(snap, **CPU)
    _assert_bit_identical(idx.search(q, 5), restored.search(q, 5))
    assert restored._delta_n == 0 and len(restored) == 300


def test_restore_nprobe_above_trained_ncells(tmp_path):
    """``nprobe`` past the trained cell count clamps, and the clamp survives
    the round trip."""
    idx, q = _port(dict(ivf_cells=16, nprobe=64), seed=17)
    assert idx._effective_ncells() == 16
    assert idx.nprobe == 64 and idx.effective_nprobe() == 16
    ref, _ = _port(dict(ivf_cells=16, nprobe=16), seed=17)
    _assert_bit_identical(ref.search(q, 10), idx.search(q, 10))
    snap = str(tmp_path / "snap")
    idx.save(snap)
    restored = RetrievalIndex.restore(snap, **CPU)
    assert restored.nprobe == 64 and restored.effective_nprobe() == 16
    _assert_bit_identical(idx.search(q, 10), restored.search(q, 10))


# -- hard-fail paths ---------------------------------------------------------


def _tamper_manifest(snap, fn):
    path = os.path.join(snap, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    fn(m)
    with open(path, "w") as f:
        json.dump(m, f)


def _saved(tmp_path, name, **kw):
    idx, _ = _port(CONFIGS[name], **kw)
    snap = str(tmp_path / "snap")
    idx.save(snap)
    return idx, snap


def test_format_version_mismatch_raises(tmp_path):
    _, snap = _saved(tmp_path, "flat")
    _tamper_manifest(snap, lambda m: m.update(format_version=FORMAT_VERSION + 1))
    with pytest.raises(SnapshotError, match="format_version"):
        RetrievalIndex.restore(snap, **CPU)


def test_torn_save_raises(tmp_path):
    _, snap = _saved(tmp_path, "flat")
    _tamper_manifest(snap, lambda m: m.update(complete=False))
    with pytest.raises(SnapshotError, match="incomplete"):
        RetrievalIndex.restore(snap, **CPU)


def test_truncated_segment_file_raises(tmp_path):
    _, snap = _saved(tmp_path, "ivf")
    main = os.path.join(snap, "main.npz")
    with open(main, "r+b") as f:
        f.truncate(os.path.getsize(main) // 2)
    with pytest.raises(SnapshotError, match="corrupted/truncated"):
        RetrievalIndex.restore(snap, **CPU)


def test_corrupted_trained_segment_raises(tmp_path):
    _, snap = _saved(tmp_path, "ivf")
    path = os.path.join(snap, "ivf.npz")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(SnapshotError, match="corrupted/truncated"):
        RetrievalIndex.restore(snap, **CPU)


def test_missing_segment_file_raises(tmp_path):
    _, snap = _saved(tmp_path, "ivfpq")
    os.remove(os.path.join(snap, "pq.npz"))
    with pytest.raises(SnapshotError, match="missing"):
        RetrievalIndex.restore(snap, **CPU)


def test_truncated_journal_raises(tmp_path):
    _, snap = _saved(tmp_path, "flat")
    jpath = os.path.join(snap, "journal.bin")
    with open(jpath, "r+b") as f:
        f.truncate(os.path.getsize(jpath) - 7)
    with pytest.raises(SnapshotError):
        RetrievalIndex.restore(snap, **CPU)


def test_manifest_array_signature_mismatch_raises(tmp_path):
    idx, snap = _saved(tmp_path, "ivf")
    _tamper_manifest(snap, lambda m: m["config"].update(dim=idx.dim * 2))
    with pytest.raises(SnapshotError, match="mismatch"):
        RetrievalIndex.restore(snap, **CPU)
    idx.save(snap)
    assert read_manifest(snap)["config"]["ivf_cells"] == 16


def test_ivf_permutation_validation_rejects_corruption():
    from repro_torch.core.ivf import build_ivf, ivf_from_arrays, ivf_to_arrays

    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((600, 16)).astype(np.float32)
    ivf = build_ivf(vecs, 4, generator=torch.Generator().manual_seed(0), **CPU)
    arrays = ivf_to_arrays(ivf)
    ok = ivf_from_arrays(arrays, **CPU)
    assert ok.ncells == ivf.ncells and ok.cell_cap == ivf.cell_cap
    broken = dict(arrays)
    perm = arrays["slot_of_row"].copy()
    perm[0] = perm[1]  # two rows claim one slot
    broken["slot_of_row"] = perm
    with pytest.raises(ValueError, match="round-trip"):
        ivf_from_arrays(broken, **CPU)
    broken = dict(arrays)
    broken["counts"] = arrays["counts"] + 1
    with pytest.raises(ValueError, match="counts"):
        ivf_from_arrays(broken, **CPU)


def test_pq_validation_rejects_out_of_range_codes():
    from repro_torch.core.pq import pq_from_arrays

    cbs = np.zeros((4, 16, 2), np.float32)
    codes = np.zeros((32, 4), np.uint8)
    hy = np.zeros((32,), np.float32)
    cb, _ = pq_from_arrays({"codebooks": cbs, "codes": codes, "hy": hy}, **CPU)
    assert cb.m == 4 and cb.ncodes == 16
    codes_bad = codes.copy()
    codes_bad[3, 1] = 16
    with pytest.raises(ValueError, match="out of codebook range"):
        pq_from_arrays({"codebooks": cbs, "codes": codes_bad, "hy": hy}, **CPU)


# -- fresh process, mesh, engine ---------------------------------------------


def test_fresh_process_restore_bit_identical(tmp_path):
    """A restore shares no state with the process that built the index:
    the snapshot check's fresh process, k-means a tripwire there."""
    from repro_torch.launch.snapshot_check import _RESTORE_SNIPPET, run_fresh, save_expected

    idx, q = _port(CONFIGS["ivfpq"], seed=7)
    snap = str(tmp_path / "snap")
    expected = save_expected(idx, snap, q, 10)
    got = run_fresh(_RESTORE_SNIPPET, snap, expected, "cpu")
    assert got["bit_identical"] and got["live_rows"] == len(idx)


def test_restore_onto_a_mesh_raises(tmp_path):
    """A cell layout cannot be resharded: a restore onto a mesh whose db
    axis derives another cell count than the image trained (16 cells over 3
    shards: 15) raises, and one that divides it serves the same results
    (with the queries unsharded, so each query tile scans the union of the
    same probes as on one device)."""
    idx, snap = _saved(tmp_path, "ivf")
    with pytest.raises(SnapshotError, match="resharded"):
        RetrievalIndex.restore(snap, mesh=_cpu_mesh((1, 3)), **CPU)
    q = np.random.default_rng(5).standard_normal((8, 32)).astype(np.float32)
    got = RetrievalIndex.restore(snap, mesh=_cpu_mesh((1, 4)), **CPU).search(q, 10)
    want = idx.search(q, 10)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())
    np.testing.assert_allclose(got.distances.numpy(), want.distances.numpy(), rtol=1e-5,
                               atol=1e-5)


MESH_REFERENCE = """
import sys, json
import numpy as np, jax
from repro.serving import RetrievalIndex, SnapshotError

port_snap, ref_snap, ivf_snap, out_path = sys.argv[1:5]
mesh = jax.make_mesh((1, 8), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
try:  # the port's image: 20 cells, which 8 shards cannot hold
    RetrievalIndex.restore(port_snap, mesh=mesh)
    out["port_image_raised"] = ""
except SnapshotError as e:
    out["port_image_raised"] = str(e)
rng = np.random.default_rng(0)
RetrievalIndex.build(np.arange(2048), rng.standard_normal((2048, 32)).astype(np.float32),
                     ivf_cells=20, nprobe=4, impl="jnp").save(ref_snap)
# An image that 8 shards can hold (16 cells), restored onto the mesh and searched.
rng = np.random.default_rng(1)
vecs = rng.standard_normal((1024, 32)).astype(np.float32)
idx = RetrievalIndex.build(np.arange(1024), vecs, ivf_cells=16, nprobe=4, impl="jnp")
idx.delete(np.arange(0, 1024, 13))
idx.upsert(np.arange(1024, 1072), rng.standard_normal((48, 32)).astype(np.float32))
q = rng.standard_normal((8, 32)).astype(np.float32)
idx.search(q, 10)
idx.save(ivf_snap)
res = RetrievalIndex.restore(ivf_snap, mesh=mesh).search(q, 10)
vecs, ids = idx._live_rows()
np.savez(out_path, q=q, v=np.asarray(res.distances), i=np.asarray(res.ids), vecs=vecs, ids=ids)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The reference's side of the mesh restores, from one subprocess with
    8 forced host devices: it restores the port's 20-cell image onto its
    (1, 8) mesh, and saves its own 20-cell image and a 16-cell one, which
    it restores onto that mesh and searches."""
    from conftest import run_with_devices

    base = tmp_path_factory.mktemp("snapshot_mesh")
    port_snap = str(base / "port20")
    _saved_port = _churned_index(dict(ivf_cells=20, nprobe=4), n=2048, **_PKW)[0]
    assert _saved_port._effective_ncells() == 20
    _saved_port.save(port_snap)
    paths = [port_snap, str(base / "ref20"), str(base / "ref16"), str(base / "out.npz")]
    stdout = run_with_devices(f"import sys\nsys.argv = [''] + {paths!r}\n" + MESH_REFERENCE)
    with np.load(paths[3]) as z:
        return dict(json.loads(stdout.strip().splitlines()[-1]), snaps=paths[:3],
                    **{key: z[key] for key in z.files})


def test_restore_onto_an_incompatible_mesh_raises_both_ways(mesh_ref):
    """20 trained cells on a (1, 8) mesh, which derives 16: the reference
    refuses the port's image, and the port the reference's, with the
    reference's message."""
    assert "resharded" in mesh_ref["port_image_raised"]
    with pytest.raises(SnapshotError, match="resharded"):
        RetrievalIndex.restore(mesh_ref["snaps"][1], mesh=_cpu_mesh((1, 8)), **CPU)


def test_reference_image_restored_onto_a_mesh_matches_reference(mesh_ref):
    """The reference's 16-cell image, restored by each package onto a
    (1, 8) mesh and searched (the reference's scorer, ``jnp`` -> ``torch``):
    ids equal except at near-ties, values at 1e-5."""
    from repro_torch.kernels import ref

    idx = RetrievalIndex.restore(mesh_ref["snaps"][2], mesh=_cpu_mesh((1, 8)), **CPU)
    assert idx.impl == "torch" and idx._dev["main_ivf"].ncells == 16
    got = idx.search(mesh_ref["q"], 10)
    qt, vt = torch.from_numpy(mesh_ref["q"]), torch.from_numpy(mesh_ref["vecs"])
    row = {int(i): r for r, i in enumerate(mesh_ref["ids"])}

    def dist(rows, ids):
        r = torch.tensor([row[int(i)] for i in ids])
        return ((qt[rows].double() - vt[r].double()) ** 2).sum(1).float()

    ref.check_topk(got.distances, got.ids.long(), torch.from_numpy(mesh_ref["v"]),
                   torch.from_numpy(mesh_ref["i"]).long(), n=1072, dist=dist, rtol=1e-5,
                   atol=1e-5)


def test_engine_rebind_resets_compile_tracking(tmp_path):
    idx, q = _port(CONFIGS["flat"], seed=11)
    eng = QueryEngine(idx, EngineConfig(k=8, min_batch=8, max_batch=64))
    eng.search(q, 8)
    assert eng.meter.summary()["compile_batches"] == 1
    snap = str(tmp_path / "snap")
    idx.save(snap)
    restored = RetrievalIndex.restore(snap, **CPU)
    eng.rebind(restored)
    assert eng.index is restored
    r1 = eng.search(q, 8)
    assert eng.meter.summary()["compile_batches"] == 2
    _assert_bit_identical(idx.search(q, 8), r1)


# -- across the two packages -------------------------------------------------

# The reference scores with its jnp tiles (its default); the port's "torch"
# maps to it in the manifest.
_RKW = dict(impl="jnp")
_PKW = dict(impl="torch", **CPU)


def test_impl_names_map_both_ways():
    assert IMPL_TO_REFERENCE == {"torch": "jnp", "kernel": "pallas", "fused": "fused"}
    assert {IMPL_TO_REFERENCE[v]: v for v in IMPL_FROM_REFERENCE.values()} == IMPL_FROM_REFERENCE


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_snapshot_restores_in_the_port(name, tmp_path, no_training):
    ref, q = _churned_index(CONFIGS[name], cls=RIndex, **_RKW)
    want = ref.search(q, 10)
    snap = str(tmp_path / name)
    ref.save(snap)
    port = RetrievalIndex.restore(snap, **CPU)
    assert port.impl == "torch" and port._main_epoch == ref._main_epoch
    assert port._loc == ref._loc and port._delta_n == ref._delta_n
    got = port.search(q, 10)
    _assert_same_as_reference(got, want)
    # Within the port, a second round trip is bit-identical.
    port.save(str(tmp_path / "again"))
    _assert_bit_identical(got, RetrievalIndex.restore(str(tmp_path / "again"), **CPU)
                          .search(q, 10))


@pytest.mark.parametrize("name", ["flat", "int8", "ivf", "ivfpq"])
def test_port_snapshot_restores_in_the_reference(name, tmp_path):
    port, q = _churned_index(CONFIGS[name], **_PKW)
    want = port.search(q, 10)
    snap = str(tmp_path / name)
    port.save(snap)
    assert read_manifest(snap)["impl"] == "jnp"
    ref = RIndex.restore(snap)
    assert ref.impl == "jnp" and ref._main_epoch == port._main_epoch
    assert ref._loc == port._loc
    _assert_same_as_reference(want, ref.search(q, 10))
    if name in ("ivf", "ivfpq"):  # the same trained cells on both sides
        np.testing.assert_array_equal(np.asarray(ref._dev["main_ivf"].row_of_slot),
                                      port._dev["main_ivf"].row_of_slot.numpy())


def test_bf16_replica_bytes_cross_the_packages(tmp_path):
    """The reference cannot restore a bf16 snapshot with its replica (its
    ``V2`` bytes are no JAX dtype); the port restores it, the replica's
    words equal to the reference's ``quantize_rows``, and restores the
    reference's own bf16 snapshot the same way.  Without the replica the
    reference restores the port's snapshot."""
    port, q = _churned_index(CONFIGS["bf16"], **_PKW)
    want = port.search(q, 10)
    snap = str(tmp_path / "port")
    port.save(snap)
    with pytest.raises(TypeError, match="V2"):
        RIndex.restore(snap)
    restored = RetrievalIndex.restore(snap, **CPU)
    ref_words = np.asarray(rquantize(jnp.asarray(port._main_vecs), "bfloat16").data).view(
        np.int16)
    for idx in (port, restored):
        got_words = idx._dev["main_q"].data.view(torch.int16).numpy()
        np.testing.assert_array_equal(got_words, ref_words)
    _assert_bit_identical(want, restored.search(q, 10))

    ref, rq = _churned_index(CONFIGS["bf16"], cls=RIndex, **_RKW)
    rsnap = str(tmp_path / "ref")
    ref.save(rsnap)
    from_ref = RetrievalIndex.restore(rsnap, **CPU)
    np.testing.assert_array_equal(from_ref._dev["main_q"].data.view(torch.int16).numpy(),
                                  np.asarray(ref._device_state()["main_q"].data).view(np.int16))
    _assert_same_as_reference(from_ref.search(rq, 10), ref.search(rq, 10))

    port.save(snap, include_replicas=False)
    _assert_same_as_reference(want, RIndex.restore(snap).search(q, 10))


def test_port_journal_replays_tenants_and_dead_rows_in_the_reference(tmp_path):
    """The delta journal's per-row liveness and tenant tags cross too."""
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((256, 16)).astype(np.float32)
    port = RetrievalIndex.build(np.arange(256), vecs, tenants=np.arange(256) % 3, **_PKW)
    port.upsert(np.arange(300, 340), rng.standard_normal((40, 16)).astype(np.float32),
                tenants=np.full(40, 7))
    port.upsert(np.arange(300, 310), rng.standard_normal((10, 16)).astype(np.float32))
    snap = str(tmp_path / "snap")
    port.save(snap)
    ref = RIndex.restore(snap)
    n = port._delta_n
    assert ref._delta_n == n
    np.testing.assert_array_equal(ref._delta_live[:n], port._delta_live[:n])
    np.testing.assert_array_equal(ref._delta_tenant[:n], port._delta_tenant[:n])
    np.testing.assert_array_equal(ref._main_tenant, port._main_tenant)


@pytest.mark.parametrize("shape,dtype", [((37, 5), torch.float32), ((1000,), torch.int32),
                                         ((9, 3, 4), torch.uint8), ((0, 4), torch.float32)])
def test_host_copies_go_in_blocks_and_keep_every_byte(monkeypatch, shape, dtype):
    """The card's copies of a snapshot's arrays go a block of rows at a time
    (``core.ivf._copy_rows``); with a block of 64 bytes every row still
    lands where it belongs."""
    from repro_torch.core import ivf as PIVF

    monkeypatch.setattr(PIVF, "_COPY_BYTES", 64)
    src = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape).to(dtype)
    dst = torch.empty_like(src)
    PIVF._copy_rows(dst, src)
    assert torch.equal(dst, src)
