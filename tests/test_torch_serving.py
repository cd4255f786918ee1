"""The port's flat serving index and engine against the JAX package's.

One build/insert/upsert/delete/compact sequence is replayed on both indexes
and every search compared; ``from_arrays`` carries the reference's segment
state into the port.  Ids must be equal (random data, no exact ties);
distances agree to atol 1e-4 / rtol 1e-5 (fp32 matmuls blocked differently).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import EngineConfig as REngineConfig
from repro.serving import QueryEngine as RQueryEngine
from repro.serving import RetrievalIndex as RIndex
from repro_torch.accounting import ServingMeter
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.index import RetrievalIndex

CPU = dict(device="cpu")


def _same(p, r):
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))
    np.testing.assert_allclose(p.distances.numpy(), np.asarray(r.distances),
                               atol=1e-4, rtol=1e-5)


def _carry(ref, impl):
    return RetrievalIndex.from_arrays(
        ref._main_vecs, ref._main_ids, ref._main_live, ref._delta_vecs,
        ref._delta_ids, ref._delta_live, ref._delta_n, distance=ref.distance,
        impl=impl, **CPU)


@pytest.mark.parametrize("impl,rimpl,distance", [("torch", "jnp", "sqeuclidean"),
                                                 ("fused", "jnp", "neg_dot"),
                                                 ("kernel", "jnp", "sqeuclidean")])
def test_lifecycle_replay_matches_reference(impl, rimpl, distance):
    g = np.random.default_rng(1)
    d = 12
    vecs = g.standard_normal((150, d)).astype(np.float32)
    ids = g.permutation(10_000)[:150]
    q = g.standard_normal((9, d)).astype(np.float32)
    ref = RIndex.build(ids, vecs, distance=distance, impl=rimpl)
    port = RetrievalIndex.build(ids, vecs, distance=distance, impl=impl, **CPU)
    steps = [
        ("insert", (np.arange(20_000, 20_070), g.standard_normal((70, d)).astype(np.float32))),
        ("upsert", (ids[:30], g.standard_normal((30, d)).astype(np.float32))),
        ("delete", (ids[50:90],)),
        ("upsert", (np.arange(20_000, 20_010), g.standard_normal((10, d)).astype(np.float32))),
        ("compact", ()),
        ("delete", (np.arange(20_050, 20_070),)),
        ("insert", (np.arange(30_000, 30_005), g.standard_normal((5, d)).astype(np.float32))),
    ]
    for op, args in steps:
        out_r, out_p = getattr(ref, op)(*args), getattr(port, op)(*args)
        assert out_r == out_p
        assert len(ref) == len(port) and ref.n_dead == port.n_dead
        assert ref.shape_signature(10) == port.shape_signature(10)
        for k in (1, 7, 20):
            _same(port.search(q, k), ref.search(jnp.asarray(q), k))
        _same(_carry(ref, impl).search(q, 7), ref.search(jnp.asarray(q), 7))


def test_from_arrays_round_trips_the_port_state():
    g = np.random.default_rng(2)
    vecs = g.standard_normal((80, 8)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(80), vecs, **CPU)
    idx.upsert([3, 500], g.standard_normal((2, 8)).astype(np.float32))
    idx.delete([10, 11])
    twin = RetrievalIndex.from_arrays(idx._main_vecs, idx._main_ids, idx._main_live,
                                      idx._delta_vecs, idx._delta_ids, idx._delta_live,
                                      idx._delta_n, **CPU)
    q = g.standard_normal((5, 8)).astype(np.float32)
    a, b = idx.search(q, 6), twin.search(q, 6)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.distances, b.distances)
    assert len(twin) == len(idx) == 79 and 10 not in twin and 500 in twin


def test_fewer_live_rows_than_k_pads_like_reference():
    vecs = np.eye(4, 6, dtype=np.float32) * np.arange(1, 5, dtype=np.float32)[:, None]
    q = np.ones((2, 6), np.float32)
    ref = RIndex.build([7, 8, 9, 10], vecs)
    port = RetrievalIndex.build([7, 8, 9, 10], vecs, **CPU)
    for index in (ref, port):
        index.delete([8])
    _same(port.search(q, 5), ref.search(jnp.asarray(q), 5))
    assert port.search(q, 5).ids.numpy()[:, 3:].tolist() == [[-1, -1], [-1, -1]]
    empty = RetrievalIndex(6, **CPU)
    assert (empty.search(q, 3).ids.numpy() == -1).all()


def test_engine_batches_like_reference():
    g = np.random.default_rng(3)
    vecs = g.standard_normal((200, 16)).astype(np.float32)
    ref = RQueryEngine(RIndex.build(np.arange(200), vecs),
                       REngineConfig(k=5, min_batch=8, max_batch=32))
    port = QueryEngine(RetrievalIndex.build(np.arange(200), vecs, **CPU),
                       EngineConfig(k=5, min_batch=8, max_batch=32))
    q = g.standard_normal((70, 16)).astype(np.float32)
    _same(port.search(q), ref.search(q))
    # pow2 padding never changes a row's result
    solo = port.search(q[:1])
    assert torch.equal(solo.ids[0], port.search(q).ids[0])
    assert port._bucket(1) == ref._bucket(1) and port._bucket(70) == ref._bucket(70)
    # the queue: latest vector wins for a re-submitted request id
    for eng in (ref, port):
        eng.submit("a", q[0])
        eng.submit("b", q[1])
        eng.submit("a", q[2])
    rres, pres = ref.flush(), port.flush()
    assert set(rres) == set(pres) == {"a", "b"} and port.pending == 0
    for key in rres:
        np.testing.assert_array_equal(pres[key][1], rres[key][1])
    s = port.meter.summary()
    assert s["compile_batches"] >= 1 and s["batches"] + s["compile_batches"] >= 5
    port.rebind(RetrievalIndex.build(np.arange(5), vecs[:5], **CPU))
    assert port.search(q[:3]).ids.shape == (3, 5)


def test_serving_meter_matches_reference_statistics():
    from repro.accounting import ServingMeter as RMeter

    samples = [(8, 0.004), (8, 0.002), (16, 0.010), (4, 0.001), (8, 0.003)]
    r, p = RMeter(), ServingMeter()
    for i, (b, s) in enumerate(samples):
        r.record(b, s, compile_batch=(i == 0))
        p.record(b, s, compile_batch=(i == 0))
    rs, ps = r.summary(), p.summary()
    for key in ("batches", "queries", "qps", "p50_ms", "p99_ms", "mean_ms",
                "compile_batches", "compile_s"):
        assert rs[key] == pytest.approx(ps[key])


def test_unported_knobs_raise(tmp_path):
    # A mesh is served (the mesh cases below), but only the port's own
    # launch.mesh.Mesh, on a restore too.
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalIndex(8, mesh=object(), **CPU)
    with pytest.raises(ValueError):  # IVF-PQ needs its coarse quantizer
        RetrievalIndex(8, pq_m=4, **CPU)
    idx = RetrievalIndex.build(np.arange(4), np.ones((4, 8), np.float32), **CPU)
    # Snapshots are served (tests/test_torch_snapshot.py).
    idx.save(str(tmp_path / "snap"))
    with pytest.raises(TypeError, match="Mesh"):
        RetrievalIndex.restore(str(tmp_path / "snap"), mesh=object(), **CPU)
    # Tenants and filters are served (tests/test_torch_filters.py).
    from repro_torch.serving.filters import QueryFilter

    idx.insert([9], np.ones((1, 8), np.float32), tenants=[1])
    q = np.ones((1, 8), np.float32)
    assert idx.search(q, 2, filter=QueryFilter(tenant=1)).ids.tolist() == [[9, -1]]
    assert QueryEngine(idx).search(q, 2, filter=QueryFilter(tenant=1)).ids.tolist() == [[9, -1]]
    with pytest.raises(ValueError):
        idx.search(q, 2, filter=QueryFilter(mode="sideways"))


# ---------------------------------------------------------------------------
# The index on a mesh: the reference runs once for the file (one subprocess
# with 8 forced host devices, as tests/test_serving.py's mesh case), its
# segment state, trained cells and codes carried into the port through
# from_arrays; the port serves them on a (2, 4) mesh of CPU positions.
# ---------------------------------------------------------------------------

MESH_REFERENCE = """
import sys
import numpy as np, jax
from repro.core.ivf import ivf_to_arrays
from repro.data.synthetic import clustered_vectors
from repro.serving import RetrievalIndex

mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
rng = np.random.default_rng(0)
d, n = 16, 512
flat_vecs = rng.standard_normal((n, d)).astype(np.float32)
clu_vecs = clustered_vectors(n, d, n_clusters=16, seed=1)
fresh = rng.standard_normal((40, d)).astype(np.float32)
q = rng.standard_normal((10, d)).astype(np.float32)
cq = clustered_vectors(10, d, n_clusters=16, seed=2)
out["q"], out["cq"] = q, cq
cases = {"flat": (flat_vecs, {}), "int8": (flat_vecs, {"scan_dtype": "int8"}),
         "ivf_full": (clu_vecs, {"ivf_cells": 16, "nprobe": 10 ** 6}),
         "ivf_int8": (clu_vecs, {"ivf_cells": 16, "nprobe": 6, "scan_dtype": "int8"}),
         "ivfpq": (clu_vecs, {"ivf_cells": 16, "nprobe": 8, "pq_m": 4})}
for name, (vecs, kw) in cases.items():
    idx = RetrievalIndex.build(np.arange(n), vecs, mesh=mesh, **kw)
    idx.delete(np.arange(0, n, 7))
    idx.insert(np.arange(9000, 9040), fresh)
    res = idx.search(cq if "ivf" in name else q, 9)
    out[name + ".v"], out[name + ".i"] = np.asarray(res.distances), np.asarray(res.ids)
    for key in ("_main_vecs", "_main_ids", "_main_live", "_delta_vecs", "_delta_ids",
                "_delta_live"):
        out[f"{name}.{key}"] = getattr(idx, key)
    out[f"{name}._delta_n"] = np.asarray(idx._delta_n)
    if "ivf" in name:
        for key, val in ivf_to_arrays(idx._dev["main_ivf"]).items():
            out[f"{name}.ivf.{key}"] = val
    if name == "ivfpq":
        cb, codes = idx._dev["main_pq"]
        out["ivfpq.pq.codebooks"] = np.asarray(cb.codebooks)
        out["ivfpq.pq.codes"], out["ivfpq.pq.hy"] = np.asarray(codes.codes), np.asarray(codes.hy)
np.savez(sys.argv[1], **out)
print("OK")
"""

MESH_CASES = {"flat": {}, "int8": {"scan_dtype": "int8"},
              "ivf_full": {"nprobe": 10 ** 6}, "ivf_int8": {"nprobe": 6, "scan_dtype": "int8"},
              "ivfpq": {"nprobe": 8}}


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    from conftest import run_with_devices

    path = tmp_path_factory.mktemp("serving_mesh") / "reference.npz"
    run_with_devices(f"import sys\nsys.argv = ['', {str(path)!r}]\n" + MESH_REFERENCE)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _cpu_mesh(shape=(2, 4)):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, ("data", "model"), devices=[torch.device("cpu")] * int(np.prod(shape)))


def _carry_mesh(R, name, impl, mesh):
    """The reference's churned index ``name``, in the port on ``mesh``."""
    from repro_torch.core.ivf import ivf_from_arrays
    from repro_torch.core.pq import pq_from_arrays

    pre = name + "."
    st = {key: R[pre + key] for key in ("_main_vecs", "_main_ids", "_main_live", "_delta_vecs",
                                        "_delta_ids", "_delta_live")}
    ivf = pq = None
    if "ivf" in name:
        ivf = ivf_from_arrays({k[len(pre) + 4:]: R[k] for k in R if k.startswith(pre + "ivf.")},
                              **CPU)
    if name == "ivfpq":
        pq = pq_from_arrays({k[len(pre) + 3:]: R[k] for k in R if k.startswith(pre + "pq.")},
                            **CPU)
    return RetrievalIndex.from_arrays(
        st["_main_vecs"], st["_main_ids"], st["_main_live"], st["_delta_vecs"],
        st["_delta_ids"], st["_delta_live"], int(R[pre + "_delta_n"]), impl=impl, ivf=ivf,
        pq=pq, mesh=mesh, **MESH_CASES[name], **CPU)


@pytest.mark.parametrize("name", list(MESH_CASES))
def test_index_on_a_mesh_matches_reference(mesh_ref, name):
    """The index's flat, int8, IVF (full probe; pruned int8) and IVF-PQ
    mesh paths, tombstones and a delta included, against the reference's
    on the same mesh shape: ids equal except at near-ties, values at 1e-5
    (the bf16 wire's, where the tier ships one, within one bf16 rounding)."""
    from repro_torch.kernels import ref

    R = mesh_ref
    idx = _carry_mesh(R, name, "torch", _cpu_mesh())
    q = R["cq" if "ivf" in name else "q"]
    got = idx.search(q, 9)
    live_vecs, live_ids = idx._live_rows()
    pos = {int(i): r for r, i in enumerate(live_ids)}
    qt, vt = torch.from_numpy(q), torch.from_numpy(live_vecs)

    def dist(rows, ids):  # an external id's distance, recomputed from the live rows
        r = torch.tensor([pos[int(i)] for i in ids])
        return ((qt[rows].double() - vt[r].double()) ** 2).sum(1).float()

    wire = name in ("int8", "ivf_int8", "ivfpq")
    ref.check_topk(got.distances, got.ids.long(), torch.from_numpy(R[name + ".v"]),
                   torch.from_numpy(R[name + ".i"]).long(), n=10_000, dist=dist,
                   rtol=2.0 ** -8 if wire else 1e-5, atol=1e-5)
    assert not np.isin(got.ids.numpy(), np.arange(0, 512, 7)).any()


@pytest.mark.parametrize("name", ["flat", "ivf_full"])
def test_index_on_a_mesh_fused_equals_the_local_index(mesh_ref, name):
    """The kernel route on the mesh (``fused_knn`` or ``ivf_scan``, the
    rescore, the butterfly) serves the exact tiers as the local index does."""
    R = mesh_ref
    q = R["cq" if "ivf" in name else "q"]
    got = _carry_mesh(R, name, "fused", _cpu_mesh()).search(q, 9)
    want = _carry_mesh(R, name, "fused", None).search(q, 9)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())
    np.testing.assert_allclose(got.distances.numpy(), want.distances.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_index_on_a_mesh_post_filters_tenants():
    """Filters are post-filtered on a mesh (the sharded scorers take no
    bitmap): no id of another tenant, and the local index's post mode."""
    from repro_torch.serving.filters import QueryFilter

    g = np.random.default_rng(3)
    vecs = g.standard_normal((512, 16)).astype(np.float32)
    tenants = np.arange(512) % 3
    q = g.standard_normal((10, 16)).astype(np.float32)
    mesh_idx = RetrievalIndex.build(np.arange(512), vecs, tenants=tenants, mesh=_cpu_mesh(),
                                    **CPU)
    local = RetrievalIndex.build(np.arange(512), vecs, tenants=tenants, **CPU)
    for idx in (mesh_idx, local):
        idx.delete(np.arange(0, 512, 11))
    f = QueryFilter(tenant=np.full(10, 1))
    got = mesh_idx.search(q, 8, filter=f)
    assert bool(((got.ids < 0) | (got.ids % 3 == 1)).all())
    want = local.search(q, 8, filter=QueryFilter(tenant=np.full(10, 1), mode="post"))
    np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())


def test_mesh_ivf_cells_round_to_the_db_axis():
    from repro_torch.data.synthetic import clustered_vectors

    vecs = clustered_vectors(400, 8, n_clusters=8, seed=0)
    idx = RetrievalIndex(8, ivf_cells=30, mesh=_cpu_mesh((1, 4)), **CPU)
    assert idx._effective_ncells() == 0  # an empty main: the flat scan
    idx = RetrievalIndex.build(np.arange(400), vecs, ivf_cells=30, mesh=_cpu_mesh((1, 4)), **CPU)
    assert idx._effective_ncells() == 28
    small = RetrievalIndex.build(np.arange(12), vecs[:12], ivf_cells=30,
                                 mesh=_cpu_mesh((1, 4)), **CPU)
    assert small._effective_ncells() == 0 and not small._use_ivf()
    assert small.search(vecs[:2], 3).ids[:, 0].tolist() == [0, 1]
    idx._device_state()  # trains the 28 cells
    with pytest.raises(ValueError, match="resharded"):  # 28 cells over 3 shards
        RetrievalIndex.from_arrays(
            vecs, np.arange(400), np.ones(400, bool), np.zeros((0, 8), np.float32),
            np.zeros(0, np.int32), np.zeros(0, bool), 0, ivf=idx._dev["main_ivf"],
            mesh=_cpu_mesh((1, 3)), **CPU)
