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
    with pytest.raises(NotImplementedError):
        RetrievalIndex(8, mesh=object(), **CPU)
    with pytest.raises(ValueError):  # IVF-PQ needs its coarse quantizer
        RetrievalIndex(8, pq_m=4, **CPU)
    idx = RetrievalIndex.build(np.arange(4), np.ones((4, 8), np.float32), **CPU)
    # Snapshots are served (tests/test_torch_snapshot.py); a mesh is not,
    # on a restore either.
    idx.save(str(tmp_path / "snap"))
    with pytest.raises(NotImplementedError):
        RetrievalIndex.restore(str(tmp_path / "snap"), mesh=object(), **CPU)
    # Tenants and filters are served (tests/test_torch_filters.py).
    from repro_torch.serving.filters import QueryFilter

    idx.insert([9], np.ones((1, 8), np.float32), tenants=[1])
    q = np.ones((1, 8), np.float32)
    assert idx.search(q, 2, filter=QueryFilter(tenant=1)).ids.tolist() == [[9, -1]]
    assert QueryEngine(idx).search(q, 2, filter=QueryFilter(tenant=1)).ids.tolist() == [[9, -1]]
    with pytest.raises(ValueError):
        idx.search(q, 2, filter=QueryFilter(mode="sideways"))
