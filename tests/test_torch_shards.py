"""The port's shard fleet (``repro_torch.serving.shards`` and the snapshot's
shard images) against the JAX package's.

At the reference tests' shape (``tests/test_shards.py``: n 2048, d 32, 16
cells, 4 shards).  The reference runs once, in the module-scoped fixture
``R``: it builds an IVF-PQ index in the exhaustive regime (nprobe = ncells,
an overfetch spanning the corpus) and one at serving settings (nprobe 8),
snapshots the first and cuts both into shard images, restores the port's
images into its own workers, and searches its own fleet (plain and
filtered) and each case of its ``aggregate_topk``; everything comes back
as numpy.  The port then runs
on the CPU, where every kernel wrapper runs its plain version.

Held: ``plan_shards`` is a partition and routing finds each cell's owner;
``aggregate_topk`` equals the reference's bit for bit (ties, +inf/-1
padding, non-pow2 shard counts, the bf16 wire); the two packages cut one
index into byte-equal images with equal fingerprints, and each restores the
other's; the router equals the port's own ``index.search`` bit for bit in
the exhaustive regime; at ``impl="torch"`` and nprobe 8 the port's fleet
returns the reference fleet's ids on the same images, values allclose
(rtol 1e-6, atol 1e-5); at ``impl="fused"`` it is held to the port's own
per-shard union scan (ROADMAP's deliberate difference); the in-process
fleet equals the (1, 4)-mesh scorer bit for bit; assembly refuses torn
fleets; ``QueryEngine`` carries coverage through its chunks; tenant
filters are refused and allow-lists and exclusions return the reference's
ids.
"""
import json
import os
import shutil

import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest
import torch

from repro_torch.core import topk as T
from repro_torch.core.knn import quantized_scan, rescore
from repro_torch.core.pq import pq_cell_bias
from repro_torch.kernels import ref as KR
from repro_torch.serving import (
    EngineConfig,
    FaultPolicy,
    FaultyWorker,
    MissingShardError,
    QueryEngine,
    QueryFilter,
    RetrievalIndex,
    ShardRouter,
    ShardSpec,
    ShardWorker,
    SnapshotError,
    aggregate_topk,
    load_fleet,
    load_router,
    plan_shards,
)
from repro_torch.serving.snapshot import (
    read_fleet_manifest,
    restore_index,
    restore_shard,
    save_shards,
    shard_dirs,
)

N, D, K, NCELLS, NSHARDS = 2048, 32, 10, 16, 4
# nprobe = ncells and an overfetch window spanning the corpus: the routed and
# the single-host path both reduce to the exact rescored top-k of every live
# row, the bit-identity regime (DESIGN.md §13).
EXHAUSTIVE = dict(ivf_cells=NCELLS, nprobe=NCELLS, pq_m=8, overfetch=128)
DEFAULTS = dict(ivf_cells=NCELLS, nprobe=8, pq_m=8, overfetch=4)
CPU = dict(device="cpu")
VALUES = dict(rtol=1e-6, atol=1e-5)
AGG_CASES = [(1, 2, 1, False), (2, 3, 3, True), (3, 1, 4, False), (4, 2, 7, True),
             (5, 3, 10, False), (6, 2, 16, True), (3, 2, 10, True)]


def _agg_inputs(S, m, k, seed):
    """Sorted per-shard runs with heavy duplicate-distance ties and +inf/-1
    padding (the reference test's generator)."""
    Kp = T.next_pow2(k)
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, size=(S, m, Kp)).astype(np.float32)
    ids = (np.arange(S)[:, None, None] * 1000 + np.arange(m)[None, :, None] * 100
           + np.arange(Kp)[None, None, :]).astype(np.int32)
    dead = rng.random((S, m, Kp)) < 0.3
    vals[dead] = np.inf
    ids[dead] = -1
    order = np.argsort(vals, axis=-1, kind="stable")
    return np.take_along_axis(vals, order, -1), np.take_along_axis(ids, order, -1)


def _filters():
    rng = np.random.default_rng(11)
    allowed = np.sort(rng.choice(N, N // 2, replace=False)).astype(np.int32)
    exclude = rng.choice(N, (24, 5), replace=False).astype(np.int32)
    return allowed, exclude


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    """The reference's side of every case, run once."""
    import jax.numpy as jnp

    from repro.data.synthetic import clustered_vectors
    from repro.serving import QueryFilter as RFilter
    from repro.serving import RetrievalIndex as RIndex
    from repro.serving import aggregate_topk as raggregate
    from repro.serving import load_router as rload_router
    from repro.serving.snapshot import restore_shard as rrestore_shard
    from repro.serving.snapshot import save_shards as rsave_shards
    from repro.serving.snapshot import shard_dirs as rshard_dirs

    base = tmp_path_factory.mktemp("torch_shards")
    out = {"base": base}
    vecs = clustered_vectors(N, D, seed=7)
    q = clustered_vectors(24, D, seed=9)
    out.update(vecs=vecs, q=q)
    ex = RIndex.build(np.arange(N), vecs, **EXHAUSTIVE)
    out["snap"] = str(base / "snap")
    ex.save(out["snap"])
    out["ex_root"] = str(base / "ref_ex")
    rsave_shards(ex, out["ex_root"], NSHARDS, replicas=2)
    out["ex_search"] = ex.search(q, K)
    # The port's images of the same index, cut from the port's restore of
    # the reference's snapshot, and read back by the reference.
    port_idx = out["port_idx"] = restore_index(out["snap"], **CPU)
    out["port_ex_root"] = str(base / "port_ex")
    save_shards(port_idx, out["port_ex_root"], NSHARDS, replicas=2)
    out["ref_on_port_images"] = []
    for d in rshard_dirs(out["port_ex_root"]):
        w = rrestore_shard(d)
        out["ref_on_port_images"].append((tuple(w.spec), w.cell_cap, w.impl, {
            "packed": np.asarray(w.packed), "ids": np.asarray(w.ids_of_slot),
            "live": np.asarray(w.live), "codes": np.asarray(w.pq_codes.codes),
            "hy": np.asarray(w.pq_codes.hy), "codebooks": np.asarray(w.pq_cb.codebooks)}))
    # Serving settings: the reference's fleet, plain and filtered.
    de = RIndex.build(np.arange(N), vecs, **DEFAULTS)
    out["de_root"] = str(base / "ref_de")
    rsave_shards(de, out["de_root"], NSHARDS)
    fleet = rload_router(rshard_dirs(out["de_root"]), impl="jnp")
    allowed, exclude = _filters()
    out["de"] = fleet.search(q, K)
    out["de_allow"] = fleet.search(q, K, filter=RFilter(allowed_ids=allowed))
    out["de_exclude"] = fleet.search(q, K, filter=RFilter(exclude_ids=exclude))
    out["agg"] = []
    for c, (S, m, k, wire) in enumerate(AGG_CASES):
        v, i = _agg_inputs(S, m, k, seed=100 + c)
        r = raggregate(jnp.asarray(v), jnp.asarray(i), k,
                       wire_dtype="bfloat16" if wire else None)
        out["agg"].append((v, i, np.asarray(r.distances), np.asarray(r.indices)))
    for key in ("ex_search", "de", "de_allow", "de_exclude"):
        out[key] = (np.asarray(out[key].distances), np.asarray(out[key].ids))
    return out


def _assert_bit_identical(a, b):
    assert torch.equal(torch.as_tensor(a.ids), torch.as_tensor(b.ids))
    assert torch.equal(torch.as_tensor(a.distances), torch.as_tensor(b.distances))


def _assert_reference(res, want):
    np.testing.assert_array_equal(res.ids.numpy(), want[1])
    np.testing.assert_allclose(res.distances.numpy(), want[0], **VALUES)


# -- partition and routing ----------------------------------------------------


def _tiny_worker(spec, ncells, fingerprint="f0"):
    cap, d = 2, 4
    cfg = dict(dim=d, distance="sqeuclidean", scan_dtype="float32", overfetch=4,
               ivf_cells=ncells, nprobe=4, pq_m=0, pq_nbits=8)
    n_loc = spec.ncells_local * cap
    return ShardWorker(spec, centroids=np.zeros((ncells, d), np.float32),
                       packed=np.zeros((n_loc, d), np.float32),
                       ids_of_slot=np.arange(n_loc, dtype=np.int32),
                       live=np.ones(n_loc, bool), config=cfg,
                       parent={"fingerprint": fingerprint}, **CPU)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(ncells=st.integers(1, 64), n_shards=st.integers(1, 64),
                  replicas=st.integers(1, 3))
def test_plan_shards_is_a_partition(ncells, n_shards, replicas):
    if n_shards > ncells:
        with pytest.raises(ValueError, match="n_shards"):
            plan_shards(ncells, n_shards, replicas)
        return
    specs = plan_shards(ncells, n_shards, replicas)
    assert len(specs) == n_shards * replicas
    widths = {s.ncells_local for s in specs}
    assert max(widths) - min(widths) <= 1 and min(widths) >= 1
    for c in range(ncells):
        owners = {s.shard_id for s in specs if s.cell_lo <= c < s.cell_hi}
        assert len(owners) == 1
    assert [(s.shard_id, s.replica) for s in specs] == \
        [(i, r) for i in range(n_shards) for r in range(replicas)]


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(n_shards=st.integers(1, NCELLS), seed=st.integers(0, 100_000),
                  use_plan=st.booleans())
def test_routing_finds_the_unique_owner(n_shards, seed, use_plan):
    rng = np.random.default_rng(seed)
    if use_plan:
        specs = plan_shards(NCELLS, n_shards)
    else:
        cuts = sorted(rng.choice(np.arange(1, NCELLS), size=n_shards - 1,
                                 replace=False).tolist())
        bounds = [0] + cuts + [NCELLS]
        specs = [ShardSpec(i, n_shards, bounds[i], bounds[i + 1]) for i in range(n_shards)]
    router = ShardRouter([_tiny_worker(s, NCELLS) for s in specs])
    probe = rng.integers(0, NCELLS, size=(3, int(rng.integers(1, 8))))
    owners = router.owners_of(probe)
    assert owners.shape == probe.shape
    for c, o in zip(probe.ravel(), owners.ravel()):
        w = router.workers[o].spec
        assert w.cell_lo <= c < w.cell_hi


# -- the aggregator ------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(AGG_CASES)))
def test_aggregate_equals_the_reference_bit_for_bit(R, case):
    S, m, k, wire = AGG_CASES[case]
    v, i, rv, ri = R["agg"][case]
    got = aggregate_topk(torch.from_numpy(v), torch.from_numpy(i), k,
                         wire_dtype="bfloat16" if wire else None)
    assert got.distances.shape == got.indices.shape == (m, k)
    np.testing.assert_array_equal(got.distances.numpy(), rv)
    np.testing.assert_array_equal(got.indices.numpy(), ri)
    # And the flat sort of the concatenated runs, where the wire is exact.
    if not wire:
        for j in range(m):
            flat = np.sort(v[:, j, :].ravel(), kind="stable")[:k]
            np.testing.assert_array_equal(got.distances[j].numpy(), flat)


def test_aggregate_refuses_an_unknown_wire():
    v, i = _agg_inputs(2, 1, 4, seed=0)
    with pytest.raises(ValueError, match="wire_dtype"):
        aggregate_topk(torch.from_numpy(v), torch.from_numpy(i), 4, wire_dtype="float16")


# -- shard images across the packages -----------------------------------------


def test_save_shards_writes_the_references_bytes(R):
    """One index (the reference's, restored in the port) cut by each package:
    equal fingerprints, equal manifests' shard/parent blocks, byte-equal
    arrays in shard.npz and pq.npz."""
    ref_root, port_root = R["ex_root"], R["port_ex_root"]
    rm, pm = read_fleet_manifest(ref_root), read_fleet_manifest(port_root)
    assert rm == pm
    for rd, pd in zip(shard_dirs(ref_root), shard_dirs(port_root), strict=True):
        assert os.path.basename(rd) == os.path.basename(pd)
        with open(os.path.join(rd, "manifest.json")) as f:
            rman = json.load(f)
        with open(os.path.join(pd, "manifest.json")) as f:
            pman = json.load(f)
        for key in ("shard", "parent", "config", "impl", "format_version"):
            assert rman[key] == pman[key], key
        assert sorted(rman["files"]) == sorted(pman["files"]) == ["pq.npz", "shard.npz"]
        for name in ("shard.npz", "pq.npz"):
            with np.load(os.path.join(rd, name)) as a, np.load(os.path.join(pd, name)) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    assert a[key].dtype == b[key].dtype, (name, key)
                    assert a[key].tobytes() == b[key].tobytes(), (name, key)


def test_each_package_restores_the_others_images(R):
    w = restore_shard(shard_dirs(R["ex_root"])[1], **CPU)
    assert w.spec == ShardSpec(1, NSHARDS, 4, 8)
    assert w.dim == D and w.pq_codes is not None and w.impl == "torch"  # the manifest's "jnp"
    assert w.packed.shape[0] == w.spec.ncells_local * w.cell_cap
    fleet = load_fleet(R["ex_root"], impl="fused", **CPU)
    assert fleet.n_replicas == 2 and fleet.n_live == N
    got = fleet.search(R["q"], K)
    _assert_reference(got, R["ex_search"])
    # The reference restored the port's images into its own workers: the
    # port's restore of the same directories holds the same arrays.
    for d, (spec, cap, impl, arrays) in zip(shard_dirs(R["port_ex_root"]),
                                            R["ref_on_port_images"], strict=True):
        pw = restore_shard(d, **CPU)
        assert tuple(pw.spec) == spec and pw.cell_cap == cap and impl == "jnp"
        mine = {"packed": pw.packed, "ids": pw.ids_of_slot, "live": pw.live,
                "codes": pw.pq_codes.codes, "hy": pw.pq_codes.hy,
                "codebooks": pw.pq_cb.codebooks}
        for key, a in arrays.items():
            assert mine[key].numpy().tobytes() == a.tobytes(), key


def test_restore_index_points_a_shard_image_at_restore_shard(R):
    with pytest.raises(SnapshotError, match="restore_shard"):
        restore_index(shard_dirs(R["ex_root"])[0], **CPU)


# -- the router against the index, the reference fleet and the mesh ----------


def _scored_by(idx, impl, *, ids=None, live=None, nprobe=NCELLS, overfetch=128):
    """The reference's trained cells and codes (``idx``: the port's restore
    of its snapshot) in a port index scored by ``impl``, with ``ids`` /
    ``live`` in place of the snapshot's, at ``nprobe`` / ``overfetch``."""
    return RetrievalIndex.from_arrays(
        idx._main_vecs, idx._main_ids if ids is None else ids,
        idx._main_live if live is None else live, np.zeros((0, D), np.float32),
        np.zeros(0, np.int32), np.zeros(0, bool), 0, impl=impl, ivf=idx._dev["main_ivf"],
        pq=idx._dev["main_pq"], nprobe=nprobe, overfetch=overfetch, **CPU)


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_router_matches_the_index_bit_for_bit_exhaustive(R, impl, tmp_path):
    idx = _scored_by(R["port_idx"], impl)
    save_shards(idx, str(tmp_path / "fleet"), NSHARDS)
    router = load_router(shard_dirs(str(tmp_path / "fleet")), **CPU)
    assert router.impl == impl and router.n_live == len(idx)
    got = router.search(R["q"], K)
    _assert_bit_identical(idx.search(R["q"], K), got)
    assert np.all(got.coverage == 1.0)
    assert all(s == "ok" for _, s in got.shard_status)


def test_fleet_equals_the_reference_fleet_at_nprobe_8(R):
    router = load_router(shard_dirs(R["de_root"]), impl="torch", **CPU)
    _assert_reference(router.search(R["q"], K), R["de"])


def test_fused_fleet_is_the_per_shard_union_scan(R):
    """At nprobe 8 < ncells, each shard's ``pq_scan`` scans the union of its
    query tile's local probes (all 24 queries are one tile): held to that
    union scan run through the plain ADC branch, shard by shard."""
    router = load_router(shard_dirs(R["de_root"]), impl="fused", **CPU)
    q = torch.from_numpy(R["q"])
    got = router.search(q, K)
    Kp = T.next_pow2(K)
    runs_v, runs_i = [], []
    for w in router.workers:
        S_loc = w.n_slots
        ncells_loc = w.spec.ncells_local
        local = router.probe(q) - w.spec.cell_lo
        ok = (local >= 0) & (local < ncells_loc)
        union = np.zeros(ncells_loc, bool)
        union[local[ok]] = True
        probed = torch.from_numpy(np.broadcast_to(union, (len(q), ncells_loc)).copy())
        cent = w.centroids[w.spec.cell_lo : w.spec.cell_hi]
        k_scan = min(S_loc, 4 * Kp, w.cell_cap)
        cand = quantized_scan(q, w.pq_codes, k_scan, distance="sqeuclidean", db_live=w.live,
                              probed=probed, cell_cap=w.cell_cap, pq_codebook=w.pq_cb,
                              cell_bias=pq_cell_bias(q, cent)).indices
        v, i = rescore(q, w.packed, cand, K)
        i = torch.where(i >= 0, w.ids_of_slot[i.clamp(min=0).long()], -1)
        runs_v.append(T.pad_topk(v, i, Kp)[0])
        runs_i.append(T.pad_topk(v, i, Kp)[1])
    want = aggregate_topk(torch.stack(runs_v), torch.stack(runs_i), K)
    vecs = torch.from_numpy(R["vecs"])
    KR.check_topk(got.distances, got.ids.long(), want.distances, want.indices.long(), n=N,
                  rtol=1e-5, atol=1e-5, dist=lambda r, c: ((q[r] - vecs[c]) ** 2).sum(1))


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_inproc_fleet_equals_the_mesh_scorer(R, impl, tmp_path):
    """The fleet and ``make_ivfpq_query_sharded`` on a (1, 4) mesh run one
    shard body over the same cells, codes and live slots: bit for bit, the
    mesh's corpus rows mapped to external ids."""
    from repro_torch.core import distributed as KD
    from repro_torch.core.ivf import packed_live
    from repro_torch.launch.mesh import make_mesh

    ids = np.arange(N)[::-1].copy()  # external ids that are not the rows
    live = np.arange(N) % 37 != 0  # and tombstones
    idx = _scored_by(R["port_idx"], impl, ids=ids, live=live, nprobe=8, overfetch=4)
    save_shards(idx, str(tmp_path / "fleet"), NSHARDS)
    router = load_fleet(str(tmp_path / "fleet"), **CPU)
    q = torch.from_numpy(R["q"])
    got = router.search(q, K)
    dev = idx._device_state()
    ivf, (cb, codes) = idx._dev["main_ivf"], idx._dev["main_pq"]
    mesh = make_mesh((1, 4), ("data", "model"), devices=[torch.device("cpu")] * 4)
    fn = KD.make_ivfpq_query_sharded(mesh, query_axis="data", db_axis="model", k=K, nprobe=8,
                                     cell_cap=ivf.cell_cap, impl=impl, overfetch=4)
    res = fn(q, ivf.centroids, cb, codes, ivf.packed, ivf.row_of_slot,
             packed_live(ivf, dev["main"][1]))
    main_ids = dev["main"][2]
    want_ids = torch.where(res.indices >= 0, main_ids[res.indices.clamp(min=0).long()], -1)
    assert torch.equal(got.distances, res.distances)
    assert torch.equal(got.ids, want_ids)


# -- assembly is the fault barrier ------------------------------------------


def _tamper(sd, fn):
    path = os.path.join(sd, "manifest.json")
    with open(path) as f:
        m = json.load(f)
    fn(m)
    with open(path, "w") as f:
        json.dump(m, f)


def test_assembly_refuses_torn_fleets(R, tmp_path):
    root = str(tmp_path / "fleet")
    shutil.copytree(R["ex_root"], root)
    dirs = shard_dirs(root)
    _tamper(dirs[1], lambda m: m["shard"].update(cell_lo=2, cell_hi=6))
    with pytest.raises(SnapshotError, match="overlap"):
        load_router(dirs, strict=False, **CPU)
    mixed = [shard_dirs(R["ex_root"])[0]] + shard_dirs(R["de_root"])[1:]
    with pytest.raises(SnapshotError, match="parent snapshot signature"):
        load_router(mixed, **CPU)
    paths = shard_dirs(R["ex_root"])
    with pytest.raises(SnapshotError, match="covers"):
        load_router(paths[:-1], **CPU)
    lazy = load_router(paths[:-1], strict=False, **CPU)
    with pytest.raises(MissingShardError, match="owned by no loaded shard"):
        lazy.search(R["q"], K)


def test_save_shards_guards(R, tmp_path):
    flat = RetrievalIndex.build(np.arange(256), R["vecs"][:256], **CPU)
    with pytest.raises(SnapshotError, match="IVF"):
        save_shards(flat, str(tmp_path / "flat"), 2)
    churned = RetrievalIndex.build(np.arange(N), R["vecs"], **CPU, **DEFAULTS)
    churned.upsert([N + 1], np.zeros((1, D), np.float32))
    with pytest.raises(SnapshotError, match="compact"):
        save_shards(churned, str(tmp_path / "delta"), 2)
    with pytest.raises(ValueError, match="n_shards"):
        plan_shards(NCELLS, 0)


# -- the engine and filters ----------------------------------------------------


def test_router_through_the_engine_carries_coverage_through_chunks(R):
    router = load_router(shard_dirs(R["de_root"]), impl="torch", degraded="partial", **CPU)
    workers = [FaultyWorker(w, FaultPolicy.die_at(0)) if w.key == "s1r0" else w
               for w in router.workers]
    router = ShardRouter(workers, degraded="partial")
    eng = QueryEngine(router, EngineConfig(k=K, min_batch=8, max_batch=8))
    got = eng.search(R["q"], K)  # 24 queries: three chunks of 8
    direct = router.search(R["q"], K)
    assert got.coverage.shape == (24,) and got.coverage.min() < 1.0
    np.testing.assert_array_equal(got.coverage, direct.coverage)
    assert dict(got.shard_status)[1] == "failed"
    _assert_bit_identical(direct, got)
    healthy = QueryEngine(load_router(shard_dirs(R["de_root"]), impl="torch", **CPU),
                          EngineConfig(k=K, min_batch=8, max_batch=16))
    res = healthy.search(R["q"], K)
    _assert_reference(res, R["de"])
    assert np.all(res.coverage == 1.0)
    assert healthy.meter.summary()["compile_batches"] >= 1


def test_filters_tenants_refused_allow_and_exclude_match_the_reference(R):
    router = load_router(shard_dirs(R["de_root"]), impl="torch", **CPU)
    allowed, exclude = _filters()
    with pytest.raises(NotImplementedError, match="tenant"):
        router.search(R["q"], K, filter=QueryFilter(tenant=0))
    got = router.search(R["q"], K, filter=QueryFilter(allowed_ids=allowed))
    _assert_reference(got, R["de_allow"])
    assert np.isin(got.ids.numpy()[got.ids.numpy() >= 0], allowed).all()
    got = router.search(R["q"], K, filter=QueryFilter(exclude_ids=exclude))
    _assert_reference(got, R["de_exclude"])
    assert not (got.ids.numpy()[:, :, None] == exclude[:, None, :]).any()
