"""The port's IVF tier against the JAX package's.

The same numpy inputs go through the reference (JAX on the CPU, its Pallas
kernels in interpret mode) and through the port (CPU tensors, so each
kernel wrapper runs its plain version).  Torch cannot replay
``jax.random``, so the port's k-means is held against the reference's from
the reference's own initial permutation, and the port's scans against
cells the reference trained (``ivf_to_arrays`` / ``ivf_from_arrays``).

Tolerances: packings, probe lists and assignments are integers and must be
equal; centroids are means summed in another order, rtol 1e-5; scan and
rescore values agree to rtol 1e-5 / atol 1e-5, ids except at near-ties
(``ref.check_topk``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as RIVF
from repro.core import knn as RK
from repro.core.distances import quantize_rows as rquantize
from repro.core.kmeans import lloyd as rlloyd
from repro.data.synthetic import clustered_vectors
from repro.kernels import ops as rops
from repro.serving import RetrievalIndex as RIndex
from repro_torch.core import ivf as PIVF
from repro_torch.core import knn as PK
from repro_torch.core.distances import quantize_rows
from repro_torch.core.kmeans import lloyd
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ops, ref
from repro_torch.serving.index import RetrievalIndex

CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check(got, want, n):
    return ref.check_topk(got.distances, got.indices.long(), _t(want.distances),
                          _t(want.indices).long(), n=n, **TOL)


@pytest.fixture(scope="module")
def trained():
    """A corpus, queries and the reference's trained cells over it."""
    x = clustered_vectors(700, 24, n_clusters=8, seed=2)
    q = clustered_vectors(13, 24, n_clusters=8, seed=3)
    ivf = RIVF.build_ivf(jnp.asarray(x), 8, iters=6)
    return x, q, ivf, PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(ivf), device="cpu")


# ---------------------------------------------------------------------------
# k-means, packing, probe lists
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,k,iters,seed", [(400, 16, 8, 5, 3), (300, 12, 6, 4, 0)])
@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_lloyd_matches_reference_from_its_permutation(n, d, k, iters, seed, impl):
    x = clustered_vectors(n, d, n_clusters=8, seed=0)
    rc, ra = rlloyd(jnp.asarray(x), k, iters=iters, seed=seed)
    perm = _t(jax.random.permutation(jax.random.PRNGKey(seed), n))
    pc, pa = lloyd(torch.from_numpy(x), k, iters=iters, init_perm=perm, impl=impl)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ra))
    np.testing.assert_allclose(pc.numpy(), np.asarray(rc), rtol=1e-5, atol=1e-6)
    assert pa.dtype == torch.int32


def test_lloyd_generator_start_is_deterministic_and_assigns_all_rows():
    x = torch.from_numpy(clustered_vectors(400, 16, n_clusters=8, seed=0))
    c1, a1 = lloyd(x, 8, iters=5, generator=torch.Generator().manual_seed(3))
    c2, a2 = lloyd(x, 8, iters=5, generator=torch.Generator().manual_seed(3))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert ((a1 >= 0) & (a1 < 8)).all()
    assert torch.equal(a1, PK.knn_query(x, c1, 1).indices[:, 0])


@pytest.mark.parametrize("n,k,d", [(5000, 37, 8), (64, 64, 3), (1, 4, 16), (3000, 2, 256)])
def test_cluster_sums_fix_their_order(n, k, d):
    """ROADMAP F3: the re-centring's sums run in an order fixed by the
    assignment alone (``core.segments``).  On the CPU (one segment a
    cluster) they are ``index_add_``'s, bit for bit; the card's pieces
    (``_piecewise_sums``, here on CPU tensors) agree to fp32 rounding, the
    same bits every time; an empty cluster sums to 0.  The prefix sum of k-means++ matches
    ``cumsum`` to float64 rounding."""
    from repro_torch.core import kmeans as KM
    from repro_torch.core import segments as SEG

    g = torch.from_numpy(np.random.default_rng(n).standard_normal((n, d)).astype(np.float32))
    a = torch.from_numpy(np.random.default_rng(k).integers(0, k, n))
    a[a == k - 1] = 0  # at least one empty cluster
    want = torch.zeros(k, d).index_add_(0, a, g)
    sums, cnt = SEG.group_sums(g, a, k)
    assert torch.equal(sums, want)
    assert torch.equal(cnt, torch.bincount(a, minlength=k))
    rows = g[torch.argsort(a, stable=True)]
    piecewise = SEG._piecewise_sums(rows, cnt)
    torch.testing.assert_close(piecewise, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(piecewise, SEG._piecewise_sums(rows.clone(), cnt.clone()))
    assert not piecewise[k - 1].any()
    x = torch.from_numpy(np.random.default_rng(1).random(n * 7 + 3))
    torch.testing.assert_close(KM._ordered_cumsum(x), torch.cumsum(x, 0), rtol=1e-12,
                               atol=0.0)


def test_kmeanspp_start_seeds_every_separated_cluster():
    """The drawn start (D^2 sampling) puts one seed in each of 12 tight,
    far-apart clusters, where a uniform draw of 12 rows almost surely
    misses some; the draw is deterministic for a generator seed."""
    from repro_torch.core.kmeans import kmeanspp_rows

    g = np.random.default_rng(4)
    centers = 100.0 * g.standard_normal((12, 8))
    label = g.integers(0, 12, 3000)
    x = torch.from_numpy((centers[label] + 1e-3 * g.standard_normal((3000, 8)))
                         .astype(np.float32))
    rows = kmeanspp_rows(x, 12, torch.Generator().manual_seed(0))
    assert sorted(label[rows.numpy()].tolist()) == list(range(12))
    assert torch.equal(rows, kmeanspp_rows(x, 12, torch.Generator().manual_seed(0)))
    cent, assign = lloyd(x, 12, iters=3, generator=torch.Generator().manual_seed(0))
    # Cell j grows from the seed rows[j]: it holds exactly that seed's cluster.
    assert torch.bincount(assign.long(), minlength=12).tolist() == np.bincount(
        label, minlength=12)[label[rows.numpy()]].tolist()


@pytest.mark.parametrize("cell_cap", [None, 256])
def test_pack_cells_matches_reference_bit_for_bit(cell_cap):
    x = np.random.default_rng(1).standard_normal((300, 12)).astype(np.float32)
    cent, assign = RIVF.train_centroids(jnp.asarray(x), 6, iters=4)
    want = RIVF.pack_cells(x, cent, assign, cell_cap=cell_cap)
    got = PIVF.pack_cells(x, _t(cent), _t(assign), cell_cap=cell_cap)
    for field in PIVF.IVFCells._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.ncells, got.cell_cap) == (want.ncells, want.cell_cap)


@pytest.mark.parametrize("m,nprobe,ncells,bm", [(8, 3, 30, 8), (32, 3, 30, 8), (64, 8, 20, 16),
                                                (256, 8, 4096, 256)])
def test_tile_probe_lists_match_reference(m, nprobe, ncells, bm):
    cells = np.random.default_rng(m).integers(0, ncells, (m, nprobe)).astype(np.int32)
    want = RIVF.tile_probe_lists(jnp.asarray(cells), ncells, bm)
    got = PIVF.tile_probe_lists(torch.from_numpy(cells), ncells, bm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ivf_arrays_carry_the_reference_cells_and_validate(trained):
    _, _, ivf, pivf = trained
    for field in PIVF.IVFCells._fields:
        np.testing.assert_array_equal(getattr(pivf, field).numpy(),
                                      np.asarray(getattr(ivf, field)))
    arrays = PIVF.ivf_to_arrays(pivf)
    assert set(arrays) == set(PIVF.IVFCells._fields)
    broken = dict(arrays, slot_of_row=np.roll(arrays["slot_of_row"], 1))
    with pytest.raises(ValueError, match="round-trip"):
        PIVF.ivf_from_arrays(broken, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        PIVF.ivf_from_arrays({k: v for k, v in arrays.items() if k != "counts"},
                             device="cpu")
    with pytest.raises(ValueError):
        PIVF.ivf_from_arrays(dict(arrays, packed=arrays["packed"][:-1]), device="cpu")


def test_ivf_from_arrays_runs_on_the_card_unless_asked_for_the_cpu(trained, monkeypatch):
    """The loader's default device is the card, as the index's: without one
    it raises rather than build the cells on the host."""
    arrays = PIVF.ivf_to_arrays(trained[3])
    assert PIVF.ivf_from_arrays(arrays, device="cpu").packed.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        PIVF.ivf_from_arrays(arrays)


def test_build_ivf_and_pack_cells_run_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Numpy input lands on ``resolve_device``'s default, the card, as
    ``ivf_from_arrays``'s does: without one both raise rather than train or
    pack on the host.  Asked for the CPU they build there, the same cells;
    a tensor stays where it lies."""
    x = clustered_vectors(300, 8, n_clusters=4, seed=1)
    kw = dict(iters=2, impl="torch")
    asked = PIVF.build_ivf(x, 4, generator=torch.Generator().manual_seed(0), device="cpu", **kw)
    lying = PIVF.build_ivf(torch.from_numpy(x), 4, generator=torch.Generator().manual_seed(0),
                           **kw)
    assert asked.packed.device.type == lying.packed.device.type == "cpu"
    for field in PIVF.IVFCells._fields:
        assert torch.equal(getattr(asked, field), getattr(lying, field)), field
    cent, assign = PIVF.train_centroids(torch.from_numpy(x), 4, iters=2,
                                        generator=torch.Generator().manual_seed(0))
    assert PIVF.pack_cells(x, cent, assign).packed.device.type == "cpu"  # the centroids' device
    assert PIVF.pack_cells(x, cent.numpy(), assign.numpy(),
                           device="cpu").packed.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        PIVF.build_ivf(x, 4, **kw)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        PIVF.pack_cells(x, cent.numpy(), assign.numpy())


def test_packed_live_and_probe_cells_match_reference(trained):
    x, q, ivf, pivf = trained
    live = np.arange(700) % 5 != 0
    np.testing.assert_array_equal(PIVF.packed_live(pivf, torch.from_numpy(live)).numpy(),
                                  np.asarray(RIVF.packed_live(ivf, jnp.asarray(live))))
    np.testing.assert_array_equal(PIVF.packed_live(pivf).numpy(),
                                  np.asarray(RIVF.packed_live(ivf)))
    for nprobe in (3, 99):  # past ncells clamps
        want = RIVF.probe_cells(jnp.asarray(q), ivf.centroids, nprobe, distance="neg_dot")
        got = PIVF.probe_cells(torch.from_numpy(q), pivf.centroids, nprobe, distance="neg_dot")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The ivf_scan kernel's function, and ivf_query
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_dtype", [None, "bfloat16", "int8"])
@pytest.mark.parametrize("m,tile_m", [(13, 256), (40, 16)])
def test_ivf_scan_matches_pallas(trained, scan_dtype, m, tile_m):
    """The union-per-tile rule at the reference's tile_m: a tile of 16
    queries scans the union of their probes, a batch under 256 is one tile."""
    x, _, ivf, pivf = trained
    q = clustered_vectors(m, 24, n_clusters=8, seed=4)
    cells = np.array(RIVF.probe_cells(jnp.asarray(q), ivf.centroids, 2))
    live = np.arange(700) % 6 != 1
    rdb = ivf.packed if scan_dtype is None else rquantize(ivf.packed, scan_dtype)
    pdb = pivf.packed if scan_dtype is None else quantize_rows(pivf.packed, scan_dtype)
    want = rops.ivf_scan(jnp.asarray(q), rdb, jnp.asarray(cells), 32, cell_cap=ivf.cell_cap,
                         tile_m=tile_m, bd=8,
                         packed_live=RIVF.packed_live(ivf, jnp.asarray(live)))
    got = ops.ivf_scan(torch.from_numpy(q), pdb, torch.from_numpy(cells), 32,
                       cell_cap=pivf.cell_cap, tile_m=tile_m,
                       packed_live=PIVF.packed_live(pivf, torch.from_numpy(live)))
    _check(got, want, ivf.packed.shape[0])
    rows = pivf.row_of_slot[got.indices.clamp(min=0).long()]
    assert not np.isin(rows.numpy()[got.indices.numpy() >= 0], np.flatnonzero(~live)).any()


def test_ivf_scan_refuses_a_fetch_wider_than_a_cell(trained):
    _, q, _, pivf = trained
    cells = torch.zeros((13, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cell block"):
        ops.ivf_scan(torch.from_numpy(q), pivf.packed, cells, pivf.cell_cap + 1,
                     cell_cap=pivf.cell_cap)


@pytest.mark.parametrize("impl,rimpl", [("fused", "fused"), ("torch", "jnp")])
@pytest.mark.parametrize("nprobe,scan_dtype", [(2, None), (3, "int8"), (8, None)])
def test_ivf_query_matches_reference(trained, impl, rimpl, nprobe, scan_dtype):
    x, q, ivf, pivf = trained
    live = np.arange(700) % 5 != 0
    rq_ = None if scan_dtype is None else rquantize(ivf.packed, scan_dtype)
    pq_ = None if scan_dtype is None else quantize_rows(pivf.packed, scan_dtype)
    want = RK.ivf_query(jnp.asarray(q), jnp.asarray(x), ivf, 9, nprobe=nprobe, impl=rimpl,
                        db_live=jnp.asarray(live), packed_q=rq_)
    got = PK.ivf_query(torch.from_numpy(q), torch.from_numpy(x), pivf, 9, nprobe=nprobe,
                       impl=impl, db_live=torch.from_numpy(live), packed_q=pq_)
    _check(got, want, 700)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_ivf_full_probe_equals_knn_query(trained, impl):
    """The reference's hatch: nprobe = ncells with the fp32 packed rows."""
    x, q, _, pivf = trained
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    exact = PK.knn_query(qt, xt, 9)
    res = PK.ivf_query(qt, xt, pivf, 9, nprobe=pivf.ncells, impl=impl)
    assert torch.equal(res.indices, exact.indices)
    torch.testing.assert_close(res.distances, exact.distances, **TOL)


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_ivf_full_probe_past_the_k_buffer_equals_knn_query(impl):
    """nprobe = ncells = 300: a shortlist wider than the card's narrow
    K-buffer (256) is every cell, taken without a kNN over the centroids;
    nprobe = 299 is a shortlist at K = 512, which the plain versions serve
    (ROADMAP F1) and both impls take alike."""
    x = torch.from_numpy(clustered_vectors(1500, 8, n_clusters=40, seed=6))
    q = torch.from_numpy(clustered_vectors(9, 8, n_clusters=40, seed=7))
    ivf = PIVF.build_ivf(x, 300, iters=2, generator=torch.Generator().manual_seed(0),
                         impl="torch")
    res = PK.ivf_query(q, x, ivf, 5, nprobe=300, impl=impl)
    exact = PK.knn_query(q, x, 5)
    assert torch.equal(res.indices, exact.indices)
    near = PK.ivf_query(q, x, ivf, 5, nprobe=299, impl=impl)  # a shortlist of k = 299
    assert torch.equal(near.indices, PK.ivf_query(q, x, ivf, 5, nprobe=299,
                                                   impl="torch").indices)
    assert (near.indices >= 0).all()


def test_ivf_query_filters_wait_for_their_slice(trained):
    """The filters are served: an all-True bitmap is no filter, and an
    exclusion list drops its row (tests/test_torch_filters.py holds them
    against the reference)."""
    x, q, _, pivf = trained
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    for impl in ("torch", "fused"):
        none = PK.ivf_query(qt, xt, pivf, 3, impl=impl)
        full = PK.ivf_query(qt, xt, pivf, 3, impl=impl,
                            q_allowed=FK.pack_mask(torch.ones(13, 700, dtype=torch.bool)))
        assert torch.equal(full.indices, none.indices)
        top = none.indices[:, :1]
        excl = PK.ivf_query(qt, xt, pivf, 3, impl=impl, exclude_rows=top)
        assert not (excl.indices == top).any()


# ---------------------------------------------------------------------------
# The serving index: ivf_cells and nprobe
# ---------------------------------------------------------------------------


def _carry(refi, **kw):
    """The port index over the reference index's segments and its cells."""
    return RetrievalIndex.from_arrays(
        refi._main_vecs, refi._main_ids, refi._main_live, refi._delta_vecs, refi._delta_ids,
        refi._delta_live, refi._delta_n, distance=refi.distance,
        ivf=PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(refi._dev["main_ivf"]), device="cpu"),
        scan_dtype=refi.scan_dtype, overfetch=refi.overfetch, nprobe=refi.nprobe, **kw, **CPU)


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_index_over_reference_cells_answers_as_reference(scan_dtype):
    """``from_arrays(ivf=...)`` over the reference's trained cells answers as
    the reference does, under upsert and delete; after a compact (which
    retrains both) the carried state answers as the reference again."""
    g = np.random.default_rng(5)
    d, n = 16, 512
    vecs = clustered_vectors(n, d, n_clusters=16, seed=8)
    q = clustered_vectors(11, d, n_clusters=16, seed=9)
    refi = RIndex.build(np.arange(n), vecs, ivf_cells=16, nprobe=4, impl="fused",
                        scan_dtype=scan_dtype)
    refi.search(jnp.asarray(q), 8)  # trains the reference's cells
    port = _carry(refi, impl="fused")
    steps = [("upsert", (np.arange(20, 60), g.standard_normal((40, d)).astype(np.float32))),
             ("delete", (np.arange(100, 160),)),
             ("insert", (np.arange(900, 905), g.standard_normal((5, d)).astype(np.float32)))]
    for op, args in steps:
        getattr(refi, op)(*args)
        getattr(port, op)(*args)
        assert refi.shape_signature(8) == port.shape_signature(8)
        for k in (1, 8):
            r, p = refi.search(jnp.asarray(q), k), port.search(q, k)
            np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))
            np.testing.assert_allclose(p.distances.numpy(), np.asarray(r.distances), **TOL)
    refi.compact()
    port.compact()
    assert port.search(q, 8).ids.shape == (11, 8)  # the port retrains its own cells
    refi.search(jnp.asarray(q), 8)
    again = _carry(refi, impl="torch")
    r, p = refi.search(jnp.asarray(q), 8), again.search(q, 8)
    np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))


def test_index_ivf_full_probe_exact_under_churn():
    """Full-probe fp32 IVF equals the flat index through insert, delete and
    compact: the packing permutation round-trips external ids."""
    g = np.random.default_rng(8)
    d, k, n = 16, 8, 512
    vecs = clustered_vectors(n, d, n_clusters=16, seed=8)
    q = clustered_vectors(11, d, n_clusters=16, seed=9)
    idx = RetrievalIndex.build(np.arange(n), vecs, ivf_cells=16, nprobe=10 ** 6, **CPU)
    flat = RetrievalIndex.build(np.arange(n), vecs, **CPU)
    for step in range(2):
        fresh = g.standard_normal((40, d)).astype(np.float32)
        for i in (idx, flat):
            i.delete(np.arange(step * 50, step * 50 + 30))
            i.upsert(np.arange(2000 + step * 40, 2040 + step * 40), fresh)
        a, b = idx.search(q, k), flat.search(q, k)
        assert torch.equal(a.ids, b.ids)
        torch.testing.assert_close(a.distances, b.distances, **TOL)
        for i in (idx, flat):
            i.compact()
    assert torch.equal(idx.search(q, k).ids, flat.search(q, k).ids)
    assert idx.effective_nprobe() == idx._dev["main_ivf"].ncells == 16


def test_index_ivf_epoch_policy_tombstones_never_retrain():
    g = np.random.default_rng(12)
    idx = RetrievalIndex.build(np.arange(256), g.standard_normal((256, 8)).astype(np.float32),
                               ivf_cells=8, scan_dtype="int8", **CPU)
    q = g.standard_normal((3, 8)).astype(np.float32)
    idx.search(q, 3)
    ivf, ivf_q = idx._dev["main_ivf"], idx._dev["main_ivf_q"]
    assert ivf_q.data.dtype == torch.int8 and "main_q" not in idx._dev
    idx.delete([0, 1, 2])
    idx.search(q, 3)
    assert idx._dev["main_ivf"] is ivf and idx._dev["main_ivf_q"] is ivf_q
    idx.compact()
    idx.search(q, 3)
    assert idx._dev["main_ivf"] is not ivf  # epoch bump: retrain and repack


def test_index_ivf_shape_signature_tracks_packed_size():
    vecs = clustered_vectors(512, 8, seed=13)
    flat = RetrievalIndex.build(np.arange(512), vecs, **CPU)
    idx = RetrievalIndex.build(np.arange(512), vecs, ivf_cells=8, **CPU)
    assert flat.shape_signature(3)[2] == 0
    assert idx.shape_signature(3)[2] == -2  # epoch 1, not built yet: a cold marker
    idx.search(clustered_vectors(3, 8, seed=14), 3)
    assert idx.shape_signature(3)[2] == idx._dev["main_ivf"].packed.shape[0] > 0
    tiny = RetrievalIndex.build(np.arange(12), vecs[:12], ivf_cells=64, **CPU)
    assert tiny._effective_ncells() == 3  # n // 4 rows
    with pytest.raises(ValueError):
        RetrievalIndex(8, distance="kl", ivf_cells=8, **CPU)
