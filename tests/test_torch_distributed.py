"""The port's multi-device core (``repro_torch.core.distributed`` over a
``repro_torch.launch.mesh.Mesh``) against the JAX package's.

The reference runs ONCE for the whole file: one module-scoped fixture runs
``repro.core.distributed`` in a subprocess with 8 forced host devices (as
``tests/test_distributed_knn.py`` does) and writes every result to an npz.
The port computes the same problems in this process, on meshes of the same
shapes whose positions are all CPU devices, so every kernel wrapper runs its
plain version.

Tolerances: values ``allclose`` at rtol/atol 1e-5 and ids equal except at
near-ties (``kernels.ref.check_topk``, which recomputes an id's distance
where the sets differ); the bf16 wire's values within one bf16 rounding
(rtol 2^-8); the butterfly, whose arithmetic is the same bitonic network
on the same inputs, bit for bit on every position.
"""
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.core import distributed as D
from repro_torch.core import ivf as PIVF
from repro_torch.core import knn as PK
from repro_torch.core.distances import quantize_rows
from repro_torch.core.pq import PQCodebook, PQCodes
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_mesh, mesh_devices

TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -8, atol=1e-5)  # one bf16 rounding of the wire

REFERENCE = """
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from repro.core import build_ivf, build_ivfpq
from repro.core import distributed as D
from repro.core.distances import quantize_rows
from repro.core.ivf import ivf_to_arrays, packed_live
from repro.data.synthetic import clustered_vectors

out = {}
AX = (jax.sharding.AxisType.Auto,)
rng = np.random.default_rng(0)
n, d, k = 1000, 32, 9
x = rng.standard_normal((1024, d)).astype(np.float32)
x[n:] = 0
out["x"] = x
mesh8 = jax.make_mesh((8,), ("ring",), axis_types=AX)
mesh3 = jax.sharding.Mesh(np.array(jax.devices()[:3]), ("ring",))
out["ring8"] = D.make_ring_allpairs(mesh8, k=k)(jnp.asarray(x), n)
x3 = np.asarray(D.pad_rows_to(jnp.asarray(x[:n]), 3))
out["x3"] = x3
out["ring3"] = D.make_ring_allpairs(mesh3, k=k)(jnp.asarray(x3), n)
out["ring8_bf16"] = D.make_ring_allpairs(mesh8, k=k, wire_dtype=jnp.bfloat16)(jnp.asarray(x), n)
out["tri8"] = D.make_triangle_allpairs(mesh8, k=k, gsize=128)(jnp.asarray(x), n)

meshx = jax.make_mesh((8,), ("x",), axis_types=AX)
def butterfly(vals, idx, wd=None):
    @functools.partial(jax.shard_map, mesh=meshx, in_specs=(PS("x"), PS("x")),
                       out_specs=(PS("x"), PS("x")), check_vma=False)
    def body(v, i):
        mv, mi = D.tree_merge_topk(v[0], i[0], "x", wire_dtype=wd)
        return mv[None], mi[None]
    return jax.jit(body)(jnp.asarray(vals), jnp.asarray(idx))
bv = np.sort(rng.standard_normal((8, 16, 8)).astype(np.float32), axis=-1)
bi = rng.integers(0, 1000, (8, 16, 8)).astype(np.int32)
tv = np.sort(rng.integers(0, 3, (8, 16, 8)).astype(np.float32), axis=-1)
ti = np.arange(8 * 16 * 8, dtype=np.int32).reshape(8, 16, 8)
out["bfly_in"] = (bv, bi)
out["bfly"] = butterfly(bv, bi)
out["bfly_bf16"] = butterfly(bv, bi, jnp.bfloat16)
out["ties_in"] = (tv, ti)
out["ties"] = butterfly(tv, ti)

mesh24 = jax.make_mesh((2, 4), ("data", "model"), axis_types=AX * 2)
q = rng.standard_normal((64, d)).astype(np.float32)
db = rng.standard_normal((512, d)).astype(np.float32)
live = np.ones(512, bool)
live[::7] = False
out["q"], out["db"], out["live"] = q, db, live
for impl in ("jnp", "fused"):
    fn = D.make_query_sharded(mesh24, query_axis="data", db_axis="model", k=11, impl=impl)
    out[f"query_{impl}"] = fn(jnp.asarray(q), jnp.asarray(db), 300, jnp.asarray(live))
    fn = D.make_query_sharded(mesh24, query_axis="data", db_axis="model", k=11, impl=impl,
                              scan_dtype="int8", wire_dtype=jnp.bfloat16)
    out[f"int8_{impl}"] = fn(jnp.asarray(q), jnp.asarray(db), 512, jnp.asarray(live))
    out[f"int8q_{impl}"] = fn(jnp.asarray(q), jnp.asarray(db), 512, jnp.asarray(live),
                              quantize_rows(jnp.asarray(db), "int8"))
# Ties everywhere: coordinates in {0, 1, 2}, so which replica comes back shows.
tq = rng.integers(0, 3, (16, 4)).astype(np.float32)
tdb = rng.integers(0, 3, (256, 4)).astype(np.float32)
out["tq"], out["tdb"] = tq, tdb
fn = D.make_query_sharded(mesh24, query_axis="data", db_axis="model", k=16, impl="jnp")
out["query_ties"] = fn(jnp.asarray(tq), jnp.asarray(tdb), 256)

vecs = clustered_vectors(512, d, n_clusters=16, seed=1)
cq = clustered_vectors(8, d, n_clusters=16, seed=2)
out["cvecs"], out["cq"] = vecs, cq
ivf = build_ivf(vecs, 16, iters=10, seed=1)
for key, val in ivf_to_arrays(ivf).items():
    out["ivf." + key] = val
cb, codes = build_ivfpq(vecs, ivf, 4, iters=8, seed=1)
out["pq.codebooks"], out["pq.codes"], out["pq.hy"] = cb.codebooks, codes.codes, codes.hy
lp = packed_live(ivf, jnp.asarray(live))
for nprobe, sd in ((16, "float32"), (6, "float32"), (6, "int8")):
    for impl in ("jnp", "fused"):
        fn = D.make_ivf_query_sharded(
            mesh24, query_axis="data", db_axis="model", k=8, nprobe=nprobe,
            cell_cap=ivf.cell_cap, impl=impl, scan_dtype=sd,
            wire_dtype=None if sd == "float32" else jnp.bfloat16)
        out[f"ivf_{nprobe}_{sd}_{impl}"] = fn(jnp.asarray(cq), ivf.centroids, ivf.packed,
                                              ivf.row_of_slot, lp)
for nprobe in (16, 6):
    fn = D.make_ivfpq_query_sharded(mesh24, query_axis="data", db_axis="model", k=8,
                                    nprobe=nprobe, cell_cap=ivf.cell_cap, impl="jnp",
                                    wire_dtype=jnp.bfloat16)
    out[f"ivfpq_{nprobe}"] = fn(jnp.asarray(cq), ivf.centroids, cb, codes, ivf.packed,
                                ivf.row_of_slot, lp)

flat = {}
for key, val in out.items():
    if isinstance(val, tuple):
        flat[key + ".v"], flat[key + ".i"] = np.asarray(val[0]), np.asarray(val[1])
    else:
        flat[key] = np.asarray(val)
np.savez(sys.argv[1], **flat)
print("OK")
"""


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    """Every reference result of this file, from one subprocess run."""
    path = tmp_path_factory.mktemp("distributed") / "reference.npz"
    run_with_devices(f"import sys\nsys.argv = ['', {str(path)!r}]\n" + REFERENCE)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _t(a):
    return torch.from_numpy(np.array(a))


def _cpu_mesh(shape, names):
    return make_mesh(shape, names, devices=[torch.device("cpu")] * int(np.prod(shape)))


def _want(R, key):
    return _t(R[key + ".v"]), _t(R[key + ".i"]).long()


def _check(got, R, key, *, n, dist, tol=TOL):
    v, i = _want(R, key)
    return ref.check_topk(got.distances, got.indices.long(), v, i, n=n, dist=dist, **tol)


def _rows_dist(a, b):
    """dist(rows, ids) for check_topk: exact sqeuclidean, a [m, d] vs b [n, d]."""
    return lambda r, c: ((a[r].double() - b[c].double()) ** 2).sum(1).float()


# ---------------------------------------------------------------------------
# The mesh.
# ---------------------------------------------------------------------------


def test_mesh_axes_groups_and_sizes():
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    assert mesh.shape["data"] == 2 and mesh.shape["model"] == 4 and mesh_devices(mesh) == 8
    assert mesh.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert mesh.groups(("data", "model")) == [list(range(8))]
    assert mesh.coords(6) == {"data": 1, "model": 2} and mesh.position({"data": 1, "model": 2}) == 6
    assert mesh.index_along(6, "data") == 1 and mesh.streams == (None,) * 8
    host = make_host_mesh(devices=[torch.device("cpu")] * 8)
    assert host.axis_names == ("data", "model") and host.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        Mesh((2, 4), ("data", "model"), [torch.device("cpu")] * 4)
    with pytest.raises(ValueError):
        mesh.axes("ring")


# ---------------------------------------------------------------------------
# Ring, triangle, butterfly.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("P", [8, 3])
def test_ring_allpairs_matches_reference(R, P, impl):
    x = _t(R["x"] if P == 8 else R["x3"])
    res = D.make_ring_allpairs(_cpu_mesh((P,), ("ring",)), k=9, impl=impl)(x, 1000)
    assert res.indices.shape == (1000, 9) and res.indices.dtype == torch.int32
    _check(res, R, f"ring{P}", n=1000, dist=_rows_dist(x, x))


def test_ring_bf16_wire_matches_reference_within_one_rounding(R):
    x = _t(R["x"])
    mesh = _cpu_mesh((8,), ("ring",))
    got = D.make_ring_allpairs(mesh, k=9, wire_dtype=torch.bfloat16, impl="torch")(x, 1000)
    _check(got, R, "ring8_bf16", n=1000, dist=_rows_dist(x, x), tol=BF16)
    # The wire is lossy, not wrong: most slots agree with the exact ring.
    exact = D.make_ring_allpairs(mesh, k=9, impl="torch")(x, 1000)
    assert (got.indices == exact.indices).float().mean() > 0.9


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_triangle_allpairs_matches_reference(R, impl):
    x = _t(R["x"])
    res = D.make_triangle_allpairs(_cpu_mesh((8,), ("ring",)), k=9, gsize=128, impl=impl)(x, 1000)
    _check(res, R, "tri8", n=1000, dist=_rows_dist(x, x))


@pytest.mark.parametrize("case", ["bfly", "bfly_bf16", "ties"])
def test_butterfly_merge_is_bit_equal_on_every_position(R, case):
    src = ("ties" if case == "ties" else "bfly") + "_in"
    vals, idx = _t(R[src + ".v"]), _t(R[src + ".i"])
    mesh = _cpu_mesh((8,), ("x",))
    wd = torch.bfloat16 if case == "bfly_bf16" else None
    mv, mi = D.tree_merge_topk(mesh, list(range(8)), list(vals), list(idx), wire_dtype=wd)
    want_v, want_i = _want(R, case)
    for p in range(8):
        assert torch.equal(mv[p], want_v[p]) and torch.equal(mi[p].long(), want_i[p]), p
    if case == "ties":  # positions differ at ties: each keeps its own buffer first
        assert any(not torch.equal(mi[0], mi[p]) for p in range(1, 8))


def test_butterfly_refuses_a_non_power_of_two_axis():
    mesh = _cpu_mesh((3,), ("x",))
    v = [torch.zeros(2, 4)] * 3
    with pytest.raises(ValueError, match="power-of-two"):
        D.tree_merge_topk(mesh, [0, 1, 2], v, [torch.zeros(2, 4, dtype=torch.int32)] * 3)


# ---------------------------------------------------------------------------
# The sharded queries.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,want", [("torch", "jnp"), ("kernel", "jnp"), ("fused", "fused")])
def test_query_sharded_ragged_with_tombstones(R, impl, want):
    q, db, live = _t(R["q"]), _t(R["db"]), _t(R["live"])
    fn = D.make_query_sharded(_cpu_mesh((2, 4), ("data", "model")), query_axis="data",
                              db_axis="model", k=11, impl=impl)
    res = fn(q, db, 300, live)
    _check(res, R, f"query_{want}", n=300, dist=_rows_dist(q, db))
    assert bool(live[res.indices.long()].all())


@pytest.mark.parametrize("replica", [False, True])
@pytest.mark.parametrize("impl,want", [("torch", "jnp"), ("fused", "fused")])
def test_query_sharded_int8_two_stage_bf16_wire(R, impl, want, replica):
    q, db, live = _t(R["q"]), _t(R["db"]), _t(R["live"])
    fn = D.make_query_sharded(_cpu_mesh((2, 4), ("data", "model")), query_axis="data",
                              db_axis="model", k=11, impl=impl, scan_dtype="int8",
                              wire_dtype=torch.bfloat16)
    res = fn(q, db, 512, live, quantize_rows(db, "int8") if replica else None)
    _check(res, R, f"int8{'q' if replica else ''}_{want}", n=512, dist=_rows_dist(q, db),
           tol=BF16)


def test_query_sharded_hands_back_the_first_db_position_copy_at_ties(R):
    """Coordinates in {0, 1, 2}: distances tie everywhere, so the positions'
    buffers differ after the butterfly; the first one along the db axis
    comes back, id for id the reference's."""
    tq, tdb = _t(R["tq"]), _t(R["tdb"])
    fn = D.make_query_sharded(_cpu_mesh((2, 4), ("data", "model")), query_axis="data",
                              db_axis="model", k=16, impl="torch")
    res = fn(tq, tdb, 256)
    want_v, want_i = _want(R, "query_ties")
    assert torch.equal(res.distances, want_v) and torch.equal(res.indices.long(), want_i)


@pytest.fixture(scope="module")
def cells(R):
    ivf = PIVF.ivf_from_arrays({k[4:]: R[k] for k in R if k.startswith("ivf.")}, device="cpu")
    pq = (PQCodebook(_t(R["pq.codebooks"])), PQCodes(_t(R["pq.codes"]), _t(R["pq.hy"])))
    return ivf, pq, PIVF.packed_live(ivf, _t(R["live"]))


@pytest.mark.parametrize("nprobe,sd,impl,want", [
    (16, "float32", "torch", "jnp"), (16, "float32", "fused", "fused"),
    (6, "float32", "torch", "jnp"), (6, "int8", "torch", "jnp")])
def test_ivf_query_sharded_matches_reference(R, cells, nprobe, sd, impl, want):
    ivf, _, lp = cells
    q, vecs = _t(R["cq"]), _t(R["cvecs"])
    fn = D.make_ivf_query_sharded(_cpu_mesh((2, 4), ("data", "model")), query_axis="data",
                                  db_axis="model", k=8, nprobe=nprobe, cell_cap=ivf.cell_cap,
                                  impl=impl, scan_dtype=sd,
                                  wire_dtype=None if sd == "float32" else torch.bfloat16)
    res = fn(q, ivf.centroids, ivf.packed, ivf.row_of_slot, lp)
    _check(res, R, f"ivf_{nprobe}_{sd}_{want}", n=512, dist=_rows_dist(q, vecs),
           tol=TOL if sd == "float32" else BF16)


def test_ivf_query_sharded_fused_is_the_union_scan_of_each_query_block(R, cells):
    """The reference's sharded fused stage 1 takes its plain probe mask on
    the CPU; the port's runs ``ivf_scan`` (each query tile scans the union
    of its probes, a superset), so at nprobe 6 it is held to the port's own
    single-device union scan of each query block, and to the reference's
    recall floor."""
    ivf, _, lp = cells
    q, vecs, live = _t(R["cq"]), _t(R["cvecs"]), _t(R["live"])
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    for sd in ("float32", "int8"):
        fn = D.make_ivf_query_sharded(mesh, query_axis="data", db_axis="model", k=8, nprobe=6,
                                      cell_cap=ivf.cell_cap, impl="fused", scan_dtype=sd,
                                      wire_dtype=None if sd == "float32" else torch.bfloat16)
        res = fn(q, ivf.centroids, ivf.packed, ivf.row_of_slot, lp)
        if sd == "float32":
            for b in range(2):
                blk = slice(4 * b, 4 * b + 4)
                one = PK.ivf_query(q[blk], vecs, ivf, 8, nprobe=6, impl="fused", db_live=live)
                ref.check_topk(res.distances[blk], res.indices[blk].long(), one.distances,
                               one.indices.long(), n=512, dist=_rows_dist(q[blk], vecs), **TOL)
        exact = PK.knn_query(q, vecs, 8, impl="torch", db_live=live)
        hits = sum(len(set(a.tolist()) & set(b.tolist()))
                   for a, b in zip(res.indices, exact.indices))
        assert hits / (8 * 8) >= 0.9, sd


@pytest.mark.parametrize("nprobe", [16, 6])
def test_ivfpq_query_sharded_matches_reference(R, cells, nprobe):
    ivf, (cb, codes), lp = cells
    q, vecs = _t(R["cq"]), _t(R["cvecs"])
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    fn = D.make_ivfpq_query_sharded(mesh, query_axis="data", db_axis="model", k=8,
                                    nprobe=nprobe, cell_cap=ivf.cell_cap, impl="torch",
                                    wire_dtype=torch.bfloat16)
    res = fn(q, ivf.centroids, cb, codes, ivf.packed, ivf.row_of_slot, lp)
    _check(res, R, f"ivfpq_{nprobe}", n=512, dist=_rows_dist(q, vecs), tol=BF16)
    # The fused route (pq_scan over each tile's union) meets the reference's floor.
    fused = D.make_ivfpq_query_sharded(mesh, query_axis="data", db_axis="model", k=8,
                                       nprobe=nprobe, cell_cap=ivf.cell_cap, impl="fused",
                                       wire_dtype=torch.bfloat16)
    got = fused(q, ivf.centroids, cb, codes, ivf.packed, ivf.row_of_slot, lp)
    exact = PK.knn_query(q, vecs, 8, impl="torch", db_live=_t(R["live"]))
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(got.indices, exact.indices))
    assert hits / (8 * 8) >= 0.9


def test_sharded_makers_refuse_bad_layouts():
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    with pytest.raises(ValueError, match="replicated over db_axis"):
        D.make_query_sharded(mesh, query_axis="model", db_axis="model", k=4)(
            torch.zeros(8, 4), torch.zeros(8, 4), 8)
    with pytest.raises(ValueError, match="must divide over db_axis"):
        D.make_ivf_query_sharded(mesh, query_axis="data", db_axis="model", k=4, nprobe=2,
                                 cell_cap=128)(torch.zeros(8, 4), torch.zeros(6, 4),
                                               torch.zeros(768, 4),
                                               torch.zeros(768, dtype=torch.int32))
    with pytest.raises(ValueError, match="split over"):
        D.make_ring_allpairs(_cpu_mesh((3,), ("ring",)), k=4)(torch.zeros(10, 4), 10)


# ---------------------------------------------------------------------------
# Probes outside a shard (the scans' probe lists).
# ---------------------------------------------------------------------------


def test_tile_probe_lists_drop_probes_outside_the_cell_range():
    cells = torch.tensor([[-3, 5], [9, 2], [12, -1], [-8, 20], [1, 1], [3, 0]], dtype=torch.int32)
    lists = PIVF.tile_probe_lists(cells, 8, 2)
    # Tile 0: 5 and 2 (9 is past the range); tile 1: none; tile 2: 0, 1, 3.
    assert lists.tolist() == [[2, 5, 5, 5], [-1, -1, -1, -1], [0, 1, 3, 3]]


@pytest.mark.parametrize("kind", ["ivf", "pq"])
def test_scans_of_a_shard_that_owns_none_of_a_tiles_probes(kind):
    """A shard's probes are the global shortlist shifted by its first cell:
    negative or past its cells for the cells other shards own.  Those match
    nothing; a query tile left with no probe of the shard scans nothing and
    comes back +inf / -1; a tile with some scans exactly those."""
    g = torch.Generator().manual_seed(0)
    ncells, cap, d, m = 4, 128, 8, 16
    packed = torch.randn(ncells * cap, d, generator=g)
    q = torch.randn(m, d, generator=g)
    # Queries 0..7 (one tile) probe only cells of other shards; 8..15 mix.
    cells = torch.randint(-6, 0, (m, 3), generator=g, dtype=torch.int32)
    cells[:8, 1] = torch.randint(ncells, 10, (8,), generator=g, dtype=torch.int32)
    cells[8:, 0] = torch.randint(0, ncells, (8,), generator=g, dtype=torch.int32)
    kept = torch.where((cells >= 0) & (cells < ncells), cells, cells[:, :1].clamp(0, ncells - 1))
    if kind == "ivf":
        run = lambda x, c: ops.ivf_scan(x, packed, c, 16, cell_cap=cap, tile_m=8)  # noqa: E731
    else:
        cb = PQCodebook(torch.randn(2, 16, d // 2, generator=g))
        codes = PQCodes(torch.randint(0, 16, (ncells * cap, 2), generator=g, dtype=torch.uint8),
                        torch.randn(ncells * cap, generator=g))
        run = lambda x, c: ops.pq_scan(x, cb, codes, c, 16, cell_cap=cap, tile_m=8)  # noqa: E731
    got = run(q, cells)
    assert bool(torch.isinf(got.distances[:8]).all()) and bool((got.indices[:8] == -1).all())
    want = run(q[8:], kept[8:])
    assert torch.equal(got.indices[8:], want.indices) and torch.equal(got.distances[8:],
                                                                      want.distances)
    assert bool((got.indices[8:] >= 0).all())
