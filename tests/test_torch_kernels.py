"""The port's kernel wrappers against the JAX package's Pallas kernels.

The reference kernels run as the JAX package's own tests run them on the
CPU (the Pallas interpreter), at ``tests/test_kernels.py`` tile sizes; the
port's wrappers, given CPU tensors, run their kernels' plain versions.

Tolerances: fp32 values agree to atol 3e-3 / rtol 1e-3, the reference
tests' own bound for the MXU form against the cumulative oracle, because the
two sum the d products in different orders.  Selection copies values, so
top-k values of one matrix agree exactly, and ids agree exactly where no
two candidates tie.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as RT
from repro.kernels import ops as rops
from repro_torch.core import topk as T
from repro_torch.core.distances import REGISTRY, get_distance
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ivf_scan as IVS
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as PD
from repro_torch.kernels import pq_scan as PQS
from repro_torch.kernels import ref
from repro_torch.kernels import rescore as RS
from repro_torch.kernels import scan as SC
from repro_torch.kernels import stream_topk as ST

CSRC = Path(ops.__file__).parent / "csrc"


def _data(name, m, n, d, seed):
    g = np.random.default_rng(seed)
    if get_distance(name).needs_positive:
        x = g.gamma(1.0, 1.0, (m, d)).astype(np.float32) + 1e-4
        y = g.gamma(1.0, 1.0, (n, d)).astype(np.float32) + 1e-4
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    return (g.standard_normal((m, d)).astype(np.float32),
            g.standard_normal((n, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("shape", [(64, 64, 32), (100, 130, 96)])
def test_pairwise_distance_matches_pallas(name, shape):
    m, n, d = shape
    x, y = _data(name, m, n, d, 0)
    want = rops.pairwise_distance(jnp.asarray(x), jnp.asarray(y), distance=name,
                                  bm=64, bn=64, bd=32)
    got = ops.pairwise_distance(*_t(x, y), distance=name)
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-3, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), ref.pairwise_distance_ref(*_t(x, y), distance=name),
                               atol=3e-3, rtol=1e-3)


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("shape", [(64, 64, 32), (100, 130, 30)])
def test_pairwise_cumulative_matches_pallas(name, shape):
    """The per-coordinate route against the reference's cumulative Pallas
    kernel (interpret mode) and the cumulative oracle, for every distance:
    the same accumulator over the same coordinates, summed in chunks of
    another size, so values agree to fp32 rounding."""
    m, n, d = shape
    x, y = _data(name, m, n, d, 1)
    want = rops.pairwise_distance(jnp.asarray(x), jnp.asarray(y), distance=name,
                                  cumulative=True, bm=64, bn=64, bd=32)
    before = PD.CUMULATIVE_LAUNCHES
    got = ops.pairwise_distance(*_t(x, y), distance=name, cumulative=True)
    assert got.shape == (m, n) and PD.CUMULATIVE_LAUNCHES == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.pairwise_distance_ref(*_t(x, y), distance=name),
                               atol=1e-5, rtol=1e-5)


def test_pairwise_cumulative_plain_blocks_and_names(monkeypatch):
    """The plain version's row, column and coordinate blocks give one pass's
    values; every distance maps to one of the kernel's accumulators and
    finalizers."""
    from repro_torch.core.distances import cumulative_kind

    x, y = _t(*_data("kl", 37, 50, 20, 2))
    one = PD.pairwise_cumulative_plain(x, y, accumulate="kl", finalize="identity")
    monkeypatch.setattr(PD, "PLAIN_CHUNK", 64)  # blocks of 1 row x 50 columns x 20 coordinates
    torch.testing.assert_close(PD.pairwise_cumulative_plain(
        x, y, accumulate="kl", finalize="identity"), one, rtol=1e-6, atol=1e-7)
    kinds = {name: cumulative_kind(get_distance(name)) for name in REGISTRY}
    assert kinds == {"sqeuclidean": ("sqeuclidean", "identity"),
                     "euclidean": ("sqeuclidean", "sqrt"), "neg_dot": ("neg_dot", "identity"),
                     "neg_cosine": ("neg_dot", "identity"),
                     "hellinger": ("hellinger", "half_sqrt"), "kl": ("kl", "identity")}
    for acc, fin in kinds.values():
        assert acc in PD.ACCUMULATE_CODES and fin in PD.CUMULATIVE_FINALIZE_CODES
    with pytest.raises(ValueError):
        PD.pairwise_distance_cumulative(x, y, accumulate="cosine", finalize="identity")


@pytest.mark.parametrize("shape,k", [((32, 128), 1), ((32, 128), 7), ((64, 1000), 16),
                                     ((1, 4096), 100)])
def test_stream_topk_matches_pallas(shape, k):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    rv, ri = rops.stream_topk(jnp.asarray(x), k)
    v, i = ops.stream_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_stream_topk_with_ties_matches_pallas_set():
    """All-zero rows: the same values and the same id set (the reference's
    network scrambles the order among equal values; the contract orders
    them by column)."""
    x = np.zeros((4, 256), np.float32)
    rv, ri = rops.stream_topk(jnp.asarray(x), 8)
    v, i = ops.stream_topk(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(np.sort(i.numpy(), 1), np.sort(np.asarray(ri), 1))
    assert (i.numpy() == np.arange(8)).all()


def test_stream_topk_pads_past_n_with_inf_and_minus_one():
    x = np.random.default_rng(4).standard_normal((3, 5)).astype(np.float32)
    rv, ri = rops.stream_topk(jnp.asarray(x), 8)
    v, i = ops.stream_topk(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert np.isinf(v.numpy()[:, 5:]).all() and (i.numpy()[:, 5:] == -1).all()
    np.testing.assert_array_equal(i.numpy()[:, :5], np.asarray(ri)[:, :5])


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot", "neg_cosine", "kl"])
@pytest.mark.parametrize("mnk", [(64, 128, 4), (130, 1000, 25)])
def test_fused_knn_matches_pallas(name, mnk):
    m, n, k = mnk
    x, y = _data(name, m, n, 64, 4)
    want = rops.fused_knn(jnp.asarray(x), jnp.asarray(y), k, distance=name,
                          tile_m=64, tile_n=128, bd=32)
    got = ops.fused_knn(*_t(x, y), k, distance=name)
    assert got.distances.shape == got.indices.shape == (m, k)
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances),
                               atol=3e-3, rtol=1e-3)
    # Ids equal except at near-ties: where they differ, both ids' true
    # distances must be within the tolerance of each other.
    D = ref.pairwise_distance_ref(*_t(x, y), distance=name).numpy()
    gi, wi = got.indices.numpy(), np.asarray(want.indices)
    rows = np.arange(m)[:, None]
    np.testing.assert_allclose(D[rows, gi], D[rows, wi], atol=3e-3, rtol=1e-3)
    assert (gi == wi).mean() > 0.99


def test_fused_knn_exclude_self_db_valid_and_live_match_pallas():
    x, _ = _data("sqeuclidean", 64, 64, 32, 5)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    kw = dict(tile_m=64, tile_n=64, bd=32)
    for args in (dict(exclude_self=True), dict(db_valid=10)):
        want = rops.fused_knn(xj, xj, 5, **kw, **{k: (jnp.int32(v) if k == "db_valid" else v)
                                               for k, v in args.items()})
        got = ops.fused_knn(xt, xt, 5, **args)
        np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    live = np.arange(64) >= 32
    want = rops.fused_knn(xj, xj, 5, **kw, db_live=jnp.asarray(live))
    got = ops.fused_knn(xt, xt, 5, db_live=torch.from_numpy(live))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert (got.indices.numpy() >= 32).all()


@pytest.mark.parametrize("name", ["sqeuclidean", "hellinger", "kl"])
def test_oracles_match_reference_oracles(name):
    from repro.kernels import ref as rref

    x, y = _data(name, 30, 40, 16, 8)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    xt, yt = _t(x, y)
    np.testing.assert_allclose(ref.pairwise_distance_mxu_ref(xt, yt, distance=name).numpy(),
                               np.asarray(rref.pairwise_distance_mxu_ref(xj, yj, distance=name)),
                               atol=1e-5, rtol=1e-5)
    rv, ri = rref.fused_knn_ref(xj, xj, 7, distance=name, exclude_self=True)
    pv, pi = ref.fused_knn_ref(xt, xt, 7, distance=name, exclude_self=True)
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    rv, ri = rref.stream_topk_ref(yj, 5)
    pv, pi = ref.stream_topk_ref(yt, 5)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


def test_fused_equals_two_phase_pipeline():
    x, y = _t(*_data("sqeuclidean", 128, 256, 64, 7))
    fused = ops.fused_knn(x, y, 20)
    v2, i2 = ops.stream_topk(ops.pairwise_distance(x, y), 20)
    np.testing.assert_allclose(fused.distances.numpy(), v2.numpy(), atol=1e-5)
    np.testing.assert_array_equal(fused.indices.numpy(), i2.numpy())


def test_plain_versions_keep_the_contract_and_launch_nothing():
    """On CPU tensors the wrappers run the plain versions (no launch), and
    those give the K smallest by (value, column) with +inf -> -1."""
    x = np.array([[3.0, 1.0, 1.0, np.inf, 0.5, 1.0]], np.float32)
    before = (PD.LAUNCHES, ST.LAUNCHES, FK.LAUNCHES)
    v, i = ST.stream_topk(torch.from_numpy(x), 8)
    assert i.tolist() == [[4, 1, 2, 5, 0, -1, -1, -1]]
    assert np.isinf(v.numpy()[0, 5:]).all()
    fx, gy, hx, hy, alpha = ops._mxu_operands(*_t(*_data("sqeuclidean", 9, 12, 8, 1)),
                                              "sqeuclidean")
    PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity")
    fv, fi = FK.fused_knn(fx, gy, hx, hy, 3, distance_finalize="identity", alpha=alpha,
                          n_real=12)
    assert fv.shape == (9, 4)
    assert (PD.LAUNCHES, ST.LAUNCHES, FK.LAUNCHES) == before
    before = (RS.LAUNCHES, IVS.LAUNCHES)
    rv, rp = RS.rescore_topk(fx, gy[None].expand(9, 12, 8).contiguous(), hx,
                             hy.expand(9, 12).contiguous(), 3, alpha=alpha, finalize="identity")
    torch.testing.assert_close(rv, fv)  # every row's candidates are the whole database
    assert torch.equal(rp, fi)
    probes = torch.zeros((1, 1), dtype=torch.int32)
    iv, ii = IVS.ivf_scan(probes, fx, gy, hx, hy, 3, cell_cap=12, tile_m=16,
                          cell_extent=torch.full((1,), 12, dtype=torch.int32),
                          distance_finalize="identity", alpha=alpha)
    assert torch.equal(iv, fv) and torch.equal(ii, fi)  # one cell, the whole database
    assert (RS.LAUNCHES, IVS.LAUNCHES) == before


@pytest.mark.parametrize("tile_m", [8, 16])
def test_ivf_scan_stops_each_cell_at_its_extent(tile_m):
    """The scan reads each cell's first cell_extent[c] slots only: where the
    slots past them are dead (+inf) the result is the whole-cell scan's, a
    live slot past an extent is never returned, and a union of empty cells
    comes back as +inf / -1."""
    from repro_torch.core.ivf import tile_probe_lists

    g = torch.Generator().manual_seed(tile_m)
    ncells, cap, d, m = 6, 16, 8, 16
    extent = torch.tensor([16, 0, 5, 9, 1, 12], dtype=torch.int32)
    gy = torch.randn(ncells * cap, d, generator=g)
    fx, hx, hy = torch.randn(m, d, generator=g), torch.zeros(m, 1), torch.zeros(1, ncells * cap)
    past = torch.arange(ncells * cap) % cap >= extent.repeat_interleave(cap)
    probes = tile_probe_lists(torch.randint(0, ncells, (m, 2), generator=g, dtype=torch.int32),
                              ncells, tile_m)
    kw = dict(cell_cap=cap, tile_m=tile_m, distance_finalize="identity", alpha=-1.0)
    v, i = IVS.ivf_scan(probes, fx, gy, hx, hy, 8, cell_extent=extent, **kw)
    assert (i >= 0).any() and not past[i[i >= 0].long()].any()
    whole = torch.full((ncells,), cap, dtype=torch.int32)
    wv, wi = IVS.ivf_scan(probes, fx, gy, hx, torch.where(past[None, :], T.POS_INF, hy), 8,
                          cell_extent=whole, **kw)
    torch.testing.assert_close(v, wv, rtol=1e-6, atol=1e-6)
    assert torch.equal(i, wi)
    empty = torch.ones((m // tile_m, 2), dtype=torch.int32)  # cell 1 has an extent of 0
    ev, ei = IVS.ivf_scan(empty, fx, gy, hx, hy, 8, cell_extent=extent, **kw)
    assert torch.isinf(ev).all() and (ei == -1).all()
    with pytest.raises(ValueError, match="cell_extent"):
        IVS.ivf_scan(probes, fx, gy, hx, hy, 8, cell_extent=extent.long(), **kw)


def test_cell_extent_is_one_past_the_last_live_slot():
    live = torch.tensor([[1, 1, 0, 1, 0, 0], [0] * 6, [1, 0, 0, 0, 0, 0], [1] * 6],
                        dtype=torch.bool)
    assert ops.cell_extent(live.reshape(-1), 4, 6).tolist() == [4, 0, 1, 6]
    assert ops.cell_extent(None, 3, 8).tolist() == [8, 8, 8]
    assert ops.cell_extent(live.reshape(-1), 4, 6).dtype == torch.int32


def test_unported_operands_raise():
    """Every operand is ported: the packed filter bitmap is taken (a bool or
    fp32 mask is refused, not cast), as is K = 512 on the CPU; wrong types
    and shapes still raise."""
    x, y = _t(*_data("sqeuclidean", 8, 16, 8, 2))
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, "sqeuclidean")
    allowed = torch.from_numpy(np.random.default_rng(1).random((8, 16)) < 0.5)
    masked = FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                          n_real=16, q_mask=FK.pack_mask(allowed))
    plain = FK.fused_knn_plain(fx, gy, hx, hy, 4, alpha=alpha, finalize="identity",
                               n_real=16, q_mask=FK.pack_mask(allowed))
    assert torch.equal(masked[1], plain[1])
    for bad in (torch.ones(8, 16), allowed, FK.pack_mask(allowed)[:3]):
        with pytest.raises(ValueError):
            FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                         n_real=16, q_mask=bad)
    with pytest.raises(ValueError):  # a storage type the kernels do not read
        FK.fused_knn(fx, gy.half(), hx, hy, 4, distance_finalize="identity", alpha=alpha,
                     n_real=16)
    with pytest.raises(ValueError):  # a scale of the wrong shape
        FK.fused_knn(fx, gy.to(torch.int8), hx, hy, 4, distance_finalize="identity",
                     alpha=alpha, n_real=16, gy_scale=hy[:, :3].contiguous())
    assert torch.equal(ops.fused_knn(x, y, 4, q_allowed=FK.pack_mask(allowed)).indices,
                       masked[1])
    assert ST.stream_topk(torch.zeros(2, 600), 300)[1].shape == (2, 512)
    with pytest.raises(ValueError):  # a wrong dtype is refused, not cast
        PD.pairwise_distance(fx.double(), gy, hx, hy, alpha=alpha, finalize="identity")


def test_split_plan_covers_every_tile():
    """Every database tile falls in exactly one split, and a split grid
    never holds more CTAs than the card keeps resident (one wave)."""
    for m, n, K, resident in [(1024, 1 << 20, 16, 132), (8, 1 << 20, 16, 264),
                              (160_000, 160_000, 128, 132), (5, 300, 256, 132),
                              (100, 129, 8, 4)]:
        bm = SC.block_rows(m, K)
        splits, tps = SC.split_plan(m, n, bm, 128, resident)
        n_tiles, row_tiles = -(-n // 128), -(-m // bm)
        assert bm in (64, 128) and (K <= 128 or bm == 64)
        assert (splits - 1) * tps < n_tiles <= splits * tps
        assert splits == 1 or splits * row_tiles <= resident
    assert SC.split_plan(1024, 1 << 20, 128, 128, 132) == (16, 512)  # serving batch: split
    assert SC.split_plan(160_000, 160_000, 128, 128, 132)[0] == 1  # all-pairs: enough rows


@pytest.mark.parametrize("module,entry", [(PD, "pairwise_distance_f32"),
                                          (ST, "stream_topk_f32"),
                                          (ST, "stream_topk_occupancy"), (FK, "fused_knn"),
                                          (MP, "merge_partials_f32"),
                                          (FK, "fused_knn_occupancy"),
                                          (FK, "fused_knn_masked"),
                                          (FK, "fused_knn_masked_occupancy"),
                                          (IVS, "ivf_scan"), (IVS, "ivf_scan_occupancy"),
                                          (IVS, "ivf_scan_table"),
                                          (RS, "rescore_f32"), (RS, "rescore_occupancy"),
                                          (PQS, "pq_scan"),
                                          (PQS, "pq_scan_occupancy"),
                                          (PD, "pairwise_cumulative")])
def test_ctypes_signatures_match_the_cuda_sources(module, entry):
    """The C entry point's parameter list and the wrapper's argtypes agree:
    a pointer or the stream is void*, an int is int, alpha (or init) is
    float."""
    from repro_torch.kernels import _backend as B

    # The library an entry point lives in: the longest source name it starts with.
    name = max((lib for lib in B.KERNEL_SOURCES if entry.startswith(lib)), key=len)
    src = (CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert m, entry
    kinds = []
    for param in m.group(1).split(","):
        p = param.strip()
        kinds.append("ptr" if "*" in p else "float" if p.startswith("float") else "int")
    import ctypes

    want = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    if entry == "pairwise_cumulative":
        argtypes = module.CUMULATIVE_ARGTYPES
    elif entry.endswith("_occupancy"):
        argtypes = getattr(module, "OCCUPANCY_ARGTYPES", SC.OCCUPANCY_ARGTYPES)
    elif entry.endswith("_masked"):
        argtypes = module.MASKED_ARGTYPES
    elif entry.endswith("_table"):
        argtypes = module.TABLE_ARGTYPES
    else:
        argtypes = module.C_ARGTYPES
    assert [want[k] for k in kinds] == argtypes
    assert "repro_error_string" in (CSRC / "common.cuh").read_text()


@pytest.mark.parametrize("library", ["fused_knn", "fused_knn_masked", "ivf_scan"])
def test_scan_dtype_codes_match_the_cuda_sources(library):
    """The storage-type codes the wrappers pass are the ones the C side
    switches on, and each scan kernel is compiled for every type, with and
    without a scale."""
    header = (CSRC / "scan.cuh").read_text()
    codes = dict(re.findall(r"k(F32|Bf16|I8) = (\d)", header))
    assert {"F32": torch.float32, "Bf16": torch.bfloat16, "I8": torch.int8} == {
        key: next(dt for dt, c in SC.GY_CODES.items() if c == int(v)) for key, v in codes.items()}
    for tb in ("float", "Bf16", "int8_t"):
        assert re.search(rf"f\(Type<{tb}>{{}}, std::true_type{{}}\) : f\(Type<{tb}>{{}}, "
                         r"std::false_type{}\)", header), tb
    src = (CSRC / f"{library}.cu").read_text()
    if library.startswith("fused_knn"):  # the entry points' bodies live in the shared header
        src += (CSRC / "fused_knn.cuh").read_text()
    assert "dispatch_gy(gy_dtype, gs != nullptr" in src
    assert "dispatch_gy(gy_dtype, scaled != 0" in src


def test_k_above_the_buffer_is_refused_by_every_wrapper():
    """ROADMAP F1: past the card's narrow K-buffer (256) every wrapper's
    plain version serves a CPU tensor at any K, as the reference does; the
    card's refusals are held in tests/test_torch_gpu.py."""
    assert T.next_pow2(257) > ST.MAX_K
    x, y = _t(*_data("sqeuclidean", 4, 300, 8, 3))
    got = ops.fused_knn(x, y, 257)
    dm = ops.pairwise_distance(x, y)
    want = ST.stream_topk_plain(dm, 257)
    assert torch.equal(got.indices, want[1][:, :257])
    assert torch.equal(ops.stream_topk(dm, 257)[1], want[1][:, :257])
    parts = torch.stack([want[0], want[0]]), torch.stack([want[1], want[1]])
    assert torch.equal(MP.merge_partials(*parts)[1], MP.merge_partials_plain(*parts)[1])
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, "sqeuclidean")
    rv, rp = RS.rescore_topk(fx, gy[None].expand(4, 300, 8).contiguous(), hx,
                             hy.expand(4, 300).contiguous(), 257, alpha=alpha,
                             finalize="identity")
    assert torch.equal(rp, want[1])


def _partials(S, m, K, seed, ties):
    """[S, m, K] ascending partial sets over disjoint column ranges, split s
    below split s + 1, with +inf/-1 empty slots."""
    g = np.random.default_rng(seed)
    v = (g.integers(0, 20, (S, m, K)) if ties else g.standard_normal((S, m, K))).astype(np.float32)
    v[:, :, K // 2 :][g.random((S, m, K - K // 2)) < 0.25] = np.inf
    v.sort(axis=2)
    i = np.empty((S, m, K), np.int32)
    for s_ in range(S):
        for r in range(m):
            i[s_, r] = s_ * 10 * K + np.sort(g.choice(10 * K, K, replace=False))
    i[np.isinf(v)] = -1
    return v, i


@pytest.mark.parametrize("S,m,K", [(2, 4, 8), (5, 9, 16), (33, 3, 16)])
def test_merge_partials_matches_reference_merge(S, m, K):
    """The merge kernel's plain version against the JAX package's bitonic
    tree merge of stacked partial sets: equal where no values tie."""
    v, i = _partials(S, m, K, S + m, ties=False)
    rv, ri = RT.merge_many_sorted(jnp.asarray(v), jnp.asarray(i), K)
    pv, pi = MP.merge_partials(torch.from_numpy(v), torch.from_numpy(i))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    fin = np.isfinite(pv.numpy())
    np.testing.assert_array_equal(pi.numpy()[fin], np.asarray(ri)[fin])
    assert (pi.numpy()[~fin] == -1).all()


def test_merge_partials_ties_go_to_the_lower_column():
    """With ties, the merge gives the K smallest by (value, column): the
    contract of one unsplit pass over the same columns."""
    v, i = _partials(6, 5, 16, 1, ties=True)
    pv, pi = MP.merge_partials(torch.from_numpy(v), torch.from_numpy(i))
    for r in range(5):
        cand = sorted((float(a), int(b)) for a, b in zip(v[:, r].ravel(), i[:, r].ravel())
                      if np.isfinite(a))[:16]
        got = [(float(a), int(b)) for a, b in zip(pv[r].numpy(), pi[r].numpy()) if b >= 0]
        assert got == cand
    rv, _ = RT.merge_many_sorted(jnp.asarray(v), jnp.asarray(i), 16)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_split_fused_then_merge_equals_one_pass():
    """Fused top-K over column ranges, merged, equals one pass over all."""
    fx, gy, hx, hy, alpha = ops._mxu_operands(*_t(*_data("neg_dot", 7, 600, 16, 2)), "neg_dot")
    whole_v, whole_i = FK.fused_knn(fx, gy, hx, hy, 10, distance_finalize="identity",
                                    alpha=alpha, n_real=600)
    parts = []
    for c0 in range(0, 600, 128):
        pv, pi = FK.fused_knn_partials(fx, gy[c0 : c0 + 128].contiguous(), hx,
                                       hy[:, c0 : c0 + 128].contiguous(), 10,
                                       distance_finalize="identity", alpha=alpha,
                                       n_real=min(128, 600 - c0))
        assert pv.shape == (1, 7, 16)
        parts.append((pv[0], torch.where(pi[0] >= 0, pi[0] + c0, pi[0])))
    mv, mi = MP.merge_partials(torch.stack([p[0] for p in parts]).contiguous(),
                               torch.stack([p[1] for p in parts]).contiguous())
    assert torch.equal(mv, whole_v) and torch.equal(mi, whole_i)


def test_split_ivf_scan_then_merge_equals_one_pass():
    """The probe list cut into ranges of slots, each range's partial sets
    merged, equals one pass over the whole list; duplicate slots are skipped."""
    g = np.random.default_rng(5)
    cap, ncells, d = 32, 10, 16
    fx, gy, hx, hy, alpha = ops._mxu_operands(*_t(*_data("neg_dot", 9, cap * ncells, d, 6)),
                                              "neg_dot")
    hy = torch.where(torch.from_numpy(g.random(cap * ncells) < 0.2)[None, :], T.POS_INF, hy)
    probes = torch.tensor([[0, 2, 3, 5, 7, 8, 8, 8]], dtype=torch.int32)
    kw = dict(cell_cap=cap, tile_m=16, distance_finalize="identity", alpha=alpha,
              cell_extent=torch.full((ncells,), cap, dtype=torch.int32))
    whole_v, whole_i = IVS.ivf_scan(probes, fx, gy, hx, hy, 10, **kw)
    dup_v, dup_i = IVS.ivf_scan(torch.tensor([[0, 0, 2, 3, 3, 5, 7, 8]], dtype=torch.int32),
                                fx, gy, hx, hy, 10, **kw)
    assert torch.equal(dup_v, whole_v) and torch.equal(dup_i, whole_i)
    parts = [IVS.ivf_scan_partials(probes[:, a:b].contiguous(), fx, gy, hx, hy, 10, **kw)
             for a, b in ((0, 3), (3, 5), (5, 8))]
    mv, mi = MP.merge_partials(torch.cat([p[0] for p in parts]).contiguous(),
                               torch.cat([p[1] for p in parts]).contiguous())
    assert torch.equal(mv, whole_v) and torch.equal(mi, whole_i)
    cols = torch.cat([torch.arange(c * cap, (c + 1) * cap) for c in (0, 2, 3, 5, 7, 8)])
    pv, pi = FK.fused_knn_plain(fx, gy[cols], hx, hy[:, cols], 10, alpha=alpha,
                                finalize="identity", n_real=len(cols))
    assert torch.equal(whole_v, pv)
    assert torch.equal(whole_i, torch.where(pi >= 0, cols[pi.clamp(min=0).long()].int(), pi))


def test_check_topk_holds_ids_not_only_values():
    """The result check used on the card: swapped exact ties and a tie cut
    at the k-th place pass; right values under wrong ids fail."""
    fx, gy, hx, hy, alpha = ops._mxu_operands(*_t(*_data("sqeuclidean", 6, 50, 8, 3)),
                                              "sqeuclidean")
    hy = hy.clone()

    def plain():
        return FK.fused_knn_plain(fx, gy, hx, hy, 8, alpha=alpha, finalize="identity",
                                  n_real=50)

    def twin(src):  # a column outside row 0's set becomes a copy of column src
        t = max(set(range(50)) - set(plain()[1][0].tolist()))
        gy[t], hy[0, t] = gy[src], hy[0, src]
        return t

    first = int(plain()[1][0, 0])
    twins = {first, twin(first)}
    last = int(plain()[1][0, 7])
    pair = {last, twin(last)}
    twins |= pair
    pv, pi = plain()
    kw = dict(n=50, rtol=1e-5, atol=1e-4,
              dist=ref.operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity"))
    assert ref.check_topk(pv, pi, pv, pi, **kw)["id_agreement"] == 1.0
    swapped = pi.clone()
    swapped[0, :2] = swapped[0, :2].flip(0)  # the first column and its twin
    assert ref.check_topk(pv, swapped, pv, pi, **kw)["swapped"] == 2
    cut = pi.clone()
    cut[0, 7] = (pair - {int(pi[0, 7])}).pop()
    assert ref.check_topk(pv, cut, pv, pi, **kw)["cut_ties"] == 1
    wrong = pi.clone()
    wrong[1, [0, 7]] = wrong[1, [7, 0]]  # distinct distances, ids swapped
    with pytest.raises(AssertionError):
        ref.check_topk(pv, wrong, pv, pi, **kw)
    outsider = pi.clone()
    outsider[2, 0] = min(set(range(50)) - set(pi[2].tolist()) - twins)
    with pytest.raises(AssertionError):
        ref.check_topk(pv, outsider, pv, pi, **kw)
