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
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as PD
from repro_torch.kernels import ref
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


def test_unported_operands_raise():
    x, y = _t(*_data("sqeuclidean", 8, 16, 8, 2))
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, "sqeuclidean")
    with pytest.raises(NotImplementedError):
        FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                     n_real=16, gy_scale=hy)
    with pytest.raises(NotImplementedError):
        FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                     n_real=16, q_mask=torch.ones(8, 16))
    with pytest.raises(NotImplementedError):
        FK.fused_knn(fx, gy.to(torch.bfloat16), hx, hy, 4, distance_finalize="identity",
                     alpha=alpha, n_real=16)
    with pytest.raises(NotImplementedError):
        ops.fused_knn(x, y, 4, q_allowed=torch.ones(8, 16, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        ops.pairwise_distance(x, y, cumulative=True)
    with pytest.raises(ValueError):  # K = 512 is past the kernels' buffer
        ST.stream_topk(torch.zeros(2, 600), 300)
    with pytest.raises(ValueError):  # a wrong dtype is refused, not cast
        PD.pairwise_distance(fx.double(), gy, hx, hy, alpha=alpha, finalize="identity")


def test_split_plan_covers_every_tile():
    """Every database tile falls in exactly one split, and a split grid
    never holds more CTAs than the card keeps resident (one wave)."""
    for m, n, K, resident in [(1024, 1 << 20, 16, 132), (8, 1 << 20, 16, 264),
                              (160_000, 160_000, 128, 132), (5, 300, 256, 132),
                              (100, 129, 8, 4)]:
        bm = FK.block_rows(m, K)
        splits, tps = FK.split_plan(m, n, bm, 128, resident)
        n_tiles, row_tiles = -(-n // 128), -(-m // bm)
        assert bm in (64, 128) and (K <= 128 or bm == 64)
        assert (splits - 1) * tps < n_tiles <= splits * tps
        assert splits == 1 or splits * row_tiles <= resident
    assert FK.split_plan(1024, 1 << 20, 128, 128, 132) == (16, 512)  # serving batch: split
    assert FK.split_plan(160_000, 160_000, 128, 128, 132)[0] == 1  # all-pairs: enough rows


@pytest.mark.parametrize("module,entry", [(PD, "pairwise_distance_f32"),
                                          (ST, "stream_topk_f32"), (FK, "fused_knn_f32"),
                                          (MP, "merge_partials_f32"),
                                          (FK, "fused_knn_occupancy")])
def test_ctypes_signatures_match_the_cuda_sources(module, entry):
    """The C entry point's parameter list and the wrapper's argtypes agree:
    a pointer or the stream is void*, an int is int, alpha is float."""
    src = (CSRC / (entry.rsplit("_", 1)[0] + ".cu")).read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert m, entry
    kinds = []
    for param in m.group(1).split(","):
        p = param.strip()
        kinds.append("ptr" if "*" in p else "float" if p.startswith("float") else "int")
    import ctypes

    want = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}
    argtypes = FK.OCCUPANCY_ARGTYPES if entry == "fused_knn_occupancy" else module.C_ARGTYPES
    assert [want[k] for k in kinds] == argtypes
    assert "repro_error_string" in (CSRC / "common.cuh").read_text()


def test_k_above_the_buffer_is_refused_by_every_wrapper():
    assert T.next_pow2(257) > ST.MAX_K
    x, y = _t(*_data("sqeuclidean", 4, 300, 8, 3))
    with pytest.raises(ValueError):
        ops.fused_knn(x, y, 257)


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
