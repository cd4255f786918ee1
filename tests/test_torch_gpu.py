"""The port's CUDA kernels on the card, held against their plain versions,
the recommender's trainer on the card held against the CPU (whole, and
sharded over a (2, 2) mesh of the card against four CPU positions), and
the language models' serve steps sharded over a (2, 2) mesh of the card
against their whole steps.

Every test here needs a CUDA device and skips without one.  The file
imports torch and the port only, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the kernels sum the d products in another order than the plain
matmul, so fp32 values agree to rounding (rtol 1e-5 plus an atol of 1e-5
times the size of the operands' products); ids agree except where two
distances are that close, and there the differing id's own distance,
recomputed from the operands, must be the value it is reported at.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import (
    cumulative_kind,
    finalize_kind,
    get_distance,
    quantize_rows,
)
from repro_torch.kernels import _backend as B
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ivf_scan as IVS
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as PD
from repro_torch.kernels import pq_scan as PQS
from repro_torch.kernels import rescore as RS
from repro_torch.kernels import scan as SC
from repro_torch.kernels import stream_topk as ST
from repro_torch.kernels.ref import check_topk, operand_distance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _data(name, m, n, d, seed):
    g = np.random.default_rng(seed)
    if get_distance(name).needs_positive:
        x = g.gamma(1.0, 1.0, (m, d)).astype(np.float32) + 1e-4
        y = g.gamma(1.0, 1.0, (n, d)).astype(np.float32) + 1e-4
        x /= x.sum(1, keepdims=True)
        y /= y.sum(1, keepdims=True)
    else:
        x = g.standard_normal((m, d)).astype(np.float32)
        y = g.standard_normal((n, d)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _operands(name, x, y, dev):
    return [t.to(dev) for t in ops._mxu_operands(x, y, name)[:4]] + [
        get_distance(name).matmul_form.alpha]


def _assert_topk_close(v, i, pv, pi, tol, fx, gy, hx, hy, alpha, fin="identity"):
    """Values agree slot by slot; ids agree except between near-equal values,
    where the differing id's own distance is the value at its slot."""
    check_topk(v, i, pv, pi, n=gy.shape[0], rtol=1e-5, atol=tol,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize=fin))


@pytest.mark.parametrize("name", ["sqeuclidean", "euclidean", "neg_dot", "kl", "hellinger"])
@pytest.mark.parametrize("shape", [(1, 1, 4), (100, 130, 20), (256, 384, 256), (300, 1000, 68),
                                   (130, 300, 36), (64, 131, 260)])
def test_pairwise_kernel_matches_plain(cuda, name, shape):
    m, n, d = shape
    x, y = _data(name, m, n, d, 0)
    fx, gy, hx, hy, alpha = _operands(name, x, y, cuda)
    fin = finalize_kind(get_distance(name))
    before = PD.LAUNCHES
    out = PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize=fin)
    torch.cuda.synchronize()
    assert PD.LAUNCHES == before + 1
    want = PD.pairwise_distance_plain(fx, gy, hx, hy, alpha=alpha, finalize=fin)
    scale = float(fx.abs().max() * gy.abs().max()) * d
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * scale + 1e-6)


@pytest.mark.parametrize("shape,k", [((1, 1), 1), ((8, 300), 7), ((64, 1000), 16),
                                     ((5, 4096), 100), ((33, 700), 256), ((16, 50), 64)])
@pytest.mark.parametrize("skip", [True, False])
def test_stream_topk_kernel_matches_plain_exactly(cuda, shape, k, skip):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    x = x.to(cuda)
    v, i = ST.stream_topk(x, k, threshold_skip=skip)
    pv, pi = ST.stream_topk_plain(x, k)
    torch.testing.assert_close(v, pv, rtol=0, atol=0)
    torch.testing.assert_close(i, pi, rtol=0, atol=0)


@pytest.mark.parametrize("K", [2 ** e for e in range(13)])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("m,n", [(3, 50_003), (700, 3000)])
def test_stream_topk_every_k_matches_plain_exactly(cuda, K, skip, m, n):
    """K from 1 to the cap on values with many exact ties and some +inf,
    rows too few to fill the card (the columns split, the splits merged)
    and enough to fill it; an odd n takes the 4-byte copies."""
    g = np.random.default_rng(K + m)
    x = g.integers(0, 200, (m, n)).astype(np.float32)
    x[g.random((m, n)) < 0.01] = np.inf
    x = torch.from_numpy(x).to(cuda)
    before = ST.LAUNCHES
    v, i = ST.stream_topk(x, K, threshold_skip=skip)
    torch.cuda.synchronize()
    assert ST.LAUNCHES == before + 1
    pv, pi = ST.stream_topk_plain(x, K)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    splits, per = ST.plan(m, n, K, cuda)
    assert (splits > 1) == (m == 3) and per % ST.STAGE_COLS == 0
    shape = ST.kernel_shape(cuda, K)
    assert shape["ctas_per_sm"] >= 1 and shape["ring_stages"] * shape["stage_bytes"] > 0


def test_stream_topk_all_inf_rows_and_unaligned_rows(cuda):
    """All-+inf rows come back as (+inf, -1); a view whose rows are not
    aligned to 16 bytes takes the 4-byte copies and gives the same sets."""
    x = torch.randn(40, 5000, device=cuda)
    x[3] = float("inf")
    v, i = ST.stream_topk(x, 64)
    assert torch.isinf(v[3]).all() and (i[3] == -1).all()
    flat = torch.randn(40 * 5000 + 1, device=cuda)
    y = flat[1:].view(40, 5000)  # contiguous, 4 bytes past a 16-byte boundary
    assert y.is_contiguous() and y.data_ptr() % 16 != 0
    vv, vi = ST.stream_topk(y, 64)
    pv, pi = ST.stream_topk_plain(y, 64)
    assert torch.equal(vv, pv) and torch.equal(vi, pi)


def test_stream_topk_ties_follow_column_order(cuda):
    """All-equal rows: the contract picks the lowest columns, in order."""
    x = torch.zeros((4, 256), device=cuda)
    x[1, 100:] = -1.0
    v, i = ST.stream_topk(x, 8)
    pv, pi = ST.stream_topk_plain(x, 8)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    assert i[0].tolist() == list(range(8))
    assert i[1].tolist() == list(range(100, 108))


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot", "neg_cosine", "kl", "euclidean"])
@pytest.mark.parametrize("mnk", [(64, 128, 4), (130, 1000, 25), (256, 512, 100),
                                 (8, 20000, 10), (100, 3000, 200)])
def test_fused_kernel_matches_plain(cuda, name, mnk):
    m, n, k = mnk
    x, y = _data(name, m, n, 64, 4)
    fx, gy, hx, hy, alpha = _operands(name, x, y, cuda)
    fin = finalize_kind(get_distance(name))
    before = FK.LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, k, distance_finalize=fin, alpha=alpha, n_real=n)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == before + 1
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize=fin, n_real=n)
    scale = float(fx.abs().max() * gy.abs().max()) * 64
    _assert_topk_close(v, i, pv, pi, 1e-5 * scale + 1e-6, fx, gy, hx, hy, alpha, fin)


@pytest.mark.parametrize("skip", [True, False])
def test_fused_masks_exclude_self_and_ties(cuda, skip):
    x, _ = _data("sqeuclidean", 300, 300, 32, 5)
    x[7] = x[3]  # an exact duplicate: distance 0 tie-free only by column
    fx, gy, hx, hy, alpha = _operands("sqeuclidean", x, x, cuda)
    live = torch.ones(300, dtype=torch.bool, device=cuda)
    live[::3] = False
    hy = torch.where(live[None, :], hy, T.POS_INF).contiguous()
    v, i = FK.fused_knn(fx, gy, hx, hy, 16, distance_finalize="identity", alpha=alpha,
                        n_real=290, exclude_self=True, threshold_skip=skip)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 16, alpha=alpha, finalize="identity",
                                n_real=290, exclude_self=True)
    _assert_topk_close(v, i, pv, pi, 1e-3, fx, gy, hx, hy, alpha)
    ii = i.cpu().numpy()
    assert not (ii == np.arange(300)[:, None]).any()
    assert (ii < 290).all() and (ii[ii >= 0] % 3 != 0).all()


def test_fused_split_path_equals_one_pass(cuda):
    """Few queries force a split of the database axis; the merge must give
    the same sets as the unsplit scan of the plain version."""
    x, y = _data("neg_dot", 3, 50_000, 128, 6)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    bm, splits, _ = FK.plan(3, 50_000, 16, cuda)
    assert splits > 1
    before = MP.LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, 10, distance_finalize="identity", alpha=alpha,
                        n_real=50_000)
    torch.cuda.synchronize()
    assert MP.LAUNCHES == before + 1
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 10, alpha=alpha, finalize="identity",
                                n_real=50_000)
    _assert_topk_close(v, i, pv, pi, 1e-4, fx, gy, hx, hy, alpha)


@pytest.mark.parametrize("S,m,K", [(2, 5, 16), (33, 1024, 16), (7, 300, 128), (3, 40, 256)])
def test_merge_kernel_matches_plain_exactly(cuda, S, m, K):
    """Partial sets with many exact ties and empty slots: the kernel keeps
    (value, column) order, lower splits first, as the plain version does."""
    g = torch.Generator().manual_seed(S * m + K)
    v = torch.randint(0, 50, (S, m, K), generator=g).float()
    v[:, :, K // 2 :] = torch.where(torch.rand((S, m, K - K // 2), generator=g) < 0.3,
                                    T.POS_INF, v[:, :, K // 2 :])
    v = torch.sort(v, dim=2).values
    cols = torch.sort(torch.randperm(10 * K, generator=g)[:K]).values
    i = (torch.arange(S)[:, None, None] * 10 * K + cols).expand(S, m, K).int()
    i = torch.where(torch.isinf(v), -1, i).contiguous()
    pv, pi = MP.merge_partials_plain(v, i)
    before = MP.LAUNCHES
    gv, gi = MP.merge_partials(v.to(cuda), i.to(cuda))
    torch.cuda.synchronize()
    assert MP.LAUNCHES == before + 1
    assert torch.equal(gv.cpu(), pv) and torch.equal(gi.cpu(), pi)


def test_fused_equals_two_phase_kernels(cuda):
    x, y = _data("sqeuclidean", 200, 3000, 96, 7)
    x, y = x.to(cuda), y.to(cuda)
    fused = ops.fused_knn(x, y, 20)
    v2, i2 = ops.stream_topk(ops.pairwise_distance(x, y), 20)
    _assert_topk_close(fused.distances, fused.indices, v2, i2, 1e-3,
                       *ops._mxu_operands(x, y, "sqeuclidean"))


def test_wrapper_raises_instead_of_falling_back(cuda):
    x, y = _data("sqeuclidean", 8, 16, 6, 8)
    fx, gy, hx, hy, alpha = ops._mxu_operands(x.to(cuda), y.to(cuda), "sqeuclidean")
    with pytest.raises(ValueError):  # mixed devices
        PD.pairwise_distance(fx, gy.cpu(), hx, hy, alpha=alpha, finalize="identity")
    with pytest.raises(ValueError):  # a scale left on the host
        FK.fused_knn(fx, gy.to(torch.int8), hx, hy, 4, distance_finalize="identity",
                     alpha=alpha, n_real=16, gy_scale=hy.cpu())
    for bad in (torch.ones(8, 16, device=cuda),  # a float mask is refused, not cast
                FK.pack_mask(torch.ones(8, 16, dtype=torch.bool))):  # a mask left on the host
        with pytest.raises(ValueError):
            FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                         n_real=16, q_mask=bad)


def test_index_on_card_matches_cpu_index(cuda):
    from repro_torch.serving.index import RetrievalIndex

    g = np.random.default_rng(9)
    vecs = g.standard_normal((5000, 32)).astype(np.float32)
    ids = g.permutation(100_000)[:5000]
    q = g.standard_normal((37, 32)).astype(np.float32)
    fresh = g.standard_normal((100, 32)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        idx = RetrievalIndex.build(ids, vecs, distance="neg_dot", device=dev)
        idx.upsert(ids[:300], vecs[:300] * 0.5)
        idx.delete(ids[1000:1100])
        idx.insert(np.arange(200_000, 200_100), fresh)
        r = idx.search(q, 10)
        out[dev] = (r.distances.cpu().numpy(), r.ids.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot", "neg_cosine"])
@pytest.mark.parametrize("mnk", [(64, 1000, 16), (3, 50_000, 40), (300, 3000, 100),
                                 (20, 700, 256)])
def test_fused_kernel_over_a_replica_matches_plain(cuda, scan_dtype, name, mnk):
    """bf16 / int8 gy widened in the loads, int8 scales in the epilogue."""
    m, n, k = mnk
    x, y = _data(name, m, n, 64, 10)
    db_q = quantize_rows(y.to(cuda), scan_dtype, distance=name)
    fx, gy, gs, hx, hy, alpha = ops._scan_operands(x.to(cuda), db_q, name)
    assert gy.dtype == db_q.data.dtype
    fin = finalize_kind(get_distance(name))
    before = FK.LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, k, distance_finalize=fin, alpha=alpha, n_real=n,
                        gy_scale=gs)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == before + 1
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize=fin, n_real=n,
                                gy_scale=gs)
    check_topk(v, i, pv, pi, n=n, rtol=1e-5, atol=1e-4,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize=fin, gy_scale=gs))


@pytest.mark.parametrize("gy_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("scaled", [False, True])
def test_fused_kernel_with_or_without_a_scale_on_every_storage_type(cuda, gy_dtype, scaled):
    """Each (storage type, scale) pair is a kernel of its own: a scale on an
    fp32 or bf16 gy, and int8 codes without one, follow the contract too."""
    g = torch.Generator().manual_seed(int(scaled))
    fx = torch.randn(200, 32, generator=g).to(cuda)
    gy = (torch.randn(5000, 32, generator=g) * 20).to(gy_dtype).to(cuda)
    hx, hy = torch.zeros(200, 1, device=cuda), torch.randn(1, 5000, generator=g).to(cuda)
    gs = torch.rand(1, 5000, generator=g).to(cuda) + 0.5 if scaled else None
    v, i = FK.fused_knn(fx, gy, hx, hy, 16, distance_finalize="identity", alpha=-1.0,
                        n_real=5000, gy_scale=gs)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 16, alpha=-1.0, finalize="identity",
                                n_real=5000, gy_scale=gs)
    check_topk(v, i, pv, pi, n=5000, rtol=1e-5, atol=1e-3,
               dist=operand_distance(fx, gy, hx, hy, alpha=-1.0, finalize="identity",
                                     gy_scale=gs))


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot", "euclidean"])
@pytest.mark.parametrize("m,Kp,d,k", [(1, 16, 4, 10), (1024, 64, 256, 10), (37, 160, 68, 25),
                                      (8, 512, 32, 256), (300, 20, 128, 7)])
def test_rescore_kernel_matches_plain(cuda, name, m, Kp, d, k):
    g = torch.Generator().manual_seed(m * Kp + d)
    fx = torch.randn(m, d, generator=g).to(cuda)
    cand = torch.randn(m, Kp, d, generator=g).to(cuda)
    hx = torch.randn(m, 1, generator=g).to(cuda)
    hy = torch.randn(m, Kp, generator=g).abs().to(cuda)
    hy[::3, -Kp // 4:] = T.POS_INF  # empty slots
    fin = finalize_kind(get_distance(name))
    before = RS.LAUNCHES
    v, p = RS.rescore_topk(fx, cand, hx, hy, k, alpha=-2.0, finalize=fin)
    torch.cuda.synchronize()
    assert RS.LAUNCHES == before + 1
    pv, pp = RS.rescore_topk_plain(fx, cand, hx, hy, k, alpha=-2.0, finalize=fin)

    def dist(r, c):  # a candidate position's value, from the operands
        out = -2.0 * (fx[r] * cand[r, c]).sum(1) + hx[r, 0] + hy[r, c]
        return torch.sqrt(out.clamp_min(0)) if fin == "sqrt" else out
    check_topk(v, p, pv, pp, n=Kp, rtol=1e-5, atol=1e-4, dist=dist)


@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m,tile_m,cap", [(8, 8, 128), (1024, 256, 256), (300, 256, 128),
                                          (40, 64, 512), (300, 64, 512)])
def test_ivf_scan_kernel_matches_plain(cuda, scan_dtype, m, tile_m, cap, whole):
    """Random probe lists over a packed corpus with dead slots; the list is
    split across CTAs and merged.  Cells are scanned whole, or to random
    extents (0 to cell_cap, the slots past them left live): the kernel must
    stop each cell where the plain version does."""
    ncells, d, k = 64, 64, 40
    g = torch.Generator().manual_seed(m + cap)
    extent = torch.randint(0, cap + 1, (ncells,), generator=g, dtype=torch.int32).to(cuda)
    if whole:
        extent.fill_(cap)
    packed = torch.randn(ncells * cap, d, generator=g).to(cuda)
    db_q = quantize_rows(packed, scan_dtype, distance="neg_dot")
    live = (torch.rand(ncells * cap, generator=g) > 0.3).to(cuda)
    q = torch.randn(m, d, generator=g).to(cuda)
    fx, gy, gs, hx, hy, alpha = ops._scan_operands(q, db_q, "neg_dot", live)
    m_pad = -(-m // tile_m) * tile_m
    cells = torch.randint(0, ncells, (m_pad, 4), generator=g, dtype=torch.int32).to(cuda)
    from repro_torch.core.ivf import tile_probe_lists

    probes = tile_probe_lists(cells, ncells, tile_m)
    kw = dict(cell_cap=cap, tile_m=tile_m, distance_finalize="identity", alpha=alpha,
              gy_scale=gs, cell_extent=extent)
    before = IVS.LAUNCHES
    v, i = IVS.ivf_scan(probes, fx, gy, hx, hy, k, **kw)
    torch.cuda.synchronize()
    assert IVS.LAUNCHES == before + 1
    pv, pi = IVS.ivf_scan_plain(probes, fx, gy, hx, hy, k, cell_cap=cap, tile_m=tile_m,
                                cell_extent=extent, alpha=alpha, finalize="identity",
                                gy_scale=gs)
    check_topk(v, i, pv, pi, n=ncells * cap, rtol=1e-5, atol=1e-4,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity",
                                     gy_scale=gs))


def _ivf_case(cuda, m, tile_m, cap, scan_dtype, seed, ncells=24, d=36, width=4):
    """A packed corpus with dead slots, random extents (some 0, some whole),
    and union probe lists (ascending, duplicate padding) of random queries;
    the scan's operands and the plain version's keywords."""
    g = torch.Generator().manual_seed(seed)
    extent = torch.randint(0, cap + 1, (ncells,), generator=g, dtype=torch.int32)
    extent[torch.rand(ncells, generator=g) < 0.2] = 0
    extent[torch.rand(ncells, generator=g) < 0.2] = cap
    packed = torch.randn(ncells * cap, d, generator=g).to(cuda)
    db_q = quantize_rows(packed, scan_dtype, distance="neg_dot")
    live = (torch.rand(ncells * cap, generator=g) > 0.3).to(cuda)
    q = torch.randn(m, d, generator=g).to(cuda)
    fx, gy, gs, hx, hy, alpha = ops._scan_operands(q, db_q, "neg_dot", live)
    cells = torch.randint(0, ncells, (-(-m // tile_m) * tile_m, width), generator=g,
                          dtype=torch.int32).to(cuda)
    from repro_torch.core.ivf import tile_probe_lists

    probes = tile_probe_lists(cells, ncells, tile_m)
    kw = dict(cell_cap=cap, tile_m=tile_m, alpha=alpha, gy_scale=gs,
              cell_extent=extent.to(cuda))
    return probes, fx, gy, gs, hx, hy, kw


def _ivf_check(cuda, probes, fx, gy, gs, hx, hy, k, kw):
    before = IVS.LAUNCHES
    v, i = IVS.ivf_scan(probes, fx, gy, hx, hy, k, distance_finalize="identity", **kw)
    torch.cuda.synchronize()
    assert IVS.LAUNCHES == before + 1 and v.shape == (fx.shape[0], T.next_pow2(k))
    pv, pi = IVS.ivf_scan_plain(probes, fx, gy, hx, hy, k, finalize="identity", **kw)
    _masked_check(v, i, pv, pi, fx, gy, gs, hx, hy, kw["alpha"], fx.shape[1])


@pytest.mark.parametrize("cap", [96, 200, 2048])
@pytest.mark.parametrize("m,tile_m,width", [(40, 8, 4), (1024, 256, 32), (8, 8, 64)])
@pytest.mark.parametrize("splits", [1, 8, 132])
def test_tile_table_kernel_matches_plain(cuda, cap, m, tile_m, width, splits):
    """The table the card builds equals tile_table's on every live entry,
    and its split bounds split_bounds'; one launch."""
    probes, fx, gy, gs, hx, hy, kw = _ivf_case(cuda, m, tile_m, cap, "float32", m + cap,
                                               ncells=48, d=4, width=width)
    before = IVS.TABLE_LAUNCHES
    table, bounds = IVS.build_table(probes, kw["cell_extent"], cap, splits)
    torch.cuda.synchronize()
    assert IVS.TABLE_LAUNCHES == before + 1
    want, counts = IVS.tile_table(probes.cpu(), kw["cell_extent"].cpu(), cap)
    assert torch.equal(bounds.cpu(), IVS.split_bounds(counts, splits))
    for t, c in enumerate(counts.tolist()):
        assert torch.equal(table[t, :c].cpu(), want[t, :c])


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("m,tile_m", [(40, 8), (13, 4), (200, 16)])
def test_ivf_scan_serves_union_tiles_below_its_query_block(cuda, scan_dtype, m, tile_m):
    """Union tiles of fewer queries than a CTA's 64 rows (ROADMAP F2): each
    CTA takes one union tile's rows, the rest of its rows dead."""
    probes, fx, gy, gs, hx, hy, kw = _ivf_case(cuda, m, tile_m, 200, scan_dtype, m + tile_m)
    assert probes.shape[0] == -(-m // tile_m) > 1
    _ivf_check(cuda, probes, fx, gy, gs, hx, hy, 10, kw)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("cap", [96, 200, 640])
@pytest.mark.parametrize("k", [1, 17, 100, -1])
def test_ivf_scan_on_the_tile_table_matches_plain(cuda, scan_dtype, cap, k):
    """The tile-table walk: ragged cells, cell_cap not a multiple of 128 (a
    tile runs into the next cell, whose columns must not enter), zero
    extents, duplicate padding, several union tiles of 8 queries and one
    of 300, bf16 / int8 with its scale, K from 1 to cell_cap (k = -1)."""
    k = cap if k < 0 else k
    for m, tile_m in ((40, 8), (300, 512)):
        probes, fx, gy, gs, hx, hy, kw = _ivf_case(cuda, m, tile_m, cap, scan_dtype, cap + k)
        _ivf_check(cuda, probes, fx, gy, gs, hx, hy, k, kw)


@pytest.mark.parametrize("kw", [dict(scan_dtype="int8"), dict(scan_dtype="bfloat16"),
                                dict(ivf_cells=16, nprobe=4),
                                dict(ivf_cells=16, nprobe=3, scan_dtype="int8")])
def test_index_tiers_on_card_match_cpu_index(cuda, kw):
    """The same index on the card and on the host: the IVF cells come from
    one training (on the card), carried to the host through from_arrays."""
    from repro_torch.core.ivf import IVFCells
    from repro_torch.serving.index import RetrievalIndex

    g = np.random.default_rng(11)
    vecs = g.standard_normal((4000, 32)).astype(np.float32)
    q = g.standard_normal((37, 32)).astype(np.float32)
    card = RetrievalIndex.build(np.arange(4000), vecs, distance="neg_dot", device="cuda", **kw)
    card.search(q, 10)
    ivf = card._dev.get("main_ivf")
    host = RetrievalIndex.from_arrays(
        card._main_vecs, card._main_ids, card._main_live, card._delta_vecs, card._delta_ids,
        card._delta_live, card._delta_n, distance="neg_dot", device="cpu",
        ivf=None if ivf is None else IVFCells(*(t.cpu() for t in ivf)),
        scan_dtype=card.scan_dtype, overfetch=card.overfetch, nprobe=card.nprobe)
    for index in (card, host):
        index.upsert(np.arange(300), vecs[:300] * 0.5)
        index.delete(np.arange(1000, 1100))
    a, b = card.search(q, 10), host.search(q, 10)
    np.testing.assert_allclose(a.distances.cpu().numpy(), b.distances.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert (a.ids.cpu().numpy() == b.ids.numpy()).mean() > 0.99


@pytest.mark.parametrize("name", ["sqeuclidean", "euclidean", "neg_dot", "neg_cosine",
                                  "hellinger", "kl"])
@pytest.mark.parametrize("shape", [(1, 1, 4), (100, 130, 20), (129, 257, 260),
                                   (300, 1000, 68)])
def test_pairwise_cumulative_kernel_matches_plain(cuda, name, shape):
    """Every accumulator and finalizer, with m, n and d off the 128 x 128 x
    16 tile: the same per-coordinate fold in another order."""
    m, n, d = shape
    x, y = (t.to(cuda) for t in _data(name, m, n, d, 2))
    dist = get_distance(name)
    if dist.pre is not None:
        x, y = dist.pre(x), dist.pre(y)
    x, y = ops._pad_d(x, y)
    acc, fin = cumulative_kind(dist)
    before = PD.CUMULATIVE_LAUNCHES
    out = PD.pairwise_distance_cumulative(x, y, accumulate=acc, finalize=fin, init=dist.init)
    torch.cuda.synchronize()
    assert PD.CUMULATIVE_LAUNCHES == before + 1
    want = PD.pairwise_cumulative_plain(x, y, accumulate=acc, finalize=fin, init=dist.init)
    scale = float(x.abs().max() * y.abs().max() + x.abs().max() ** 2) * d
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * scale + 1e-6)
    via_ops = ops.pairwise_distance(*_data(name, m, n, d, 2), distance=name, cumulative=True)
    torch.testing.assert_close(out.cpu(), via_ops, rtol=1e-5, atol=1e-5 * scale + 1e-6)


def _pq_case(cuda, m, tile_m, cap, pq_m, ncodes, residual, seed, ncells=64, width=4):
    """Random codes, tables, extents, dead slots and probe lists."""
    from repro_torch.core.ivf import tile_probe_lists

    g = torch.Generator().manual_seed(seed)
    S = ncells * cap
    codes = torch.randint(0, ncodes, (S, pq_m), generator=g, dtype=torch.uint8).to(cuda)
    luts = torch.randn(m, pq_m * ncodes, generator=g).to(cuda)
    hx = torch.randn(m, 1, generator=g).to(cuda)
    live = torch.rand(S, generator=g) > 0.3
    hy = torch.where(live, torch.randn(S, generator=g), float("inf"))[None, :].to(cuda)
    qc = torch.randn(m, ncells, generator=g).to(cuda) if residual else None
    extent = torch.randint(0, cap + 1, (ncells,), generator=g, dtype=torch.int32).to(cuda)
    m_pad = -(-m // tile_m) * tile_m
    cells = torch.randint(0, ncells, (m_pad, width), generator=g, dtype=torch.int32).to(cuda)
    probes = tile_probe_lists(cells, ncells, tile_m)
    kw = dict(cell_cap=cap, ncodes=ncodes, tile_m=tile_m, cell_extent=extent, qc=qc,
              distance_finalize="identity")
    return probes, luts, codes, hx, hy, kw


def _pq_check(cuda, probes, luts, codes, hx, hy, k, kw, skip=None):
    """One launch (and its merge) against the plain version: values to
    rounding, ids tie-aware, each differing id at its own ADC value."""
    before = PQS.LAUNCHES
    v, i = PQS.pq_scan(probes, luts, codes, hx, hy, k, threshold_skip=skip, **kw)
    torch.cuda.synchronize()
    assert PQS.LAUNCHES == before + 1
    plain_kw = {key: val for key, val in kw.items() if key != "distance_finalize"}
    pv, pi = PQS.pq_scan_plain(probes, luts, codes, hx, hy, k, finalize="identity", **plain_kw)
    m, pq_m = luts.shape[0], codes.shape[1]
    lut3 = luts.reshape(m, pq_m, kw["ncodes"])
    qc, cap = kw["qc"], kw["cell_cap"]

    def adc(rows, cols):
        s = lut3[rows[:, None], torch.arange(pq_m, device=cuda)[None, :],
                 codes[cols].long()].sum(1)
        if qc is not None:
            s = s + qc[rows, cols // cap]
        return s + hx[rows, 0] + hy[0, cols]

    check_topk(v, i, pv, pi, n=codes.shape[0], rtol=1e-5, atol=1e-4, dist=adc)


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("pq_m,nbits", [(32, 8), (32, 4), (8, 8), (8, 4), (6, 8), (6, 4),
                                        (256, 8), (256, 4)])
@pytest.mark.parametrize("m,tile_m,cap", [(8, 8, 128), (1024, 256, 256), (300, 256, 128)])
def test_pq_scan_kernel_matches_plain(cuda, residual, pq_m, nbits, m, tile_m, cap):
    """Random codes, tables, extents and dead slots: the kernel equals its
    plain version, values to rounding and ids tie-aware, in ring mode
    (pq_m 32), generic mode (8, 6; 256 at 4 bits, whose ring would not fit)
    and with the tables in chunks (256 at 8 bits), whether the probe list is
    split across CTAs (a batch of 8) or not."""
    ncodes, k = 2 ** nbits, 40
    probes, luts, codes, hx, hy, kw = _pq_case(cuda, m, tile_m, cap, pq_m, ncodes, residual,
                                               m + pq_m + cap)
    _pq_check(cuda, probes, luts, codes, hx, hy, k, kw)
    pl = PQS.plan(probes, m, pq_m, ncodes, T.next_pow2(k), cuda, tile_m)
    qb, ring, chunk = PQS.kernel_mode(pq_m, ncodes, T.next_pow2(k))
    assert (pl.qb, pl.ring, pl.chunk) == (min(qb, tile_m), ring, chunk)
    assert pl.ring == (pq_m == 32)
    assert (pl.chunk < pq_m) == (pq_m * ncodes * 4 > PQS.LUT_BUDGET)
    if m == 8:  # one or two CTAs of queries: the list is split to fill the card
        assert pl.splits > 1
    if m == 1024 and pq_m * ncodes == 32 * 256:  # 512 CTAs of two queries: no split
        assert pl.splits == 1


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("pq_m,K", [(32, 1), (32, 16), (32, 256), (32, 4096), (8, 1),
                                    (8, 1024), (256, 64), (256, 2048)])
def test_pq_scan_every_width_with_and_without_the_skip(cuda, skip, pq_m, K):
    """K from 1 to the cap, the threshold skip on and off (every valid slot
    staged: the same result), on a cell_cap of 4096 so that K fits a cell."""
    probes, luts, codes, hx, hy, kw = _pq_case(cuda, 24, 8, 4096, pq_m, 256, K % 2 == 0,
                                               K + pq_m, ncells=8, width=3)
    _pq_check(cuda, probes, luts, codes, hx, hy, K, kw, skip=skip)


def test_pq_scan_serves_a_table_past_shared_memory(cuda):
    """pq_m 256 at 8 bits: one query's table is 256 KiB, past a CTA's shared
    memory; the kernel walks it in chunks that fit and equals its plain
    version (ROADMAP F2)."""
    m, pq_m, ncodes = 40, 256, 256
    probes, luts, codes, hx, hy, kw = _pq_case(cuda, m, 16, 256, pq_m, ncodes, True, 5)
    pl = PQS.plan(probes, m, pq_m, ncodes, 16, cuda, 16)
    assert (pl.qb, pl.ring) == (1, False) and pq_m * ncodes * 4 > PQS.LUT_BUDGET
    assert pl.chunk * ncodes * 4 <= PQS.LUT_BUDGET and pl.chunk < pq_m
    per_sm, smem = PQS.kernel_shape(cuda, pl.qb, pl.ring, pl.chunk, pq_m, ncodes, 16)
    assert per_sm >= 1 and smem == PQS.smem_bytes(pl.qb, pl.ring, pl.chunk, pq_m, ncodes, 16)
    _pq_check(cuda, probes, luts, codes, hx, hy, 10, kw)


# The 3xTF32 wgmma tile product (csrc/gemm_tc.cuh) of pairwise_distance and
# fused_knn, against float64 where a one-pass TF32 product would fail.

def _f64_matrix(fx, gy, hx, hy, alpha, fin="identity"):
    t = alpha * (fx.double() @ gy.double().T) + hx.double() + hy.double()
    return t.clamp(min=0).sqrt() if fin == "sqrt" else t


def _cancelling(name, m, n, d, seed):
    """Rows where the product's rounding shows: a large common offset for
    sqeuclidean (-2 x.y cancels against the norms), rows of norm ~ 1e3 for
    neg_dot."""
    x, y = _data("sqeuclidean", m, n, d, seed)
    if name == "sqeuclidean":
        return x + 30.0, y + 30.0
    return x * 60.0, y * 60.0


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot"])
@pytest.mark.parametrize("shape", [(300, 1000, 256), (129, 257, 260)])
def test_pairwise_kernel_matches_float64_where_cancellation_bites(cuda, name, shape):
    m, n, d = shape
    x, y = _cancelling(name, m, n, d, 20)
    fx, gy, hx, hy, alpha = _operands(name, x, y, cuda)
    out = PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity")
    want = _f64_matrix(fx, gy, hx, hy, alpha)
    scale = float(fx.abs().max() * gy.abs().max()) * d
    torch.testing.assert_close(out.double(), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_fused_kernel_matches_float64_where_cancellation_bites(cuda, name, exclude_self):
    x, _ = _cancelling(name, 700, 700, 256, 21)
    fx, gy, hx, hy, alpha = _operands(name, x, x, cuda)
    v, i = FK.fused_knn(fx, gy, hx, hy, 10, distance_finalize="identity", alpha=alpha,
                        n_real=700, exclude_self=exclude_self)
    full = _f64_matrix(fx, gy, hx, hy, alpha)
    if exclude_self:
        full.fill_diagonal_(float("inf"))
    pv, pi = ST.sorted_prefix(full, 16)
    scale = float(fx.abs().max() * gy.abs().max()) * 256
    check_topk(v.double(), i, pv, pi, n=700, rtol=1e-5, atol=1e-5 * scale,
               dist=lambda r, c: ((alpha * (fx[r].double() * gy[c].double()).sum(1)
                                   + hx[r, 0].double() + hy[0, c].double())))


@pytest.mark.parametrize("gy_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mnd", [(1, 1, 4), (65, 129, 20), (70, 300, 36), (130, 1000, 68),
                                 (64, 131, 260)])
def test_fused_kernel_on_ragged_shapes(cuda, gy_dtype, mnd):
    m, n, d = mnd
    x, y = _data("neg_dot", m, n, d, 23)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    gs = None
    if gy_dtype == torch.bfloat16:
        gy = gy.to(torch.bfloat16)
    elif gy_dtype == torch.int8:
        q = quantize_rows(y.to(cuda), "int8", distance="neg_dot")
        gy, gs = q.data, q.scale.float()[None, :].contiguous()
    k = min(n, 10)
    v, i = FK.fused_knn(fx, gy, hx, hy, k, distance_finalize="identity", alpha=alpha,
                        n_real=n, gy_scale=gs)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize="identity",
                                n_real=n, gy_scale=gs)
    scale = float(fx.abs().max() * gy.float().abs().max()) * d * (
        1.0 if gs is None else float(gs.max()))
    check_topk(v, i, pv, pi, n=n, rtol=1e-5, atol=1e-5 * scale + 1e-6,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity",
                                     gy_scale=gs))


def test_fused_split_gives_the_one_pass_sets_bit_for_bit(cuda, monkeypatch):
    """Each database tile's product is the same whichever CTA forms it, so
    the merged split equals the unsplit scan exactly."""
    x, y = _data("neg_dot", 200, 20_000, 256, 24)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=20_000)
    assert FK.plan(200, 20_000, 16, cuda)[1] > 1
    v, i = FK.fused_knn(fx, gy, hx, hy, 10, **kw)
    n_tiles = -(-20_000 // 128)
    monkeypatch.setattr(FK, "plan", lambda *a, **k: (FK.block_rows(200, 16), 1, n_tiles))
    parts = FK.fused_knn_partials(fx, gy, hx, hy, 10, **kw)
    assert parts[0].shape[0] == 1
    assert torch.equal(v, parts[0][0]) and torch.equal(i, parts[1][0])


@pytest.mark.parametrize("bm,K", [(64, 1), (64, 16), (64, 128), (64, 256), (128, 1), (128, 16),
                                  (128, 32), (64, 512), (64, 1024)])
def test_fused_occupancy_reports_the_compiled_layout(cuda, bm, K):
    per_sm, tile_n, smem = SC.kernel_shape("fused_knn", cuda, bm, K)
    assert per_sm >= 1 and tile_n == 128 and 0 < smem <= 232448
    assert FK.block_rows(1024, K) == (128 if K <= FK.WIDE_MAX_K else 64)


def test_a_failed_launch_or_build_raises_and_nothing_falls_back(cuda, monkeypatch):
    x, y = _data("sqeuclidean", 100, 300, 64, 25)
    fx, gy, hx, hy, alpha = _operands("sqeuclidean", x, y, cuda)
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=300)
    before = FK.LAUNCHES
    with monkeypatch.context() as mp:  # a block width the kernel is not built for
        mp.setattr(FK, "plan", lambda *a, **k: (96, 1, 3))
        with pytest.raises(RuntimeError, match="fused_knn"):
            FK.fused_knn(fx, gy, hx, hy, 10, **kw)
    assert FK.LAUNCHES == before

    def no_build(names=()):
        raise RuntimeError("kernel build failed: (simulated)")

    monkeypatch.setattr(B, "_LIBS", {})
    monkeypatch.setattr(B, "build", no_build)
    before = PD.LAUNCHES, FK.LAUNCHES
    with pytest.raises(RuntimeError, match="build failed"):
        PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity")
    with pytest.raises(RuntimeError, match="build failed"):
        FK.fused_knn(fx, gy, hx, hy, 10, **kw)
    assert (PD.LAUNCHES, FK.LAUNCHES) == before


def test_fused_kmeans_assignment_holds_the_chip_smoke_tolerance(cuda):
    """Rows near their centroid (clustered_vectors' shape): distances near
    5.8 from dot products near 256, so the product's absolute error shows;
    chip_smoke.py holds the k-means pass to atol 1e-3 against the plain
    version, as here."""
    g = np.random.default_rng(26)
    centers = g.standard_normal((512, 256)).astype(np.float32)
    x = centers[g.integers(0, 512, 20_000)] + 0.15 * g.standard_normal((20_000, 256)).astype(
        np.float32)
    fx, gy, hx, hy, alpha = ops._mxu_operands(torch.from_numpy(x).to(cuda),
                                              torch.from_numpy(centers).to(cuda), "sqeuclidean")
    v, i = FK.fused_knn(fx, gy, hx, hy, 1, distance_finalize="identity", alpha=alpha,
                        n_real=512)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 1, alpha=alpha, finalize="identity",
                                n_real=512)
    check_topk(v, i, pv, pi, n=512, rtol=1e-5, atol=1e-3,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity"))


# ---------------------------------------------------------------------------
# The per-query filter bitmap (q_mask) and fetch widths above 256
# ---------------------------------------------------------------------------


def _scan_operands_of(gy_dtype, x, y, dev):
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, dev)
    gs = None
    if gy_dtype == torch.bfloat16:
        gy = gy.to(torch.bfloat16)
    elif gy_dtype == torch.int8:
        q = quantize_rows(y.to(dev), "int8", distance="neg_dot")
        gy, gs = q.data, q.scale.float()[None, :].contiguous()
    return fx, gy, gs, hx, hy, alpha


def _masked_check(v, i, pv, pi, fx, gy, gs, hx, hy, alpha, d):
    scale = float(fx.abs().max() * gy.float().abs().max()) * d * (
        1.0 if gs is None else float(gs.max()))
    check_topk(v, i, pv, pi, n=gy.shape[0], rtol=1e-5, atol=1e-5 * scale + 1e-6,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity",
                                     gy_scale=gs))


@pytest.mark.parametrize("gy_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("mn", [(3, 20_001), (70, 4_999), (130, 1_000), (1, 33)])
@pytest.mark.parametrize("split", [True, False])
def test_fused_masked_kernel_matches_plain(cuda, monkeypatch, gy_dtype, mn, split):
    """Ragged m and n (n % 32 != 0), every storage type, the database axis
    split or walked in one pass: the masked kernel keeps the plain
    version's sets, and no masked column enters."""
    m, n = mn
    x, y = _data("neg_dot", m, n, 36, 30)
    fx, gy, gs, hx, hy, alpha = _scan_operands_of(gy_dtype, x, y, cuda)
    allowed = torch.rand((m, n), generator=torch.Generator().manual_seed(n)) < 0.3
    words = FK.pack_mask(allowed).to(cuda)
    if not split:
        n_tiles = -(-n // 128)
        monkeypatch.setattr(FK, "plan", lambda *a, **k: (FK.block_rows(m, 16), 1, n_tiles))
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=n, gy_scale=gs)
    before = FK.LAUNCHES, FK.MASKED_LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, 10, q_mask=words, **kw)
    torch.cuda.synchronize()
    assert (FK.LAUNCHES, FK.MASKED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 10, alpha=alpha, finalize="identity",
                                n_real=n, gy_scale=gs, q_mask=words)
    _masked_check(v, i, pv, pi, fx, gy, gs, hx, hy, alpha, 36)
    ok = i >= 0
    assert allowed.to(cuda).gather(1, i.clamp(min=0).long())[ok].all()


@pytest.mark.parametrize("skip", [True, False])
def test_fused_mask_composes_with_db_live_and_exclude_self(cuda, skip):
    x, _ = _data("sqeuclidean", 300, 300, 32, 31)
    fx, gy, hx, hy, alpha = _operands("sqeuclidean", x, x, cuda)
    live = torch.ones(300, dtype=torch.bool, device=cuda)
    live[::3] = False
    hy = torch.where(live[None, :], hy, T.POS_INF).contiguous()
    allowed = (torch.rand((300, 300), generator=torch.Generator().manual_seed(1)) < 0.5).to(cuda)
    allowed[5] = False
    kw = dict(alpha=alpha, n_real=290, exclude_self=True, q_mask=FK.pack_mask(allowed))
    v, i = FK.fused_knn(fx, gy, hx, hy, 16, distance_finalize="identity", threshold_skip=skip,
                        **kw)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 16, finalize="identity", **kw)
    _assert_topk_close(v, i, pv, pi, 1e-3, fx, gy, hx, hy, alpha)
    ii = i.cpu().numpy()
    ok = ii >= 0
    assert not (ii == np.arange(300)[:, None]).any() and (ii < 290).all()
    assert (ii[ok] % 3 != 0).all() and allowed.cpu().numpy()[np.nonzero(ok)[0], ii[ok]].all()
    assert (i[5] == -1).all() and torch.isinf(v[5]).all()


@pytest.mark.parametrize("m", [3, 200])
def test_fused_all_true_mask_equals_no_mask_and_all_false_is_empty(cuda, m):
    x, y = _data("neg_dot", m, 30_000, 64, 32)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=30_000)
    none = FK.fused_knn(fx, gy, hx, hy, 10, **kw)
    W = FK.mask_words(30_000)
    for words in (torch.full((m, W), -1, dtype=torch.int32, device=cuda),
                  torch.full((1, W), -1, dtype=torch.int32, device=cuda)):  # a shared row
        full = FK.fused_knn(fx, gy, hx, hy, 10, q_mask=words, **kw)
        assert torch.equal(full[0], none[0]) and torch.equal(full[1], none[1])
    empty = FK.fused_knn(fx, gy, hx, hy, 10, q_mask=torch.zeros((m, W), dtype=torch.int32,
                                                                device=cuda), **kw)
    assert torch.isinf(empty[0]).all() and (empty[1] == -1).all()


@pytest.mark.parametrize("k", [300, 1000])
@pytest.mark.parametrize("mn", [(3, 100_003), (70, 5_000), (130, 1_500)])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_wide_k_matches_plain(cuda, k, mn, masked):
    """K = 512 and 1024: the K-buffers in the kernel's output; split (few
    queries) and not; with and without a mask."""
    m, n = mn
    x, y = _data("neg_dot", m, n, 64, 33)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    words = None
    if masked:
        words = FK.pack_mask(torch.rand((m, n), generator=torch.Generator().manual_seed(m)) < 0.4
                             ).to(cuda)
    before = FK.WIDE_LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, k, distance_finalize="identity", alpha=alpha, n_real=n,
                        q_mask=words)
    torch.cuda.synchronize()
    assert FK.WIDE_LAUNCHES == before + 1 and v.shape == (m, T.next_pow2(k))
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize="identity", n_real=n,
                                q_mask=words)
    _masked_check(v, i, pv, pi, fx, gy, None, hx, hy, alpha, 64)


@pytest.mark.parametrize("gy_dtype", [torch.bfloat16, torch.int8])
def test_fused_wide_k_over_a_replica_matches_plain(cuda, gy_dtype):
    x, y = _data("neg_dot", 20, 40_000, 64, 34)
    fx, gy, gs, hx, hy, alpha = _scan_operands_of(gy_dtype, x, y, cuda)
    v, i = FK.fused_knn(fx, gy, hx, hy, 512, distance_finalize="identity", alpha=alpha,
                        n_real=40_000, gy_scale=gs)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 512, alpha=alpha, finalize="identity",
                                n_real=40_000, gy_scale=gs)
    _masked_check(v, i, pv, pi, fx, gy, gs, hx, hy, alpha, 64)


@pytest.mark.parametrize("S,m,K", [(2, 5, 512), (8, 1024, 512), (3, 40, 1024), (16, 100, 1024)])
def test_merge_kernel_wide_matches_plain_exactly(cuda, S, m, K):
    g = torch.Generator().manual_seed(S * m + K)
    v = torch.randint(0, 200, (S, m, K), generator=g).float()
    v[:, :, K // 2 :] = torch.where(torch.rand((S, m, K - K // 2), generator=g) < 0.3,
                                    T.POS_INF, v[:, :, K // 2 :])
    v = torch.sort(v, dim=2).values
    cols = torch.sort(torch.randperm(10 * K, generator=g)[:K]).values
    i = (torch.arange(S)[:, None, None] * 10 * K + cols).expand(S, m, K).int()
    i = torch.where(torch.isinf(v), -1, i).contiguous()
    pv, pi = MP.merge_partials_plain(v, i)
    before = MP.WIDE_LAUNCHES
    gv, gi = MP.merge_partials(v.to(cuda), i.to(cuda))
    torch.cuda.synchronize()
    assert MP.WIDE_LAUNCHES == before + 1
    assert torch.equal(gv.cpu(), pv) and torch.equal(gi.cpu(), pi)


def test_card_refuses_k_past_the_narrow_kernels_buffer(cuda):
    """Past the card's one cap, 4096 (ROADMAP F1b and F1c closed below it),
    each of the six selection kernels refuses K = 8192, naming the cap,
    and launches nothing."""
    n = 9000
    before = (ST.LAUNCHES, RS.LAUNCHES, IVS.LAUNCHES, PQS.LAUNCHES, FK.LAUNCHES, MP.LAUNCHES)
    with pytest.raises(ValueError, match="4096"):
        ST.stream_topk(torch.zeros((2, n), device=cuda), 5000)
    fx, gy, hx, hy, alpha = _operands("sqeuclidean", *_data("sqeuclidean", 4, n, 8, 35), cuda)
    with pytest.raises(ValueError, match="4096"):
        RS.rescore_topk(fx, gy[None].expand(4, n, 8).contiguous(), hx,
                        hy.expand(4, n).contiguous(), 5000, alpha=alpha, finalize="identity")
    probes = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    extent = torch.full((1,), n, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        IVS.ivf_scan(probes, fx, gy, hx, hy, 5000, cell_cap=n, tile_m=8, cell_extent=extent,
                     distance_finalize="identity", alpha=alpha)
    luts = torch.zeros((4, 2 * 16), device=cuda)
    codes = torch.zeros((n, 2), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="4096"):
        PQS.pq_scan(probes, luts, codes, hx, hy, 5000, cell_cap=n, ncodes=16, tile_m=8,
                    cell_extent=extent, distance_finalize="identity")
    with pytest.raises(ValueError, match="4096"):
        FK.fused_knn(fx, gy, hx, hy, 4097, distance_finalize="identity", alpha=alpha, n_real=n)
    with pytest.raises(ValueError, match="4096"):
        MP.merge_partials(torch.zeros((2, 4, 8192), device=cuda),
                          torch.zeros((2, 4, 8192), dtype=torch.int32, device=cuda))
    assert (ST.LAUNCHES, RS.LAUNCHES, IVS.LAUNCHES, PQS.LAUNCHES, FK.LAUNCHES,
            MP.LAUNCHES) == before


def test_filtered_index_on_card_matches_cpu_index(cuda):
    """Tenants, an allow-list and exclusions through the served path, on
    the card and on the CPU: the same ids (K = 512 through k + E)."""
    from repro_torch.serving.filters import QueryFilter
    from repro_torch.serving.index import RetrievalIndex

    g = np.random.default_rng(36)
    vecs = g.standard_normal((6000, 32)).astype(np.float32)
    ids = g.permutation(100_000)[:6000]
    tenants = g.integers(0, 5, 6000)
    q = g.standard_normal((37, 32)).astype(np.float32)
    idx = {dev: RetrievalIndex.build(ids, vecs, tenants=tenants, device=dev)
           for dev in ("cpu", "cuda")}
    for i in idx.values():
        i.upsert(ids[:50], vecs[50:100], tenants=np.full(50, 4))
        i.delete(ids[200:260])
    filters = [QueryFilter(tenant=g.integers(0, 5, 37)),
               QueryFilter(allowed_ids=ids[::3]),
               QueryFilter(tenant=g.integers(0, 5, 37), exclude_ids=[ids[:400].tolist()]),
               QueryFilter(allowed_ids=[])]
    for f in filters:
        a, b = idx["cpu"].search(q, 10, filter=f), idx["cuda"].search(q, 10, filter=f)
        torch.testing.assert_close(b.distances.cpu(), a.distances, rtol=1e-5, atol=1e-3)
        assert (b.ids.cpu() == a.ids).float().mean() > 0.99


# ---------------------------------------------------------------------------
# Fetch widths up to the card's cap (4096) in all six selection kernels
# ---------------------------------------------------------------------------

WIDE_KS = [512, 1024, 2048, 4096]


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("skip", [True, False])
def test_stream_topk_wide_k_matches_plain_exactly(cuda, K, skip):
    x = torch.from_numpy(np.random.default_rng(K).integers(0, 300, (37, 9001)).astype(
        np.float32)).to(cuda)  # many exact ties
    before = ST.WIDE_LAUNCHES
    v, i = ST.stream_topk(x, K - 3, threshold_skip=skip)
    torch.cuda.synchronize()
    assert ST.WIDE_LAUNCHES == before + 1 and v.shape == (37, K)
    pv, pi = ST.stream_topk_plain(x, K - 3)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("K", WIDE_KS)
def test_rescore_wide_k_matches_plain(cuda, K):
    m, Kp, d = 9, K + 300, 32
    g = torch.Generator().manual_seed(K)
    fx = torch.randn(m, d, generator=g).to(cuda)
    cand = torch.randn(m, Kp, d, generator=g).to(cuda)
    hx = torch.randn(m, 1, generator=g).to(cuda)
    hy = torch.randn(m, Kp, generator=g).abs().to(cuda)
    hy[::2, -Kp // 3:] = T.POS_INF  # rows with fewer than K candidates end in empty slots
    before = RS.WIDE_LAUNCHES
    v, p = RS.rescore_topk(fx, cand, hx, hy, K, alpha=-2.0, finalize="identity")
    torch.cuda.synchronize()
    assert RS.WIDE_LAUNCHES == before + 1
    pv, pp = RS.rescore_topk_plain(fx, cand, hx, hy, K, alpha=-2.0, finalize="identity")
    check_topk(v, p, pv, pp, n=Kp, rtol=1e-5, atol=1e-4,
               dist=lambda r, c: -2.0 * (fx[r] * cand[r, c]).sum(1) + hx[r, 0] + hy[r, c])


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("masked", [False, True])
def test_fused_wide_k_up_to_the_cap_matches_plain(cuda, K, masked):
    m, n = 70, 20_011
    x, y = _data("neg_dot", m, n, 36, K)
    fx, gy, hx, hy, alpha = _operands("neg_dot", x, y, cuda)
    words = None
    if masked:
        words = FK.pack_mask(torch.rand((m, n), generator=torch.Generator().manual_seed(K))
                             < 0.4).to(cuda)
    before = FK.WIDE_LAUNCHES
    v, i = FK.fused_knn(fx, gy, hx, hy, K, distance_finalize="identity", alpha=alpha,
                        n_real=n, q_mask=words)
    torch.cuda.synchronize()
    assert FK.WIDE_LAUNCHES == before + 1 and v.shape == (m, K)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, K, alpha=alpha, finalize="identity", n_real=n,
                                q_mask=words)
    _masked_check(v, i, pv, pi, fx, gy, None, hx, hy, alpha, 36)


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_ivf_scan_wide_k_matches_plain(cuda, K, scan_dtype):
    """K up to cell_cap = 4096: the K-buffers in the output's rows."""
    probes, fx, gy, gs, hx, hy, kw = _ivf_case(cuda, 40, 8, 4096, scan_dtype, K, ncells=12,
                                               d=32, width=3)
    before = IVS.WIDE_LAUNCHES
    _ivf_check(cuda, probes, fx, gy, gs, hx, hy, K, kw)
    assert IVS.WIDE_LAUNCHES == before + 1


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("pq_m,ncodes", [(8, 16), (32, 256)])
def test_pq_scan_wide_k_matches_plain(cuda, K, pq_m, ncodes):
    """K up to cell_cap = 4096, generic and ring mode: the K-buffers and
    their staging areas in shared memory beside the tables."""
    probes, luts, codes, hx, hy, kw = _pq_case(cuda, 24, 8, 4096, pq_m, ncodes, True, K,
                                               ncells=8, width=3)
    before = PQS.WIDE_LAUNCHES
    _pq_check(cuda, probes, luts, codes, hx, hy, K, kw)
    assert PQS.WIDE_LAUNCHES == before + 1


@pytest.mark.parametrize("K", WIDE_KS)
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_wide_k_with_every_column_entering(cuda, K, skip, masked):
    """Values that fall along each row (gy zero, hy descending): every
    column beats the K-th, so every tile flushes every row; with a bitmap,
    some rows allowed fewer than K columns end in (+inf, -1) slots."""
    m, n, d = 70, 3 * K + 1000, 16
    g = torch.Generator().manual_seed(K + masked)
    fx = torch.randn(m, d, generator=g).to(cuda)
    gy = torch.zeros(n, d, device=cuda)
    hx = torch.randn(m, 1, generator=g).to(cuda)
    hy = torch.linspace(1.0, -1.0, n)[None, :].contiguous().to(cuda)
    words = None
    if masked:
        allowed = torch.rand((m, n), generator=g) < 0.9
        allowed[::5] = False
        for r in range(0, m, 5):
            allowed[r, torch.randperm(n, generator=g)[: K // 3]] = True
        words = FK.pack_mask(allowed).to(cuda)
    v, i = FK.fused_knn(fx, gy, hx, hy, K, distance_finalize="identity", alpha=-2.0,
                        n_real=n, q_mask=words, threshold_skip=skip)
    torch.cuda.synchronize()
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, K, alpha=-2.0, finalize="identity", n_real=n,
                                q_mask=words)
    _masked_check(v, i, pv, pi, fx, gy, None, hx, hy, -2.0, d)
    if masked:
        assert (i[::5, K // 3 :] == -1).all() and torch.isinf(v[::5, K // 3 :]).all()


@pytest.mark.parametrize("m,tile_m", [(40, 8), (45, 16), (100, 32), (64, 64)])
@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_ivf_scan_wide_k_on_union_tiles_below_the_query_block(cuda, m, tile_m, scan_dtype):
    """K 2048 with union tiles of fewer than 64 queries (and a short last
    one): the dead rows past each union tile take nothing."""
    probes, fx, gy, gs, hx, hy, kw = _ivf_case(cuda, m, tile_m, 4096, scan_dtype, m + tile_m,
                                               ncells=10, d=32, width=3)
    before = IVS.WIDE_LAUNCHES
    _ivf_check(cuda, probes, fx, gy, gs, hx, hy, 2048, kw)
    assert IVS.WIDE_LAUNCHES == before + 1


@pytest.mark.parametrize("K", [2 ** e for e in range(13)])
@pytest.mark.parametrize("m,d", [(3, 36), (130, 128)])
def test_rescore_every_width_with_empty_slots_and_unaligned_candidates(cuda, K, m, d):
    """One kernel for every K from 1 to the cap: Kp not a multiple of 32,
    empty slots, rows with fewer live candidates than K, ties."""
    Kp = K + 37 if K >= 64 else 3 * K + 5
    g = torch.Generator().manual_seed(K * 7 + m)
    fx = torch.randn(m, d, generator=g).to(cuda)
    cand = torch.randn(m, Kp, d, generator=g).round().to(cuda)  # integer dots: exact ties
    hx = torch.zeros(m, 1, device=cuda)
    hy = torch.randint(0, 4, (m, Kp), generator=g).float().to(cuda)
    hy[::2, Kp // 3 :] = T.POS_INF
    hy[1::7] = T.POS_INF  # rows with no live candidate
    v, p = RS.rescore_topk(fx.round(), cand, hx, hy, K, alpha=-2.0, finalize="identity")
    torch.cuda.synchronize()
    pv, pp = RS.rescore_topk_plain(fx.round(), cand, hx, hy, K, alpha=-2.0,
                                   finalize="identity")
    assert torch.equal(v, pv) and torch.equal(p, pp)  # integer values: exact, ties by position


def _merge_case(S, m, K, seed):
    """[S, m, K] ascending partial sets over ascending disjoint column
    ranges, values from few integers (exact ties), a third of the upper half
    +inf/-1."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randint(0, 40, (S, m, K), generator=g).float()
    v[:, :, K // 2 :] = torch.where(torch.rand((S, m, K - K // 2), generator=g) < 0.3,
                                    T.POS_INF, v[:, :, K // 2 :])
    v = torch.sort(v, dim=2).values
    cols = torch.sort(torch.randperm(4 * K, generator=g)[:K]).values
    i = (torch.arange(S)[:, None, None] * 4 * K + cols).expand(S, m, K).int()
    return v, torch.where(torch.isinf(v), -1, i).contiguous()


@pytest.mark.parametrize("S", [1, 2, 3, 16, 33])
@pytest.mark.parametrize("K", [2 ** e for e in range(13)])
def test_merge_tree_matches_plain_exactly(cuda, S, K):
    """The merge tree at every power of 2 up to the cap, on both paths (a
    warp a row up to S' K = 512 entries, a CTA a row above, in groups where
    the row exceeds 16,384 entries), with ties and empty slots."""
    m = 300 if S * K <= 4096 else 5
    v, i = _merge_case(S, m, K, S * 7 + K)
    pv, pi = MP.merge_partials_plain(v, i)
    before = MP.LAUNCHES
    gv, gi = MP.merge_partials(v.to(cuda), i.to(cuda))
    torch.cuda.synchronize()
    assert MP.LAUNCHES == before + 1
    assert torch.equal(gv.cpu(), pv) and torch.equal(gi.cpu(), pi)


# ---------------------------------------------------------------------------
# k-means on the card, snapshots and the lifecycle (ROADMAP F3)
# ---------------------------------------------------------------------------


def _clustered(n, d, seed):
    g = np.random.default_rng(seed)
    centres = g.standard_normal((64, d)).astype(np.float32) * 4
    return (centres[g.integers(0, 64, n)] + g.standard_normal((n, d))).astype(np.float32)


def test_ivf_and_pq_builds_are_byte_equal_twice_on_the_card(cuda):
    """F3: two trainings of one epoch from one seed give the same bytes:
    centroids, packed rows, both permutations, counts, codebooks, codes and
    hy.  An ``index_add_`` re-centring (atomic adds, their order set by the
    hardware) gives ulp-different centroids from run to run at this size."""
    from repro_torch.core.ivf import build_ivf, ivf_to_arrays
    from repro_torch.core.pq import build_ivfpq, pq_to_arrays

    x = torch.from_numpy(_clustered(1 << 17, 64, 0)).to(cuda)
    runs = []
    for _ in range(2):
        cells = build_ivf(x, 256, distance="neg_dot", generator=torch.Generator().manual_seed(3))
        cb, codes = build_ivfpq(x, cells, 8, distance="neg_dot",
                                generator=torch.Generator().manual_seed(3))
        runs.append({**ivf_to_arrays(cells), **pq_to_arrays(cb, codes)})
    for key, a in runs[0].items():
        assert a.tobytes() == runs[1][key].tobytes(), key


_TIERS = {"flat": {}, "int8": {"scan_dtype": "int8"}, "bf16": {"scan_dtype": "bfloat16"},
          "ivf": {"ivf_cells": 64, "nprobe": 8},
          "ivfpq": {"ivf_cells": 64, "nprobe": 8, "pq_m": 16}}


def _served(kw, n=1 << 15, d=64, seed=1, **more):
    """An index on the card with churn, and queries."""
    from repro_torch.serving import RetrievalIndex

    g = np.random.default_rng(seed)
    idx = RetrievalIndex.build(np.arange(n), _clustered(n, d, seed), distance="neg_dot",
                               **kw, **more)
    idx.delete(np.arange(0, n, 97))
    idx.upsert(np.arange(n, n + 300), g.standard_normal((300, d)).astype(np.float32))
    idx.upsert(np.arange(n, n + 20), g.standard_normal((20, d)).astype(np.float32))
    return idx, g.standard_normal((256, d)).astype(np.float32)


@pytest.mark.parametrize("tier", list(_TIERS))
def test_snapshot_round_trip_on_the_card_is_bit_identical(cuda, tier, tmp_path):
    from repro_torch.serving import RetrievalIndex

    idx, q = _served(_TIERS[tier], device=cuda)
    want = idx.search(q, 10)
    idx.save(str(tmp_path / "snap"))
    got = RetrievalIndex.restore(str(tmp_path / "snap"), device=cuda).search(q, 10)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances)


def _handoff_and_twin(cuda, tier, snap, hook=None):
    """A lifecycle whose background compact is handed off, and the result of
    a synchronous compact and first search of the same state."""
    from repro_torch.serving import LifecycleConfig, LifecycleIndex

    idx, q = _served(_TIERS[tier], device=cuda)
    twin, _ = _served(_TIERS[tier], device=cuda)
    idx.search(q, 10)
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    twin.compact()
    want = twin.search(q, 10)
    if hook is not None:
        hook()
    lc.compact(wait=True)
    return lc, q, want


@pytest.mark.parametrize("tier", list(_TIERS))
def test_background_handoff_on_the_card_equals_a_synchronous_compact(cuda, tier, tmp_path):
    """The worker trains on its own stream while the default stream is
    free; its epoch serves bit for bit what a synchronous compact trains
    (k-means deterministic on the card, F3)."""
    lc, q, want = _handoff_and_twin(cuda, tier, str(tmp_path / "snap"))
    got = lc.search(q, 10)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances)
    assert lc.stats()["handoffs"] == 1
    lc.close()


def test_the_swap_waits_for_the_workers_last_kernel(cuda, tmp_path, monkeypatch):
    """The worker's last kernels are still in flight at the swap: its cells
    are zeroed, then restored behind a ~1 s sleep on the worker's stream.
    The serving stream must wait for them: a search that read the cells
    early would see the zeros."""
    import threading

    from repro_torch.serving import lifecycle as L

    real, pending = L.save_index, []

    def slow_save(new, *a, **kw):
        out = real(new, *a, **kw)
        if threading.current_thread() is not threading.main_thread():
            cells = new._dev["main_ivf"]
            keep = [t.clone() for t in (cells.centroids, cells.packed)]
            for t in (cells.centroids, cells.packed):
                t.zero_()
            torch.cuda._sleep(2_000_000_000)
            for t, k in zip((cells.centroids, cells.packed), keep):
                t.copy_(k)
            done = torch.cuda.Event()
            done.record()
            pending.append(done)
        return out

    def arm():
        monkeypatch.setattr(L, "save_index", slow_save)

    lc, q, want = _handoff_and_twin(cuda, "ivf", str(tmp_path / "snap"), hook=arm)
    assert pending and not pending[0].query(), "the worker's last kernel had already finished"
    got = lc.search(q, 10)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances)
    lc.close()


@pytest.mark.parametrize("shape,dtype", [((1000, 7), torch.float32), ((4097,), torch.int32),
                                         ((33, 3, 5), torch.uint8), ((3, 8), torch.int16)])
def test_host_copies_in_pinned_blocks_keep_every_byte(cuda, monkeypatch, shape, dtype):
    """``core.ivf._np`` / ``_tensor``: to and from the card a block of rows
    at a time through a pinned stage (blocks of 64 bytes here)."""
    from repro_torch.core import ivf as IV

    monkeypatch.setattr(IV, "_COPY_BYTES", 64)
    host = np.random.default_rng(0).integers(0, 100, size=shape).astype(
        torch.empty(0, dtype=dtype).numpy().dtype)
    on_card = IV._tensor(host, cuda)
    assert on_card.device.type == "cuda"
    assert np.array_equal(on_card.cpu().numpy(), host)
    assert np.array_equal(IV._np(on_card), host)


def test_two_threads_launch_one_kernel_at_two_widths(cuda):
    """The lifecycle's worker and the serving thread launch the fused kernel
    at once at different widths (k-means at K 1, a probe at K 8): a C entry
    point sets the kernel's shared-memory limit and then launches, so the
    two threads' calls must not interleave (``_backend`` serializes a
    library's calls; interleaved, a launch fails with ``invalid argument``).
    K 1 and K 32 over 256 queries run one instantiation (BM 128) at two
    shared-memory sizes.  Each thread on its own stream, thousands of
    launches; every result equals the one-thread result."""
    import threading

    g = np.random.default_rng(7)
    q = torch.from_numpy(g.standard_normal((256, 64)).astype(np.float32)).to(cuda)
    db = torch.from_numpy(g.standard_normal((8192, 64)).astype(np.float32)).to(cuda)
    widths = (1, 32)
    assert {FK.plan(256, 8192, k, cuda)[0] for k in widths} == {128}
    want = {k: ops.fused_knn(q, db, k) for k in widths}
    errors, bad = [], []

    def work(k):
        stream = torch.cuda.Stream(cuda)
        try:
            with torch.cuda.stream(stream):
                for _ in range(3000):
                    got = ops.fused_knn(q, db, k)
                stream.synchronize()
                if not (torch.equal(got.indices, want[k].indices)
                        and torch.equal(got.distances, want[k].distances)):
                    bad.append(k)
        except RuntimeError as e:  # reported below
            errors.append(str(e))

    threads = [threading.Thread(target=work, args=(k,)) for k in widths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert not bad


def test_worker_launches_are_counted_apart_on_the_card(cuda, tmp_path):
    """The worker's kernels go to its tally, the serving thread's to the
    wrappers' counters."""
    lc, q, _ = _handoff_and_twin(cuda, "ivfpq", str(tmp_path / "snap"))
    before = FK.LAUNCHES
    lc.search(q, 10)
    assert FK.LAUNCHES > before
    tally = lc.stats()["worker_launches"]
    assert tally.get("fused_knn.LAUNCHES", 0) > 0, tally
    lc.close()


# ---------------------------------------------------------------------------
# The kernels whose selection this tree did not rewrite compile as before
# ---------------------------------------------------------------------------

PTXAS_BASELINE = Path(__file__).with_name("ptxas_registers.json")


def _ptxas_entries(log: str) -> dict:
    """{entry function: {"registers": n, "spill": [stores, loads]}} of a
    ``-Xptxas -v`` report."""
    import re

    out, cur = {}, None
    for ln in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", ln):
            cur = out.setdefault(m.group(1), {})
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                                  r"spill loads", ln)):
            cur["spill"] = [int(m.group(1)), int(m.group(2))]
        elif cur is not None and (m := re.search(r"Used (\d+) registers", ln)):
            cur["registers"] = int(m.group(1))
    return out


@pytest.mark.parametrize("name", ["fused_knn", "fused_knn_masked", "ivf_scan", "rescore",
                                  "merge_partials", "pairwise_distance", "pairwise_cumulative"])
def test_ptxas_reports_of_the_other_kernels_are_unchanged(cuda, name):
    """Each entry function of these libraries compiles to the registers and
    spills recorded in ``tests/ptxas_registers.json`` (on the H100's CUDA
    12.8): the scan kernels at K <= 256, ``merge_partials`` and the two
    pairwise libraries as built before the staged selection was added to
    ``select.cuh``; the scan kernels' K > 256 instantiations (``Li4096E``)
    and ``rescore`` as rewritten onto it.  A change to ``select.cuh`` or
    ``gemm_tc.cuh`` must leave every entry as it is."""
    B.build((name,))
    got = _ptxas_entries(B.library_path(name).with_suffix(".log").read_text())
    want = json.loads(PTXAS_BASELINE.read_text())[name]
    assert got == want


# ---------------------------------------------------------------------------
# The multi-device core with four positions on one card (core.distributed
# over launch.mesh): each path against the single-device path on the card.
# ---------------------------------------------------------------------------


def _card_mesh(cuda, shape, names, streams=True):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, names, devices=[cuda] * int(np.prod(shape)), streams=streams)


def _sq_dist(a, b):
    return lambda r, c: ((a[r].double() - b[c].double()) ** 2).sum(1).float()


@pytest.mark.parametrize("maker", ["ring", "triangle"])
def test_mesh_allpairs_on_four_positions_of_one_card(cuda, monkeypatch, maker):
    """Ring and triangle over four positions on the card, tiles walked in
    blocks of 512 columns, against the single-device fused all-pairs: the
    tiles go through ``pairwise_distance`` and each side's selection through
    ``stream_topk``."""
    from repro_torch.core import distributed as D
    from repro_torch.core.knn import knn_allpairs

    monkeypatch.setattr(D, "COL_CHUNK", 512)
    n, k = 3000, 16
    x = torch.from_numpy(_clustered(n, 64, 5)).to(cuda)
    mesh = _card_mesh(cuda, (4,), ("ring",))
    before = PD.LAUNCHES, ST.LAUNCHES
    if maker == "ring":
        got = D.make_ring_allpairs(mesh, k=k)(D.pad_rows_to(x, 4), n)
    else:
        xp = D.pad_rows_to(x, 4 * 256)
        got = D.make_triangle_allpairs(mesh, k=k, gsize=256)(xp, n)
    torch.cuda.synchronize()
    assert PD.LAUNCHES > before[0] and ST.LAUNCHES > before[1]
    want = knn_allpairs(x, k, impl="fused")
    check_topk(got.distances, got.indices.long(), want.distances, want.indices.long(), n=n,
               rtol=1e-5, atol=2e-3, dist=_sq_dist(x, x))


@pytest.mark.parametrize("tier", ["fp32", "int8", "ivf", "ivfpq"])
def test_mesh_queries_on_four_positions_of_one_card(cuda, tier):
    """The sharded flat, two-stage, IVF and IVF-PQ queries over a (1, 4)
    mesh on the card against the single-device query of the same rows:
    exact tiers tie-aware equal, the compressed ones at their recall."""
    from repro_torch.core import distributed as D
    from repro_torch.core import knn as K
    from repro_torch.core.ivf import build_ivf, packed_live
    from repro_torch.core.pq import build_ivfpq

    n, d, k = 1 << 14, 64, 10
    db = torch.from_numpy(_clustered(n, d, 7)).to(cuda)
    q = db[:512] + 0.1 * torch.randn(512, d, generator=torch.Generator().manual_seed(8)).to(cuda)
    live = torch.ones(n, dtype=torch.bool, device=cuda)
    live[::13] = False
    mesh = _card_mesh(cuda, (1, 4), ("data", "model"))
    axes = dict(query_axis="data", db_axis="model", k=k)
    exact = K.knn_query(q, db, k, db_live=live)
    counts = {m: m.LAUNCHES for m in (FK, RS, IVS, PQS)}
    if tier in ("fp32", "int8"):
        fn = D.make_query_sharded(mesh, scan_dtype="float32" if tier == "fp32" else "int8",
                                  wire_dtype=None if tier == "fp32" else torch.bfloat16, **axes)
        got = fn(q, db, n, live)
        used = (FK,) if tier == "fp32" else (FK, RS)
    else:
        cells = build_ivf(db, 64, generator=torch.Generator().manual_seed(1))
        lp = packed_live(cells, live)
        if tier == "ivf":
            fn = D.make_ivf_query_sharded(mesh, nprobe=64, cell_cap=cells.cell_cap, **axes)
            got = fn(q, cells.centroids, cells.packed, cells.row_of_slot, lp)
            used = (IVS, RS)
        else:
            cb, codes = build_ivfpq(db, cells, 16, generator=torch.Generator().manual_seed(1))
            fn = D.make_ivfpq_query_sharded(mesh, nprobe=8, cell_cap=cells.cell_cap,
                                            overfetch=8, wire_dtype=torch.bfloat16, **axes)
            got = fn(q, cells.centroids, cb, codes, cells.packed, cells.row_of_slot, lp)
            used = (PQS, RS)
    torch.cuda.synchronize()
    assert all(m.LAUNCHES > counts[m] for m in used)
    if tier in ("fp32", "ivf"):  # exact: nprobe covers every cell
        check_topk(got.distances, got.indices.long(), exact.distances, exact.indices.long(),
                   n=n, rtol=1e-5, atol=2e-3, dist=_sq_dist(q, db))
    else:
        hits = (got.indices[:, :, None] == exact.indices[:, None, :]).any(2).float().mean()
        assert float(hits) >= 0.85, (tier, float(hits))


@pytest.mark.parametrize("kind", ["ivf", "pq"])
def test_a_query_tile_with_no_probe_of_the_shard_on_the_card(cuda, kind):
    """Probes another shard owns (negative or past this shard's cells):
    the tile that has none scans nothing and comes back +inf / -1; the
    other tile is the plain version's."""
    g = torch.Generator().manual_seed(0)
    ncells, cap, d, m = 8, 128, 32, 128
    packed = torch.randn(ncells * cap, d, generator=g)
    q = torch.randn(m, d, generator=g)
    cells = torch.randint(-12, 0, (m, 4), generator=g, dtype=torch.int32)
    cells[:64, 1] = torch.randint(ncells, 20, (64,), generator=g, dtype=torch.int32)
    cells[64:, 0] = torch.randint(0, ncells, (64,), generator=g, dtype=torch.int32)
    if kind == "ivf":
        def run(dev):
            return ops.ivf_scan(q.to(dev), packed.to(dev), cells.to(dev), 16, cell_cap=cap,
                                tile_m=64)
    else:
        from repro_torch.core.pq import PQCodebook, PQCodes

        cb = PQCodebook(torch.randn(32, 256, 1, generator=g))
        codes = PQCodes(torch.randint(0, 256, (ncells * cap, 32), generator=g,
                                      dtype=torch.uint8), torch.randn(ncells * cap, generator=g))

        def run(dev):
            return ops.pq_scan(q.to(dev), PQCodebook(cb.codebooks.to(dev)),
                               PQCodes(*(t.to(dev) for t in codes)), cells.to(dev), 16,
                               cell_cap=cap, tile_m=64)
    got, want = run(cuda), run(torch.device("cpu"))
    assert bool(torch.isinf(got.distances[:64]).all()) and bool((got.indices[:64] == -1).all())
    assert torch.equal(got.indices.cpu(), want.indices)
    torch.testing.assert_close(got.distances.cpu(), want.distances, rtol=1e-5, atol=1e-4)


def test_mesh_positions_on_four_streams_or_one_give_equal_ids(cuda):
    """The same ring and sharded query with each position on its own stream
    and with all four on the caller's: a copy that did not wait for its
    source's stream would read a heap not yet written."""
    from repro_torch.core import distributed as D

    x = torch.from_numpy(_clustered(4096, 64, 9)).to(cuda)
    q = x[:256] + 0.01
    out = []
    for streams in (True, False):
        mesh = _card_mesh(cuda, (4,), ("ring",), streams=streams)
        ring = D.make_ring_allpairs(mesh, k=32)(x, 4096)
        qmesh = _card_mesh(cuda, (1, 4), ("data", "model"), streams=streams)
        qs = D.make_query_sharded(qmesh, query_axis="data", db_axis="model", k=32)(q, x, 4096)
        torch.cuda.synchronize()
        out.append((ring.indices, qs.indices))
    assert all(s is not None for s in _card_mesh(cuda, (4,), ("ring",)).streams)
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])


def test_mesh_index_on_the_card_matches_the_local_index(cuda):
    from repro_torch.serving import RetrievalIndex

    idx, q = _served({}, device=cuda, mesh=_card_mesh(cuda, (1, 4), ("data", "model")))
    local, _ = _served({}, device=cuda)
    got, want = idx.search(q, 10), local.search(q, 10)
    assert torch.equal(got.ids, want.ids)
    torch.testing.assert_close(got.distances, want.distances, rtol=1e-5, atol=1e-4)


def test_a_failed_launch_on_a_mesh_raises(cuda, monkeypatch):
    """Positions on the card launch the kernels or raise: nothing runs the
    plain version instead."""
    from repro_torch.core import distributed as D

    x = torch.from_numpy(_clustered(1024, 64, 3)).to(cuda)
    mesh = _card_mesh(cuda, (4,), ("ring",))

    def refuse(*a, **k):
        raise RuntimeError("pairwise_distance: CUDA error 1: (simulated)")

    monkeypatch.setattr(PD, "pairwise_distance", refuse)
    with pytest.raises(RuntimeError, match="simulated"):
        D.make_ring_allpairs(mesh, k=8)(x, 1024)


# ---------------------------------------------------------------------------
# The shard fleet on the card: in process and in worker processes
# ---------------------------------------------------------------------------

_FLEET_EXHAUSTIVE = dict(ivf_cells=16, nprobe=16, pq_m=8, overfetch=128)


def _fleet_root(cuda, root, **kw):
    """The reference tests' shape (n 2048, d 32, 16 cells) on the card, cut
    into 2 shards with a manifest of 2 replicas."""
    from repro_torch.serving import RetrievalIndex, save_shards

    x = _clustered(2048, 32, seed=7)
    q = _clustered(24, 32, seed=9)
    idx = RetrievalIndex.build(np.arange(2048), x, device=cuda, **kw)
    save_shards(idx, root, 2, replicas=2)
    return idx, q, x


def test_fleets_on_the_card_equal_the_index_exhaustive(cuda, tmp_path):
    """In the exhaustive regime the in-process fleet and a fleet of four
    worker processes on the card return the index's search bit for bit."""
    from repro_torch.serving import load_fleet

    root = str(tmp_path / "fleet")
    idx, q, _ = _fleet_root(cuda, root, **_FLEET_EXHAUSTIVE)
    want = idx.search(q, 10)
    inproc = load_fleet(root, device=cuda)
    got = inproc.search(q, 10)
    assert got.ids.device.type == "cuda" and np.all(got.coverage == 1.0)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances)
    proc = load_fleet(root, workers="proc", device=cuda)
    try:
        assert all(w.alive and w.device.type == "cuda" for w in proc.supervisor.workers)
        got = proc.search(q, 10)
        assert torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances)
    finally:
        procs = [w._proc for w in proc.supervisor.workers]
        proc.supervisor.shutdown(drain=True)
    assert [p.wait(timeout=30) for p in procs] == [0] * len(procs)


@pytest.mark.parametrize("tier", ["pq", "int8"])
def test_a_shard_worker_launches_its_kernels_on_the_card(cuda, tier, tmp_path):
    """The worker's query runs the tier's scan kernel and the rescore kernel
    (its own tally), and equals the plain body on the same image."""
    from repro_torch.serving import restore_shard
    from repro_torch.serving.snapshot import shard_dirs

    kw = dict(ivf_cells=16, nprobe=8, overfetch=4, **({"pq_m": 8} if tier == "pq"
                                                      else {"scan_dtype": "int8"}))
    root = str(tmp_path / tier)
    _, q, x = _fleet_root(cuda, root, **kw)
    w = restore_shard(shard_dirs(root)[1], device=cuda)
    q = torch.from_numpy(q).to(cuda)
    with B.launch_tally() as tally:
        got = w.topk(q, 10)
        torch.cuda.synchronize()
    scan = "pq_scan.LAUNCHES" if tier == "pq" else "ivf_scan.LAUNCHES"
    assert tally.get(scan, 0) > 0 and tally.get("rescore.LAUNCHES", 0) > 0, tally
    assert tally.get("fused_knn.LAUNCHES", 0) > 0, tally  # the worker's shortlist
    host = restore_shard(shard_dirs(root)[1], device="cpu")
    want = host.topk(q.cpu(), 10)
    qh, xh = q.cpu(), torch.from_numpy(x)
    check_topk(got.distances.cpu(), got.indices.cpu().long(), want.distances,
               want.indices.long(), n=2048, rtol=1e-5, atol=1e-4,
               dist=lambda r, c: ((qh[r] - xh[c]) ** 2).sum(1))


def test_the_bf16_result_leg_built_on_the_card_is_the_hosts(cuda):
    from repro_torch.serving import transport as TR

    g = torch.Generator().manual_seed(0)
    vals = torch.sort(torch.randn((256, 64), generator=g) * 300, dim=1).values
    vals[:, -3:] = float("inf")
    ids = torch.randint(0, 1 << 20, (256, 64), generator=g, dtype=torch.int32)
    card = TR.pack_frame(TR.F_RESULT, {"seq": 3}, TR.encode_result(
        vals.to(cuda), ids.to(cuda), wire_dtype="bfloat16"))
    host = TR.pack_frame(TR.F_RESULT, {"seq": 3}, TR.encode_result(
        vals, ids, wire_dtype="bfloat16"))
    assert card == host


def test_processes_that_start_cold_build_each_library_once(cuda, tmp_path):
    """Two processes build the same libraries into an empty build directory
    at once: the file lock lets one compile each library and the other find
    it built, and each library has one compiler log."""
    import shutil
    import subprocess
    import sys

    src = Path(B.__file__).resolve().parents[2]
    shutil.copytree(src / "repro_torch", tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    names = ("merge_partials", "rescore")
    code = ("import json; from repro_torch.kernels import _backend as B; "
            f"B.build({names!r}); print(json.dumps(B.BUILT))")
    env = {**os.environ, "PYTHONPATH": str(tmp_path / "src")}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(2)]
    built = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0
        built += json.loads(out.strip().splitlines()[-1])
    assert sorted(built) == sorted(names), built
    build_dir = tmp_path / "build" / "repro_torch"
    for name in names:
        assert len(list(build_dir.glob(f"{name}-*.so"))) == 1
        logs = list(build_dir.glob(f"{name}-*.log"))
        assert len(logs) == 1 and "registers" in logs[0].read_text()


# -- the two-tower retrieval service on the card -------------------------------


def _service_params(cfg, dev, seed=0):
    """Towers drawn on the CPU from a seed, and the same values on ``dev``."""
    from repro_torch.models.recsys import init_two_tower

    cpu = init_two_tower(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    moved = {key: [({k: v.to(dev) for k, v in leaf.items()} if isinstance(leaf, dict)
                    else leaf.to(dev)) for leaf in leaves] for key, leaves in cpu.items()}
    return cpu, moved


def _service_pair(cuda, n=16384, **svc_kw):
    from repro_torch.configs.two_tower import smoke_config
    from repro_torch.serving import ServiceConfig, TwoTowerRetrievalService

    cfg = smoke_config()
    cpu_p, dev_p = _service_params(cfg, cuda)
    sc = ServiceConfig(k=10, **svc_kw)
    host = TwoTowerRetrievalService(cpu_p, cfg, sc, device="cpu")
    card = TwoTowerRetrievalService(dev_p, cfg, sc, device=cuda)
    g = np.random.default_rng(3)
    fields = g.integers(0, min(cfg.i_sizes()), size=(n, cfg.n_item_fields)).astype(np.int32)
    users = g.integers(0, min(cfg.u_sizes()), size=(64, cfg.n_user_fields)).astype(np.int32)
    return cfg, host, card, fields, users


def _assert_served_close(got, want, corpus, u):
    ids, scores = got
    wids, wscores = want
    np.testing.assert_allclose(scores, wscores, rtol=1e-5, atol=1e-5)
    for r, j in zip(*np.nonzero(ids != wids)):  # near-ties: the id's own score
        assert abs(float(u[r] @ corpus[int(ids[r, j])]) - scores[r, j]) <= 1e-5


def test_service_on_the_card_matches_the_cpu(cuda):
    from repro_torch.models import recsys as P

    cfg, host, card, fields, users = _service_pair(cuda)
    n = len(fields)
    want_vecs = host.build_corpus(np.arange(n), fields)
    got_vecs = card.build_corpus(np.arange(n), fields)
    assert got_vecs.device.type == cuda.type
    torch.testing.assert_close(got_vecs.cpu(), want_vecs, rtol=1e-5, atol=1e-5)
    corpus = dict(enumerate(want_vecs.numpy()))
    keys = np.concatenate([np.arange(40), np.arange(24)])  # 24 repeat users
    for step in ("initial", "churn", "compact", "exclude"):
        if step == "churn":
            new = np.random.default_rng(4).integers(0, min(cfg.i_sizes()), size=(300, 4))
            for svc in (host, card):
                svc.ingest_items(np.arange(n, n + 300), new.astype(np.int32))
                svc.delete_items(np.arange(0, n, 97))
            vecs, ids = host.index._live_rows()
            corpus.update(zip(ids.tolist(), vecs))
        if step == "compact":
            host.compact()
            card.compact()
        kw = {"exclude_ids": [np.arange(j, j + 9) for j in range(64)]} if step == "exclude" else {}
        u = P.user_embedding(host.params, users[keys]).numpy()
        want = host.recommend(keys, users[keys], **kw)
        got = card.recommend(keys, users[keys], **kw)
        _assert_served_close(got, want, corpus, u)
    assert card.stats()["cache"] == host.stats()["cache"]
    assert card.stats()["cache"]["hits"] > 0


def test_tower_products_stay_fp32_with_tf32_switched_on(cuda):
    """The towers' matmuls run in IEEE fp32 with TF32 off, as the process
    leaves it; where the process allows TF32 they refuse to run, and the
    process' setting is left as it was."""
    from repro_torch.models import recsys as P

    g = torch.Generator().manual_seed(1)
    x = torch.randn(1024, 384, generator=g) * 0.125
    layers = [{"w": torch.randn(a, b, generator=g) / a ** 0.5, "b": torch.zeros(b)}
              for a, b in ((384, 1024), (1024, 512), (512, 256))]
    want = x.double()
    for i, layer in enumerate(layers):
        want = want @ layer["w"].double() + layer["b"].double()
        if i < 2:
            want = want.clamp_min(0)
    dev_layers = [{k: v.to(cuda) for k, v in layer.items()} for layer in layers]
    got = P.apply_mlp(dev_layers, x.to(cuda)).cpu().double()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    for switch in ("precision", "flag"):
        prev = torch.get_float32_matmul_precision()
        try:
            if switch == "precision":
                torch.set_float32_matmul_precision("high")
            else:
                torch.backends.cuda.matmul.allow_tf32 = True
            assert torch.backends.cuda.matmul.allow_tf32
            setting = torch.get_float32_matmul_precision()
            # TF32 is really on: a bare product of the same operands is off by more
            tf32_err = float((x.to(cuda) @ dev_layers[0]["w"]).cpu().double().sub(
                x.double() @ layers[0]["w"].double()).abs().max())
            with pytest.raises(RuntimeError, match="TF32 is on"):
                P.apply_mlp(dev_layers, x.to(cuda))
            assert torch.get_float32_matmul_precision() == setting
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.set_float32_matmul_precision(prev)
            torch.backends.cuda.matmul.allow_tf32 = False
        assert tf32_err > 1e-4, (switch, tf32_err)


def test_service_recommend_launches_the_scan_and_merge(cuda):
    cfg, host, card, fields, users = _service_pair(cuda)
    card.build_corpus(np.arange(len(fields)), fields)
    with B.launch_tally() as tally:
        ids, _ = card.recommend(np.arange(8), users[:8])
        card.recommend(np.arange(64), users)
    assert ids.shape == (8, 10) and (ids >= 0).all()
    assert tally.get("fused_knn.LAUNCHES", 0) >= 2, tally
    assert tally.get("merge_partials.LAUNCHES", 0) >= 1, tally


def test_service_lifecycle_and_shards_on_the_card(cuda, tmp_path):
    from repro_torch.configs.two_tower import smoke_config
    from repro_torch.serving import ServiceConfig, ShardRouter, TwoTowerRetrievalService

    cfg = smoke_config()
    _, params = _service_params(cfg, cuda)
    g = np.random.default_rng(6)
    fields = g.integers(0, min(cfg.i_sizes()), size=(4096, 4)).astype(np.int32)
    users = g.integers(0, min(cfg.u_sizes()), size=(32, 6)).astype(np.int32)
    keys = np.arange(32)
    # The lifecycle: journaled churn, a background compact, recovery.
    snap = str(tmp_path / "wal")
    sc = ServiceConfig(k=10, snapshot_dir=snap, wal=True)
    svc = TwoTowerRetrievalService(params, cfg, sc, device=cuda)
    svc.build_corpus(np.arange(4096), fields)
    svc.enable_lifecycle()
    svc.ingest_items(np.arange(4096, 4160), fields[:64])
    svc.delete_items(np.arange(0, 4096, 41))
    svc.compact(wait=True)
    want = svc.recommend(keys + 1000, users)
    svc2 = TwoTowerRetrievalService(params, cfg, sc, device=cuda)
    rec = svc2.recover_lifecycle()
    assert rec.wal and rec.torn_bytes == 0
    got = svc2.recommend(keys + 1000, users)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    svc2.lifecycle.close()
    svc.lifecycle.close()
    # An in-process shard fleet on the card, exhaustive: the index's results.
    root = str(tmp_path / "shards")
    sc = ServiceConfig(k=10, shards=2, snapshot_dir=root, **_FLEET_EXHAUSTIVE)
    svc = TwoTowerRetrievalService(params, cfg, sc, device=cuda)
    svc.build_corpus(np.arange(2048), fields[:2048])
    want = svc.recommend(keys, users)
    svc.save_shards()
    svc.restore_shards()
    assert isinstance(svc.engine.index, ShardRouter)
    assert all(w.device.type == cuda.type for w in svc.router.workers)
    got = svc.recommend(keys + 5000, users)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# The recommender's trainer: row-sparse table updates on the card.
# ---------------------------------------------------------------------------


def _rowwise(table, ids, rows, lr=0.05):
    """One row-wise Adagrad update of ``table`` from per-lookup gradients
    (``ids``, ``rows``), on ``table``'s device: (table, accumulator)."""
    from repro_torch.train import optim as O

    opt = O.mixed_table_adamw({"t": True})
    params = {"t": table}
    state = opt.init(params)
    grads, _ = O.clip_by_global_norm({"t": O.coalesce_rows(ids, rows)}, 1.0)
    opt.update(grads, state, params, lr)
    return params["t"], state.m["t"]


def test_row_sparse_update_on_the_card_matches_the_cpu_and_repeats_byte_equal(cuda):
    """65,536 lookups into 4,096 rows, drawn as ``recsys_batch`` draws ids
    (low rows repeated hundreds of times): the card's coalesced update equals
    the CPU's within fp32 rounding, untouched rows keep their bytes, and two
    runs on the card give the same bytes (no atomics)."""
    g = np.random.default_rng(0)
    table = torch.from_numpy(g.standard_normal((4096, 64)).astype(np.float32))
    ids = torch.from_numpy((g.random(65536) ** 2 * 3500).astype(np.int64))
    rows = torch.from_numpy(g.standard_normal((65536, 64)).astype(np.float32))
    want_t, want_m = _rowwise(table.clone(), ids, rows)
    runs = [_rowwise(table.to(cuda, copy=True), ids.to(cuda), rows.to(cuda)) for _ in range(2)]
    for got_t, got_m in runs:
        torch.testing.assert_close(got_t.cpu(), want_t, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got_m.cpu(), want_m, rtol=1e-5, atol=0.0)
        assert torch.equal(got_t[3500:].cpu(), table[3500:])  # never looked up
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"])
def test_train_steps_of_each_arch_on_the_card_match_the_cpu(cuda, arch_id):
    """Three steps at ``smoke_config()`` from one start: losses and params on
    the card within rtol 1e-4 and atol 1e-5 of the CPU's; a second run on the
    card byte-equal to the first."""
    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys as P
    from repro_torch.models.nn import split_params, tree_map

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    sc = STP.StepConfig(peak_lr=5e-3, warmup_steps=1, total_steps=100,
                        micro_batches=2 if arch_id == "two-tower-retrieval" else 1)
    values, _ = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                              device="cpu"))

    def run(dev):
        rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
        loss, baxes = STP.recsys_loss(arch_id, cfg)
        step, _, _, opt = STP.make_train_step(loss, arch.abstract_params(cfg), rules, baxes, sc)
        state = STP.init_state(opt, tree_map(lambda t: t.to(dev, copy=True), values))
        losses = []
        for i in range(3):
            state, m = step(state, recsys_batch(arch_id, 64, cfg, step=i))
            losses.append(float(m["loss"]))
        return losses, [t.cpu() for t in P.param_leaves(state.params)]

    want_l, want_p = run(torch.device("cpu"))
    got_l, got_p = run(cuda)
    again_l, again_p = run(cuda)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert got_l == again_l and all(torch.equal(a, b) for a, b in zip(got_p, again_p))


@pytest.mark.parametrize("arch_id", ["dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"])
def test_sharded_steps_on_a_2x2_mesh_of_the_card_match_four_cpu_positions(cuda, arch_id):
    """Three sharded steps at ``smoke_config()`` on a (2, 2) mesh whose four
    positions share the card (each its own stream), against the same on four
    CPU positions: losses and params within rtol 1e-4 and atol 1e-5; after
    every step on the card, every replica of every block byte-equal."""
    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import Sharded, make_rules, shard_tree, unshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys as P
    from repro_torch.models.nn import split_params, tree_leaves, tree_map

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    sc = STP.StepConfig(peak_lr=5e-3, warmup_steps=1, total_steps=100,
                        micro_batches=2 if arch_id == "two-tower-retrieval" else 1)
    values, _ = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                              device="cpu"))

    def replicas_equal(state):
        for s in tree_leaves((state.params, state.opt.m, state.opt.v)):
            if isinstance(s, Sharded):
                for group in s.replica_groups():
                    a = s.parts[group[0]].reshape(-1).view(torch.uint8)
                    if not all(torch.equal(a, s.parts[q].reshape(-1).view(torch.uint8))
                               for q in group[1:]):
                        return False
        return True

    def run(dev):
        rules = make_rules(make_mesh((2, 2), ("data", "model"), devices=[dev] * 4))
        loss, baxes = STP.recsys_loss(arch_id, cfg)
        step, _, st_shard, opt = STP.make_train_step(loss, arch.abstract_params(cfg), rules,
                                                     baxes, sc)
        state = shard_tree(STP.init_state(opt, tree_map(lambda t: t.to(dev, copy=True),
                                                        values)), st_shard)
        losses, equal = [], True
        for i in range(3):
            state, m = step(state, recsys_batch(arch_id, 64, cfg, step=i))
            losses.append(float(m["loss"]))
            equal &= replicas_equal(state)
        return losses, [t.cpu() for t in P.param_leaves(unshard_tree(state.params))], equal

    want_l, want_p, _ = run(torch.device("cpu"))
    got_l, got_p, equal = run(cuda)
    assert equal
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_an_update_reaches_the_last_row_of_a_table_past_2_31_elements(cuda):
    """A table of 2^31 + 2^16 elements (8.6 GB): a lookup and a row-wise
    update at its last row and at the rows around element 2^31 land where
    int64 offsets put them, and the rows between keep their bytes."""
    from repro_torch.models import recsys as P

    D = 64
    R = (1 << 31) // D + 1024
    table = torch.zeros(R, D, device=cuda)
    edge = (1 << 31) // D
    ids = torch.tensor([R - 1, R - 1, edge, edge - 1, 5], device=cuda)
    table[ids] = torch.arange(5 * D, device=cuda, dtype=torch.float32).reshape(5, D)[[0, 0, 2, 3, 4]]
    looked = P.embedding_lookup(table, ids)
    assert torch.equal(looked.cpu(), table.index_select(0, ids).cpu())
    before = table.index_select(0, ids).cpu()
    rows = torch.ones(5, D, device=cuda)
    table, acc = _rowwise(table, ids, rows, lr=0.5)
    after = table.index_select(0, ids).cpu()
    scale = min(1.0, 1.0 / float(np.sqrt(2 * 2 * D + 3 * D)))  # the clip over the coalesced rows
    for j, dup in ((0, 2), (2, 1), (3, 1), (4, 1)):
        g = dup * scale
        want = before[j] - 0.5 * g / np.sqrt(g * g + 1e-8)
        torch.testing.assert_close(after[j], want, rtol=1e-6, atol=1e-6)
    assert float(acc[R - 1, 0]) > 0 and float(acc[edge, 0]) > 0
    assert not table[edge + 1 : R - 1].any()  # the rows between: untouched zeros
    del table, acc
    torch.cuda.empty_cache()


# -- the training loop's checkpoints and the NequIP potential ------------------------


def _radius_sets(src, n, k):
    rows = np.asarray(src).reshape(n, k)
    return [set(r.tolist()) - {i} for i, r in enumerate(rows)]


def _brute_radius(pos, cutoff, k):
    p = pos.astype(np.float64)
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    near = np.take_along_axis(d2, order, 1) <= cutoff * cutoff
    return np.where(near, order, np.arange(len(p))[:, None]).reshape(-1), d2


def test_radius_graph_at_d3_on_the_card_matches_a_brute_force_and_the_plain_version(cuda):
    """``radius_graph`` on the card (the fused kernel at d 3, padded to 4)
    against a float64 brute force and against the same call on the CPU (the
    kernel's plain version): neighbour sets equal except at near-ties, over
    drawn points and over molecules 100 apart at x ~ 10^4."""
    from repro_torch.data import graphs as GR

    mb = GR.molecule_batch(24, 30, 64, n_species=8, seed=3)
    far = mb["positions"].copy()
    far[:, 0] += np.repeat(np.arange(24) * 100.0 + 9000.0, 30).astype(np.float32)
    near = np.random.default_rng(1).standard_normal((300, 3)).astype(np.float32) * 2
    for pos, cutoff, k in ((far, 5.0, 12), (near, 2.5, 8)):
        n = len(pos)
        src, dst = GR.radius_graph(torch.from_numpy(pos).to(cuda), cutoff, k)
        assert src.device.type == cuda.type and src.dtype == torch.int32
        assert torch.equal(dst.cpu(), torch.arange(n, dtype=torch.int32).repeat_interleave(k))
        plain, _ = GR.radius_graph(torch.from_numpy(pos), cutoff, k)
        want, d2 = _brute_radius(pos, cutoff, k)
        kth = np.sort(d2, 1)[:, k - 1]
        got_sets = _radius_sets(src.cpu(), n, k)
        for other in (_radius_sets(want, n, k), _radius_sets(plain, n, k)):
            for i, (a, b) in enumerate(zip(got_sets, other)):
                for j in a ^ b:  # a near-tie at the k-th distance or at the cutoff
                    assert min(abs(d2[i, j] - kth[i]), abs(d2[i, j] - cutoff ** 2)) \
                        <= 1e-4 * max(1.0, d2[i, j]), (i, j)


def test_nequip_steps_on_the_card_repeat_byte_equal_and_match_the_cpu(cuda):
    from repro_torch.configs import registry as REG
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.nn import split_params, tree_leaves, tree_map

    arch = REG.get("nequip")
    cfg = arch.smoke_config()
    cell = {c.name: c for c in arch.shapes}["molecule"]
    start, _ = split_params(arch.init_params(cfg, cell, generator=torch.Generator().manual_seed(0),
                                             device="cpu"))
    batch = arch.smoke_batch("molecule", device="cpu")

    def run(dev):
        rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
        loss, baxes = STP.gnn_potential_loss(cfg, n_graphs=4)
        step, _, _, opt = STP.make_train_step(loss, arch.abstract_params(cfg, cell), rules, baxes,
                                              STP.StepConfig(peak_lr=5e-3, warmup_steps=5,
                                                             total_steps=60))
        state = STP.init_state(opt, tree_map(lambda t: t.to(dev, copy=True), start))
        b = {k: (tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev))
             for k, v in batch.items()}
        losses = []
        for _ in range(3):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return losses, [t.cpu() for t in tree_leaves(state.params)]

    want_l, want_p = run(torch.device("cpu"))
    got_l, got_p = run(cuda)
    again_l, again_p = run(cuda)
    assert got_l == again_l and all(torch.equal(a, b) for a, b in zip(got_p, again_p))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_p, want_p):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_streamed_checkpoint_of_a_leaf_past_one_block_round_trips_on_the_card(cuda, tmp_path):
    """A leaf of more than one pinned block (and a bf16 one, and an int)
    saved from the card and restored into the card's tensors in place."""
    from repro_torch.train import checkpoint as C

    g = torch.Generator(cuda).manual_seed(0)
    big = torch.randn(C.BLOCK_BYTES // 4 + 12345, generator=g, device=cuda)
    half = torch.randn((777, 3), generator=g, device=cuda).to(torch.bfloat16)
    final = C.save(str(tmp_path), {"big": big, "half": half, "step": 9}, 2)
    z = np.load(os.path.join(final, "leaves.npz"))
    assert np.array_equal(z["leaf_00000"][-4096:], big[-4096:].cpu().numpy())
    like = {"big": torch.zeros_like(big), "half": torch.zeros_like(half), "step": 0}
    ptr = like["big"].data_ptr()
    stats = {}
    out, step, _ = C.restore(str(tmp_path), like, stats=stats)
    assert step == 2 and out["step"] == 9 and out["big"].data_ptr() == ptr
    assert torch.equal(out["big"], big) and torch.equal(out["half"], half)
    assert stats["bytes"] == big.numel() * 4 + half.numel() * 2 + 4


def test_async_save_on_the_card_holds_the_bytes_of_its_step(cuda, tmp_path):
    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as C

    arch = REG.get("dlrm-rm2")
    cfg = arch.smoke_config()
    rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[cuda]))
    loss, baxes = STP.recsys_loss("dlrm-rm2", cfg)
    step, _, _, opt = STP.make_train_step(loss, arch.abstract_params(cfg), rules, baxes,
                                          STP.StepConfig(peak_lr=5e-3, warmup_steps=1))
    state = STP.init_state(opt, arch.init_params(cfg, device=cuda))
    mgr = C.CheckpointManager(str(tmp_path), keep=2)
    for i in range(3):
        state, _ = step(state, recsys_batch("dlrm-rm2", 64, cfg, step=i))
        want = [t.clone() if isinstance(t, torch.Tensor) else t for t in C.flatten(state)]
        mgr.save(state, i + 1)
        state, _ = step(state, recsys_batch("dlrm-rm2", 64, cfg, step=10 + i))  # in place
        mgr.wait()
        like = C.unflatten(state, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                                   if isinstance(t, torch.Tensor) else t
                                   for t in C.flatten(state)])
        out, _, _ = C.restore(str(tmp_path), like, step=i + 1, device=cuda)
        for a, b in zip(C.flatten(out), want):
            assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b


# -- the language models (phase 15) -----------------------------------------------


@pytest.fixture
def lm_cuda(cuda):
    """The card with bf16 products reduced in fp32, as the models require;
    the process' setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield cuda
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev


@pytest.mark.parametrize("m,n,k", [(4, 128, 8), (8192, 128, 8), (64, 8, 2), (16, 4, 1)])
@pytest.mark.parametrize("ties", [False, True])
def test_stream_topk_at_the_router_shapes(cuda, m, n, k, ties):
    """The MoE router's selections (qwen3's 128 experts top-8 at decode and
    at a prefill of 8,192 tokens, mixtral's top-2, a top-1): ids and values
    equal to the plain version, ties included (values from {0, .., 3})."""
    g = torch.Generator().manual_seed(m + n + k)
    x = (torch.randint(0, 4, (m, n), generator=g).float() if ties
         else -torch.softmax(torch.randn(m, n, generator=g), dim=-1))
    before = ST.LAUNCHES
    got_v, got_i = ops.stream_topk(x.to(cuda), k)
    assert ST.LAUNCHES > before
    want_v, want_i = ST.stream_topk_plain(x, k)
    assert torch.equal(got_i.cpu(), want_i[:, :k]) and torch.equal(got_v.cpu(), want_v[:, :k])


LM_ARCHS = ["h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_smoke_lms_serve_on_the_card_as_on_the_cpu(lm_cuda, arch_id):
    """``smoke_config()`` drawn once on the CPU: a prefill of 2 x 16 tokens
    and 8 decode steps on the card and on the CPU, the logits within 1e-4
    (dense, fp32) or 5e-3 (the MoE's bf16 expert path), the MoE's router on
    the ``stream_topk`` kernel."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import split_params, tree_map

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    values = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))[0]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 24)))
    tol = dict(rtol=0, atol=5e-3 if cfg.moe is not None else 1e-4)

    def serve(dev):
        v = tree_map(lambda t: t.to(dev, copy=True), values)
        cache = Tr.init_cache(cfg, 2, 24, device=dev)
        out = [Tr.prefill(v, toks[:, :16].to(dev), cfg, cache)[0].cpu()]
        for t in range(16, 24):
            out.append(Tr.decode_step(v, cache, toks[:, t].to(dev), cfg)[0].cpu())
        return out

    want = serve(torch.device("cpu"))
    before = ST.LAUNCHES
    got = serve(lm_cuda)
    assert (ST.LAUNCHES > before) == (cfg.moe is not None)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **tol)


def test_sp_decode_on_four_positions_of_one_card(lm_cuda):
    """The sequence-parallel decode on a (1, 4) mesh of one card against the
    plain decode from one prefilled cache, cloned: logits within 2e-3 (the
    reference test's bound), full attention and the SWA ring."""
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import split_params

    rules = make_rules(make_mesh((1, 4), ("data", "model"), devices=[lm_cuda] * 4))
    for window in (None, 8):
        cfg = Tr.TransformerConfig(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                                   head_dim=16, d_ff=128, vocab=256, sliding_window=window,
                                   dtype=torch.float32)
        values = split_params(Tr.init_params(cfg, generator=torch.Generator(lm_cuda)
                                             .manual_seed(0), device=lm_cuda))[0]
        toks = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (4, 32))).to(lm_cuda)
        cache = Tr.init_cache(cfg, 4, 32, device=lm_cuda)
        Tr.prefill(values, toks[:, :16], cfg, cache)
        _, mk, _ = STP.make_lm_decode_step(cfg, rules, Tr.abstract_params(cfg))
        _, mk_sp, _ = STP.make_lm_decode_step(cfg, rules, Tr.abstract_params(cfg),
                                              seq_parallel=True)
        fb, fs = mk(cache, toks[:, 0]), mk_sp(cache, toks[:, 0])
        cb, cs = cache.clone(), cache.clone()
        for t in range(16, 22):
            lb, cb = fb(values, cb, toks[:, t])
            ls, cs = fs(values, cs, toks[:, t])
        assert float((lb - ls).abs().max()) < 2e-3


LM_ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b", "h2o-danube-3-4b", "gemma-2b", "yi-6b"]


def _sharded_serve(cfg, values, toks, rules, sharded, sp, dev):
    """Prefill 16 tokens of ``toks`` and decode the next 4, on ``rules``' mesh
    (``values`` and the cache cut over it) or whole; the logits on the host."""
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import cache_shardings, shard_tree
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import tree_map

    abstract = Tr.abstract_params(cfg)
    v = tree_map(lambda t: t.to(dev, copy=True), values)
    cache = Tr.init_cache(cfg, toks.shape[0], 20, device=dev)
    prefill_for = STP.make_lm_prefill_step(cfg, rules, abstract)[1]
    if sharded:
        v = shard_tree(v, STP.param_shardings(rules, abstract)[0])
        cache = shard_tree(cache, cache_shardings(rules, cache, sp))
    t = toks.to(dev)
    lg, cache = prefill_for(t[:, :16], cache)(v, t[:, :16], cache)
    out = [lg.float().cpu()]
    step = STP.make_lm_decode_step(cfg, rules, abstract, seq_parallel=sp)[1](cache, t[:, 16])
    for i in range(16, 20):
        lg, cache = step(v, cache, t[:, i])
        out.append(lg.float().cpu())
    return out


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_sharded_serve_steps_on_a_2x2_mesh_of_the_card(lm_cuda, arch_id):
    """Each LM at smoke size on a (2, 2) mesh of the card (its params and
    cache cut: heads, experts and vocabulary over "model", FSDP over "data",
    the batch over "data"): the prefill and 4 decode steps, plain and
    sequence-parallel, against the whole steps on the card, within 1e-4 of
    the largest |logit| (the MoE's bf16 expert path within 5e-3, as
    ``test_smoke_lms_serve_on_the_card_as_on_the_cpu`` holds it)."""
    from repro_torch.configs import registry as REG
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.nn import split_params

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    values = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))[0]
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (4, 20)))
    whole_rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[lm_cuda]))
    rules = make_rules(make_mesh((2, 2), ("data", "model"), devices=[lm_cuda] * 4))
    want = _sharded_serve(cfg, values, toks, whole_rules, False, False, lm_cuda)
    scale = max(float(w.abs().max()) for w in want)
    atol = 5e-3 if cfg.moe is not None else 1e-4 * scale
    for sp in (False, True):
        got = _sharded_serve(cfg, values, toks, rules, True, sp, lm_cuda)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("arch_id", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_each_position_launches_the_router_on_its_stream(lm_cuda, arch_id, monkeypatch):
    """The sharded prefill and decode on a (2, 2) mesh of the card launch
    ``stream_topk`` once a position and a layer, each on that position's
    stream, and every selection equals ``stream_topk_plain`` on the same
    scores."""
    from repro_torch.configs import registry as REG
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.nn import split_params

    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    values = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                           device="cpu"))[0]
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (4, 20)))
    rules = make_rules(make_mesh((2, 2), ("data", "model"), devices=[lm_cuda] * 4))
    streams = {s.cuda_stream for s in rules.mesh.streams}
    records = []
    orig = ST.stream_topk

    def wrap(x, k, **kw):
        got = orig(x, k, **kw)
        records.append((x, k, got, torch.cuda.current_stream(x.device).cuda_stream))
        return got

    monkeypatch.setattr(ST, "stream_topk", wrap)
    before = ST.LAUNCHES
    _sharded_serve(cfg, values, toks, rules, True, False, lm_cuda)
    torch.cuda.synchronize()
    assert len(records) == 4 * cfg.n_layers * 5 and ST.LAUNCHES - before >= len(records)
    assert {r[3] for r in records} == streams
    for x, k, (v, i), _ in records:
        pv, pi = ST.stream_topk_plain(x, k)
        assert torch.equal(i, pi) and torch.equal(v, pv)


def test_lm_products_refuse_tf32_and_reduced_bf16_sums(cuda):
    """Attention's fp32 scores refuse while TF32 is on, and a bf16 product
    refuses while cuBLAS may reduce it in bf16; neither switch is flipped."""
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as Tr

    q = torch.randn(1, 4, 2, 8, device=cuda)
    pos = torch.arange(4, device=cuda)[None]
    prev_bf16 = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="TF32 is on"):
            A.gqa_attention(q, q, q, q_pos=pos, k_pos=pos)
        assert torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        A.gqa_attention(q, q, q, q_pos=pos, k_pos=pos)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        x = torch.randn(2, 3, 16, device=cuda, dtype=torch.bfloat16)
        w = torch.randn(16, 4, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="reduced-precision"):
            Tr._proj(x, w)
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        Tr._proj(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prev_bf16


def test_meta_outputs_match_the_card_for_every_wrapper(cuda):
    """The dry run's shape path: each wrapper's outputs on meta tensors have
    the shapes and dtypes of its kernel's outputs on the card (the cases of
    ``tests/test_torch_dryrun.py``), and a dry run in a fresh process on
    this machine initialises no CUDA."""
    import subprocess
    import sys

    from test_torch_dryrun import REPO, _layout, _on, wrapper_cases

    for name, (call, args, _) in wrapper_cases().items():
        assert _layout(call(_on(args, "meta"))) == _layout(call(_on(args, cuda))), name
    code = ("import torch\nfrom repro_torch.launch import dryrun\n"
            "dryrun.run_cell('qwen3-moe-30b-a3b', 'decode_32k', False)\n"
            "print(torch.cuda.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=300)
    assert proc.stdout.split() == ["False"], proc.stderr[-2000:]
