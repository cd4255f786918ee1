"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA device and skips without one.  The file
imports torch and the port only, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: the kernels sum the d products in another order than the plain
matmul, so fp32 values agree to rounding (rtol 1e-5 plus an atol of 1e-5
times the size of the operands' products); ids agree except where two
distances are that close, and there the differing id's own distance,
recomputed from the operands, must be the value it is reported at.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import finalize_kind, get_distance
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as PD
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
@pytest.mark.parametrize("shape", [(1, 1, 4), (100, 130, 20), (256, 384, 256), (300, 1000, 68)])
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
    with pytest.raises(NotImplementedError):
        FK.fused_knn(fx, gy, hx, hy, 4, distance_finalize="identity", alpha=alpha,
                     n_real=16, gy_scale=hy)


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
