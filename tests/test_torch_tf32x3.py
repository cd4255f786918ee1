"""The 3xTF32 arithmetic of the matmul-form kernels' tile product, on the CPU.

``csrc/gemm_tc.cuh`` splits each fp32 operand into TF32 halves and sums three
tensor-core products; ``repro_torch.kernels.tf32`` repeats that arithmetic in
plain PyTorch, and these tests hold it to float64 and to the plain fp32
versions with the tolerances the kernels are held to on the card
(``tests/test_torch_gpu.py``): rtol 1e-5 plus an atol of 1e-5 times the size
of the operands' products (max |fx| * max |gy| * d).  One test also holds
the emulated product's distances to the JAX package's Pallas kernel, in
interpret mode, with the reference tests' own MXU-form tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.core import topk as T
from repro_torch.core.distances import FINALIZERS, REGISTRY, finalize_kind, get_distance
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ops
from repro_torch.kernels.ref import check_topk, operand_distance
from repro_torch.kernels.stream_topk import sorted_prefix
from repro_torch.kernels.tf32 import tf32_round, tf32_split, tf32x3_matmul


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


def _wide(seed, n=4096):
    """fp32 values over many binades and both signs."""
    g = np.random.default_rng(seed)
    return torch.from_numpy((g.standard_normal(n) * 10.0 ** g.uniform(-20, 20, n))
                            .astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_has_its_low_13_mantissa_bits_zero(seed):
    hi, lo = tf32_split(_wide(seed))
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hi_plus_lo_is_within_2_pow_minus_22_of_x(seed):
    x = _wide(seed)
    hi, lo = tf32_split(x)
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # hi alone is plain TF32: within 2^-11 |x|, and no closer in general
    assert bool(((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())


def test_rounding_is_to_nearest_ties_away_from_zero():
    """cvt.rna.tf32.f32: a tie (low 13 bits 0x1000) rounds away from zero,
    below a tie rounds down, above it up."""
    bits = torch.tensor([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F801001, 0x3F803000],
                        dtype=torch.int64).to(torch.int32)
    want = torch.tensor([0x3F802000, 0xBF802000, 0x3F800000, 0x3F802000, 0x3F804000],
                        dtype=torch.int64).to(torch.int32)
    got = tf32_round(bits.view(torch.float32)).view(torch.int32)
    assert got.tolist() == want.tolist()
    # a carry out of the mantissa moves to the next binade, and past the
    # largest finite value to inf
    top = torch.tensor([0x3FFFF000, 0x7F7FF000], dtype=torch.int64).to(torch.int32)
    assert tf32_round(top.view(torch.float32)).tolist() == [2.0, float("inf")]


def test_inf_and_nan_pass_through():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 1.0])
    hi, lo = tf32_split(x)
    assert hi[0] == float("inf") and hi[1] == -float("inf") and torch.isnan(hi[2])
    assert hi[3] == 1.0 and lo.tolist() == [0.0, 0.0, 0.0, 0.0]
    # a nan with only low mantissa bits set stays a nan, not an inf
    odd = torch.tensor([0x7F800001], dtype=torch.int64).to(torch.int32).view(torch.float32)
    assert torch.isnan(tf32_round(odd)).all() and torch.isnan(tf32_split(odd)[0]).all()


def _scale(fx, gy):
    return float(fx.abs().max() * gy.float().abs().max()) * fx.shape[1]


@pytest.mark.parametrize("name", sorted(REGISTRY))
@pytest.mark.parametrize("shape", [(33, 70, 20), (64, 130, 68), (17, 40, 260)])
def test_three_pass_product_matches_float64(name, shape):
    m, n, d = shape
    x, y = _data(name, m, n, d, 7)
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, name)
    fin = FINALIZERS[finalize_kind(get_distance(name))]
    got = fin(alpha * tf32x3_matmul(fx, gy) + hx + hy)
    want = fin(alpha * (fx.double() @ gy.double().T) + hx.double() + hy.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5 * _scale(fx, gy) + 1e-6)


def test_one_tf32_pass_would_fail_the_same_tolerance():
    """The check above has teeth: plain TF32 (hi . hi alone) misses it."""
    x, y = _data("sqeuclidean", 64, 130, 256, 8)
    x = x + 30.0  # a large common offset: -2 x.y cancels against the norms
    y = y + 30.0
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, "sqeuclidean")
    want = alpha * (fx.double() @ gy.double().T) + hx.double() + hy.double()
    one = alpha * (tf32_round(fx) @ tf32_round(gy).T) + hx + hy
    three = alpha * tf32x3_matmul(fx, gy) + hx + hy
    atol = 1e-5 * _scale(fx, gy)
    assert float((one.double() - want).abs().max()) > atol + 1e-5 * float(want.abs().max())
    torch.testing.assert_close(three.double(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot"])
def test_three_pass_product_matches_pallas(name):
    """The emulated product's distances against the JAX package's MXU-form
    Pallas kernel (interpret mode), at its tests' tolerance."""
    x, y = _data(name, 64, 130, 96, 9)
    want = rops.pairwise_distance(jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                                  distance=name, bm=64, bn=64, bd=32)
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, y, name)
    got = alpha * tf32x3_matmul(fx, gy) + hx + hy
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-3, rtol=1e-3)


def _emulated_fused(fx, gy, hx, hy, k, *, alpha, finalize, n_real, exclude_self,
                    gy_scale=None):
    """The fused kernel's selection fed by the three-pass product."""
    t = alpha * tf32x3_matmul(fx, gy)
    if gy_scale is not None:
        t = t * gy_scale
    tile = FINALIZERS[finalize](t + hx + hy)
    col = torch.arange(gy.shape[0])
    dead = (col >= n_real)[None, :].expand_as(tile)
    if exclude_self:
        dead = dead | (torch.arange(fx.shape[0])[:, None] == col[None, :])
    return sorted_prefix(torch.where(dead, T.POS_INF, tile), T.next_pow2(k))


@pytest.mark.parametrize("name", ["sqeuclidean", "neg_dot", "euclidean", "kl"])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_three_pass_selection_matches_plain(name, exclude_self):
    x, _ = _data(name, 200, 200, 68, 10)
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, x, name)
    fin = finalize_kind(get_distance(name))
    v, i = _emulated_fused(fx, gy, hx, hy, 10, alpha=alpha, finalize=fin, n_real=190,
                           exclude_self=exclude_self)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 10, alpha=alpha, finalize=fin, n_real=190,
                                exclude_self=exclude_self)
    check_topk(v, i, pv, pi, n=gy.shape[0], rtol=1e-5, atol=1e-5 * _scale(fx, gy) + 1e-6,
               dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize=fin))
    if exclude_self:
        assert not bool((i == torch.arange(200)[:, None]).any())


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_rows_get_a_zero_lo(dtype):
    """A bf16 or int8 row is exact in TF32: its lo is zero, so the kernel
    issues two products, and they equal the three-pass product."""
    x, y = _data("neg_dot", 40, 300, 64, 11)
    if dtype == "bf16":
        gy = y.to(torch.bfloat16)
    else:
        gy = (y / y.abs().amax(1, keepdim=True) * 127).round().to(torch.int8)
    hi, lo = tf32_split(gy.float())
    assert torch.equal(hi, gy.float()) and int(lo.count_nonzero()) == 0
    fx = x.contiguous()
    two = tf32x3_matmul(fx, gy)
    assert torch.equal(two, tf32x3_matmul(fx, gy.float()))
    hx, hy = torch.zeros(40, 1), torch.zeros(1, 300)
    scale = torch.rand(1, 300, generator=torch.Generator().manual_seed(0)) + 0.5
    v, i = _emulated_fused(fx, gy, hx, hy, 10, alpha=-1.0, finalize="identity", n_real=300,
                           exclude_self=False, gy_scale=scale)
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, 10, alpha=-1.0, finalize="identity",
                                n_real=300, gy_scale=scale)
    check_topk(v, i, pv, pi, n=300, rtol=1e-5, atol=1e-5 * _scale(fx, gy) * 1.5 + 1e-6,
               dist=operand_distance(fx, gy, hx, hy, alpha=-1.0, finalize="identity",
                                     gy_scale=scale))
