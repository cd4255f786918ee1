"""The port's distances against the JAX package's, on the same numpy inputs.

Tolerance: fp32 sums taken in another order (einsum/matmul blocking differs
between XLA and PyTorch on the CPU), so values agree to rtol 1e-5 with an
atol of 1e-5 for these O(1)-O(100) magnitudes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as RD
from repro_torch.core import distances as PD

NAMES = sorted(RD.REGISTRY)


def _data(name, m, n, d, seed):
    g = np.random.default_rng(seed)
    if RD.get_distance(name).needs_positive:
        x = g.gamma(1.0, 1.0, (m, d)).astype(np.float32) + 1e-4
        y = g.gamma(1.0, 1.0, (n, d)).astype(np.float32) + 1e-4
        return x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    return (g.standard_normal((m, d)).astype(np.float32),
            g.standard_normal((n, d)).astype(np.float32))


def test_registry_matches_reference():
    assert sorted(PD.REGISTRY) == NAMES
    for name in NAMES:
        r, p = RD.get_distance(name), PD.get_distance(name)
        assert (r.init, r.needs_positive, r.pre is None) == (p.init, p.needs_positive, p.pre is None)
        assert r.matmul_form.alpha == p.matmul_form.alpha
        assert PD.is_symmetric(name) == RD.is_symmetric(name)
    with pytest.raises(KeyError):
        PD.get_distance("nope")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("chunk", [None, 8])
def test_cumulative_pairwise_matches_reference(name, chunk):
    x, y = _data(name, 13, 17, 24, 0)
    want = RD.get_distance(name).pairwise(jnp.asarray(x), jnp.asarray(y), chunk=chunk)
    got = PD.get_distance(name).pairwise(torch.from_numpy(x), torch.from_numpy(y), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_matmul_form_and_finalizer_match_reference(name):
    x, y = _data(name, 20, 30, 40, 1)
    rd, pd = RD.get_distance(name), PD.get_distance(name)
    want = rd.matmul_form.pairwise(jnp.asarray(x), jnp.asarray(y), RD.matmul_finalize(rd))
    got = pd.matmul_form.pairwise(torch.from_numpy(x), torch.from_numpy(y),
                                  PD.matmul_finalize(pd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # The finalizer kind the kernels take is the reference's matmul finalizer.
    a = np.linspace(-2.0, 5.0, 15, dtype=np.float32)
    np.testing.assert_allclose(
        PD.FINALIZERS[PD.finalize_kind(pd)](torch.from_numpy(a)).numpy(),
        np.asarray(RD.matmul_finalize(rd)(jnp.asarray(a))), rtol=1e-6)
    # The matmul form and the cumulative path agree (Hellinger prefactor rule).
    cum = pd.pairwise(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), cum.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_operand_maps_match_reference(name):
    x, _ = _data(name, 9, 1, 16, 2)
    rf, pf = RD.get_distance(name).matmul_form, PD.get_distance(name).matmul_form
    for fn in ("fx", "gy", "hx", "hy"):
        np.testing.assert_allclose(getattr(pf, fn)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(rf, fn)(jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6)
