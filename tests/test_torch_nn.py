"""The port's NN substrate (``repro_torch.models.nn``) against the JAX
package's ``repro.models.nn``, on the CPU.

The same values, drawn with numpy from a seed, go through both packages:
``apply_dense`` (with and without a bias, with a bf16 ``compute_dtype``),
``apply_mlp`` with an activation between layers and a final one, the norms
(``apply_rmsnorm`` at offsets 1 and 0, ``apply_layernorm``), each of
``ACTS`` and ``model_scan`` (a carry and stacked outputs, and ``xs=None``
with a length) within rtol and atol 1e-6 (bf16: 1e-2).  The params'
structure, shapes and logical axes equal the reference's, and ``n_params``
counts the same.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import nn as RN
from repro_torch.models import nn as N

TOL = dict(rtol=1e-6, atol=1e-6)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _axes(tree, nn):
    return jax.tree.leaves(jax.tree.map(lambda p: p.axes, tree, is_leaf=nn.is_param),
                           is_leaf=lambda x: isinstance(x, tuple))


def _cross(port_tree):
    """The port's Param tree with its values as jnp arrays, in the reference's Params."""
    return N.tree_map(lambda p: RN.Param(jnp.asarray(p.value.numpy()), p.axes), port_tree,
                      is_leaf=N.is_param)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_dense_matches_the_reference(bias, compute_dtype):
    g = torch.Generator().manual_seed(0)
    p = N.dense(g, 24, 40, (None, "mlp"), bias=bias)
    if bias:
        p["bias"].value.copy_(torch.from_numpy(_rng(1).standard_normal(40).astype(np.float32)))
    ref = RN.dense(jax.random.PRNGKey(0), 24, 40, (None, "mlp"), bias=bias)
    assert _axes(p, N) == _axes(ref, RN)
    assert [tuple(t.shape) for t in N.tree_leaves(N.split_params(p)[0])] == \
        [t.shape for t in jax.tree.leaves(RN.split_params(ref)[0])]
    assert N.n_params(p) == RN.n_params(ref)
    x = _rng(2).standard_normal((16, 24)).astype(np.float32)
    tdt = None if compute_dtype is None else getattr(torch, compute_dtype)
    jdt = None if compute_dtype is None else getattr(jnp, compute_dtype)
    got = N.apply_dense(p, torch.from_numpy(x), compute_dtype=tdt)
    want = RN.apply_dense(_cross(p), jnp.asarray(x), compute_dtype=jdt)
    tol = TOL if compute_dtype is None else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("act", sorted(N.ACTS))
def test_mlp_and_acts_match_the_reference(act):
    g = torch.Generator().manual_seed(3)
    p = N.mlp(g, [12, 32, 32, 5])
    ref = RN.mlp(jax.random.PRNGKey(3), [12, 32, 32, 5])
    assert _axes(p, N) == _axes(ref, RN)
    assert N.n_params(p) == RN.n_params(ref)
    x = _rng(4).standard_normal((9, 12)).astype(np.float32)
    got = N.apply_mlp(p, torch.from_numpy(x), act=N.ACTS[act], final_act=torch.sigmoid)
    want = RN.apply_mlp(_cross(p), jnp.asarray(x), act=RN.ACTS[act], final_act=jax.nn.sigmoid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    z = _rng(5).standard_normal((7, 33)).astype(np.float32) * 4
    np.testing.assert_allclose(N.ACTS[act](torch.from_numpy(z)).numpy(),
                               np.asarray(RN.ACTS[act](jnp.asarray(z))), **TOL)


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_norms_match_the_reference(offset):
    d = 48
    x = (_rng(6).standard_normal((5, 3, d)) * 3 + 1).astype(np.float32)
    scale = _rng(7).standard_normal(d).astype(np.float32)
    bias = _rng(8).standard_normal(d).astype(np.float32)
    rms = N.rmsnorm_params(d, ("embed",))
    rms["scale"].value.copy_(torch.from_numpy(scale))
    assert _axes(rms, N) == _axes(RN.rmsnorm_params(d, ("embed",)), RN)
    got = N.apply_rmsnorm(rms, torch.from_numpy(x), offset=offset)
    want = RN.apply_rmsnorm(_cross(rms), jnp.asarray(x), offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ln = N.layernorm_params(d)
    ln["scale"].value.copy_(torch.from_numpy(scale))
    ln["bias"].value.copy_(torch.from_numpy(bias))
    got = N.apply_layernorm(ln, torch.from_numpy(x))
    want = RN.apply_layernorm(_cross(ln), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_model_scan_matches_the_reference():
    xs = {"a": _rng(9).standard_normal((6, 4)).astype(np.float32),
          "b": [_rng(10).standard_normal((6, 2, 3)).astype(np.float32)]}
    c0 = np.ones(4, np.float32)

    def body(lib):
        def f(c, x):
            c = c * 0.5 + x["a"] + lib.sum(x["b"][0])
            return c, {"c": c, "s": lib.sum(c)}
        return f

    tc, tys = N.model_scan(body(torch), torch.from_numpy(c0),
                           N.tree_map(torch.from_numpy, xs))
    jc, jys = RN.model_scan(body(jnp), jnp.asarray(c0), jax.tree.map(jnp.asarray, xs))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tys["c"].numpy(), np.asarray(jys["c"]), **TOL)
    np.testing.assert_allclose(tys["s"].numpy(), np.asarray(jys["s"]), **TOL)

    def count(c, _):
        return c + 1, None

    tc, tys = N.model_scan(count, torch.zeros(()), None, length=5)
    jc, jys = RN.model_scan(count, jnp.zeros(()), None, length=5)
    assert tys is None and jys is None and float(tc) == float(jc) == 5.0
