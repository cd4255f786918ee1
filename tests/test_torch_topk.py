"""The port's selection primitives against the JAX package's, bit for bit.

Same numpy inputs through ``repro.core.topk`` and ``repro_torch.core.topk``;
values and ids must be identical, ties included (lower position wins in the
network, the first buffer wins a merge, the lower column first in
``tile_topk``, ``+inf`` slots carry ``-1``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as RT
from repro_torch.core import topk as PT


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _tied(g, shape):
    """Values drawn from a handful of levels, so ties are everywhere."""
    return g.integers(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("logl", [0, 1, 3, 5, 7])
@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("tied", [False, True])
def test_bitonic_sort_kv_matches_reference(logl, ascending, tied):
    g = np.random.default_rng(logl)
    L = 2 ** logl
    vals = _tied(g, (5, L)) if tied else g.standard_normal((5, L)).astype(np.float32)
    idx = np.broadcast_to(np.arange(L, dtype=np.int32), (5, L)).copy()
    rv, ri = RT.bitonic_sort_kv(jnp.asarray(vals), jnp.asarray(idx), ascending=ascending)
    pv, pi = PT.bitonic_sort_kv(torch.from_numpy(vals), torch.from_numpy(idx),
                                ascending=ascending)
    _eq(rv, pv)
    _eq(ri, pi)


@pytest.mark.parametrize("logk", [0, 2, 4, 6])
@pytest.mark.parametrize("tied", [False, True])
def test_merge_topk_sorted_matches_reference(logk, tied):
    g = np.random.default_rng(10 + logk)
    K = 2 ** logk
    draw = (lambda: _tied(g, (6, K))) if tied else (
        lambda: g.standard_normal((6, K)).astype(np.float32))
    a, b = np.sort(draw(), axis=1), np.sort(draw(), axis=1)
    ai = np.broadcast_to(np.arange(K, dtype=np.int32), (6, K)).copy()
    bi = ai + K
    rv, ri = RT.merge_topk_sorted(*map(jnp.asarray, (a, ai, b, bi)))
    pv, pi = PT.merge_topk_sorted(*map(torch.from_numpy, (a, ai, b, bi)))
    _eq(rv, pv)
    _eq(ri, pi)


@pytest.mark.parametrize("bn,K,off", [(64, 16, 0), (100, 32, 512), (5, 8, 7), (256, 8, 0)])
def test_tile_topk_matches_lax_top_k_order(bn, K, off):
    g = np.random.default_rng(bn)
    tile = _tied(g, (7, bn))
    tile[0, :] = 0.0  # a fully tied row
    tile[1, ::2] = np.inf
    rv, ri = RT.tile_topk(jnp.asarray(tile), K, off)
    pv, pi = PT.tile_topk(torch.from_numpy(tile), K, off)
    _eq(rv, pv)
    _eq(ri, pi)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("tied", [False, True])
def test_update_running_streams_tiles_like_reference(skip, tied):
    g = np.random.default_rng(5)
    m, k, bn = 6, 10, 32
    rrun = RT.init_running(m, k)
    prun = PT.init_running(m, k, device="cpu")
    for t in range(6):
        tile = _tied(g, (m, bn)) if tied else g.standard_normal((m, bn)).astype(np.float32)
        rrun = RT.update_running(*rrun, jnp.asarray(tile), t * bn, threshold_skip=skip)
        prun = PT.update_running(*prun, torch.from_numpy(tile), t * bn, threshold_skip=skip)
    _eq(rrun[0], prun[0])
    _eq(rrun[1], prun[1])
    rv, ri = RT.finalize_topk(*rrun, k)
    pv, pi = PT.finalize_topk(*prun, k)
    _eq(ri, pi)


def test_merge_many_sorted_and_pad_topk_match_reference():
    g = np.random.default_rng(9)
    S, m, K = 5, 4, 8
    vals = np.sort(_tied(g, (S, m, K)), axis=-1)
    idx = np.arange(S * m * K, dtype=np.int32).reshape(S, m, K)
    rv, ri = RT.merge_many_sorted(jnp.asarray(vals), jnp.asarray(idx), 6)
    pv, pi = PT.merge_many_sorted(torch.from_numpy(vals), torch.from_numpy(idx), 6)
    _eq(rv, pv)
    _eq(ri, pi)
    rv, ri = RT.pad_topk(jnp.asarray(vals[0, :, :3]), jnp.asarray(idx[0, :, :3]), 8)
    pv, pi = PT.pad_topk(torch.from_numpy(vals[0, :, :3]), torch.from_numpy(idx[0, :, :3]), 8)
    _eq(rv, pv)
    _eq(ri, pi)


def test_topk_smallest_and_scalars_match_reference():
    g = np.random.default_rng(2)
    x = _tied(g, (5, 40))
    rv, ri = RT.topk_smallest(jnp.asarray(x), 9)
    pv, pi = PT.topk_smallest(torch.from_numpy(x), 9)
    _eq(rv, pv)
    _eq(ri, pi)
    assert [PT.next_pow2(n) for n in (1, 2, 3, 100, 128, 129)] == \
        [RT.next_pow2(n) for n in (1, 2, 3, 100, 128, 129)]
    for flag in (None, True, False):
        assert PT.resolve_threshold_skip(flag, kernel=True) == \
            RT.resolve_threshold_skip(flag, pallas=True)
        assert PT.resolve_threshold_skip(flag, kernel=False) == \
            RT.resolve_threshold_skip(flag, pallas=False)
