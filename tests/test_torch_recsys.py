"""The port's two-tower towers (``repro_torch.models.recsys``), config
(``repro_torch.configs.two_tower``), params fingerprint and embedding cache
against the JAX package's.

On the CPU at ``smoke_config()``, with the reference's params carried
across as numpy (``params_from_reference``).  Held: both towers' outputs
within rtol and atol 1e-5 and of norm 1; the full config's shapes, drawn on
the meta device, equal to the reference's ``abstract_params`` (the full
width, with no allocation); ``param_leaves`` in ``jax.tree.leaves`` order;
the service's params fingerprint equal to the reference's string, and the
block-streamed CRC equal to ``zlib.crc32`` of the whole leaf; the cache's
hits, misses and eviction order equal to the reference cache's on a seeded
sequence of puts, gets and invalidates, and the service's user embeddings
through a cache smaller than a batch equal to the reference service's.
"""
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as REG
from repro.models import recsys as RR
from repro.models.nn import split_params
from repro.serving import ServiceConfig as RServiceConfig
from repro.serving import TwoTowerRetrievalService as RService
from repro.serving.cache import EmbeddingCache as RCache
from repro_torch.configs import two_tower as TT
from repro_torch.models import recsys as P
from repro_torch.serving import EmbeddingCache, ServiceConfig, TwoTowerRetrievalService
from repro_torch.serving.service import params_crc32, tensor_crc32

ARCH = REG.get("two-tower-retrieval")
CFG = TT.smoke_config()


@pytest.fixture(scope="module")
def values():
    vals, _ = split_params(ARCH.init_params(jax.random.PRNGKey(0), ARCH.smoke_config()))
    return vals


def test_configs_match_the_reference():
    from repro.configs import two_tower as RT

    for name in ("full_config", "smoke_config"):
        want, got = getattr(RT, name)(), getattr(TT, name)()
        assert dataclasses_dict(got) == dataclasses_dict(want), name
        assert got.u_sizes() == want.u_sizes() and got.i_sizes() == want.i_sizes()
    assert TT.serving_defaults() == RT.serving_defaults()
    assert P.default_table_sizes(26) == RR.default_table_sizes(26)


def dataclasses_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("tower", ["user", "item"])
def test_towers_match_the_reference(values, tower):
    rng = np.random.default_rng(3)
    sizes = CFG.u_sizes() if tower == "user" else CFG.i_sizes()
    # every row of every table at least once, the last rows included
    n = max(sizes)
    ids = np.stack([np.concatenate([np.arange(s), rng.integers(0, s, n - s)]) for s in sizes],
                   axis=1).astype(np.int32)
    ref_fn = RR.user_embedding if tower == "user" else RR.item_embedding
    port_fn = P.user_embedding if tower == "user" else P.item_embedding
    want = np.asarray(ref_fn(values, jax.numpy.asarray(ids)))
    params = P.params_from_reference(jax.tree.map(np.asarray, values), device="cpu")
    got = port_fn(params, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.norm(dim=1).numpy(), 1.0, rtol=1e-5, atol=1e-5)


def test_full_config_shapes_on_meta():
    abstract, _ = split_params(ARCH.abstract_params(ARCH.full_config()))
    want = [tuple(x.shape) for x in jax.tree.leaves(abstract)]
    params = P.init_two_tower(TT.full_config(), device="meta")
    leaves = P.param_leaves(params)
    assert [tuple(t.shape) for t in leaves] == want
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in leaves)
    assert P.n_params(params) == sum(int(np.prod(s)) for s in want) == 11_122_707_968


def test_param_leaves_follow_jax_tree_leaves(values):
    params = P.params_from_reference(jax.tree.map(np.asarray, values), device="cpu")
    for got, want in zip(P.param_leaves(params), jax.tree.leaves(values), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_draws_the_reference_distributions():
    g = torch.Generator().manual_seed(7)
    params = P.init_two_tower(CFG, generator=g, device="cpu")
    again = P.init_two_tower(CFG, generator=torch.Generator().manual_seed(7), device="cpu")
    other = P.init_two_tower(CFG, generator=torch.Generator().manual_seed(8), device="cpu")
    for a, b, c in zip(P.param_leaves(params), P.param_leaves(again), P.param_leaves(other)):
        assert torch.equal(a, b)
        assert a.ndim == 1 or not torch.equal(a, c)
    tables = torch.cat([t.flatten() for t in params["user_tables"] + params["item_tables"]])
    assert abs(float(tables.std()) - CFG.feat_dim ** -0.5) < 0.01
    for layer in params["user_mlp"] + params["item_mlp"]:
        fan_in = layer["w"].shape[0]
        assert abs(float(layer["w"].std()) - fan_in ** -0.5) < 0.15 * fan_in ** -0.5
        assert not layer["b"].any()


@pytest.mark.parametrize("capacity", [0, 5, 64])
def test_embed_users_through_the_cache_matches_the_reference(values, capacity):
    """Batches of mixed hits and misses, with keys repeated inside a batch
    (with other fields) and, at capacity 5, a cache smaller than a batch:
    the same rows, counts and LRU order as the reference service's."""
    ref = RService(values, CFG, RServiceConfig(cache_capacity=capacity))
    params = P.params_from_reference(jax.tree.map(np.asarray, values), device="cpu")
    port = TwoTowerRetrievalService(params, CFG, ServiceConfig(cache_capacity=capacity),
                                    device="cpu")
    rng = np.random.default_rng(capacity)
    lim = min(CFG.u_sizes())
    for _ in range(8):
        keys = rng.integers(0, 32, size=rng.integers(1, 12))
        # a key's fields differ between its repeats: the last one's row wins
        feats = rng.integers(0, lim, size=(len(keys), CFG.n_user_fields)).astype(np.int32)
        want = np.asarray(ref.embed_users(keys, feats))
        got = port.embed_users(keys, feats)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert list(port.user_cache._slots) == list(ref.user_cache._rows)
        assert port.user_cache.stats() == ref.user_cache.stats()
    assert capacity == 0 or port.user_cache.hits > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_params_fingerprint_matches_the_reference(seed):
    vals, _ = split_params(ARCH.init_params(jax.random.PRNGKey(seed), ARCH.smoke_config()))
    want = RService(vals, CFG, RServiceConfig())._params_fingerprint()
    params = P.params_from_reference(jax.tree.map(np.asarray, vals), device="cpu")
    assert params_crc32(params) == want
    # small blocks: every leaf streamed in pieces, the string unchanged
    assert params_crc32(params, block_bytes=1000) == want
    svc = TwoTowerRetrievalService(params, CFG, ServiceConfig(), device="cpu")
    assert svc._params_fingerprint() == want


@pytest.mark.parametrize("block", [1, 64, 1000, 4096, 1 << 20])
def test_tensor_crc32_in_blocks_is_the_whole_leafs(block):
    t = torch.from_numpy(np.random.default_rng(block).standard_normal((37, 29), np.float32))
    want = zlib.crc32(t.numpy().tobytes(), 12345)
    assert tensor_crc32(t, 12345, block_bytes=block) == want


def test_embedding_cache_lru_and_stats():
    """``tests/test_serving.py::test_embedding_cache_lru_and_stats`` on the port."""
    c = EmbeddingCache(capacity=2)
    c.put(1, np.ones(3))
    c.put(2, np.full(3, 2.0))
    assert c.get(1) is not None  # 1 now most-recent
    c.put(3, np.full(3, 3.0))  # evicts 2
    assert c.get(2) is None and c.get(3) is not None
    found, missing = c.get_many([1, 2, 3])
    assert set(found) == {1, 3} and missing == [2]
    assert c.hits == 4 and c.misses == 2


@pytest.mark.parametrize("capacity", [0, 1, 5, 64])
def test_embedding_cache_matches_the_reference(capacity):
    rng = np.random.default_rng(capacity)
    ref, port = RCache(capacity), EmbeddingCache(capacity)
    for step in range(400):
        op = rng.integers(0, 6)
        keys = rng.integers(0, 40, size=rng.integers(1, 9)).tolist()
        if op == 0:
            for c in (ref, port):
                c.put(keys[0], np.full(2, step, np.float32))
        elif op == 1:
            got = [port.get(k) for k in keys]
            want = [ref.get(k) for k in keys]
            assert [g is None for g in got] == [w is None for w in want]
        elif op == 2:
            (fr, mr), (fp, mp) = ref.get_many(keys), port.get_many(keys)
            assert mr == mp and sorted(fr) == sorted(fp)
            for k in fr:
                np.testing.assert_array_equal(fr[k], fp[k])
        elif op == 3:
            rows = [np.full(2, step + i, np.float32) for i in range(len(keys))]
            ref.put_many(keys, rows)
            port.put_many(keys, rows)
        elif op == 4 and step % 50 == 0:
            ref.invalidate()
            port.invalidate()
        else:
            ref.invalidate(keys[0])
            port.invalidate(keys[0])
        assert list(port._slots) == list(ref._rows)  # the LRU order
        assert port.stats() == ref.stats() or (np.isnan(port.hit_rate) and np.isnan(ref.hit_rate))
