"""The port's kNN solvers against the JAX package's, on the same inputs.

``impl`` pairs: port ``"torch"`` <-> reference ``"jnp"``, ``"kernel"`` <->
``"pallas"`` (the Pallas kernel in interpret mode), ``"fused"`` <->
``"fused"``.  The plain paths run the same selection network on both sides,
so ids agree exactly; distances agree to atol 1e-4 / rtol 1e-5 (fp32
matmuls blocked differently by XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn as RK
from repro_torch.core import knn as PK
from repro_torch.data import synthetic as PS
from repro_torch.kernels import fused_knn as FK
from repro.data import synthetic as RS

PAIRS = [("torch", "jnp"), ("kernel", "pallas"), ("fused", "fused")]


def _close(p, r, ids_exact=True, atol=1e-4):
    np.testing.assert_allclose(p.distances.numpy(), np.asarray(r.distances),
                               atol=atol, rtol=1e-5)
    if ids_exact:
        np.testing.assert_array_equal(p.indices.numpy(), np.asarray(r.indices))


def test_synthetic_generators_are_the_references():
    np.testing.assert_array_equal(PS.random_vectors(50, 7, seed=3), RS.random_vectors(50, 7, seed=3))
    np.testing.assert_array_equal(PS.clustered_vectors(60, 5, seed=1),
                                  RS.clustered_vectors(60, 5, seed=1))
    np.testing.assert_array_equal(PS.distribution_vectors(40, 6, seed=2),
                                  RS.distribution_vectors(40, 6, seed=2))


@pytest.mark.parametrize("pimpl,rimpl", PAIRS)
@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_cosine", "kl"])
def test_knn_query_matches_reference(pimpl, rimpl, distance):
    if distance == "kl":
        q, db = PS.distribution_vectors(50, 16, seed=0), PS.distribution_vectors(200, 16, seed=1)
    else:
        q, db = PS.random_vectors(50, 16, seed=0), PS.random_vectors(200, 16, seed=1)
    kw = dict(distance=distance, tile_m=32, tile_n=64)
    r = RK.knn_query(jnp.asarray(q), jnp.asarray(db), 12, impl=rimpl, **kw)
    p = PK.knn_query(torch.from_numpy(q), torch.from_numpy(db), 12, impl=pimpl, **kw)
    _close(p, r)


@pytest.mark.parametrize("pimpl,rimpl", PAIRS)
def test_knn_query_masks_match_reference(pimpl, rimpl):
    q, db = PS.random_vectors(40, 8, seed=2), PS.random_vectors(150, 8, seed=3)
    live = np.random.default_rng(0).random(150) < 0.7
    kw = dict(tile_m=32, tile_n=64)
    r = RK.knn_query(jnp.asarray(q), jnp.asarray(db), 9, impl=rimpl,
                     db_live=jnp.asarray(live), **kw)
    p = PK.knn_query(torch.from_numpy(q), torch.from_numpy(db), 9, impl=pimpl,
                     db_live=torch.from_numpy(live), **kw)
    _close(p, r)
    assert live[p.indices.numpy()].all()
    # exclude_self on the full square, and k past the row count
    r = RK.knn_query(jnp.asarray(db[:20]), jnp.asarray(db[:20]), 30, impl=rimpl,
                     exclude_self=True, **kw)
    p = PK.knn_query(torch.from_numpy(db[:20]), torch.from_numpy(db[:20]), 30, impl=pimpl,
                     exclude_self=True, **kw)
    _close(p, r)
    assert p.indices.shape == (20, 19)


@pytest.mark.parametrize("pimpl,rimpl", PAIRS)
@pytest.mark.parametrize("distance", ["sqeuclidean", "hellinger"])
def test_knn_allpairs_symmetric_matches_reference(pimpl, rimpl, distance):
    """The symmetric triangle with its mirror update.  The port's "fused"
    solves the full square in the kernel where the reference's symmetric
    branch runs plain tiles: the same neighbours either way."""
    x = (PS.distribution_vectors(300, 32, seed=4) if distance == "hellinger"
         else PS.random_vectors(300, 32, seed=4))
    r = RK.knn_allpairs(jnp.asarray(x), 10, distance=distance, gsize=128, impl=rimpl)
    p = PK.knn_allpairs(torch.from_numpy(x), 10, distance=distance, gsize=128, impl=pimpl)
    _close(p, r, atol=1e-4 if distance == "sqeuclidean" else 1e-5)


def test_knn_allpairs_full_square_and_asymmetric_match_reference():
    x = PS.distribution_vectors(130, 12, seed=5)
    r = RK.knn_allpairs(jnp.asarray(x), 6, distance="kl", gsize=64)
    p = PK.knn_allpairs(torch.from_numpy(x), 6, distance="kl", gsize=64, impl="torch")
    _close(p, r, atol=1e-5)
    y = PS.random_vectors(130, 12, seed=6)
    r = RK.knn_allpairs(jnp.asarray(y), 6, gsize=64, symmetric=False, exclude_self=False)
    p = PK.knn_allpairs(torch.from_numpy(y), 6, gsize=64, symmetric=False, exclude_self=False,
                        impl="torch")
    _close(p, r)
    assert (p.indices.numpy()[:, 0] == np.arange(130)).all()  # self is nearest


def test_knn_query_brute_force_exactness():
    """The quickstart's check: the engine is exact, not approximate."""
    db = PS.clustered_vectors(3000, 32, seed=2)
    q = PS.clustered_vectors(16, 32, seed=3)
    res = PK.knn_query(torch.from_numpy(q), torch.from_numpy(db), 20)
    for r in range(16):
        brute = np.argsort(((q[r] - db) ** 2).sum(1), kind="stable")[:20]
        assert set(res.indices[r].tolist()) == set(brute.tolist())


def test_unknown_impl_and_filters_raise():
    """An unknown impl raises; a filter bitmap is served on every impl, the
    masked entries never selected (tests/test_torch_filters.py holds it
    against the reference)."""
    x = torch.from_numpy(PS.random_vectors(10, 4))
    with pytest.raises(ValueError):
        PK.knn_query(x, x, 3, impl="jnp")
    allowed = torch.from_numpy(np.random.default_rng(0).random((10, 10)) < 0.5)
    for impl in ("torch", "kernel", "fused"):
        res = PK.knn_query(x, x, 3, impl=impl, q_allowed=FK.pack_mask(allowed))
        ok = res.indices >= 0
        assert allowed.gather(1, res.indices.clamp(min=0).long())[ok].all()
        assert ok.sum(1).tolist() == allowed.sum(1).clamp(max=3).tolist()
