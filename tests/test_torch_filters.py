"""The port's filtered and multi-tenant retrieval against the JAX package's
(DESIGN.md §17).

The same numpy inputs go through the reference (JAX on the CPU, its fused
Pallas kernel in interpret mode) and through the port (CPU tensors, so the
fused kernel's wrapper runs its plain version, with the bitmap packed as
the card takes it).  Integer outputs (ids, canonical filters) must be
equal; distances agree to rtol 1e-5 / atol 1e-5 (fp32 matmuls blocked
differently by XLA and PyTorch).  Index configs the reference trains with
``jax.random`` are held against the masked brute force and the isolation
invariant instead, or run over the reference's trained cells
(``ivf_from_arrays`` / ``pq_from_arrays``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as RIVF
from repro.core import knn as RK
from repro.core import pq as RPQ
from repro.core.distances import quantize_rows as rquantize
from repro.serving import QueryFilter as RQueryFilter
from repro.serving import RetrievalIndex as RIndex
from repro.serving import filters as RF
from repro_torch.core import ivf as PIVF
from repro_torch.core import knn as PK
from repro_torch.core import pq as PPQ
from repro_torch.core.distances import quantize_rows
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ops
from repro_torch.serving import filters as F
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.filters import QueryFilter
from repro_torch.serving.index import RetrievalIndex

CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = {"jnp": "torch", "fused": "fused"}  # reference impl -> the port's

# tests/test_filters.py's CONFIGS: (build kwargs, exact at these knobs).
CONFIGS = [
    ({}, True),
    ({"impl": "fused"}, True),
    ({"scan_dtype": "bfloat16", "overfetch": 64}, True),
    ({"ivf_cells": 8, "nprobe": 8, "overfetch": 64}, True),
    ({"ivf_cells": 8, "nprobe": 8, "overfetch": 64, "impl": "fused"}, True),
    ({"ivf_cells": 16, "nprobe": 4}, False),  # probed: invariants only
    ({"ivf_cells": 8, "nprobe": 8, "pq_m": 4, "overfetch": 64}, True),
]
CONFIG_IDS = ["-".join(f"{k}{v}" for k, v in c.items()) or "flat" for c, _ in CONFIGS]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(p_vals, p_ids, r_vals, r_ids):
    np.testing.assert_array_equal(np.asarray(p_ids), np.asarray(r_ids))
    rv, pv = np.asarray(r_vals), np.asarray(p_vals)
    np.testing.assert_array_equal(np.isinf(pv), np.isinf(rv))
    np.testing.assert_allclose(np.where(np.isinf(pv), 0, pv), np.where(np.isinf(rv), 0, rv),
                               **TOL)


def _port_kw(kw):
    kw = dict(kw)
    kw["impl"] = IMPLS[kw.get("impl", "jnp")]
    return {**kw, **CPU}


def _corpus(n=400, d=16, seed=3):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.permutation(10 * n)[:n].astype(np.int64)
    tenants = rng.integers(0, 3, n).astype(np.int32)
    return rng, vecs, ids, tenants


def _churn(indexes, rng, ids, d, n_del=40, n_ins=24):
    """Delete some rows, insert tenant-tagged new ones on every index."""
    dead = ids[rng.choice(len(ids), n_del, replace=False)]
    extra = rng.standard_normal((n_ins, d)).astype(np.float32)
    eids = (np.arange(n_ins) + 10 * len(ids) + 7).astype(np.int64)
    etens = rng.integers(0, 3, n_ins).astype(np.int32)
    for idx in indexes:
        idx.delete(dead)
        idx.insert(eids, extra, tenants=etens)
    return dead, extra, eids, etens


def _brute_masked(q, vecs, ids, mask, k):
    """Exact filtered top-k: +inf disallowed, stable sort, id -1 pads."""
    d2 = ((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
    d2 = np.where(mask, d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    v = np.take_along_axis(d2, order, axis=1)
    return v, np.where(np.isfinite(v), ids[order], -1)


# ---------------------------------------------------------------------------
# filters.py, and the packed bitmap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f,m", [
    (dict(), 4), (dict(exclude_ids=[[], [], [], []]), 4),
    (dict(tenant=2, exclude_ids=[[5, 6]]), 3),
    (dict(exclude_ids=[[1], [2, 3], []]), 3),
    (dict(tenant=[0, 4, 1], allowed_ids=[9, 3, 3, 7], mode="post"), 3),
    (dict(exclude_ids=np.array([[4, -1], [-1, -1], [8, 2]]), mode="pre"), 3),
])
def test_filters_canonical_forms_match_reference(f, m):
    r = RF.normalize(RQueryFilter(**f), m)
    p = F.normalize(QueryFilter(**f), m)
    assert (r is None) == (p is None)
    if r is None:
        return
    for a, b in zip(p, r):
        if isinstance(b, str) or b is None:
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert F.exclusion_width(p) == RF.exclusion_width(r)
    for lo, hi, m_pad in ((0, 2, 4), (1, 3, 8)):
        for a, b in zip(F.pad_rows(F.slice_rows(p, lo, hi), m_pad),
                        RF.pad_rows(RF.slice_rows(r, lo, hi), m_pad)):
            if isinstance(b, str) or b is None:
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        F.normalize(QueryFilter(mode="sideways"), 4)


def test_selectivity_mode_and_widen_match_reference():
    rng = np.random.default_rng(0)
    live = rng.random(200) < 0.8
    ids = rng.permutation(1000)[:200]
    tenants = rng.integers(0, 4, 200)
    for f in (dict(tenant=[0, 3]), dict(allowed_ids=ids[:70]),
              dict(tenant=[1, 1], allowed_ids=ids[50:150]), dict(tenant=[9, 1]),
              dict(allowed_ids=[])):
        r = RF.selectivity(RF.normalize(RQueryFilter(**f), 2), live=live, ids=ids,
                           tenants=tenants)
        p_f = F.normalize(QueryFilter(**f), 2)
        assert F.selectivity(p_f, live=live, ids=ids, tenants=tenants) == r
    assert F.selectivity(F.normalize(QueryFilter(tenant=1), 2), live=np.zeros(3, bool),
                         ids=np.arange(3), tenants=np.zeros(3)) == 1.0
    for s in (0.0, 1e-9, 0.1, 0.49, 0.5, 0.7, 1.0):
        for mode in F.MODES:
            assert F.resolve_mode(mode, s) == RF.resolve_mode(mode, s)
        for k in (1, 10, 37):
            assert F.widen(k, s) == RF.widen(k, s)
    assert (F.AUTO_PRE_BELOW, F.MAX_WIDEN, F.MODES) == (RF.AUTO_PRE_BELOW, RF.MAX_WIDEN,
                                                        RF.MODES)


@pytest.mark.parametrize("rows,n", [(5, 1), (3, 31), (4, 32), (7, 77), (2, 300)])
def test_bitmap_pack_unpack_round_trip(rows, n):
    """The fused kernel's bitmap format: bit c % 32 of word c // 32, LSB
    first, the bits past n clear; int32 words hold the uint32 bits."""
    g = np.random.default_rng(n)
    allowed = torch.from_numpy(g.random((rows, n)) < 0.5)
    allowed[0] = True  # a row of all bits set: words of -1 (bit 31 the sign)
    words = FK.pack_mask(allowed)
    assert words.dtype == torch.int32 and words.shape == (rows, FK.mask_words(n))
    assert torch.equal(FK.unpack_mask(words, n), allowed)
    want = np.zeros((rows, FK.mask_words(n)), np.uint32)
    for c in range(n):
        want[:, c // 32] |= allowed[:, c].numpy().astype(np.uint32) << np.uint32(c % 32)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    cols = torch.from_numpy(g.integers(-1, n, (rows, 9)))
    got = FK.mask_bits_at(words, cols)
    assert torch.equal(got, allowed.gather(1, cols.clamp(min=0)) & (cols >= 0))
    assert not got[cols < 0].any()
    shared = FK.mask_bits_at(words[:1], cols)
    assert torch.equal(shared, allowed[0][cols.clamp(min=0)] & (cols >= 0))


# ---------------------------------------------------------------------------
# core/knn.py: q_allowed and exclude_rows
# ---------------------------------------------------------------------------


def _allowed(m, n, seed, share=0.5):
    g = np.random.default_rng(seed)
    a = g.random((m, n)) < share
    a[1] = False  # a query with no allowed row: (+inf, -1) everywhere
    return a


@pytest.mark.parametrize("pimpl,rimpl", [("torch", "jnp"), ("fused", "fused")])
def test_knn_query_q_allowed_matches_reference(pimpl, rimpl):
    g = np.random.default_rng(4)
    q = g.standard_normal((9, 16)).astype(np.float32)
    db = g.standard_normal((300, 16)).astype(np.float32)
    live = g.random(300) < 0.8
    allowed = _allowed(9, 300, 5, share=0.1)
    r = RK.knn_query(jnp.asarray(q), jnp.asarray(db), 24, impl=rimpl, tile_m=16, tile_n=128,
                     db_live=jnp.asarray(live), q_allowed=jnp.asarray(allowed))
    p = PK.knn_query(_t(q), _t(db), 24, impl=pimpl, tile_m=16, tile_n=128,
                     db_live=_t(live), q_allowed=FK.pack_mask(_t(allowed)))
    _same(p.distances, p.indices, r.distances, r.indices)
    assert not np.isfinite(p.distances[1].numpy()).any() and (p.indices[1] == -1).all()
    # The port takes the packed words only: the reference's bool form is
    # refused, not cast.  An all-True bitmap gives None's result.
    with pytest.raises(ValueError):
        PK.knn_query(_t(q), _t(db), 24, impl=pimpl, db_live=_t(live), q_allowed=_t(allowed))
    full = PK.knn_query(_t(q), _t(db), 24, impl=pimpl,
                        q_allowed=FK.pack_mask(torch.ones(9, 300, dtype=bool)))
    none = PK.knn_query(_t(q), _t(db), 24, impl=pimpl)
    assert torch.equal(full.indices, none.indices) and torch.equal(full.distances,
                                                                   none.distances)


def test_fused_q_allowed_composes_with_exclude_self_and_db_valid():
    g = np.random.default_rng(6)
    x = g.standard_normal((40, 16)).astype(np.float32)
    allowed = _allowed(40, 40, 7)
    live = g.random(40) < 0.9
    r = RK.knn_query(jnp.asarray(x), jnp.asarray(x), 8, impl="fused", exclude_self=True,
                     db_live=jnp.asarray(live), q_allowed=jnp.asarray(allowed))
    p = PK.knn_query(_t(x), _t(x), 8, impl="fused", exclude_self=True, db_live=_t(live),
                     q_allowed=FK.pack_mask(_t(allowed)))
    _same(p.distances, p.indices, r.distances, r.indices)
    ri = ops.fused_knn(_t(x), _t(x), 8, db_valid=25, q_allowed=FK.pack_mask(_t(allowed)))
    want = PK.knn_query(_t(x), _t(x[:25]), 8, impl="torch",
                        q_allowed=FK.pack_mask(_t(allowed[:, :25])))
    assert torch.equal(ri.indices, want.indices)


@pytest.mark.parametrize("pimpl,rimpl", [("torch", "jnp"), ("fused", "fused")])
def test_two_stage_q_allowed_matches_reference(pimpl, rimpl):
    g = np.random.default_rng(8)
    q = g.standard_normal((7, 16)).astype(np.float32)
    db = g.standard_normal((260, 16)).astype(np.float32)
    allowed = _allowed(7, 260, 9, share=0.3)
    r = RK.two_stage_query(jnp.asarray(q), jnp.asarray(db), rquantize(jnp.asarray(db), "int8"),
                           6, impl=rimpl, overfetch=4, q_allowed=jnp.asarray(allowed))
    p = PK.two_stage_query(_t(q), _t(db), quantize_rows(_t(db), "int8"), 6, impl=pimpl,
                           overfetch=4, q_allowed=FK.pack_mask(_t(allowed)))
    _same(p.distances, p.indices, r.distances, r.indices)
    assert allowed[np.arange(7)[:, None], p.indices.clamp(min=0).numpy()][
        p.indices.numpy() >= 0].all()


@pytest.fixture(scope="module")
def cells():
    """A corpus, queries, and the reference's cells and residual PQ replica
    over it (pq_m 4, nbits 4), carried to the port."""
    x = clustered_vectors(400, 16, n_clusters=8, seed=2)
    q = clustered_vectors(9, 16, n_clusters=8, seed=3)
    ivf = RIVF.build_ivf(jnp.asarray(x), 8, iters=4)
    cb, codes = RPQ.build_ivfpq(jnp.asarray(x), ivf, 4, nbits=4, iters=3, seed=2)
    pivf = PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(ivf), device="cpu")
    return x, q, ivf, pivf, (cb, codes), PPQ.pq_from_arrays(RPQ.pq_to_arrays(cb, codes),
                                                           device="cpu")


@pytest.mark.parametrize("pimpl,rimpl", [("torch", "jnp"), ("fused", "fused")])
@pytest.mark.parametrize("tier", ["ivf", "ivfpq"])
def test_ivf_queries_filters_match_reference(cells, pimpl, rimpl, tier):
    """``q_allowed`` pre-filters the plain scan, post-filters the kernel's
    candidates; ``exclude_rows`` drops rows at the rescore on both."""
    x, q, ivf, pivf, (cb, codes), pq = cells
    g = np.random.default_rng(10)
    allowed = _allowed(9, 400, 11, share=0.4)
    live = g.random(400) < 0.9
    excl = g.integers(0, 400, (9, 5)).astype(np.int32)
    excl[:, 3:] = -1
    excl[0] = -1
    kw = dict(nprobe=4, overfetch=8)
    if tier == "ivf":
        r = RK.ivf_query(jnp.asarray(q), jnp.asarray(x), ivf, 6, impl=rimpl, **kw,
                         db_live=jnp.asarray(live), q_allowed=jnp.asarray(allowed),
                         exclude_rows=jnp.asarray(excl))
        p = PK.ivf_query(_t(q), _t(x), pivf, 6, impl=pimpl, **kw, db_live=_t(live),
                         q_allowed=FK.pack_mask(_t(allowed)), exclude_rows=_t(excl))
    else:
        r = RK.ivfpq_query(jnp.asarray(q), jnp.asarray(x), ivf, cb, codes, 6, impl=rimpl, **kw,
                           db_live=jnp.asarray(live), q_allowed=jnp.asarray(allowed),
                           exclude_rows=jnp.asarray(excl))
        p = PK.ivfpq_query(_t(q), _t(x), pivf, *pq, 6, impl=pimpl, **kw, db_live=_t(live),
                           q_allowed=FK.pack_mask(_t(allowed)), exclude_rows=_t(excl))
    _same(p.distances, p.indices, r.distances, r.indices)
    ids = p.indices.numpy()
    rows = np.arange(9)[:, None].repeat(6, 1)
    assert allowed[rows, ids.clip(0)][ids >= 0].all() and live[ids[ids >= 0]].all()
    assert not any(np.isin(ids[i][ids[i] >= 0], excl[i]).any() for i in range(9))
    # The reference's bool form is refused, not cast.
    kw2 = dict(impl=pimpl, **kw, db_live=_t(live), q_allowed=_t(allowed), exclude_rows=_t(excl))
    with pytest.raises(ValueError):
        if tier == "ivf":
            PK.ivf_query(_t(q), _t(x), pivf, 6, **kw2)
        else:
            PK.ivfpq_query(_t(q), _t(x), pivf, *pq, 6, **kw2)


# ---------------------------------------------------------------------------
# The serving index and engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,exact", CONFIGS, ids=CONFIG_IDS)
def test_index_tenant_filter_isolation_and_exactness(kw, exact):
    """No cross-tenant row in any mode; exact configs equal the masked brute
    force; the flat and quantized ones equal the reference's index."""
    rng, vecs, ids, tenants = _corpus()
    d, m, k = vecs.shape[1], 7, 8
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **_port_kw(kw))
    ref = None if "ivf_cells" in kw else RIndex.build(ids, vecs, tenants=tenants, **kw)
    dead, extra, eids, etens = _churn([i for i in (idx, ref) if i is not None], rng, ids, d)
    all_vecs = np.concatenate([vecs, extra])
    all_ids = np.concatenate([ids, eids])
    all_ten = np.concatenate([tenants, etens])
    live = ~np.isin(all_ids, dead)
    q = rng.standard_normal((m, d)).astype(np.float32)
    qt = rng.integers(0, 3, m).astype(np.int32)
    for mode in ("auto", "pre", "post"):
        r = idx.search(q, k, filter=QueryFilter(tenant=qt, mode=mode))
        ri = r.ids.numpy()
        for i in range(m):
            got = ri[i][ri[i] >= 0]
            assert np.isin(got, all_ids[live & (all_ten == qt[i])]).all(), (mode, i)
        if ref is not None:
            rr = ref.search(q, k, filter=RQueryFilter(tenant=qt, mode=mode))
            _same(r.distances, r.ids, rr.distances, rr.ids)
        if exact and mode != "post":
            mask = live[None, :] & (all_ten[None, :] == qt[:, None])
            bv, bi = _brute_masked(q, all_vecs, all_ids, mask, k)
            rv = r.distances.numpy()
            np.testing.assert_allclose(np.where(np.isfinite(rv), rv, 0.0),
                                       np.where(np.isfinite(bv), bv, 0.0), atol=1e-3)
            for i in range(m):
                assert set(ri[i][np.isfinite(rv[i])]) == set(bi[i][np.isfinite(bv[i])])


@pytest.mark.parametrize("kw,exact", CONFIGS, ids=CONFIG_IDS)
def test_trivial_filter_is_bit_identical(kw, exact):
    del exact
    rng, vecs, ids, tenants = _corpus(n=200)
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **_port_kw(kw))
    _churn([idx], rng, ids, vecs.shape[1], n_del=20, n_ins=12)
    q = rng.standard_normal((6, vecs.shape[1])).astype(np.float32)
    r0 = idx.search(q, 8)
    for f in (QueryFilter(), QueryFilter(mode="pre"), QueryFilter(mode="post"),
              QueryFilter(exclude_ids=[[]] * 6), None):
        r1 = idx.search(q, 8, filter=f)
        assert torch.equal(r0.ids, r1.ids) and torch.equal(r0.distances, r1.distances)


def test_exclusions_and_allow_list_match_reference():
    """Exclusions exact through the k + E widening (k + E = 70, K = 128);
    the allow-list pre and post (s = 0.3: auto pre-filters), both against
    the reference index and the masked brute force."""
    rng, vecs, ids, tenants = _corpus()
    d, m, k = vecs.shape[1], 7, 8
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **CPU)
    ref = RIndex.build(ids, vecs, tenants=tenants)
    dead, extra, eids, _ = _churn([idx, ref], rng, ids, d)
    all_vecs = np.concatenate([vecs, extra])
    all_ids = np.concatenate([ids, eids])
    live = ~np.isin(all_ids, dead)
    q = rng.standard_normal((m, d)).astype(np.float32)
    base = _brute_masked(q, all_vecs, all_ids, np.broadcast_to(live, (m, len(all_ids))), 80)[1]
    ex = [base[i, : 8 * i + rng.integers(0, 8)].tolist() + [99_999] * (i % 2) for i in range(m)]
    mask = np.broadcast_to(live, (m, len(all_ids))).copy()
    for i in range(m):
        mask[i] &= ~np.isin(all_ids, np.asarray(ex[i], np.int64))
    bv, bi = _brute_masked(q, all_vecs, all_ids, mask, k)
    r = idx.search(q, k, filter=QueryFilter(exclude_ids=ex))
    rr = ref.search(q, k, filter=RQueryFilter(exclude_ids=ex))
    _same(r.distances, r.ids, rr.distances, rr.ids)
    for i in range(m):
        assert set(r.ids[i].tolist()) - {-1} == set(bi[i]) - {-1}, i
    allow = all_ids[live][rng.choice(live.sum(), 120, replace=False)]
    amask = np.broadcast_to(live & np.isin(all_ids, allow), (m, len(all_ids)))
    bv, bi = _brute_masked(q, all_vecs, all_ids, amask, k)
    for mode in ("pre", "post", "auto"):
        f = dict(allowed_ids=allow, mode=mode)
        r = idx.search(q, k, filter=QueryFilter(**f))
        rr = ref.search(q, k, filter=RQueryFilter(**f))
        _same(r.distances, r.ids, rr.distances, rr.ids)
        assert np.isin(r.ids.numpy()[r.ids.numpy() >= 0], allow).all(), mode
        if mode != "post":
            assert all(set(r.ids[i].tolist()) - {-1} == set(bi[i]) - {-1} for i in range(m))


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_all_false_filter_returns_empty_slots(impl):
    rng, vecs, ids, tenants = _corpus(n=120)
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, impl=impl, **CPU)
    idx.insert([5_000], vecs[:1], tenants=[2])
    q = rng.standard_normal((4, vecs.shape[1])).astype(np.float32)
    for f in (QueryFilter(allowed_ids=np.array([], np.int64)), QueryFilter(tenant=99),
              QueryFilter(tenant=99, exclude_ids=[[1, 2]])):
        r = idx.search(q, 8, filter=f)
        assert (r.ids == -1).all() and torch.isinf(r.distances).all()


def test_tenants_ride_compaction_and_from_arrays():
    """Tags survive upsert and compact; ``from_arrays`` carries the
    reference's tagged state, and the two then answer alike."""
    rng, vecs, ids, tenants = _corpus(n=150)
    d = vecs.shape[1]
    ref = RIndex.build(ids, vecs, tenants=tenants)
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **CPU)
    new = rng.standard_normal((10, d)).astype(np.float32)
    for i in (ref, idx):
        i.upsert(ids[:10], new, tenants=np.full(10, 2))
        i.delete(ids[20:30])
    q = rng.standard_normal((5, d)).astype(np.float32)
    f = dict(tenant=rng.integers(0, 3, 5), exclude_ids=[[int(ids[0])]])
    carried = RetrievalIndex.from_arrays(
        ref._main_vecs, ref._main_ids, ref._main_live, ref._delta_vecs, ref._delta_ids,
        ref._delta_live, ref._delta_n, main_tenant=ref._main_tenant,
        delta_tenant=ref._delta_tenant, **CPU)
    want = ref.search(q, 6, filter=RQueryFilter(**f))
    for port in (idx, carried):
        _same(*port.search(q, 6, filter=QueryFilter(**f)), want.distances, want.ids)
    for i in (ref, idx):
        i.compact()
    np.testing.assert_array_equal(idx._main_tenant, ref._main_tenant)
    want = ref.search(q, 6, filter=RQueryFilter(**f))
    _same(*idx.search(q, 6, filter=QueryFilter(**f)), want.distances, want.ids)


def test_index_selectivity_is_counted_for_each_search():
    """The index counts a filter's live selectivity on its device, for each
    search, from nothing kept between searches: it equals the reference's
    host count over the same rows for a sequence of filters whose
    allow-lists and tenant sets change from one search to the next."""
    rng, vecs, ids, tenants = _corpus(n=300)
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **CPU)
    _, _, eids, _ = _churn([idx], rng, ids, vecs.shape[1])
    n = idx._delta_n
    rows = dict(live=np.concatenate([idx._main_live, idx._delta_live[:n]]),
                ids=np.concatenate([idx._main_ids, idx._delta_ids[:n]]),
                tenants=np.concatenate([idx._main_tenant, idx._delta_tenant[:n]]))
    all_ids = rows["ids"]
    for f in (dict(allowed_ids=all_ids[:150]), dict(allowed_ids=all_ids[100:]),
              dict(allowed_ids=np.concatenate([eids, [10**6]])), dict(tenant=[0, 1, 1]),
              dict(tenant=[2, 2, 2]), dict(tenant=[7, 0, 1]),
              dict(tenant=[1, 2, 0], allowed_ids=all_ids[::3]),
              dict(tenant=[1, 2, 0], allowed_ids=all_ids[1::3]), dict(allowed_ids=[])):
        fc = F.normalize(QueryFilter(**f), 3)
        dev = idx._device_state()
        want = RF.selectivity(RF.normalize(RQueryFilter(**f), 3), **rows)
        assert idx._selectivity(fc, dev, idx._memberships(fc, dev)) == want, f


def test_engine_chunk_pad_invariant_under_filtering():
    rng, vecs, ids, tenants = _corpus(n=200)
    d, m, k = vecs.shape[1], 11, 6
    idx = RetrievalIndex.build(ids, vecs, tenants=tenants, **CPU)
    q = rng.standard_normal((m, d)).astype(np.float32)
    qt = rng.integers(0, 3, m).astype(np.int32)
    ex = [[int(i)] * (j % 3) for j, i in enumerate(ids[:m])]
    f = QueryFilter(tenant=qt, exclude_ids=ex)
    want = idx.search(q, k, filter=f)
    eng = QueryEngine(idx, EngineConfig(k=k, min_batch=4, max_batch=4))
    got = eng.search(q, k, filter=f)
    assert torch.equal(want.ids, got.ids) and torch.equal(want.distances, got.distances)
    assert eng.meter.summary()["compile_batches"] == 1  # one shape, one filter key
    eng.search(q, k, filter=QueryFilter(tenant=qt, mode="post"))
    assert eng.meter.summary()["compile_batches"] == 2


# ---------------------------------------------------------------------------
# ROADMAP fault F1: fetch widths above 256 on the plain versions
# ---------------------------------------------------------------------------


def _f1_knn_query():
    g = np.random.default_rng(0)
    q, db = g.standard_normal((40, 16)).astype(np.float32), g.standard_normal(
        (600, 16)).astype(np.float32)
    r = RK.knn_query(jnp.asarray(q), jnp.asarray(db), 300)
    return PK.knn_query(_t(q), _t(db), 300), r


def _f1_allpairs():
    x = np.random.default_rng(0).standard_normal((400, 8)).astype(np.float32)
    return PK.knn_allpairs(_t(x), 300), RK.knn_allpairs(jnp.asarray(x), 300)


def _f1_index(**kw):
    g = np.random.default_rng(0)
    x = g.standard_normal((2000, 16)).astype(np.float32)
    q = g.standard_normal((6, 16)).astype(np.float32)
    k = 100 if kw else 300
    port = RetrievalIndex.build(np.arange(2000), x, **kw, **CPU).search(q, k)
    ref = RIndex.build(np.arange(2000), x, **kw).search(q, k)
    return (port.distances, port.ids), (ref.distances, ref.ids)


def _f1_ivf():
    g = np.random.default_rng(0)
    x = g.standard_normal((4096, 8)).astype(np.float32)
    q = g.standard_normal((5, 8)).astype(np.float32)
    ref = RIndex.build(np.arange(4096), x, ivf_cells=1024, nprobe=300)
    want = ref.search(q, 10)  # trains the cells the port is given
    port = RetrievalIndex.from_arrays(
        ref._main_vecs, ref._main_ids, ref._main_live, np.zeros((0, 8), np.float32),
        np.zeros(0, np.int32), np.zeros(0, bool), 0, impl="torch", nprobe=300,
        ivf=PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(ref._dev["main_ivf"]), device="cpu"), **CPU)
    got = port.search(q, 10)
    return (got.distances, got.ids), (want.distances, want.ids)


@pytest.mark.parametrize("case", ["knn_query", "allpairs", "flat_index", "int8_index", "ivf"])
def test_fetch_widths_above_256_match_reference(case):
    """Each input of ROADMAP F1: the plain versions serve K = 512 as the
    reference does."""
    p, r = {"knn_query": _f1_knn_query, "allpairs": _f1_allpairs,
            "flat_index": _f1_index,
            "int8_index": lambda: _f1_index(scan_dtype="int8"), "ivf": _f1_ivf}[case]()
    _same(p[0], p[1], r[0], r[1])
