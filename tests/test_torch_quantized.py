"""The port's two-stage quantized scan against the JAX package's.

The same numpy inputs go through the reference (JAX on the CPU, its Pallas
kernels in interpret mode) and through the port (CPU tensors, so each
kernel wrapper runs its plain version).

Tolerances: replicas are integer or bf16 data and must be equal bit for
bit (``torch.round`` and ``jnp.round`` both round half to even); ``hy`` sums
d terms in another order, rtol 1e-6.  Scan and rescore values agree to
rtol 1e-5 / atol 1e-5 (fp32 products summed in another order); ids agree
except at near-ties, checked with ``ref.check_topk``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import accounting as raccounting
from repro.core import knn as RK
from repro.core.distances import dequantize_rows as rdequantize
from repro.core.distances import quantize_rows as rquantize
from repro.kernels import ops as rops
from repro.serving import RetrievalIndex as RIndex
from repro_torch import accounting
from repro_torch.core import knn as PK
from repro_torch.core.distances import (
    QUANTIZABLE,
    canonical_scan_dtype,
    dequantize_rows,
    finalize_kind,
    get_distance,
    gy_rows,
    quantize_rows,
)
from repro_torch.kernels import ops, ref
from repro_torch.serving.index import RetrievalIndex

CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _rows(n, d, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


def _check(v, i, rv, ri, n, dist=None):
    """Port (v, i) against reference (rv, ri): values within TOL, ids equal
    but for near-ties."""
    return ref.check_topk(v, i.long(), torch.from_numpy(np.array(rv)),
                          torch.from_numpy(np.array(ri)).long(), n=n, dist=dist, **TOL)


def _scan_distance(q, db_q, distance):
    """``dist(rows, cols)``: the quantized scan's value of each pair."""
    fx, gy, gs, hx, hy, alpha = ops._scan_operands(q, db_q, distance)
    return ref.operand_distance(fx, gy, hx, hy, alpha=alpha, gy_scale=gs,
                                finalize=finalize_kind(get_distance(distance)))


# ---------------------------------------------------------------------------
# quantize_rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", QUANTIZABLE)
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_quantize_rows_matches_reference(distance, scan_dtype):
    y = _rows(300, 24, 0, 3.0)
    y[0] = 0.0  # a zero row: the int8 scale floors at eps / 127
    y[1] = 2.5  # a constant row
    r = rquantize(jnp.asarray(y), scan_dtype, distance=distance)
    p = quantize_rows(torch.from_numpy(y), scan_dtype, distance=distance)
    assert p.data.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                            "int8": torch.int8}[scan_dtype]
    rd, pd = np.asarray(r.data.astype(jnp.float32)), p.data.float().numpy()
    if distance == "neg_cosine" and scan_dtype == "float32":
        # gy normalises the row; the two norms differ in the last place
        np.testing.assert_allclose(pd, rd, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(pd, rd)
    if scan_dtype == "int8":
        if distance == "neg_cosine":
            np.testing.assert_allclose(p.scale.numpy(), np.asarray(r.scale), rtol=1e-6)
        else:
            np.testing.assert_array_equal(p.scale.numpy(), np.asarray(r.scale))
    else:
        assert p.scale is None and r.scale is None
    np.testing.assert_allclose(p.hy.numpy(), np.asarray(r.hy), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dequantize_rows(p).numpy(), np.asarray(rdequantize(r)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_quantize_rows_block_by_block_equals_one_block(scan_dtype, monkeypatch):
    """The replica is built a block of rows at a time; the blocks change
    nothing, down to the bit."""
    from repro_torch.core import distances as D

    y = torch.from_numpy(_rows(1000, 24, 3, 2.0))
    whole = quantize_rows(y, scan_dtype, distance="sqeuclidean")
    monkeypatch.setattr(D, "_QUANT_BLOCK", 24 * 7)  # 143 blocks of 7 rows, a ragged last
    blocks = quantize_rows(y, scan_dtype, distance="sqeuclidean")
    assert torch.equal(whole.data, blocks.data) and torch.equal(whole.hy, blocks.hy)
    assert (whole.scale is None and blocks.scale is None) or torch.equal(whole.scale,
                                                                         blocks.scale)


def test_quantize_names_and_unquantizable_distances():
    assert canonical_scan_dtype("bf16") == "bfloat16" and canonical_scan_dtype("f32") == "float32"
    y = torch.ones(8, 8) / 8.0
    with pytest.raises(ValueError):
        quantize_rows(y, "int8", distance="kl")
    with pytest.raises(ValueError):
        quantize_rows(y, "float16")
    with pytest.raises(ValueError):
        gy_rows(y, "hellinger")
    q = quantize_rows(torch.zeros(5, 4), "int8")
    assert torch.isfinite(q.scale).all() and (q.scale > 0).all()
    assert torch.equal(dequantize_rows(q), torch.zeros(5, 4))


# ---------------------------------------------------------------------------
# The kernels' functions: the quantized fused scan and the rescore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_dot", "neg_cosine"])
@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
def test_fused_knn_over_a_replica_matches_pallas(distance, scan_dtype):
    y, x = _rows(400, 32, 1), _rows(40, 32, 2)
    live = np.arange(400) % 7 != 3
    r = rquantize(jnp.asarray(y), scan_dtype, distance=distance)
    p = quantize_rows(torch.from_numpy(y), scan_dtype, distance=distance)
    want = rops.fused_knn(jnp.asarray(x), r, 20, distance=distance, tile_m=64, tile_n=128,
                          bd=32, db_live=jnp.asarray(live))
    got = ops.fused_knn(torch.from_numpy(x), p, 20, distance=distance,
                        db_live=torch.from_numpy(live))
    _check(got.distances, got.indices, want.distances, want.indices, 400,
           dist=_scan_distance(torch.from_numpy(x), p, distance))
    assert not np.isin(got.indices.numpy(), np.flatnonzero(~live)).any()


@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_dot", "euclidean"])
@pytest.mark.parametrize("Kp", [16, 20, 64])
def test_rescore_topk_matches_pallas(distance, Kp):
    """Candidate lists from a scan, with empty slots; Kp not a multiple of
    K is padded to K * 2^t as the reference pads it."""
    y, x = _rows(300, 24, 3), _rows(17, 24, 4)
    cand = RK.knn_query(jnp.asarray(x), jnp.asarray(y), Kp, distance=distance).indices
    cand = np.asarray(cand).copy()
    cand[::3, -5:] = -1
    want = rops.rescore_topk(jnp.asarray(x), jnp.asarray(y), jnp.asarray(cand), 6,
                             distance=distance, bm=8, bd=8)
    got = ops.rescore_topk(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cand),
                           6, distance=distance)
    assert got.indices.dtype == torch.int32 and got.indices.shape == (17, 6)
    _check(got.distances, got.indices, want.distances, want.indices, 300)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_dot"])
def test_rescore_topk_past_256_matches_pallas(distance):
    """k 300 (K 512) over 1000 candidates a row, padded to Kp 1024, with
    empty slots and a row left fewer than K live ones: the fetch width of a
    filtered rescore (k + E past 256)."""
    g = np.random.default_rng(7)
    y, x = _rows(1500, 8, 8), _rows(5, 8, 9)
    cand = np.stack([g.permutation(1500)[:1000] for _ in range(5)]).astype(np.int32)
    cand[::2, -40:] = -1
    cand[3, 250:] = -1
    want = rops.rescore_topk(jnp.asarray(x), jnp.asarray(y), jnp.asarray(cand), 300,
                             distance=distance, bm=8, bd=8)
    got = ops.rescore_topk(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cand),
                           300, distance=distance)
    assert got.indices.shape == (5, 300)
    _check(got.distances, got.indices, want.distances, want.indices, 1500)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert (got.indices.numpy()[3, 250:] == -1).all()


@pytest.mark.parametrize("impl,rimpl", [("torch", "jnp"), ("fused", "fused")])
def test_rescore_handles_empty_slots_and_k_wider_than_candidates(impl, rimpl):
    y, x = _rows(50, 8, 5), _rows(4, 8, 6)
    cand = np.array([[0, 1, -1, -1]] * 4, np.int32)
    want = RK.rescore(jnp.asarray(x), jnp.asarray(y), jnp.asarray(cand), 4, impl=rimpl)
    got = PK.rescore(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(cand), 4,
                     impl=impl)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.distances.numpy(), np.asarray(want.distances), **TOL)
    assert (got.indices.numpy()[:, 2:] == -1).all()
    assert np.isposinf(got.distances.numpy()[:, 2:]).all()


def test_scan_width_matches_reference():
    for n, k, o in [(1000, 10, 4), (40, 10, 4), (1000, 10, 1), (5, 1, 8), (1 << 20, 100, 4)]:
        assert PK.scan_width(n, k, o) == RK.scan_width(n, k, o)


# ---------------------------------------------------------------------------
# quantized_scan and two_stage_query
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_dot"])
def test_quantized_scan_matches_reference(scan_dtype, distance):
    y, x = _rows(1500, 20, 7), _rows(9, 20, 8)
    live = np.arange(1500) % 5 != 0
    r = rquantize(jnp.asarray(y), scan_dtype, distance=distance)
    p = quantize_rows(torch.from_numpy(y), scan_dtype, distance=distance)
    want = RK.quantized_scan(jnp.asarray(x), r, 40, distance=distance,
                             db_live=jnp.asarray(live))
    got = PK.quantized_scan(torch.from_numpy(x), p, 40, distance=distance,
                            db_live=torch.from_numpy(live))
    _check(got.distances, got.indices, want.distances, want.indices, 1500,
           dist=_scan_distance(torch.from_numpy(x), p, distance))


@pytest.mark.parametrize("impl,rimpl", [("torch", "jnp"), ("fused", "fused"),
                                        ("kernel", "pallas")])
@pytest.mark.parametrize("scan_dtype", ["float32", "bfloat16", "int8"])
def test_two_stage_query_matches_reference(impl, rimpl, scan_dtype):
    y, x = _rows(600, 16, 9), _rows(13, 16, 10)
    live = np.arange(600) % 9 != 4
    r = rquantize(jnp.asarray(y), scan_dtype, distance="neg_dot")
    p = quantize_rows(torch.from_numpy(y), scan_dtype, distance="neg_dot")
    want = RK.two_stage_query(jnp.asarray(x), jnp.asarray(y), r, 7, distance="neg_dot",
                              impl=rimpl, db_live=jnp.asarray(live))
    got = PK.two_stage_query(torch.from_numpy(x), torch.from_numpy(y), p, 7,
                             distance="neg_dot", impl=impl, db_live=torch.from_numpy(live))
    _check(got.distances, got.indices, want.distances, want.indices, 600)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_two_stage_float32_replica_is_exact(impl):
    """The reference's hatch: K' fp32 scan candidates contain the top-k."""
    y, x = torch.from_numpy(_rows(200, 16, 11)), torch.from_numpy(_rows(13, 16, 12))
    exact = PK.knn_query(x, y, 7)
    res = PK.two_stage_query(x, y, quantize_rows(y, "float32"), 7, impl=impl)
    assert torch.equal(res.indices, exact.indices)
    torch.testing.assert_close(res.distances, exact.distances, **TOL)


class _Shapes(TorchDispatchMode):
    """Records the shape and dtype of every tensor an aten op returns."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.append((str(func), tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("scan_dtype", ["int8", "bfloat16"])
def test_plain_scan_never_holds_a_dequantized_corpus(scan_dtype):
    """The plain scan widens one [tile_n, d] tile at a time: no op of the
    whole two-stage query returns an fp32 tensor with corpus-many rows."""
    n, d, m, k = 4096, 32, 8, 10
    db = torch.from_numpy(_rows(n, d, 13))
    q = torch.from_numpy(_rows(m, d, 14))
    db_q = quantize_rows(db, scan_dtype)
    with _Shapes() as rec:
        res = PK.two_stage_query(q, db, db_q, k, impl="torch")
    assert res.indices.shape == (m, k)
    assert any(s[0] == 1024 and dt == torch.float32 for _, s, dt in rec.seen), \
        "the per-tile upcast was not seen: the recorder saw nothing"
    big = [(f, s) for f, s, dt in rec.seen
           if dt == torch.float32 and len(s) == 2 and s[0] >= n]
    assert not big, f"corpus-sized fp32 tensors on the plain scan path: {big}"


# ---------------------------------------------------------------------------
# The serving index: scan_dtype and overfetch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("impl,rimpl", [("torch", "jnp"), ("fused", "fused")])
def test_index_quantized_lifecycle_matches_reference(scan_dtype, impl, rimpl):
    """One insert/upsert/delete/compact sequence on both indexes; the delta
    stays fp32, the replica follows compact."""
    g = np.random.default_rng(15)
    d = 16
    vecs = g.standard_normal((256, d)).astype(np.float32)
    q = g.standard_normal((12, d)).astype(np.float32)
    kw = dict(distance="neg_dot", scan_dtype=scan_dtype, overfetch=2)
    refi = RIndex.build(np.arange(256), vecs, impl=rimpl, **kw)
    port = RetrievalIndex.build(np.arange(256), vecs, impl=impl, **kw, **CPU)
    steps = [("delete", (np.arange(0, 256, 5),)),
             ("insert", (np.arange(1000, 1030), g.standard_normal((30, d)).astype(np.float32))),
             ("upsert", (np.arange(10, 20), g.standard_normal((10, d)).astype(np.float32))),
             ("compact", ()),
             ("delete", (np.arange(1000, 1010),))]
    for op, args in steps:
        getattr(refi, op)(*args)
        getattr(port, op)(*args)
        assert refi.shape_signature(8) == port.shape_signature(8)
        for k in (1, 8):
            r, p = refi.search(jnp.asarray(q), k), port.search(q, k)
            np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))
            np.testing.assert_allclose(p.distances.numpy(), np.asarray(r.distances), **TOL)


def test_index_float32_scan_dtype_is_bit_exact():
    g = np.random.default_rng(16)
    vecs, q = g.standard_normal((300, 24)).astype(np.float32), g.standard_normal(
        (9, 24)).astype(np.float32)
    a = RetrievalIndex.build(np.arange(300), vecs, **CPU).search(q, 11)
    b = RetrievalIndex.build(np.arange(300), vecs, scan_dtype="fp32", **CPU).search(q, 11)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.distances, b.distances)


def test_tombstone_does_not_requantize_but_compact_does():
    g = np.random.default_rng(17)
    idx = RetrievalIndex.build(np.arange(64), g.standard_normal((64, 8)).astype(np.float32),
                               scan_dtype="int8", **CPU)
    q = g.standard_normal((3, 8)).astype(np.float32)
    idx.search(q, 3)
    replica = idx._dev["main_q"]
    idx.delete([0, 1, 2])
    res = idx.search(q, 3)
    assert idx._dev["main_q"] is replica  # a mask flip, the same replica
    assert not np.isin(res.ids.numpy(), [0, 1, 2]).any()
    idx.compact()
    idx.search(q, 3)
    assert idx._dev["main_q"] is not replica
    assert idx._dev["main_q"].data.shape[0] == 61


def test_index_quantized_rejects_unquantizable_distance():
    with pytest.raises(ValueError):
        RetrievalIndex(8, distance="kl", scan_dtype="int8", **CPU)
    with pytest.raises(ValueError):
        RetrievalIndex(8, scan_dtype="float16", **CPU)


def test_scan_bytes_model_matches_reference():
    for kw in (dict(), dict(scan_dtype="int8"), dict(scan_dtype="bfloat16", k=100),
               dict(scan_dtype="int8", ncells=64, nprobe=8), dict(ncells=64),
               dict(ncells=4096, nprobe=8, overfetch=2)):
        want = raccounting.scan_bytes_per_query(1 << 20, 256, **kw)
        assert accounting.scan_bytes_per_query(1 << 20, 256, **kw) == want, kw
