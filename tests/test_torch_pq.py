"""The port's IVF-PQ tier against the JAX package's.

The same numpy inputs go through the reference (JAX on the CPU, its Pallas
kernels in interpret mode) and through the port (CPU tensors, so each
kernel wrapper runs its plain version).  Torch cannot replay
``jax.random``, so the port's codebooks are trained from the reference's
own initial permutations, and its scans run over codebooks, codes and
cells the reference trained (``pq_to_arrays`` / ``pq_from_arrays``).

Tolerances: codes and packings are integers and must be equal; codebooks
are k-means means summed in another order, rtol 1e-5; decoded rows are
gathers and must be equal; ``hy`` and the lookup tables sum in another
order, rtol 1e-5.  ADC values agree to rtol 1e-5 / atol 1e-5 (the port
sums the table entries in another order than the reference's one-hot
contraction), ids except at near-ties (``ref.check_topk``, each differing
id's ADC value recomputed from the tables).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import accounting as raccounting
from repro.core import ivf as RIVF
from repro.core import knn as RK
from repro.core import pq as RPQ
from repro.data.synthetic import clustered_vectors
from repro.kernels import ops as rops
from repro.kernels.pq_scan import pq_scan_pallas
from repro.serving import RetrievalIndex as RIndex
from repro_torch import accounting
from repro_torch.core import ivf as PIVF
from repro_torch.core import knn as PK
from repro_torch.core import pq as PPQ
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ops, ref
from repro_torch.kernels import pq_scan as PQS
from repro_torch.serving.index import RetrievalIndex

CPU = dict(device="cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perms(seed, n, m):
    """The reference's per-subspace k-means starts (``train_pq``: seed + j)."""
    return [_t(jax.random.permutation(jax.random.PRNGKey(seed + j), n)) for j in range(m)]


def _carry_pq(cb, codes):
    return PPQ.pq_from_arrays(RPQ.pq_to_arrays(cb, codes), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """A corpus, the reference's cells over it and its residual and plain
    PQ replicas of the packed rows (pq_m 4, nbits 4), carried to the port."""
    x = clustered_vectors(700, 16, n_clusters=8, spread=0.4, seed=3)
    ivf = RIVF.build_ivf(jnp.asarray(x), 8, iters=5)
    out = {"x": x, "ivf": ivf,
           "pivf": PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(ivf), device="cpu")}
    for residual in (True, False):
        cb, codes = RPQ.build_ivfpq(jnp.asarray(x), ivf, 4, nbits=4, iters=4, seed=2,
                                    residual=residual)
        out[residual] = (cb, codes, *_carry_pq(cb, codes))
    return out


def _adc_distance(luts, qc, hx, hy, cell_cap, codes):
    """``dist(rows, slots)``: the ADC value of each (query, packed slot)
    (sqeuclidean: the identity finalizer)."""
    m = luts.shape[0]
    lut3 = luts.reshape(m, codes.shape[1], -1)

    def dist(rows, cols):
        s = lut3[rows[:, None], torch.arange(codes.shape[1])[None, :],
                 codes[cols].long()].sum(1)
        if qc is not None:
            s = s + qc[rows, cols // cell_cap]
        return s + hx[rows, 0] + hy[0, cols]
    return dist


# ---------------------------------------------------------------------------
# Codebooks, codes, arrays, tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,nbits,impl", [(4, 4, "fused"), (8, 3, "torch"), (2, 5, "fused")])
def test_train_and_encode_match_reference_from_its_permutations(m, nbits, impl):
    x = clustered_vectors(400, 16, n_clusters=8, seed=1)
    cb = RPQ.train_pq(jnp.asarray(x), m, nbits=nbits, iters=4, seed=7)
    pcb = PPQ.train_pq(torch.from_numpy(x), m, nbits=nbits, iters=4,
                       init_perms=_perms(7, 400, m), impl=impl)
    np.testing.assert_allclose(pcb.codebooks.numpy(), np.asarray(cb.codebooks), rtol=1e-5,
                               atol=1e-6)
    assert (pcb.m, pcb.ncodes, pcb.dsub) == (cb.m, cb.ncodes, cb.dsub)
    # Codes and decoded rows from the reference's own codebook: bit for bit.
    rcb = PPQ.PQCodebook(_t(cb.codebooks))
    codes = PPQ.encode_pq(rcb, torch.from_numpy(x), impl=impl)
    want = RPQ.encode_pq(cb, jnp.asarray(x))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(PPQ.decode_pq(rcb, codes).numpy(),
                                  np.asarray(RPQ.decode_pq(cb, want)))


def test_build_pq_matches_reference_and_generator_start_is_deterministic():
    x = clustered_vectors(300, 16, n_clusters=6, seed=4)
    cb, codes = RPQ.build_pq(x, 4, nbits=4, iters=3, seed=5, distance="neg_dot")
    pcb, pcodes = PPQ.build_pq(torch.from_numpy(x), 4, nbits=4, iters=3,
                               init_perms=_perms(5, 300, 4), distance="neg_dot")
    np.testing.assert_allclose(pcb.codebooks.numpy(), np.asarray(cb.codebooks), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pcodes.codes.numpy(), np.asarray(codes.codes))
    np.testing.assert_allclose(pcodes.hy.numpy(), np.asarray(codes.hy), **TOL)
    a = PPQ.build_pq(torch.from_numpy(x), 4, nbits=4, iters=3,
                     generator=torch.Generator().manual_seed(3))
    b = PPQ.build_pq(torch.from_numpy(x), 4, nbits=4, iters=3,
                     generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0].codebooks, b[0].codebooks) and torch.equal(a[1].codes, b[1].codes)


@pytest.mark.parametrize("residual", [True, False])
def test_build_ivfpq_matches_reference_block_by_block(trained, residual, monkeypatch):
    """Codes of every packed slot, pad slots included, equal the reference's,
    whether the slots go through in one block or in blocks of 64 rows."""
    x, pivf = trained["x"], trained["pivf"]
    cb, codes = trained[residual][:2]
    outs = []
    for block in (None, 64 * 16):
        if block:
            monkeypatch.setattr(PPQ, "_ENCODE_BLOCK", block)
        outs.append(PPQ.build_ivfpq(torch.from_numpy(x), pivf, 4, nbits=4, iters=4,
                                    init_perms=_perms(2, 700, 4), residual=residual))
    for pcb, pcodes in outs:
        np.testing.assert_allclose(pcb.codebooks.numpy(), np.asarray(cb.codebooks),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(pcodes.codes.numpy(), np.asarray(codes.codes))
        np.testing.assert_allclose(pcodes.hy.numpy(), np.asarray(codes.hy), **TOL)
    assert torch.equal(outs[0][1].codes, outs[1][1].codes)
    assert torch.equal(outs[0][1].hy, outs[1][1].hy)


def test_pq_arrays_round_trip_and_reject_what_the_reference_rejects(trained):
    cb, codes, pcb, pcodes = trained[True]
    np.testing.assert_array_equal(pcodes.codes.numpy(), np.asarray(codes.codes))
    arrays = PPQ.pq_to_arrays(pcb, pcodes)
    assert set(arrays) == {"codebooks", "codes", "hy"}
    for key in arrays:
        np.testing.assert_array_equal(arrays[key], np.asarray(RPQ.pq_to_arrays(cb, codes)[key]))
    cbs, cds = arrays["codebooks"], arrays["codes"]
    broken = [
        {k: v for k, v in arrays.items() if k != "hy"},
        dict(arrays, codebooks=cbs[0]),
        dict(arrays, codebooks=np.concatenate([cbs, cbs[:, :1]], 1)),  # 17 codes
        dict(arrays, codes=cds.astype(np.int32)),
        dict(arrays, codes=cds[:, :3]),
        dict(arrays, hy=arrays["hy"][:-1]),
        dict(arrays, codes=np.where(cds == cds.max(), 16, cds).astype(np.uint8)),
    ]
    for bad in broken:
        with pytest.raises(ValueError):
            RPQ.pq_from_arrays(bad)
        with pytest.raises(ValueError):
            PPQ.pq_from_arrays(bad, device="cpu")


def test_pq_from_arrays_runs_on_the_card_unless_asked_for_the_cpu(trained, monkeypatch):
    """The loader's default device is the card, as the index's: without one
    it raises rather than build the replica on the host."""
    arrays = RPQ.pq_to_arrays(*trained[True][:2])
    assert PPQ.pq_from_arrays(arrays, device="cpu")[1].codes.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        PPQ.pq_from_arrays(arrays)


@pytest.mark.parametrize("distance", ["sqeuclidean", "neg_dot", "neg_cosine"])
def test_luts_and_cell_bias_match_reference(trained, distance):
    cb, _, pcb, _ = trained[True]
    q = clustered_vectors(9, 16, n_clusters=8, seed=5)
    np.testing.assert_allclose(
        PPQ.build_pq_luts(pcb, torch.from_numpy(q), distance=distance).numpy(),
        np.asarray(RPQ.build_pq_luts(cb, jnp.asarray(q), distance=distance)), **TOL)
    cent = trained["ivf"].centroids
    np.testing.assert_allclose(
        PPQ.pq_cell_bias(torch.from_numpy(q), _t(cent), distance=distance).numpy(),
        np.asarray(RPQ.pq_cell_bias(jnp.asarray(q), cent, distance=distance)), **TOL)


def test_pq_geometry_is_validated():
    x = torch.from_numpy(clustered_vectors(300, 15, seed=2))
    with pytest.raises(ValueError):
        PPQ.train_pq(x, 4, nbits=4)  # 4 does not divide 15
    with pytest.raises(ValueError):
        PPQ.train_pq(torch.from_numpy(clustered_vectors(300, 16, seed=2)), 4, nbits=9)
    with pytest.raises(ValueError):
        PPQ.train_pq(torch.from_numpy(clustered_vectors(10, 16, seed=2)), 4, nbits=4)
    with pytest.raises(ValueError):
        PPQ.build_pq(torch.ones(300, 16) / 16, 4, distance="kl")


# ---------------------------------------------------------------------------
# The pq_scan kernel's function, quantized_scan's ADC branch, ivfpq_query
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("m,tile_m", [(13, 256), (40, 16)])
def test_pq_scan_matches_pallas(trained, residual, m, tile_m):
    """The union-per-tile rule at the reference's tile_m, with tombstones:
    values to rounding, ids tie-aware; no dead slot is returned."""
    ivf, pivf = trained["ivf"], trained["pivf"]
    cb, codes, pcb, pcodes = trained[residual]
    q = clustered_vectors(m, 16, n_clusters=8, seed=6)
    cells = np.array(RIVF.probe_cells(jnp.asarray(q), ivf.centroids, 3))
    live = np.arange(700) % 6 != 1
    want = rops.pq_scan(jnp.asarray(q), cb, codes, jnp.asarray(cells), 16,
                        cell_cap=ivf.cell_cap, tile_m=tile_m,
                        centroids=ivf.centroids if residual else None,
                        packed_live=RIVF.packed_live(ivf, jnp.asarray(live)))
    lp = PIVF.packed_live(pivf, torch.from_numpy(live))
    qt = torch.from_numpy(q)
    got = ops.pq_scan(qt, pcb, pcodes, torch.from_numpy(cells), 16, cell_cap=pivf.cell_cap,
                      tile_m=tile_m, centroids=pivf.centroids if residual else None,
                      packed_live=lp)
    _, luts, _, hx, hy, qc, _, _ = ops.pq_scan_operands(
        qt, pcb, pcodes, torch.from_numpy(cells), 16, cell_cap=pivf.cell_cap,
        centroids=pivf.centroids if residual else None, packed_live=lp)
    ref.check_topk(got.distances, got.indices.long(), _t(want.distances),
                   _t(want.indices).long(), n=pcodes.codes.shape[0],
                   dist=_adc_distance(luts, qc, hx, hy, pivf.cell_cap, pcodes.codes), **TOL)
    served = got.indices[got.indices >= 0].long()
    assert bool(lp[served].all())


def test_pq_scan_duplicates_extents_and_splits_keep_one_pass():
    """The plain version skips a repeated slot, stops each cell at its
    extent, and a list cut into ranges whose partial sets are merged equals
    one pass; empty cells come back as +inf / -1."""
    from repro_torch.kernels.merge_partials import merge_partials

    g = torch.Generator().manual_seed(0)
    ncells, cap, pq_m, ncodes, m = 10, 16, 4, 8, 9
    codes = torch.randint(0, ncodes, (ncells * cap, pq_m), generator=g, dtype=torch.uint8)
    luts = torch.randn(m, pq_m * ncodes, generator=g)
    hx, hy = torch.zeros(m, 1), torch.randn(1, ncells * cap, generator=g)
    qc = torch.randn(m, ncells, generator=g)
    extent = torch.tensor([16, 0, 5, 9, 16, 12, 1, 16, 3, 16], dtype=torch.int32)
    kw = dict(cell_cap=cap, ncodes=ncodes, tile_m=16, cell_extent=extent,
              distance_finalize="identity", qc=qc)
    probes = torch.tensor([[0, 2, 3, 5, 7, 8, 8, 8]], dtype=torch.int32)
    v, i = PQS.pq_scan(probes, luts, codes, hx, hy, 10, **kw)
    dv, di = PQS.pq_scan(torch.tensor([[0, 0, 2, 3, 3, 5, 7, 8]], dtype=torch.int32), luts,
                         codes, hx, hy, 10, **kw)
    assert torch.equal(dv, v) and torch.equal(di, i)
    past = torch.arange(ncells * cap) % cap >= extent.repeat_interleave(cap)
    assert not past[i[i >= 0].long()].any()
    parts = [PQS.pq_scan_partials(probes[:, a:b].contiguous(), luts, codes, hx, hy, 10, **kw)
             for a, b in ((0, 3), (3, 5), (5, 8))]
    mv, mi = merge_partials(torch.cat([p[0] for p in parts]).contiguous(),
                            torch.cat([p[1] for p in parts]).contiguous())
    assert torch.equal(mv, v) and torch.equal(mi, i)
    ev, ei = PQS.pq_scan(torch.ones((1, 2), dtype=torch.int32), luts, codes, hx, hy, 4, **kw)
    assert torch.isinf(ev).all() and (ei == -1).all()
    assert PQS.query_block(32 * 256) == 4 and PQS.query_block(4 * 16) == 8  # 128 KiB of tables
    with pytest.raises(ValueError, match="codes"):
        PQS.pq_scan(probes, luts, codes.int(), hx, hy, 10, **kw)
    with pytest.raises(ValueError, match="luts"):
        PQS.pq_scan(probes, luts[:, :-1].contiguous(), codes, hx, hy, 10, **kw)


# ---------------------------------------------------------------------------
# The pq_scan kernel's lookups (csrc/pq_scan.cu), as torch functions
# ---------------------------------------------------------------------------


def ring_sums(luts, codes, ncodes, cell_cap):
    """Ring mode's arithmetic, index for index: the tables staged by the
    load loop's decomposition of the flat index (transposed per block of 32
    subspaces to [code][32]); lane l = the slot's place in its unit of 32;
    each block's 8 code words read rotated by l // 4 words and funnel-shifted
    by l % 4 bytes, step t's code byte t of them and its subspace
    (l + t) mod 32; the sum over blocks, then steps, in that order."""
    m, L = luts.shape
    S, pq_m = codes.shape
    nblk, lg = pq_m // 32, ncodes.bit_length() - 1
    i = torch.arange(m * L)
    jj, rest = i & 31, i >> 5
    c, bq = rest & (ncodes - 1), rest >> lg
    blk, q = bq % nblk, bq // nblk
    smem = luts[q, (blk * 32 + jj) * ncodes + c].view(m, L)
    words = torch.from_numpy(codes.numpy().view("<u4").astype(np.int64))  # [S, pq_m / 4]
    lane = (torch.arange(S) % cell_cap) % 32
    a4, rot = 8 * (lane & 3), lane >> 2
    acc = torch.zeros(m, S)
    for b in range(nblk):
        w = [words[torch.arange(S), b * 8 + ((k + rot) & 7)] for k in range(8)]
        r8 = [(((w[(k + 1) & 7] << 32) | w[k]) >> a4) & 0xFFFFFFFF for k in range(8)]
        for t in range(32):
            code = (r8[t >> 2] >> (8 * (t & 3))) & 0xFF
            idx = (code << 5) | ((lane + t) & 31)
            acc = acc + smem[:, b * ncodes * 32 + idx]
    return acc


def generic_sums(luts, codes, ncodes, chunk):
    """Generic mode's: the tables as stored, in chunks of ``chunk``
    subspaces; the partial sums carried across chunks, subspaces in order."""
    m = luts.shape[0]
    S, pq_m = codes.shape
    acc = torch.zeros(m, S)
    for j0 in range(0, pq_m, chunk):
        lut = luts[:, j0 * ncodes : (j0 + min(chunk, pq_m - j0)) * ncodes]
        for j in range(min(chunk, pq_m - j0)):
            acc = acc + lut[:, j * ncodes + codes[:, j0 + j].long()]
    return acc


@pytest.mark.parametrize("pq_m,nbits", [(32, 8), (32, 4), (8, 8), (8, 4), (6, 8), (6, 4),
                                        (256, 8), (256, 4), (64, 8)])
def test_kernel_lookups_match_adc_and_pallas(pq_m, nbits):
    """The kernel's lookups in the mode ``plan`` gives (ring at pq_m 32;
    generic at 64, 8 and 6; generic at 256, in chunks at 8 bits: ROADMAP
    F2), held to rounding against ``adc_scores`` and, through a whole scan
    of every cell, against the reference's ``pq_scan_pallas`` in interpret
    mode: values to rounding, ids tie-aware."""
    ncodes, m, cap, ncells, k = 2 ** nbits, 8, 32, 6, 10
    g = np.random.default_rng(pq_m * 10 + nbits)
    luts = g.standard_normal((m, pq_m * ncodes)).astype(np.float32)
    codes = g.integers(0, ncodes, (ncells * cap, pq_m)).astype(np.uint8)
    hx = g.standard_normal((m, 1)).astype(np.float32)
    hy = g.standard_normal((1, ncells * cap)).astype(np.float32)
    hy[0, g.random(ncells * cap) < 0.2] = np.inf
    qc = g.standard_normal((m, ncells)).astype(np.float32)
    lt, ct = torch.from_numpy(luts), torch.from_numpy(codes)
    qb, ring, chunk = PQS.kernel_mode(pq_m, ncodes, 16)
    assert ring == (pq_m == 32)  # the rings of 16 warps at pq_m 64 pass the budget
    assert (chunk < pq_m) == (pq_m * ncodes * 4 > PQS.LUT_BUDGET)
    sums = ring_sums(lt, ct, ncodes, cap) if ring else generic_sums(lt, ct, ncodes, chunk)
    adc = PQS.adc_scores(lt.view(m, pq_m, ncodes), ct)
    torch.testing.assert_close(sums, adc, rtol=1e-5, atol=1e-4)
    scores = sums + torch.from_numpy(qc).repeat_interleave(cap, 1) + torch.from_numpy(hx) + \
        torch.from_numpy(hy)
    v, i = PQS.sorted_prefix(scores, 16)
    probes = np.arange(ncells, dtype=np.int32)[None, :]
    rv, ri = pq_scan_pallas(jnp.asarray(probes), jnp.asarray(luts), jnp.asarray(codes.T.copy()),
                            jnp.asarray(hx), jnp.asarray(hy), k, cell_cap=cap, ncodes=ncodes,
                            qc=jnp.asarray(qc), bm=m, interpret=True)
    qct = torch.from_numpy(qc)

    def dist(rows, cols):
        return adc[rows, cols] + qct[rows, cols // cap] + torch.from_numpy(hx)[rows, 0] + \
            torch.from_numpy(hy)[0, cols]

    ref.check_topk(v, i.long(), _t(rv), _t(ri).long(), n=ncells * cap, dist=dist, **TOL)


@pytest.mark.parametrize("residual", [True, False])
def test_quantized_scan_adc_matches_reference(trained, residual):
    ivf, pivf = trained["ivf"], trained["pivf"]
    cb, codes, pcb, pcodes = trained[residual]
    q = clustered_vectors(11, 16, n_clusters=8, seed=7)
    live = np.arange(ivf.packed.shape[0]) % 7 != 3
    cbias = RPQ.pq_cell_bias(jnp.asarray(q), ivf.centroids) if residual else None
    want = RK.quantized_scan(jnp.asarray(q), codes, 24, db_live=jnp.asarray(live),
                             pq_codebook=cb, cell_bias=cbias, cell_cap=ivf.cell_cap,
                             tile_n=256)
    pbias = PPQ.pq_cell_bias(torch.from_numpy(q), pivf.centroids) if residual else None
    got = PK.quantized_scan(torch.from_numpy(q), pcodes, 24, db_live=torch.from_numpy(live),
                            pq_codebook=pcb, cell_bias=pbias, cell_cap=pivf.cell_cap,
                            tile_n=256)
    luts = PPQ.build_pq_luts(pcb, torch.from_numpy(q)).reshape(11, -1)
    hx = (torch.from_numpy(q) ** 2).sum(1, keepdim=True)
    hy = torch.where(torch.from_numpy(live), pcodes.hy, float("inf"))[None, :]
    ref.check_topk(got.distances, got.indices.long(), _t(want.distances),
                   _t(want.indices).long(), n=pcodes.codes.shape[0],
                   dist=_adc_distance(luts, pbias, hx, hy, pivf.cell_cap, pcodes.codes), **TOL)


@pytest.mark.parametrize("impl,rimpl", [("fused", "fused"), ("torch", "jnp")])
@pytest.mark.parametrize("residual,nprobe", [(True, 3), (False, 2), (True, 8)])
def test_ivfpq_query_matches_reference(trained, impl, rimpl, residual, nprobe):
    x, ivf, pivf = trained["x"], trained["ivf"], trained["pivf"]
    cb, codes, pcb, pcodes = trained[residual]
    q = clustered_vectors(13, 16, n_clusters=8, seed=8)
    live = np.arange(700) % 5 != 0
    want = RK.ivfpq_query(jnp.asarray(q), jnp.asarray(x), ivf, cb, codes, 7, nprobe=nprobe,
                          impl=rimpl, db_live=jnp.asarray(live), residual=residual)
    got = PK.ivfpq_query(torch.from_numpy(q), torch.from_numpy(x), pivf, pcb, pcodes, 7,
                         nprobe=nprobe, impl=impl, db_live=torch.from_numpy(live),
                         residual=residual)
    ref.check_topk(got.distances, got.indices.long(), _t(want.distances),
                   _t(want.indices).long(), n=700, **TOL)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert not np.isin(got.indices.numpy(), np.flatnonzero(~live)).any()


@pytest.mark.parametrize("impl", ["torch", "fused"])
def test_ivfpq_exhaustive_overfetch_equals_knn_query(trained, impl):
    """The reference's hatch: nprobe = ncells and a fetch spanning the
    corpus make every row a candidate, so the exact rescore is knn_query."""
    x, pivf = trained["x"], trained["pivf"]
    _, _, pcb, pcodes = trained[True]
    xt = torch.from_numpy(x)
    qt = torch.from_numpy(clustered_vectors(11, 16, n_clusters=8, seed=9))
    live = torch.from_numpy(np.arange(700) % 4 != 2)
    exact = PK.knn_query(qt, xt, 9, db_live=live)
    # The kernel's fetch is capped at cell_cap, so its hatch is the plain path's.
    res = PK.ivfpq_query(qt, xt, pivf, pcb, pcodes, 9, nprobe=pivf.ncells, overfetch=700,
                         impl="torch", db_live=live)
    assert torch.equal(res.indices, exact.indices)
    torch.testing.assert_close(res.distances, exact.distances, **TOL)
    res = PK.ivfpq_query(qt, xt, pivf, pcb, pcodes, 9, nprobe=pivf.ncells,
                         overfetch=min(pivf.cell_cap, 256) // 16, impl=impl, db_live=live)
    assert not np.isin(res.indices.numpy(), np.flatnonzero(~live.numpy())).any()
    # An all-True filter bitmap is no filter.
    full = PK.ivfpq_query(qt, xt, pivf, pcb, pcodes, 3, impl=impl,
                          q_allowed=FK.pack_mask(torch.ones(11, 700, dtype=torch.bool)))
    assert torch.equal(full.indices, PK.ivfpq_query(qt, xt, pivf, pcb, pcodes, 3,
                                                    impl=impl).indices)


# ---------------------------------------------------------------------------
# The serving index: pq_m and pq_nbits
# ---------------------------------------------------------------------------


def _carry(refi, **kw):
    """The port index over the reference index's segments, cells and codes."""
    cb, codes = refi._dev["main_pq"]
    return RetrievalIndex.from_arrays(
        refi._main_vecs, refi._main_ids, refi._main_live, refi._delta_vecs, refi._delta_ids,
        refi._delta_live, refi._delta_n, distance=refi.distance,
        ivf=PIVF.ivf_from_arrays(PIVF.ivf_to_arrays(refi._dev["main_ivf"]), device="cpu"),
        pq=_carry_pq(cb, codes), overfetch=refi.overfetch, nprobe=refi.nprobe, **kw, **CPU)


@pytest.mark.parametrize("impl,rimpl", [("fused", "fused"), ("torch", "jnp")])
def test_index_over_reference_pq_answers_as_reference(impl, rimpl):
    """``from_arrays(pq=...)`` over the reference's trained cells and codes
    answers as the reference does, under upsert, delete and insert."""
    g = np.random.default_rng(5)
    d, n = 16, 512
    vecs = g.standard_normal((n, d)).astype(np.float32)
    q = g.standard_normal((11, d)).astype(np.float32)
    refi = RIndex.build(np.arange(n), vecs, ivf_cells=8, nprobe=3, pq_m=4, pq_nbits=4,
                        impl=rimpl, distance="neg_dot")
    refi.search(jnp.asarray(q), 8)  # trains the reference's cells and codes
    port = _carry(refi, impl=impl)
    assert port.pq_m == 4 and port.pq_nbits == 4 and port._use_pq()
    steps = [("upsert", (np.arange(20, 60), g.standard_normal((40, d)).astype(np.float32))),
             ("delete", (np.arange(100, 160),)),
             ("insert", (np.arange(900, 905), g.standard_normal((5, d)).astype(np.float32)))]
    for op, args in steps:
        getattr(refi, op)(*args)
        getattr(port, op)(*args)
        assert refi.shape_signature(8) == port.shape_signature(8)
        for k in (1, 8):
            r, p = refi.search(jnp.asarray(q), k), port.search(q, k)
            np.testing.assert_array_equal(p.ids.numpy(), np.asarray(r.ids))
            np.testing.assert_allclose(p.distances.numpy(), np.asarray(r.distances), **TOL)
    with pytest.raises(ValueError, match="cells"):
        RetrievalIndex.from_arrays(vecs, np.arange(n), np.ones(n, bool), vecs[:0],
                                   np.zeros(0, np.int32), np.zeros(0, bool), 0,
                                   pq=port._dev["main_pq"], **CPU)


def test_index_pq_validation_and_small_main_falls_back_to_ivf():
    for kw in (dict(pq_m=4), dict(ivf_cells=8, pq_m=5), dict(ivf_cells=8, pq_m=4, pq_nbits=9)):
        with pytest.raises(ValueError):
            RetrievalIndex(16, **kw, **CPU)
        with pytest.raises(ValueError):
            RIndex(16, **kw)
    g = np.random.default_rng(10)
    vecs = g.standard_normal((100, 8)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(100), vecs, ivf_cells=8, nprobe=10 ** 6, pq_m=4,
                               **CPU)
    assert not idx._use_pq() and idx._use_ivf()
    flat = RetrievalIndex.build(np.arange(100), vecs, **CPU)
    q = g.standard_normal((5, 8)).astype(np.float32)
    assert torch.equal(idx.search(q, 6).ids, flat.search(q, 6).ids)
    assert "main_pq" not in idx._dev


def _recall(got, want):
    return float((got[:, :, None] == want[:, None, :]).any(2).float().mean())


@pytest.mark.parametrize("impl", ["fused", "torch"])
def test_index_ivfpq_churn_recall_epoch_policy_and_no_resurrected_ids(impl):
    """The reference's floor (0.9, ``tests/test_pq.py``) under upsert,
    delete and compact; a delete keeps the codes, a compact retrains them."""
    d, k, n = 16, 8, 1024
    vecs = clustered_vectors(n, d, n_clusters=16, seed=11)
    q = clustered_vectors(12, d, n_clusters=16, seed=12)
    idx = RetrievalIndex.build(np.arange(n), vecs, ivf_cells=16, nprobe=6, pq_m=4,
                               impl=impl, **CPU)
    flat = RetrievalIndex.build(np.arange(n), vecs, **CPU)
    idx.search(q, k)
    pq = idx._dev["main_pq"]
    assert "main_ivf_q" not in idx._dev  # the PQ replica replaces the scan replica
    deleted = np.arange(0, n, 9)
    fresh = clustered_vectors(40, d, n_clusters=16, seed=13)
    for i in (idx, flat):
        i.delete(deleted)
        i.upsert(np.arange(2000, 2040), fresh)
    r, e = idx.search(q, k), flat.search(q, k)
    assert idx._dev["main_pq"] is pq  # a mask flip, the same codes
    assert _recall(r.ids, e.ids) >= 0.9
    assert not np.isin(r.ids.numpy(), deleted).any()
    for i in (idx, flat):
        i.compact()
    r, e = idx.search(q, k), flat.search(q, k)
    assert idx._dev["main_pq"] is not pq  # epoch bump: retrain and re-encode
    assert _recall(r.ids, e.ids) >= 0.9
    assert not np.isin(r.ids.numpy(), deleted).any()


@pytest.mark.parametrize("kw", [dict(pq_m=8), dict(pq_m=16, ncells=64, nprobe=8),
                                dict(pq_m=32, ncells=4096, nprobe=8, overfetch=8),
                                dict(pq_m=4, pq_nbits=4, k=100)])
def test_scan_bytes_model_pq_matches_reference(kw):
    for n, d in ((8192, 64), (1 << 20, 256)):
        want = raccounting.scan_bytes_per_query(n, d, **kw)
        assert accounting.scan_bytes_per_query(n, d, **kw) == want, kw
