"""The selection kernels' host-side plans and networks, on the CPU.

* ``ivf_scan``'s tile table (``kernels/ivf_scan.py::tile_table``) and its
  split across CTAs (``split_bounds``): the table the card walks covers
  exactly the slots the reference's scan takes, and each split's share.
* ``merge_partials``'s merge tree (``csrc/merge_partials.cu``), written
  here as a torch function of the same network, against the plain merge
  (``merge_partials_plain``) and the JAX package's bitonic tree merge.
* The card's cap on K, shared by the six selection kernels.

Integer outputs and selected values are compared exactly: the network only
moves entries.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as RT
from repro_torch.core import topk as T
from repro_torch.core.ivf import tile_probe_lists
from repro_torch.kernels import ivf_scan as IVS
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import stream_topk as ST

# ---------------------------------------------------------------------------
# The tile table of ivf_scan.
# ---------------------------------------------------------------------------


def _probe_case(seed, nt, width, ncells, cap):
    """Union probe lists of random queries (ascending, duplicate padding)
    and random extents, some cells empty, some whole."""
    g = np.random.default_rng(seed)
    cells = torch.from_numpy(g.integers(0, ncells, (nt * 4, width)).astype(np.int32))
    probes = tile_probe_lists(cells, ncells, 4)
    ext = g.integers(0, cap + 1, ncells)
    ext[g.random(ncells) < 0.2] = 0
    ext[g.random(ncells) < 0.2] = cap
    return probes, torch.from_numpy(ext.astype(np.int32))


@pytest.mark.parametrize("cap", [32, 96, 128, 200, 512])
@pytest.mark.parametrize("seed", [0, 1])
def test_tile_table_covers_each_union_exactly(cap, seed):
    """Each union tile's entries, each cut at its hi, cover exactly the
    first ``cell_extent[c]`` slots of every distinct cell of its list (the
    slots ``ivf_scan_plain`` scores), in ascending slot order; every hi is
    its cell's end and every entry starts a 128-column tile of its cell."""
    ncells = 40
    probes, ext = _probe_case(seed, 6, 5, ncells, cap)
    table, counts = IVS.tile_table(probes, ext, cap)
    assert table.dtype == torch.int32 and counts.dtype == torch.int32
    assert table.shape == (probes.shape[0], max(1, int(counts.max())), 2)
    for t in range(probes.shape[0]):
        cells = torch.unique_consecutive(probes[t]).tolist()
        want = [c * cap + j for c in cells for j in range(int(ext[c]))]
        entries = table[t, : int(counts[t])].tolist()
        assert len(entries) == sum(-(-int(ext[c]) // 128) for c in cells)
        got = []
        for col0, hi in entries:
            cell = col0 // cap
            assert hi == cell * cap + int(ext[cell]), (col0, hi)
            assert (col0 - cell * cap) % 128 == 0 and col0 < hi
            got.extend(range(col0, min(col0 + 128, hi)))
        assert got == want  # ascending, each slot once, duplicates skipped
        assert (table[t, int(counts[t]):] == 0).all()


def test_tile_table_skips_padding_empty_cells_and_non_cells():
    """A slot repeating its predecessor, a cell of extent 0 and a slot
    naming no cell add no entry; a list of nothing gives a table of one
    dead entry, so the card always gets a row to point at."""
    ext = torch.tensor([300, 0, 129, 5], dtype=torch.int32)
    probes = torch.tensor([[0, 0, 1, 2, 2], [-1, 1, 3, 3, 7], [1, 1, 1, 1, 1]],
                          dtype=torch.int32)
    table, counts = IVS.tile_table(probes, ext, 300)
    assert counts.tolist() == [5, 1, 0]
    assert table[0, :5].tolist() == [[0, 300], [128, 300], [256, 300], [600, 729], [728, 729]]
    assert table[1, 0].tolist() == [900, 905]
    empty, n0 = IVS.tile_table(torch.ones((2, 3), dtype=torch.int32), ext, 300)
    assert n0.tolist() == [0, 0] and empty.shape == (2, 1, 2)


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_split_bounds_cover_the_table_once_and_balance(splits):
    counts = torch.tensor([0, 1, 5, 64, 100, 7], dtype=torch.int32)
    b = IVS.split_bounds(counts, splits)
    assert b.dtype == torch.int32 and b.shape == (6, splits + 1)
    assert (b[:, 0] == 0).all() and torch.equal(b[:, -1], counts)
    size = b[:, 1:] - b[:, :-1]
    assert (size >= 0).all()
    assert ((size.max(1).values - size.min(1).values) <= 1).all()


def test_build_table_on_the_cpu_is_the_plain_table_and_bounds():
    """The wrapper the card launches: a CPU tensor gets tile_table's rows
    and split_bounds' ranges, and launches nothing."""
    probes, ext = _probe_case(3, 5, 4, 30, 200)
    before = IVS.TABLE_LAUNCHES
    table, bounds = IVS.build_table(probes, ext, 200, 6)
    want, counts = IVS.tile_table(probes, ext, 200)
    assert torch.equal(table, want) and torch.equal(bounds, IVS.split_bounds(counts, 6))
    assert IVS.TABLE_LAUNCHES == before


# ---------------------------------------------------------------------------
# The merge tree of merge_partials.
# ---------------------------------------------------------------------------


def _lex_less(av, ai, bv, bi):
    return (av < bv) | ((av == bv) & (ai < bi))


def _tree(v, i, n, K):
    """csrc/merge_partials.cu merge_tree on rows of n lists of K entries
    (list l ascending for even l, descending for odd l): list 0, ascending."""
    span = K
    while span < n * K:
        pairs = n * K // (2 * span)
        for q in range(pairs):  # the minimum of A[j] and B[j], B descending
            a = q * 2 * span + torch.arange(K)
            b = a + span
            take = _lex_less(v[:, b], i[:, b], v[:, a], i[:, a])
            v[:, a] = torch.where(take, v[:, b], v[:, a])
            i[:, a] = torch.where(take, i[:, b], i[:, a])
        dist = K // 2
        while dist:  # the clean-up, merged list q ascending for even q
            w = torch.arange(K // 2)
            for q in range(pairs):
                a = q * 2 * span + (((w & ~(dist - 1)) << 1) | (w & (dist - 1)))
                b = a + dist
                va, ia, vb, ib = v[:, a], i[:, a], v[:, b], i[:, b]
                swap = _lex_less(vb, ib, va, ia) if q % 2 == 0 else _lex_less(va, ia, vb, ib)
                v[:, a], v[:, b] = torch.where(swap, vb, va), torch.where(swap, va, vb)
                i[:, a], i[:, b] = torch.where(swap, ib, ia), torch.where(swap, ia, ib)
            dist //= 2
        span *= 2


def network_merge(part_v, part_i, group=None):
    """The merge kernel's network: the S lists padded to a power of 2 with
    empty ones, odd slots reversed, merged pairwise; with ``group``, groups
    of that many lists, slot 0 of each later group holding the running
    result (the CTA path)."""
    S, m, K = part_v.shape
    n = T.next_pow2(S)
    P = n if group is None else min(n, group)
    v = torch.full((m, P * K), T.POS_INF)
    i = torch.full((m, P * K), -1, dtype=torch.int32)

    def load(s0, first):
        for slot in range(first, P):
            s = s0 + slot
            lv = part_v[s] if s < S else torch.full((m, K), T.POS_INF)
            li = part_i[s] if s < S else torch.full((m, K), -1, dtype=torch.int32)
            if slot % 2:
                lv, li = lv.flip(1), li.flip(1)
            v[:, slot * K : (slot + 1) * K], i[:, slot * K : (slot + 1) * K] = lv, li

    load(0, 0)
    _tree(v, i, P, K)
    s0 = P
    while s0 < S:
        load(s0 - 1, 1)
        _tree(v, i, P, K)
        s0 += P - 1
    out_v = v[:, :K]
    return out_v, torch.where(out_v < T.POS_INF, i[:, :K], -1)


def _partials(S, m, K, seed, ties=True):
    """[S, m, K] ascending partial sets over disjoint ascending column
    ranges, values drawn from few integers (many exact ties) or normal, a
    quarter of the upper half +inf/-1."""
    g = np.random.default_rng(seed)
    v = (g.integers(0, 12, (S, m, K)) if ties else g.standard_normal((S, m, K))).astype(
        np.float32)
    v[:, :, K // 2 :][g.random((S, m, K - K // 2)) < 0.25] = np.inf
    v.sort(axis=2)
    i = np.empty((S, m, K), np.int32)
    for s in range(S):
        for r in range(m):
            i[s, r] = s * 4 * K + np.sort(g.choice(4 * K, K, replace=False))
    i[np.isinf(v)] = -1
    return torch.from_numpy(v), torch.from_numpy(i)


@pytest.mark.parametrize("S", [1, 2, 3, 16, 33])
@pytest.mark.parametrize("K", [1, 2, 8, 16, 64])
def test_merge_network_equals_the_plain_merge(S, K):
    """The kernel's merge order, with ties and empty slots, gives the plain
    version's K smallest by (value, column), lower splits first."""
    v, i = _partials(S, 5, K, S * 100 + K)
    pv, pi = MP.merge_partials_plain(v, i)
    nv, ni = network_merge(v, i)
    assert torch.equal(nv, pv) and torch.equal(ni, pi)


@pytest.mark.parametrize("S,K,group", [(9, 16, 4), (33, 4, 8), (5, 32, 2), (16, 8, 16)])
def test_merge_network_in_groups_equals_the_plain_merge(S, K, group):
    """The CTA path's chain of groups (K = 4096 merges four lists a group)
    gives the same set as one tree."""
    v, i = _partials(S, 4, K, S + K + group)
    pv, pi = MP.merge_partials_plain(v, i)
    nv, ni = network_merge(v, i, group=group)
    assert torch.equal(nv, pv) and torch.equal(ni, pi)


def test_merge_network_matches_the_reference_tree_merge():
    """Against the JAX package's bitonic tree merge where no values tie (at
    exact ties its network may keep another column, ROADMAP "Exact ties"):
    equal values, and equal ids where a value is finite."""
    v, i = _partials(6, 7, 16, 3, ties=False)
    rv, ri = RT.merge_many_sorted(jnp.asarray(v.numpy()), jnp.asarray(i.numpy()), 16)
    nv, ni = network_merge(v, i)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(rv))
    fin = np.isfinite(nv.numpy())
    np.testing.assert_array_equal(ni.numpy()[fin], np.asarray(ri)[fin])


def test_card_cap_is_4096_for_every_selection_kernel():
    """One cap on the card, named in the refusal; the narrow kernels'
    shared-memory buffer stays 256 (their switch to the wide copy)."""
    assert ST.MAX_SELECT_K == 4096 and ST.MAX_K == 256
    ST.require_card_k(4096, "stream_topk")
    with pytest.raises(ValueError, match="4096"):
        ST.require_card_k(8192, "pq_scan")
