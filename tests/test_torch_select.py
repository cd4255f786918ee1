"""The selection kernels' host-side plans and networks, on the CPU.

* ``ivf_scan``'s tile table (``kernels/ivf_scan.py::tile_table``) and its
  split across CTAs (``split_bounds``): the table the card walks covers
  exactly the slots the reference's scan takes, and each split's share.
* ``merge_partials``'s merge tree (``csrc/merge_partials.cu``), written
  here as a torch function of the same network, against the plain merge
  (``merge_partials_plain``) and the JAX package's bitonic tree merge.
* The staged bulk-merge selection of ``stream_topk``, ``pq_scan`` and
  ``rescore`` (``csrc/select.cuh``), written here as a torch function of
  the same network as ``csrc/stream_topk.cu`` drives it, against the plain
  version and the JAX package's bitonic merge.
* The scan kernel's wide selection (``csrc/fused_knn.cuh`` at K > 256): the
  same staging, flushed by one warp into a row of device memory
  (``warp_sort_keys``, ``warp_merge_into_row``), modelled in numpy down to
  its index arithmetic, against the plain version.
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


# ---------------------------------------------------------------------------
# The staged bulk-merge selection of stream_topk and pq_scan.
# ---------------------------------------------------------------------------

EMPTY_KEY = np.uint64(0xFF8000007FFFFFFF)  # select.cuh kEmptyKey: (+inf, -1)
PAD_KEY = np.uint64(2 ** 64 - 1)  # kPadKey
TRIM_MIN, TRIM_STOP = 256, 64  # kTrimMin, kTrimStop


def staged_key(v, c):
    """select.cuh ``staged_key`` in numpy: -0.0 folded into +0.0, the
    float's bits made monotone in the high word, the column's with its sign
    bit flipped in the low word."""
    u = (np.asarray(v, np.float32) + np.float32(0.0)).view(np.uint32).astype(np.uint64)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    lo = (np.asarray(c, np.int32).view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def staged_decode(k):
    """select.cuh ``staged_value`` and ``staged_id``."""
    hi = (k >> np.uint64(32)).astype(np.uint32)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi)
    return u.astype(np.uint32).view(np.float32), (k.astype(np.uint32) ^ np.uint32(
        0x80000000)).view(np.int32)


def _cx(k, lo, hi):
    """Compare-exchange of slots lo, hi (index arrays): the smaller to lo."""
    x, y = k[lo].copy(), k[hi].copy()
    k[lo], k[hi] = np.minimum(x, y), np.maximum(x, y)


def staged_trim(bk, staged, K):
    """select.cuh ``staged_trim``: the bound, found MSB first 8 bits a pass
    from the byte where the smallest and largest key first differ, of the
    bin that holds the K-th smallest of buffer and staging, narrowed until
    it holds at most kTrimStop keys; the staged keys at or below it."""
    keys = np.concatenate([bk, staged])
    diff = int(keys.min()) ^ int(keys.max())
    top = 0 if diff == 0 else (diff.bit_length() - 1) // 8 * 8
    span = (1 << (top + 8)) - 1
    lo = np.uint64(int(keys.min()) & ~span & (2 ** 64 - 1))
    bound, below = np.uint64(int(lo) + span), 0
    for shift in range(top, -8, -8):
        s = np.uint64(shift)
        live = keys[(keys >= lo) & (keys <= bound)]
        hist = np.bincount(((live >> s) & np.uint64(255)).astype(np.int64), minlength=256)
        run = below + np.cumsum(hist)
        b = int(np.argmax(run >= K))
        below, count = int(run[b] - hist[b]), int(hist[b])
        lo = lo + (np.uint64(b) << s)
        bound = lo + ((np.uint64(1) << s) - np.uint64(1))
        if count <= TRIM_STOP or shift == 0:
            break
    return staged[staged <= bound]


def staged_flush(bk, staged, K):
    """select.cuh ``staged_flush`` on one list: a trim past kTrimMin staged
    keys, the staged keys padded to P = next_pow2(n) with kPadKey and
    bitonic-sorted, then merged into the ascending buffer by the minimum of
    buffer[j] and staged[K - 1 - j] and log2 K half-cleaner stages."""
    if len(staged) > TRIM_MIN:
        staged = staged_trim(bk, staged, K)
    n = len(staged)
    P = T.next_pow2(max(n, 1))
    k = np.concatenate([staged, np.full(P - n, PAD_KEY, np.uint64)])
    w = np.arange(P // 2)
    size = 2
    while size <= P:
        stride = size // 2
        while stride:
            a = ((w & ~(stride - 1)) << 1) | (w & (stride - 1))
            up = (a & size) == 0
            _cx(k, np.where(up, a, a + stride), np.where(up, a + stride, a))
            stride //= 2
        size *= 2
    j = np.arange(K)
    b = K - 1 - j
    ok = b < P
    bk[j[ok]] = np.minimum(bk[j[ok]], k[b[ok]])
    dist, w = K // 2, np.arange(K // 2)
    while dist:
        a = ((w & ~(dist - 1)) << 1) | (w & (dist - 1))
        _cx(bk, a, a + dist)
        dist //= 2


def staged_select(x, K, *, skip=True, stage=1024, floor=2048, seed=0):
    """csrc/stream_topk.cu's selection of each row of ``x``: stages of
    ``stage`` columns; a column whose key beats the K-th entry as of the
    last flush (all of them without the skip) is appended, in a shuffled
    order (the order the atomics give is any); a flush when the staged count
    exceeds cap - stage, and at the end."""
    m, n = x.shape
    cap = min(ST.MAX_SELECT_K, max(floor, 2 * K))
    g = np.random.default_rng(seed)
    out_v = torch.full((m, K), T.POS_INF)
    out_i = torch.full((m, K), -1, dtype=torch.int32)
    for r in range(m):
        keys = staged_key(x[r].numpy(), np.arange(n, dtype=np.int32))
        bk = np.full(K, EMPTY_KEY, np.uint64)
        staged, kth = [], EMPTY_KEY
        for c0 in range(0, n, stage):
            kk = keys[c0 : c0 + stage]
            staged.append(g.permutation(kk if not skip else kk[kk < kth]))
            assert sum(map(len, staged)) <= cap
            if sum(map(len, staged)) > cap - stage:
                staged_flush(bk, np.concatenate(staged), K)
                staged, kth = [], bk[K - 1]
        if sum(map(len, staged)):
            staged_flush(bk, np.concatenate(staged), K)
        v, i = staged_decode(bk)
        out_v[r], out_i[r] = torch.from_numpy(v.copy()), torch.from_numpy(i.copy())
    return out_v, out_i


def _tied_rows(m, n, seed, levels=50):
    """Rows of few integer values (many exact ties), some +inf, one row all
    +inf."""
    g = np.random.default_rng(seed)
    x = g.integers(0, levels, (m, n)).astype(np.float32)
    x[g.random((m, n)) < 0.02] = np.inf
    x[m - 1] = np.inf
    return torch.from_numpy(x)


@pytest.mark.parametrize("K", [2 ** e for e in range(13)])
@pytest.mark.parametrize("skip", [True, False])
def test_staged_network_equals_the_plain_selection(K, skip):
    """K from 1 to the cap, ties, +inf entries and an all-+inf row: the
    staged network with a stale threshold and shuffled appends gives the
    plain version's K smallest by (value, column), exactly."""
    x = _tied_rows(3, 3 * K + 1500, K)
    pv, pi = ST.stream_topk_plain(x, K)
    sv, si = staged_select(x, K, skip=skip, seed=K)
    assert torch.equal(sv, pv) and torch.equal(si, pi)
    assert (si[2] == -1).all() and torch.isinf(sv[2]).all()


@pytest.mark.parametrize("K,stage,floor", [(16, 64, 128), (256, 128, 256), (4, 32, 64)])
def test_staged_network_with_frequent_flushes(K, stage, floor):
    """Small stages and staging areas force a flush every few stages (the
    threshold stale across many of them): the same sets."""
    x = _tied_rows(4, 5000, K + stage, levels=20)
    pv, pi = ST.stream_topk_plain(x, K)
    sv, si = staged_select(x, K, stage=stage, floor=floor, seed=1)
    assert torch.equal(sv, pv) and torch.equal(si, pi)


@pytest.mark.parametrize("K", [1, 8, 64, 512, 4096])
def test_staged_merge_matches_the_reference_bitonic_merge(K):
    """The flush's merge of a sorted staging list into the buffer against
    the JAX package's ``merge_topk_sorted`` where no values tie (at exact
    ties its network may keep another column, ROADMAP "Exact ties")."""
    g = np.random.default_rng(K)
    a = np.sort(g.standard_normal(K).astype(np.float32))
    b = np.sort(g.standard_normal(K).astype(np.float32))
    ai = np.sort(g.choice(10 * K, K, replace=False)).astype(np.int32)
    bi = np.sort(g.choice(10 * K, K, replace=False) + 10 * K).astype(np.int32)
    bk = staged_key(a, ai)
    perm = g.permutation(K)  # staged in any order
    staged_flush(bk, staged_key(b, bi)[perm], K)
    bv, bidx = staged_decode(bk)
    rv, ri = RT.merge_topk_sorted(jnp.asarray(a), jnp.asarray(ai), jnp.asarray(b), jnp.asarray(bi))
    np.testing.assert_array_equal(bv, np.asarray(rv))
    np.testing.assert_array_equal(bidx, np.asarray(ri))


@pytest.mark.parametrize("m,n,K,resident,want", [
    (8, 160_000, 128, 660, (20, 8192)), (1024, 160_000, 4096, 264, (1, 163_840)),
    (8192, 160_000, 128, 660, (1, 163_840)), (3, 50_003, 4096, 264, (7, 8192)),
    (1, 5, 1, 660, (1, 8192))])
def test_stream_topk_splits_columns_only_when_rows_cannot_fill_the_card(m, n, K, resident,
                                                                        want):
    """Each split a whole number of stages, at least max(8 stages, 2 K)
    columns; no split once the rows fill the card's resident CTAs."""
    splits, per = ST.split_columns(m, n, K, resident)
    assert (splits, per) == want
    assert per % ST.STAGE_COLS == 0 and (splits - 1) * per < n <= splits * per



def test_staged_keys_order_as_value_then_column():
    """Sorting by the 64-bit key is the (value, column) order of the plain
    version, with ties, -0.0 beside +0.0, +-inf, the empty slot (+inf, -1)
    after every finite entry and before (+inf, c >= 0), and the pad last;
    a key decodes to its entry (-0.0 as +0.0, which compares equal)."""
    g = np.random.default_rng(0)
    v = np.concatenate([g.integers(-3, 4, 400).astype(np.float32) / 2,
                        [0.0, -0.0, np.inf, -np.inf, np.inf, 1e-38, -1e-38, 3.4e38]]).astype(
        np.float32)
    c = g.permutation(len(v)).astype(np.int32)
    c[-4] = -1  # one empty slot among the +inf entries
    keys = staged_key(v, c)
    order = np.argsort(keys, kind="stable")
    want = sorted(range(len(v)), key=lambda j: (float(v[j]), int(c[j])))
    assert order.tolist() == want
    dv, di = staged_decode(keys)
    assert np.array_equal(dv, v) and np.array_equal(di, c)  # -0.0 == 0.0 in the compare
    assert int(staged_key(np.inf, -1)) == 0xFF8000007FFFFFFF  # kEmptyKey
    assert int(staged_key(np.inf, 2 ** 31 - 1)) < 2 ** 64 - 1  # below kPadKey


# ---------------------------------------------------------------------------
# The wide scan's flush into a row of device memory (select.cuh
# warp_sort_keys, warp_merge_into_row), as fused_knn.cuh drives it.
# ---------------------------------------------------------------------------

MERGE_RUN = 8  # select.cuh kMergeRun: consecutive entries a lane holds


def warp_sort_keys(k, n):
    """``warp_sort_keys`` on k[:n] in place: a bitonic network over P =
    next_pow2(n) slots, every compare-exchange ascending (the first step of
    each merge mirrored); one that reaches a slot at or past n is skipped,
    as if a pad above every key stood there."""
    P = T.next_pow2(max(n, 1))
    w = np.arange(P // 2)
    size = 2
    while size <= P:
        o = w & (size // 2 - 1)
        base = (w - o) << 1
        a, b = base + o, base + size - 1 - o
        ok = b < n
        _cx(k, a[ok], b[ok])
        stride = size // 4
        while stride:
            a = ((w & ~(stride - 1)) << 1) | (w & (stride - 1))
            ok = a + stride < n
            _cx(k, a[ok], a[ok] + stride)
            stride //= 2
        size *= 2


def warp_merge_into_row(row, K, fill, s):
    """``warp_merge_into_row``: the ascending staged keys ``s`` merged into
    ``row`` (K keys, the first ``fill`` real), top-down 256 entries at a
    time, lane l holding entries g0 + 8 l .. + 7 (the next group read before
    this one is written); entry j moves to j + its rank among the staged
    keys, staged key t to t + g0 + 8 L + (lane L's entries of rank <= t), L
    the last lane whose first entry's rank is <= t.  Asserts that no place
    is read after this flush wrote it and that no place is written twice.
    Returns the key written at K - 1, or None."""
    n = len(s)
    group = 32 * MERGE_RUN
    written, kth = set(), None
    carry = n
    g0 = -(-fill // MERGE_RUN) * MERGE_RUN - group
    while True:
        j = g0 + np.arange(group)  # lane l: j[8 l : 8 l + 8]
        real = (j >= 0) & (j < fill)
        assert not written & set(j[j >= 0].tolist()), "read after write"
        a = np.where(real, row[np.clip(j, 0, K - 1)], np.where(j < 0, np.uint64(0), EMPTY_KEY))
        r = np.searchsorted(s, a, side="left")  # staged keys below each entry
        for jj, rr, aa, ok in zip(j, r, a, real):
            to = jj + rr
            if ok and rr > 0 and to < K:
                assert to not in written
                written.add(int(to))
                row[to] = aa
                kth = aa if to == K - 1 else kth
        lane_r = r.reshape(32, MERGE_RUN)
        first = int(lane_r[0, 0])
        for t in range(first, carry):
            L = int(np.searchsorted(lane_r[:, 0], t, side="right")) - 1
            to = t + g0 + MERGE_RUN * L + int((lane_r[L] <= t).sum())
            if to < K:
                assert to not in written
                written.add(int(to))
                row[to] = s[t]
                kth = s[t] if to == K - 1 else kth
        carry = first
        if carry == 0:
            return kth
        g0 -= group


def wide_select(x, K, *, skip=True, cap=160, allowed=None, seed=0):
    """csrc/fused_knn.cuh's wide selection of each row of ``x``, a batch of
    32 columns at a time: a column that is allowed and beats the row's K-th
    key as of its last flush (the empty key until K have entered; without
    the skip, any finite value) is appended in a shuffled order; a row whose
    staging area cannot take a batch's keys is flushed (sort, merge) and the
    batch held against the new K-th; every row with staged keys is flushed
    at the end, and the places past the row's fill end empty."""
    m, n = x.shape
    g = np.random.default_rng(seed)
    out_v = torch.full((m, K), T.POS_INF)
    out_i = torch.full((m, K), -1, dtype=torch.int32)
    for r in range(m):
        keys = staged_key(x[r].numpy(), np.arange(n, dtype=np.int32))
        ok = np.ones(n, bool) if allowed is None else allowed[r]
        row = np.full(K, 0xDEAD, np.uint64)  # not written until the walk ends: any bits
        kth, fill, staged = EMPTY_KEY, 0, np.zeros(0, np.uint64)

        def flush():
            nonlocal kth, fill, staged
            st = staged.copy()
            warp_sort_keys(st, len(st))
            assert np.array_equal(st, np.sort(staged))
            got = warp_merge_into_row(row, K, fill, st)
            kth = got if got is not None else kth
            fill = min(K, fill + len(st))
            staged = np.zeros(0, np.uint64)

        for c0 in range(0, n, 32):
            kk, good = keys[c0 : c0 + 32], ok[c0 : c0 + 32]
            want = good & (kk < (kth if skip else EMPTY_KEY))
            if len(staged) + want.sum() > cap:
                flush()
                want = good & (kk < (kth if skip else EMPTY_KEY))
            staged = np.concatenate([staged, g.permutation(kk[want])])
        if len(staged):
            flush()
        row[fill:] = EMPTY_KEY
        v, i = staged_decode(row)
        out_v[r], out_i[r] = torch.from_numpy(v.copy()), torch.from_numpy(i.copy())
    return out_v, out_i


def _wide_rows(m, n, K, seed):
    """Tied rows (+inf entries, an all-+inf row), one of them descending so
    that every column enters and every tile flushes; and an allow-mask that
    leaves one row fewer than K columns and excludes some everywhere."""
    x = _tied_rows(m, n, seed, levels=40)
    x[0] = torch.arange(n, 0, -1, dtype=torch.float32)
    g = np.random.default_rng(seed + 1)
    allowed = g.random((m, n)) < 0.9
    allowed[1] = False
    allowed[1, g.choice(n, K // 3, replace=False)] = True
    return x, allowed


@pytest.mark.parametrize("K", [512, 1024, 2048, 4096])
@pytest.mark.parametrize("skip", [True, False])
def test_wide_flush_into_device_rows_equals_the_plain_selection(K, skip):
    """The warp's sort and top-down rank merge, at every wide K, with ties,
    +inf entries, an all-+inf row, a descending row, excluded columns and a
    row allowed fewer than K columns: exactly the plain version's K
    smallest by (value, column), (+inf, -1) in the slots left empty."""
    n = 3 * K + 700
    x, allowed = _wide_rows(4, n, K, K)
    masked = torch.where(torch.from_numpy(allowed), x, T.POS_INF)
    pv, pi = ST.stream_topk_plain(masked, K)
    sv, si = wide_select(x, K, skip=skip, allowed=allowed, seed=K)
    assert torch.equal(sv, pv) and torch.equal(si, pi)
    assert (si[1, K // 3 :] == -1).all() and (si[3] == -1).all()


@pytest.mark.parametrize("K,cap", [(512, 32), (1024, 63), (4096, 208)])
def test_wide_flush_with_frequent_flushes(K, cap):
    """Staging areas that hold one or two batches flush every batch or two
    (the threshold stale across none of them): the same sets."""
    x, allowed = _wide_rows(3, 2 * K + 333, K, K + cap)
    masked = torch.where(torch.from_numpy(allowed), x, T.POS_INF)
    pv, pi = ST.stream_topk_plain(masked, K)
    sv, si = wide_select(x, K, cap=cap, allowed=allowed, seed=cap)
    assert torch.equal(sv, pv) and torch.equal(si, pi)


@pytest.mark.parametrize("n", [1, 2, 5, 31, 33, 100, 160, 208, 256])
def test_warp_sort_with_pads_that_take_no_room(n):
    """The ascending network over next_pow2(n) slots, the ones past n
    skipped: any n sorts."""
    k = staged_key(np.random.default_rng(n).integers(0, 9, n).astype(np.float32),
                   np.random.default_rng(n + 1).permutation(n).astype(np.int32))
    want = np.sort(k)
    warp_sort_keys(k, n)
    assert np.array_equal(k, want)
