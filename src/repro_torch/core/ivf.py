"""IVF coarse quantizer: cell-probed retrieval (DESIGN.md §IVF).

PyTorch port of ``repro/core/ivf.py``.  The corpus is partitioned into
``ncells`` Voronoi cells around k-means centroids; a query probes only the
``nprobe`` cells nearest it, and the survivors are rescored exactly.  The
scan kernel is ``kernels/ivf_scan.py``; the query pipeline is
``core.knn.ivf_query``.

* ``train_centroids``: Lloyd k-means (``core.kmeans.lloyd``) in ``gy``
  space, the geometry the scan scores in.
* ``pack_cells``: rows permuted so that each cell owns one contiguous block
  of ``cell_cap`` slots (a power of two, at least ``MIN_CELL_CAP``): the
  scan reads a cell by naming its block, so an unprobed cell costs no
  reads.  ``slot_of_row`` and ``row_of_slot`` carry the permutation both
  ways.  Numpy with a stable argsort, as the reference, so the packing is
  the reference's bit for bit.
* ``tile_probe_lists``: per tile of ``bm`` queries, the ascending union of
  their probed cells, padded by repeating the last one.  Every query of the
  tile scans the whole union, a superset of its own probes.  Probes outside
  the cell range (another shard's cells) are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import gy_rows
from repro_torch.kernels._backend import resolve_device

Tensor = torch.Tensor

# Minimum rows per cell block (the reference's TPU lane tile; here also a
# multiple of the scan's 128-column tile).
MIN_CELL_CAP = 128

# Copies between host memory and the card go a block of rows at a time, at
# most this many bytes, through a pinned staging buffer: CUDA runs copies
# from or to pageable memory one after the other, so one multi-GB
# copy (a snapshot's packed rows, in the lifecycle's background worker) held
# a serving batch's 1 MiB query upload for its whole length (2.0 s for
# 4 GiB), and pageable blocks still for about 44 ms a batch; through pinned
# blocks a batch takes its own time (src/repro_torch/lifecycle_probe.py,
# PERF.md).
_COPY_BYTES = 1 << 25


class IVFCells(NamedTuple):
    """A trained coarse quantizer and the cell-packed corpus, as tensors on
    one device.  ``ncells = centroids.shape[0]``, ``cell_cap =
    packed.shape[0] // ncells``.

    centroids:   [ncells, d] fp32 cell centres in ``gy`` space.
    packed:      [ncells * cell_cap, d] fp32 corpus rows; cell c owns slots
                 [c*cell_cap, (c+1)*cell_cap), slots past its count are zero.
    row_of_slot: [ncells * cell_cap] int32 corpus row of each slot, -1 on pad.
    slot_of_row: [n] int32 slot of each corpus row.
    counts:      [ncells] int32 rows per cell.
    """

    centroids: Tensor
    packed: Tensor
    row_of_slot: Tensor
    slot_of_row: Tensor
    counts: Tensor

    @property
    def ncells(self) -> int:
        return self.centroids.shape[0]

    @property
    def cell_cap(self) -> int:
        return self.packed.shape[0] // self.centroids.shape[0]


def train_centroids(x: Tensor, ncells: int, *, distance: str = "sqeuclidean",
                    iters: int = 10, init_perm: Tensor | None = None,
                    generator: torch.Generator | None = None,
                    impl: str = "fused") -> tuple[Tensor, Tensor]:
    """Lloyd k-means over ``x`` [n, d] in ``gy`` space, on ``x``'s device.

    Returns (centroids [ncells, d], assign [n] int32).  The reference's
    ``seed`` is a ``torch.Generator`` here (or an explicit ``init_perm``):
    torch cannot replay ``jax.random``.
    """
    from repro_torch.core.kmeans import lloyd

    assert 1 <= ncells <= x.shape[0], (ncells, x.shape[0])
    return lloyd(gy_rows(x, distance), ncells, iters=iters, init_perm=init_perm,
                 generator=generator, impl=impl)


def _np(a) -> np.ndarray:
    """``a`` as a host numpy array; from the card in blocks (``_copy_rows``)."""
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    if a.device.type == "cpu":
        return a.numpy()
    out = torch.empty(a.shape, dtype=a.dtype)
    _copy_rows(out, a)
    return out.numpy()


def _copy_rows(dst: Tensor, src: Tensor) -> None:
    """``dst.copy_(src)``, a block of leading rows of at most ``_COPY_BYTES``
    at a time; between the host and the card each block goes through one
    pinned staging buffer, on the calling thread's current stream."""
    if src.dim() == 0 or src.numel() == 0:
        dst.copy_(src)
        return
    step = max(1, _COPY_BYTES // (src[0].numel() * src.element_size()))
    card = next((t.device for t in (src, dst) if t.device.type == "cuda"), None)
    if card is None or src.device.type == dst.device.type:
        for r in range(0, src.shape[0], step):
            dst[r : r + step].copy_(src[r : r + step])
        return
    stage = torch.empty((min(step, src.shape[0]), *src.shape[1:]), dtype=src.dtype,
                        pin_memory=True)
    stream = torch.cuda.current_stream(card)
    for r in range(0, src.shape[0], step):
        n = min(step, src.shape[0] - r)
        if src.device.type == "cuda":
            stage[:n].copy_(src[r : r + n], non_blocking=True)
            stream.synchronize()
            dst[r : r + n].copy_(stage[:n])
        else:
            stage[:n].copy_(src[r : r + n])
            dst[r : r + n].copy_(stage[:n], non_blocking=True)
            stream.synchronize()  # the stage is written again next block


def pack_cells(x, centroids, assign, *, cell_cap: int | None = None,
               device=None) -> IVFCells:
    """Permute corpus rows into the cell-packed layout.

    ``cell_cap`` defaults to ``next_pow2(largest cell)``, at least
    ``MIN_CELL_CAP``.  Within a cell, rows keep their corpus order.  The
    permutation is computed on the host with numpy's stable argsort, as the
    reference computes it; the rows are then scattered into their slots on
    ``device``, so a packed copy many times the corpus is never built on the
    host.  ``device`` defaults to where the centroids lie, else the rows, and
    for numpy inputs to the card (``resolve_device("cuda")``).
    """
    if device is None:
        lying = [t.device for t in (centroids, x) if isinstance(t, torch.Tensor)]
        device = lying[0] if lying else resolve_device("cuda")
    centroids = _np(centroids).astype(np.float32, copy=False)
    assign = _np(assign).astype(np.int64)
    n, d = x.shape
    ncells = centroids.shape[0]
    counts = np.bincount(assign, minlength=ncells).astype(np.int32)
    cap = T.next_pow2(max(int(counts.max(initial=1)), MIN_CELL_CAP))
    if cell_cap is not None:
        assert cell_cap >= counts.max(initial=0), (cell_cap, counts.max())
        assert cell_cap & (cell_cap - 1) == 0, cell_cap
        cap = int(cell_cap)
    # rank of each row within its cell (stable: in-cell order is corpus order)
    order = np.argsort(assign, kind="stable")
    rank = np.empty(n, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank[order] = np.arange(n) - np.repeat(starts, counts)
    slot_of_row = (assign * cap + rank).astype(np.int32)
    row_of_slot = np.full(ncells * cap, -1, np.int32)
    row_of_slot[slot_of_row] = np.arange(n, dtype=np.int32)
    rows = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    packed = torch.zeros((ncells * cap, d), dtype=torch.float32, device=device)
    packed[_tensor(slot_of_row, device).long()] = rows.to(device, torch.float32)
    return IVFCells(_tensor(centroids, device), packed, _tensor(row_of_slot, device),
                    _tensor(slot_of_row, device), _tensor(counts, device))


def _tensor(a: np.ndarray, device) -> Tensor:
    """``a`` on ``device`` (to the card in blocks, ``_copy_rows``); torch
    needs a writable array, so a read-only one is copied."""
    t = torch.from_numpy(a if a.flags.writeable and a.flags.c_contiguous
                         else np.array(a, order="C"))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    _copy_rows(out, t)
    return out


def build_ivf(x, ncells: int, *, distance: str = "sqeuclidean", iters: int = 10,
              init_perm: Tensor | None = None, generator: torch.Generator | None = None,
              impl: str = "fused", cell_cap: int | None = None, device=None) -> IVFCells:
    """Train the coarse quantizer and pack the corpus: the build-time entry.

    ``x`` is a tensor (trained where it lies unless ``device`` says
    otherwise) or a numpy array (trained on ``device``, the card unless the
    caller asks for the CPU).  The reference's ``seed`` is a
    ``torch.Generator`` or an ``init_perm`` here, as in ``train_centroids``.
    """
    if isinstance(x, torch.Tensor):
        xt = x if device is None else x.to(resolve_device(device))
    else:
        xt = torch.from_numpy(np.asarray(x, np.float32)).to(resolve_device(
            "cuda" if device is None else device))
    cent, assign = train_centroids(xt, ncells, distance=distance, iters=iters,
                                   init_perm=init_perm, generator=generator, impl=impl)
    return pack_cells(xt, cent, assign, cell_cap=cell_cap, device=xt.device)


def ivf_to_arrays(ivf) -> dict[str, np.ndarray]:
    """Host-side numpy dict of a trained IVF structure (the port's, or the
    reference's: any object with the five ``IVFCells`` fields)."""
    return {f: _np(getattr(ivf, f)) for f in IVFCells._fields}


def ivf_from_arrays(arrays: dict, *, device="cuda") -> IVFCells:
    """Rebuild and validate an ``IVFCells`` from ``ivf_to_arrays`` output,
    on ``device`` (the card unless the caller asks for the CPU).

    The validation is structural, as the reference's: the permutation must
    round-trip and the geometry cohere.  Raises ``ValueError``.
    """
    device = resolve_device(device)
    missing = [f for f in IVFCells._fields if f not in arrays]
    if missing:
        raise ValueError(f"IVF arrays missing fields {missing}")
    cent = np.asarray(arrays["centroids"], np.float32)
    packed = np.asarray(arrays["packed"], np.float32)
    row_of_slot = np.asarray(arrays["row_of_slot"], np.int32)
    slot_of_row = np.asarray(arrays["slot_of_row"], np.int32)
    counts = np.asarray(arrays["counts"], np.int32)
    ncells, d = cent.shape
    S, n = packed.shape[0], slot_of_row.shape[0]
    if S == 0 or S % ncells or packed.shape[1] != d:
        raise ValueError(f"packed shape {packed.shape} incoherent with centroids {cent.shape}")
    cap = S // ncells
    if cap & (cap - 1) or cap < MIN_CELL_CAP:
        raise ValueError(f"cell_cap {cap} not a pow2 >= {MIN_CELL_CAP}")
    if row_of_slot.shape != (S,) or counts.shape != (ncells,):
        raise ValueError(f"permutation/count shapes {row_of_slot.shape}/{counts.shape} "
                         f"incoherent with packed {packed.shape}")
    if not ((slot_of_row >= 0) & (slot_of_row < S)).all():
        raise ValueError("slot_of_row out of packed range")
    if (row_of_slot[slot_of_row] != np.arange(n, dtype=np.int32)).any():
        raise ValueError("slot_of_row / row_of_slot do not round-trip")
    if int(counts.sum()) != n or int(counts.max(initial=0)) > cap:
        raise ValueError(f"counts (sum {counts.sum()}) incoherent with n={n}, cell_cap={cap}")
    return IVFCells(*(_tensor(a, device)
                      for a in (cent, packed, row_of_slot, slot_of_row, counts)))


def packed_live(ivf: IVFCells, db_live: Tensor | None = None) -> Tensor:
    """Bool [ncells * cell_cap] live mask in packed-slot order: pad slots are
    dead, and ``db_live`` ([n], original row order) rides the permutation."""
    alive = ivf.row_of_slot >= 0
    if db_live is None:
        return alive
    safe = ivf.row_of_slot.clamp(0, db_live.shape[0] - 1).long()
    return alive & db_live[safe]


def probe_cells(queries: Tensor, centroids: Tensor, nprobe: int, *,
                distance: str = "sqeuclidean", impl: str = "fused") -> Tensor:
    """The ``nprobe`` nearest cells of each query [m, nprobe], by the index
    distance (``knn_query`` over the centroids)."""
    from repro_torch.core.knn import knn_query

    nprobe = min(nprobe, centroids.shape[0])
    return knn_query(queries, centroids, nprobe, distance=distance, impl=impl).indices


def shortlist(queries: Tensor, centroids: Tensor, nprobe: int, *,
              distance: str = "sqeuclidean", impl: str = "fused") -> Tensor:
    """The cells each query probes [m, min(nprobe, ncells)], as a set: every
    consumer takes it as one, so where ``nprobe`` covers every cell they are
    taken in order without a kNN over the centroids, else ``probe_cells``."""
    ncells = centroids.shape[0]
    if nprobe >= ncells:
        cells = torch.arange(ncells, dtype=torch.int32, device=queries.device)
        return cells.expand(queries.shape[0], ncells)
    return probe_cells(queries, centroids, nprobe, distance=distance, impl=impl)


def tile_probe_lists(cells: Tensor, ncells: int, bm: int) -> Tensor:
    """Per-query-tile union probe lists [m/bm, W] int32, W = min(ncells,
    bm * nprobe): the tile's distinct probed cells ascending, padded out to
    W by repeating the last one.  ``cells`` [m, nprobe] with m % bm == 0.

    A probe outside ``[0, ncells)`` names no cell here and is dropped: on a
    mesh, a shard takes the global shortlist shifted by its first cell
    (``core.distributed``), so the cells other shards own fall outside its
    range.  A tile left with no probe gets a list of -1, which the scans
    read as no cell: its rows come back +inf / -1.
    """
    m, nprobe = cells.shape
    assert m % bm == 0, (m, bm)
    nt = m // bm
    W = min(ncells, bm * nprobe)
    c = cells.reshape(nt, bm * nprobe).long()
    ok = (c >= 0) & (c < ncells)
    present = torch.zeros((nt, ncells + 1), dtype=torch.bool, device=cells.device)
    present.scatter_(1, torch.where(ok, c, ncells), True)  # column ncells: dropped probes
    present = present[:, :ncells]
    ids = torch.arange(ncells, device=cells.device)
    # Present cells first, ascending; absent cells after them.
    order = torch.argsort(torch.where(present, ids, ncells + ids), dim=1)[:, :W]
    n_present = present.sum(1)
    last = order.gather(1, (n_present[:, None] - 1).clamp(0, W - 1))
    real = torch.arange(W, device=cells.device)[None, :] < n_present[:, None]
    lists = torch.where(real, order, last)
    return torch.where(n_present[:, None] > 0, lists, -1).to(torch.int32)
