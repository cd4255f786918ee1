"""Product quantization: per-subspace codebooks and ADC lookup tables
(DESIGN.md §PQ).

PyTorch port of ``repro/core/pq.py``.  A ``gy``-mapped row of d coordinates
is cut into ``m`` subspaces of ``d / m``; each subspace has a codebook of
``2^nbits`` codewords (k-means, ``core.kmeans.lloyd``), and a row is stored
as its ``m`` uint8 codeword ids.  The scan (``kernels/pq_scan.py``) scores a
row by asymmetric distance computation: a per-query table of subspace
partial dots (``build_pq_luts``), summed over the row's codes.

Contract, as the reference's: ``PQCodes.hy`` is the rank-1 term of the
DECODED rows, so a scanned value is exactly the distance to the decoded
corpus and candidate order is the only error, which the exact rescore
repairs (``core.knn.ivfpq_query``).  With a coarse quantizer the codes
encode the residual ``gy(row) - centroid[cell]`` (``build_ivfpq``), and the
cross term ``alpha * fx . centroid[cell]`` rides into the scan per (query,
cell) (``pq_cell_bias``).

Torch cannot replay ``jax.random``: ``train_pq`` takes each subspace's
k-means start as an explicit permutation (the reference's own draw, as the
parity tests pass it) or draws it from a ``torch.Generator``.  Encoding is
the per-subspace 1-NN through ``knn_query``, so on the card it runs the
fused kernel at k = 1.  ``build_ivfpq`` (``train_ivfpq``, then
``encode_ivfpq``) encodes the cell-packed slots a block at a time: the
packed copy can be many times the corpus, and no temporary the size of it
is formed.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.distances import get_distance, gy_rows
from repro_torch.core.ivf import _np, _tensor
from repro_torch.core import kmeans
from repro_torch.kernels._backend import resolve_device

Tensor = torch.Tensor

_ENCODE_BLOCK = 1 << 26  # elements of packed rows encoded at a time


class PQCodebook(NamedTuple):
    """Per-subspace codeword tables in the (residual) ``gy`` space.

    codebooks: [m, ncodes, dsub] fp32; d = m * dsub, ncodes = 2^nbits.
    """

    codebooks: Tensor

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ncodes(self) -> int:
        return self.codebooks.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebooks.shape[2]


class PQCodes(NamedTuple):
    """The PQ scan replica of a database (analogue of ``QuantizedRows``).

    codes: [n, m] uint8 per-row codeword ids.
    hy:    [n] fp32 rank-1 term of the decoded rows (residual base
           included); dead rows are masked to +inf through it at query time.
    """

    codes: Tensor
    hy: Tensor


def _check_pq_geometry(d: int, m: int, nbits: int) -> int:
    if m < 1 or d % m != 0:
        raise ValueError(f"pq_m={m} must divide d={d}")
    if not 1 <= nbits <= 8:
        raise ValueError(f"pq_nbits={nbits} must be in [1, 8] (uint8 codes)")
    return 2 ** nbits


def train_pq(rows: Tensor, m: int, *, nbits: int = 8, iters: int = 10,
             init_perms: Sequence[Tensor] | None = None,
             generator: torch.Generator | None = None, impl: str = "fused") -> PQCodebook:
    """Train ``m`` subspace codebooks over pre-mapped rows [n, d].

    Subspace j runs Lloyd k-means from the rows ``init_perms[j][:2^nbits]``;
    without ``init_perms`` each start is a ``torch.randperm`` drawn from
    ``generator``, one subspace after the other.  Needs n >= 2^nbits.
    """
    n, d = rows.shape
    ncodes = _check_pq_geometry(d, m, nbits)
    if n < ncodes:
        raise ValueError(f"PQ training needs >= 2^nbits = {ncodes} rows, got {n}")
    if init_perms is not None and len(init_perms) != m:
        raise ValueError(f"want one initial permutation per subspace ({m}), "
                         f"got {len(init_perms)}")
    subs = rows.float().reshape(n, m, d // m)
    cbs = [kmeans.lloyd(subs[:, j].contiguous(), ncodes, iters=iters,
                        init_perm=None if init_perms is None else init_perms[j],
                        generator=generator, impl=impl)[0] for j in range(m)]
    return PQCodebook(torch.stack(cbs))


def encode_pq(cb: PQCodebook, rows: Tensor, *, impl: str = "fused") -> Tensor:
    """Codes [n, m] uint8 of pre-mapped rows [n, d]: per subspace the
    nearest codeword by squared euclidean distance (``knn_query`` at k = 1)."""
    from repro_torch.core.knn import knn_query

    n, d = rows.shape
    if d != cb.m * cb.dsub:
        raise ValueError(f"rows of width {d} for a codebook of {cb.m} x {cb.dsub}")
    subs = rows.float().reshape(n, cb.m, cb.dsub)
    cols = [knn_query(subs[:, j].contiguous(), cb.codebooks[j], 1, distance="sqeuclidean",
                      impl=impl).indices[:, 0] for j in range(cb.m)]
    return torch.stack(cols, dim=1).to(torch.uint8)


def decode_pq(cb: PQCodebook, codes: Tensor) -> Tensor:
    """Decoded rows [n, d] of codes [n, m] (``gy`` / residual space)."""
    n, m = codes.shape
    if m != cb.m:
        raise ValueError(f"codes of {m} subspaces for a codebook of {cb.m}")
    sub = torch.arange(m, device=codes.device)
    return cb.codebooks[sub[None, :], codes.long()].reshape(n, m * cb.dsub)


def build_pq(x: Tensor, m: int, *, nbits: int = 8, distance: str = "sqeuclidean",
             iters: int = 10, init_perms: Sequence[Tensor] | None = None,
             generator: torch.Generator | None = None,
             impl: str = "fused") -> tuple[PQCodebook, PQCodes]:
    """Flat (no coarse quantizer) PQ replica of corpus rows ``x`` [n, d]."""
    g = gy_rows(x, distance)
    cb = train_pq(g, m, nbits=nbits, iters=iters, init_perms=init_perms,
                  generator=generator, impl=impl)
    codes = encode_pq(cb, g, impl=impl)
    hy = get_distance(distance).matmul_form.hy(decode_pq(cb, codes)).float()
    return cb, PQCodes(codes, hy)


def train_ivfpq(x: Tensor, ivf, m: int, *, nbits: int = 8, distance: str = "sqeuclidean",
                iters: int = 10, init_perms: Sequence[Tensor] | None = None,
                generator: torch.Generator | None = None, impl: str = "fused",
                residual: bool = True) -> PQCodebook:
    """The codebooks of an IVF-PQ replica: trained on the corpus rows
    ``x`` (their residuals to their cell's centroid when ``residual``),
    never on pad slots, which would pull the codewords toward
    ``-centroid``.  ``ivf`` is a trained ``core.ivf.IVFCells`` over ``x``."""
    g = gy_rows(x, distance)
    if residual:
        g = g - ivf.centroids[ivf.slot_of_row.long() // ivf.cell_cap]
    return train_pq(g, m, nbits=nbits, iters=iters, init_perms=init_perms,
                    generator=generator, impl=impl)


def encode_ivfpq(cb: PQCodebook, ivf, *, distance: str = "sqeuclidean", impl: str = "fused",
                 residual: bool = True) -> PQCodes:
    """Codes and ``hy`` of every packed slot of ``ivf``, pad slots included,
    in packed-slot order.  The slots go through a block at a time into the
    preallocated replica: each step is row-local, so the result is that of
    one pass over the whole packed array, and no temporary the size of it
    is formed."""
    hy_of = get_distance(distance).matmul_form.hy
    S, d = ivf.packed.shape
    cap, dev = ivf.cell_cap, ivf.packed.device
    codes = torch.empty((S, cb.m), dtype=torch.uint8, device=dev)
    hy = torch.empty(S, dtype=torch.float32, device=dev)
    step = max(1, _ENCODE_BLOCK // max(d, 1))
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        rows = gy_rows(ivf.packed[s0:s1], distance)
        if residual:
            base = ivf.centroids[torch.arange(s0, s1, device=dev) // cap]
            c = encode_pq(cb, rows - base, impl=impl)
            decoded = base + decode_pq(cb, c)
        else:
            c = encode_pq(cb, rows, impl=impl)
            decoded = decode_pq(cb, c)
        codes[s0:s1] = c
        hy[s0:s1] = hy_of(decoded).float()
    return PQCodes(codes, hy)


def build_ivfpq(x: Tensor, ivf, m: int, *, nbits: int = 8, distance: str = "sqeuclidean",
                iters: int = 10, init_perms: Sequence[Tensor] | None = None,
                generator: torch.Generator | None = None, impl: str = "fused",
                residual: bool = True) -> tuple[PQCodebook, PQCodes]:
    """PQ replica of an IVF index's cell-packed rows (the IVFADC build):
    ``train_ivfpq`` then ``encode_ivfpq``.  ``residual=True`` encodes
    ``gy(row) - centroid[cell]``; ``hy`` is the rank-1 term of the decoded
    packed rows, residual base included, so a scanned value is the distance
    to the decoded corpus.  Pad slots carry codes too, and are dead through
    the live mask at query time."""
    cb = train_ivfpq(x, ivf, m, nbits=nbits, distance=distance, iters=iters,
                     init_perms=init_perms, generator=generator, impl=impl, residual=residual)
    return cb, encode_ivfpq(cb, ivf, distance=distance, impl=impl, residual=residual)


def pq_to_arrays(cb, codes) -> dict[str, np.ndarray]:
    """Host-side numpy dict of a trained PQ replica (the port's, or the
    reference's: anything with ``codebooks``, ``codes`` and ``hy``)."""
    return {"codebooks": _np(cb.codebooks), "codes": _np(codes.codes), "hy": _np(codes.hy)}


def pq_from_arrays(arrays: dict, *, device="cuda") -> tuple[PQCodebook, PQCodes]:
    """Rebuild and validate (PQCodebook, PQCodes) from ``pq_to_arrays``
    output, on ``device`` (the card unless the caller asks for the CPU).

    Structural checks, as the reference's: geometry, dtypes and code range,
    so that a corrupted replica fails here rather than index past a
    codebook inside the scan.  Raises ``ValueError``.
    """
    device = resolve_device(device)
    missing = [f for f in ("codebooks", "codes", "hy") if f not in arrays]
    if missing:
        raise ValueError(f"PQ snapshot missing fields {missing}")
    cbs = np.asarray(arrays["codebooks"], np.float32)
    codes = np.asarray(arrays["codes"])
    hy = np.asarray(arrays["hy"], np.float32)
    if cbs.ndim != 3:
        raise ValueError(f"codebooks must be [m, ncodes, dsub], got {cbs.shape}")
    m, ncodes, _ = cbs.shape
    if ncodes & (ncodes - 1) or not 2 <= ncodes <= 256:
        raise ValueError(f"ncodes {ncodes} not a pow2 in [2, 256]")
    if codes.dtype != np.uint8 or codes.ndim != 2 or codes.shape[1] != m:
        raise ValueError(f"codes must be uint8 [n, m={m}], got {codes.dtype} {codes.shape}")
    if hy.shape != (codes.shape[0],):
        raise ValueError(f"hy shape {hy.shape} != ({codes.shape[0]},)")
    if ncodes < 256 and int(codes.max(initial=0)) >= ncodes:
        raise ValueError(f"code id {int(codes.max())} out of codebook range {ncodes}")
    return (PQCodebook(_tensor(cbs, device)),
            PQCodes(_tensor(codes, device), _tensor(hy, device)))


def build_pq_luts(cb: PQCodebook, queries: Tensor, *,
                  distance: str = "sqeuclidean") -> Tensor:
    """ADC lookup tables [mq, m, ncodes] fp32 of a query batch:
    ``lut[q, j, c] = alpha * <fx(q)[j-th subspace], codebooks[j, c]>``, the
    subspace partial of the matmul-form dot, prescaled by alpha so that the
    scan is a table sum plus the rank-1 epilogue.  One product per batch,
    left to ``torch.einsum`` as the reference leaves it to XLA."""
    mf = get_distance(distance).matmul_form
    fx = mf.fx(queries.float()).float()
    mq, d = fx.shape
    if d != cb.m * cb.dsub:
        raise ValueError(f"queries of width {d} for a codebook of {cb.m} x {cb.dsub}")
    return mf.alpha * torch.einsum("qjd,jcd->qjc", fx.reshape(mq, cb.m, cb.dsub),
                                   cb.codebooks.float())


def pq_cell_bias(queries: Tensor, centroids: Tensor, *,
                 distance: str = "sqeuclidean") -> Tensor:
    """Residual-PQ cross term [mq, ncells]: ``alpha * fx(q) . centroid_c``,
    constant over a cell's slots, so the scan adds it once per (query, cell)."""
    mf = get_distance(distance).matmul_form
    return mf.alpha * (mf.fx(queries.float()).float() @ centroids.float().T)
