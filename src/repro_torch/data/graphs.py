"""Graph storage, neighbour sampling, and kNN / radius graph construction.

Port of ``repro/data/graphs.py``.

* ``CSRGraph``, ``random_graph``, ``neighbor_sample`` and ``molecule_batch``
  are numpy with the reference's generators: the same seeds give the same
  arrays, bit for bit.
* ``knn_graph`` / ``radius_graph`` build edge lists on the port's all-pairs
  solver, ``core.knn.knn_allpairs(impl="fused")``: on the card, the fused
  distance + top-K kernel.  They take and return tensors on the caller's
  device (a numpy input goes to ``device``); the reference returns numpy.
  Padding rules are the reference's: a ``-1`` slot (k > n - 1) and, in the
  radius graph, a pair beyond the cutoff become self-loops, which the GNN
  masks.

Conditioning.  The matmul form ``|x|^2 + |y|^2 - 2 x.y`` loses the low bits
of a distance to the size of the coordinates: at |x| ~ 10^4, fp32's step
at |x|^2 is 16, more than a cutoff of 5 squared.  Both functions solve in
coordinates centred on the points' mean.  ``radius_graph`` goes further:
no pair within the cutoff straddles a gap wider than the cutoff along an
axis, so the points are split at every such gap (on each axis in turn,
until none is left) and each group is solved on its own, centred on its
own mean.  The result is the reference's, pair for pair, since every pair
the cutoff keeps lies within one group; only its rounding is better.  The
cutoff is then applied to each kept pair's distance recomputed as a
difference, ``|pos[src] - pos[dst]|^2``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels._backend import resolve_device

Tensor = torch.Tensor


def _rng(seed: int, step: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass
class CSRGraph:
    """Host-side CSR adjacency. indptr: [N+1] int64; indices: [nnz] int32."""

    indptr: np.ndarray
    indices: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def n_edges(self) -> int:
        return len(self.indices)

    def degree(self, u: np.ndarray) -> np.ndarray:
        return self.indptr[u + 1] - self.indptr[u]


def random_graph(n_nodes: int, n_edges: int, seed: int = 0, *, power: float = 0.8) -> CSRGraph:
    """Skewed-degree random graph (preferential-attachment-ish) in CSR."""
    g = _rng(seed)
    dst_pref = (g.random(n_edges) ** (1.0 / max(power, 1e-3)) * n_nodes).astype(np.int64)
    dst = np.minimum(dst_pref, n_nodes - 1)
    src = g.integers(0, n_nodes, n_edges)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr=indptr, indices=dst.astype(np.int32))


def neighbor_sample(graph: CSRGraph, seeds: np.ndarray, fanouts: tuple[int, ...],
                    seed: int = 0, step: int = 0) -> dict:
    """GraphSAGE fanout sampling with static shapes (the reference's).

    Returns nodes [n_pad] int32 (padded with -1), node_mask [n_pad] bool,
    src/dst [sum_h E_h] int32 relabelled edge endpoints and seeds_local
    [len(seeds)], the seeds' positions in ``nodes``.
    """
    g = _rng(seed, step)
    frontier = seeds.astype(np.int64)
    all_dst: list[np.ndarray] = []
    visited = [seeds.astype(np.int64)]
    for f in fanouts:
        deg = graph.degree(frontier)
        # sample-with-replacement offsets; degree-0 nodes self-loop.
        offs = (g.random((len(frontier), f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
        nbr = graph.indices[np.minimum(graph.indptr[frontier][:, None] + offs,
                                       len(graph.indices) - 1)]
        nbr = np.where(deg[:, None] > 0, nbr, frontier[:, None].astype(np.int32))
        src = nbr.reshape(-1).astype(np.int64)  # messages flow nbr -> frontier
        all_dst.append(np.repeat(frontier, f))
        frontier = src
        visited.append(src)

    nodes, inv = np.unique(np.concatenate(visited), return_inverse=True)
    # Static padding: the worst case is all sampled nodes distinct.
    n_pad = int(len(seeds) * np.prod([1] + [f + 1 for f in fanouts]))
    n_pad = max(n_pad, len(nodes))
    pad_nodes = np.full(n_pad, -1, np.int32)
    pad_nodes[: len(nodes)] = nodes.astype(np.int32)

    counts = [len(v) for v in visited]
    splits = np.split(inv, np.cumsum(counts)[:-1])
    seeds_local = splits[0].astype(np.int32)
    src_rel = (np.concatenate(list(splits[1:])).astype(np.int32) if fanouts
               else np.zeros(0, np.int32))
    dst_parts = [np.searchsorted(nodes, dsts).astype(np.int32) for dsts in all_dst]
    dst_rel = np.concatenate(dst_parts) if dst_parts else np.zeros(0, np.int32)
    return {"nodes": pad_nodes, "node_mask": pad_nodes >= 0, "src": src_rel, "dst": dst_rel,
            "seeds_local": seeds_local}


# ---------------------------------------------------------------------------
# kNN / radius graph construction (the paper's solver feeding the GNN).
# ---------------------------------------------------------------------------


def _positions(positions, device) -> Tensor:
    if isinstance(positions, Tensor):
        return positions.float()
    return torch.as_tensor(np.asarray(positions, np.float32)).to(resolve_device(device))


def _gsize(n: int) -> int:
    return min(512, max(128, n))


def knn_graph(positions, k: int, *, exclude_self: bool = True, impl: str = "fused",
              device="cuda") -> tuple[Tensor, Tensor]:
    """Directed kNN edge list (src -> dst: src is a neighbour of dst).

    positions: [N, 3].  Returns (src [N*k], dst [N*k]) int32 on the
    positions' device.  Runs the paper's all-pairs solver.
    """
    from repro_torch.core.knn import knn_allpairs

    pos = _positions(positions, device)
    n = pos.shape[0]
    res = knn_allpairs(pos - pos.mean(0), k, distance="sqeuclidean", impl=impl,
                       gsize=_gsize(n), exclude_self=exclude_self)
    dst = torch.arange(n, dtype=torch.int32, device=pos.device).repeat_interleave(
        res.indices.shape[1])
    src = res.indices.reshape(-1).to(torch.int32)
    # Padding entries (idx -1, when k > n-1) become self-loops (masked in the GNN).
    return torch.where(src < 0, dst, src), dst


def cutoff_groups(points: np.ndarray, cutoff: float) -> list[np.ndarray]:
    """The rows of ``points`` [n, 3] split at every gap wider than ``cutoff``
    along an axis, each axis in turn, until no group splits: each group's
    sorted row ids.  No pair within ``cutoff`` spans two groups."""
    p = np.asarray(points, np.float64)
    stack, out = [np.arange(len(p))], []
    while stack:
        ids = stack.pop()
        for ax in range(p.shape[1]):
            x = p[ids, ax]
            order = np.argsort(x, kind="stable")
            gaps = np.nonzero(np.diff(x[order]) > cutoff)[0]
            if len(gaps):
                stack.extend(np.split(ids[order], gaps + 1))
                break
        else:
            out.append(np.sort(ids))
    out.sort(key=lambda ids: ids[0])
    return out


def radius_graph(positions, cutoff: float, max_neighbors: int, *, impl: str = "fused",
                 device="cuda") -> tuple[Tensor, Tensor]:
    """Edges within ``cutoff`` (the NequIP neighbour list), k-capped, padded.

    kNN with k = max_neighbors over each group of ``cutoff_groups`` (module
    docstring), then distance-filtered; pairs beyond the cutoff become
    self-loops, keeping the shape static.  Returns (src [N*k], dst [N*k])
    int32 on the positions' device.
    """
    from repro_torch.core.knn import knn_allpairs

    pos = _positions(positions, device)
    n = pos.shape[0]
    k = min(max_neighbors, max(n - 1, 1))
    src = torch.full((n, k), -1, dtype=torch.long, device=pos.device)
    for ids in cutoff_groups(pos.detach().cpu().numpy(), cutoff):
        if len(ids) < 2:
            continue
        rows = torch.from_numpy(ids).to(pos.device)
        sub = pos.index_select(0, rows)
        res = knn_allpairs(sub - sub.mean(0), min(k, len(ids) - 1), distance="sqeuclidean",
                           impl=impl, gsize=_gsize(len(ids)), exclude_self=True)
        got = res.indices.long()
        kk = got.shape[1]
        src[rows, :kk] = torch.where(got >= 0, rows[got.clamp_min(0)], got)
    dst = torch.arange(n, device=pos.device).repeat_interleave(k)
    src = src.reshape(-1)
    diff = pos.index_select(0, src.clamp_min(0)) - pos.index_select(0, dst)
    ok = (src >= 0) & ((diff * diff).sum(-1) <= cutoff * cutoff)
    return torch.where(ok, src, dst).to(torch.int32), dst.to(torch.int32)


def molecule_batch(batch: int, n_nodes: int, n_edges: int, n_species: int = 16,
                   seed: int = 0, step: int = 0) -> dict:
    """Pack ``batch`` random molecules into one graph by index offsetting.

    Positions are jittered lattice points; edges come from each molecule's
    all-pairs radius graph (cutoff 3.0), padded to n_edges each; energies
    and forces follow a planted harmonic-pair potential, so the loss is
    learnable.  numpy, the reference's generator: equal arrays, bit for bit.
    """
    g = _rng(seed, step)
    side = int(np.ceil(n_nodes ** (1 / 3)))
    lat = np.stack(np.meshgrid(*([np.arange(side)] * 3), indexing="ij"), -1).reshape(-1, 3)

    pos_all, spec_all, src_all, dst_all, e_all, f_all, gid_all = [], [], [], [], [], [], []
    for b in range(batch):
        pick = g.permutation(len(lat))[:n_nodes]
        pos = (1.8 * lat[pick].astype(np.float32)
               + 0.2 * g.standard_normal((n_nodes, 3), dtype=np.float32))
        spec = g.integers(0, n_species, n_nodes).astype(np.int32)
        d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        ii, jj = np.nonzero(d2 < 9.0)
        order = np.argsort(d2[ii, jj])[:n_edges]
        src = np.full(n_edges, 0, np.int32)
        dst = np.full(n_edges, 0, np.int32)
        src[: len(order)] = ii[order]
        dst[: len(order)] = jj[order]
        # planted potential: harmonic springs on the true edges
        diff = pos[src[: len(order)]] - pos[dst[: len(order)]]
        r = np.linalg.norm(diff, axis=1)
        e = 0.5 * ((r - 1.8) ** 2).sum()
        fvec = np.zeros((n_nodes, 3), np.float32)
        pair_f = ((r - 1.8) / np.maximum(r, 1e-9))[:, None] * diff
        np.add.at(fvec, src[: len(order)], -pair_f)
        np.add.at(fvec, dst[: len(order)], pair_f)
        pos_all.append(pos)
        spec_all.append(spec)
        src_all.append(src + b * n_nodes)
        dst_all.append(dst + b * n_nodes)
        e_all.append(e)
        f_all.append(fvec)
        gid_all.append(np.full(n_nodes, b, np.int32))

    return {
        "positions": np.concatenate(pos_all),
        "node_input": np.concatenate(spec_all),
        "edges": (np.concatenate(src_all), np.concatenate(dst_all)),
        "energy": np.asarray(e_all, np.float32),
        "forces": np.concatenate(f_all),
        "node_graph": np.concatenate(gid_all),
        "n_graphs": batch,
    }
