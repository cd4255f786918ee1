"""NequIP-style E(3)-equivariant message-passing network (arXiv:2101.03164).

Port of ``repro/models/gnn.py``.  Irreps are carried in the Cartesian basis
up to l_max = 2:

  l=0  scalars   s : [N, C]
  l=1  vectors   v : [N, 3, C]
  l=2  traceless symmetric tensors, stored in their 5-form t : [N, 5, C]

Edge attributes are the Cartesian harmonics of the edge unit vector u
(Y0 = 1, Y1 = u, Y2 = u u^T - I/3) and a Bessel radial basis under a smooth
polynomial cutoff.  Every interaction block evaluates the reference's ten
Clebsch-Gordan paths (l_in x l_edge -> l_out as dot, cross and symmetrized
outer products), each weighted per channel by an MLP of the radial basis,
and sums the messages over each destination node.

What differs from the reference, and why:

* Forces are ``-dE/dpos`` by ``torch.autograd.grad``; the potential loss
  differentiates them again (``create_graph=True``).  The message sums, the
  gathers of node features onto edges and the per-graph energy sums are
  ``core.segments.segment_sum`` / ``gather`` over an edge list sorted once:
  each is the other's gradient, so every derivative order sums in an order
  the edge list fixes, never by atomics, and ``torch.segment_reduce``'s
  missing second derivative is never asked for.  Every backward runs on
  one thread (``core.segments.one_thread_backward``), so two runs on
  the card give the same bytes.
* Initialisers draw the reference's distributions from a
  ``torch.Generator``: torch cannot replay ``jax.random``, so the values
  differ.  ``params_from_reference`` carries the reference's values across.
* The mesh hints (``constrain``) are the identity on one position and are
  left out; ``feature_dtype`` keeps its meaning (the features' dtype
  through the mixes and gathers; the sums stay fp32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.segments import Segments, gather, one_thread_backward, segment_sum
from repro_torch.kernels._backend import resolve_device
from repro_torch.models.nn import (Param, is_param, lecun_init, require_fp32_products, tree_leaves,
                                   tree_map)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    n_layers: int = 5
    d_hidden: int = 32  # channels per irrep
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    d_feat: int = 0  # optional input node-feature dim (0 = species one-hot)
    n_species: int = 16
    radial_hidden: int = 32
    avg_neighbors: float = 12.0  # aggregation normalizer (NequIP conv norm)
    feature_dtype: Any = torch.float32  # node features through mixes and gathers

    @property
    def n_paths(self) -> int:
        # l<=1: 0x0->0, 1x1->0, 0x1->1, 1x0->1, 1x1->1 (5 paths);
        # l=2 adds 2x2->0, 2x1->1, 0x2->2, 1x1->2, 2x0->2 (10 in all).
        return 10 if self.l_max >= 2 else 5


# ---------------------------------------------------------------------------
# Radial and angular bases.
# ---------------------------------------------------------------------------


def bessel_rbf(r: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """sin(n pi r / rc) / r basis (NequIP eq. 8), fp32, shape [..., n_rbf]."""
    r = torch.clamp_min(r.float(), 1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    scale = float(np.sqrt(np.float32(2.0 / cutoff)))
    return scale * torch.sin(n * math.pi * r[..., None] / cutoff) / r[..., None]


def poly_cutoff(r: Tensor, cutoff: float, p: int = 6) -> Tensor:
    """XPLOR-style smooth cutoff envelope, 1 at r=0, 0 at r>=cutoff (C^2)."""
    x = torch.clamp(r.float() / cutoff, 0.0, 1.0)
    return (1.0 - 0.5 * (p + 1.0) * (p + 2.0) * x ** p + p * (p + 2.0) * x ** (p + 1)
            - 0.5 * p * (p + 1.0) * x ** (p + 2))


def edge_harmonics(vec: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Cartesian Y0/Y1/Y2 of edge vectors [E, 3] -> (r [E], u [E, 3], T [E, 3, 3]).

    Gradient-safe at vec = 0 (padding and self edges): sqrt(r^2 + eps)
    keeps the backward pass finite where a plain norm would give NaN.
    """
    vec = vec.float()
    r = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-18)
    u = vec / torch.clamp_min(r, 1e-9)[..., None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    t = u[..., :, None] * u[..., None, :] - eye / 3.0
    return r, u, t


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def _linear(g, c_in, c_out, device, axes=(None, "tensor")):
    return Param(lecun_init(g, (c_in, c_out), c_in, device=device), axes)


def init_layer(generator, cfg: GNNConfig, *, device="cuda"):
    C, R, H, P = cfg.d_hidden, cfg.n_rbf, cfg.radial_hidden, cfg.n_paths
    g, dev = generator, device
    return {
        # radial MLP: rbf -> per-(path, channel) weights
        "rad_w1": Param(lecun_init(g, (R, H), R, device=dev), (None, None)),
        "rad_b1": Param(torch.zeros((H,), device=dev), (None,)),
        "rad_w2": Param(lecun_init(g, (H, P * C), H, device=dev), (None, "tensor")),
        # pre/post channel mixes per irrep
        "mix_s_in": _linear(g, C, C, dev),
        "mix_v_in": _linear(g, C, C, dev),
        "mix_t_in": _linear(g, C, C, dev),
        "mix_s_out": _linear(g, C, C, dev),
        "mix_v_out": _linear(g, C, C, dev),
        "mix_t_out": _linear(g, C, C, dev),
        # gate: scalars -> gates for the v and t channels
        "gate_w": Param(lecun_init(g, (C, 2 * C), C, device=dev), (None, "tensor")),
        "sc_w": _linear(g, C, C, dev),  # self-connection (residual mix)
    }


def init_params(cfg: GNNConfig, *, generator: torch.Generator | None = None, device="cuda"):
    """The ``Param`` tree drawn on ``device`` from ``generator`` (default: a
    fresh one seeded 0); ``device="meta"`` gives shapes only."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(0)
    d_in = cfg.d_feat if cfg.d_feat > 0 else cfg.n_species
    g = generator
    return {
        "embed": Param(lecun_init(g, (d_in, cfg.d_hidden), d_in, device=dev), (None, "tensor")),
        "layers": [init_layer(g, cfg, device=dev) for _ in range(cfg.n_layers)],
        "out_w1": Param(lecun_init(g, (cfg.d_hidden, cfg.d_hidden), cfg.d_hidden, device=dev),
                        (None, "tensor")),
        "out_w2": Param(lecun_init(g, (cfg.d_hidden, 1), cfg.d_hidden, device=dev),
                        ("tensor", None)),
    }


def abstract_params(cfg: GNNConfig):
    return init_params(cfg, device="meta")


def params_from_reference(values, *, device="cuda"):
    """A reference value tree (``split_params(init_params(...))[0]``, numpy
    or JAX leaves) as the port's values on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), values)


# ---------------------------------------------------------------------------
# Interaction block.
# ---------------------------------------------------------------------------


def _val(p):
    return p.value if is_param(p) else p


def _mix(w, x: Tensor) -> Tensor:
    """Channel mix on the last axis for any irrep layout."""
    return x @ _val(w).to(x.dtype)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a [E, 3, C] x b [E, 3] along axis 1 (``jnp.cross(axisa=axisb=axisc=1)``)."""
    a0, a1, a2 = a[:, 0], a[:, 1], a[:, 2]
    b0, b1, b2 = b[:, 0, None], b[:, 1, None], b[:, 2, None]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=1)


def _messages(s_j, v_j, t_j, u, T, w, cfg: GNNConfig):
    """Per-edge tensor-product messages.

    s_j [E,C], v_j [E,3,C], t_j [E,3,3,C]; u [E,3], T [E,3,3];
    w [E, P, C] per-path per-channel radial weights.  Returns (ms, mv, mt).
    """
    wi = iter(range(cfg.n_paths))

    def nw():
        return w[:, next(wi), :]

    # l_out = 0
    ms = nw() * s_j  # 0 x 0 -> 0
    ms = ms + nw() * torch.einsum("eic,ei->ec", v_j, u)  # 1 x 1 -> 0
    # l_out = 1
    mv = nw()[:, None, :] * s_j[:, None, :] * u[:, :, None]  # 0 x 1 -> 1
    mv = mv + nw()[:, None, :] * v_j  # 1 x 0 -> 1
    mv = mv + nw()[:, None, :] * _cross(v_j, u)  # 1 x 1 -> 1
    if cfg.l_max < 2:
        return ms, mv, None
    ms = ms + nw() * torch.einsum("eijc,eij->ec", t_j, T)  # 2 x 2 -> 0
    mv = mv + nw()[:, None, :] * torch.einsum("eijc,ej->eic", t_j, u)  # 2 x 1 -> 1
    # l_out = 2
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    mt = nw()[:, None, None, :] * s_j[:, None, None, :] * T[..., None]  # 0 x 2 -> 2
    vu = v_j[:, :, None, :] * u[:, None, :, None]
    sym = 0.5 * (vu + vu.transpose(1, 2))
    tr = torch.diagonal(sym, dim1=1, dim2=2).sum(-1)
    mt = mt + nw()[:, None, None, :] * (sym - eye[None, :, :, None] * tr[:, None, None, :] / 3.0)
    mt = mt + nw()[:, None, None, :] * t_j  # 2 x 0 -> 2
    return ms, mv, mt


def pack_t(t: Tensor) -> Tensor:
    """Traceless symmetric [..., 3, 3, C] -> irreducible [..., 5, C]."""
    return torch.stack([t[..., 0, 0, :], t[..., 1, 1, :], t[..., 0, 1, :],
                        t[..., 0, 2, :], t[..., 1, 2, :]], dim=-2)


def unpack_t(t5: Tensor) -> Tensor:
    """Inverse of pack_t: [..., 5, C] -> full traceless symmetric 3x3."""
    t00, t11, t01, t02, t12 = (t5[..., i, :] for i in range(5))
    row0 = torch.stack([t00, t01, t02], dim=-2)
    row1 = torch.stack([t01, t11, t12], dim=-2)
    row2 = torch.stack([t02, t12, -t00 - t11], dim=-2)
    return torch.stack([row0, row1, row2], dim=-3)


def edge_segments(edges, n_nodes: int, device) -> tuple[Segments, Segments]:
    """(src, dst) index arrays as ``Segments`` over ``n_nodes`` on ``device``."""
    src, dst = (torch.as_tensor(e).to(device=device, dtype=torch.long) for e in edges)
    return Segments(src, n_nodes), Segments(dst, n_nodes)


def layer_forward(lp, feats, segs, edge_attr, cfg: GNNConfig):
    """One interaction block.

    feats: dict(s [N,C], v [N,3,C], t [N,5,C] irreducible); segs: the
    (src, dst) ``Segments`` of the edges (``edge_segments``); edge_attr:
    (rbf * envelope [E,R], u [E,3], T [E,3,3]).
    """
    s, v, t = feats["s"], feats["v"], feats["t"]
    seg_src, seg_dst = segs
    rbf, u, T = edge_attr
    C = s.shape[1]

    # Radial weights per path x channel.
    h = F.silu(rbf @ _val(lp["rad_w1"]) + _val(lp["rad_b1"]))
    w = (h @ _val(lp["rad_w2"])).reshape(-1, cfg.n_paths, C)

    # Pre-mix, then gather the neighbours' features onto the edges; l=2 stays
    # in its 5-form through mix and gather and is unpacked in edge space.
    wd = cfg.feature_dtype
    s_j = gather(_mix(lp["mix_s_in"], s.to(wd)), seg_src)
    v_j = gather(_mix(lp["mix_v_in"], v.to(wd)), seg_src)
    t_j = unpack_t(gather(_mix(lp["mix_t_in"], t.to(wd)), seg_src))

    ms, mv, mt = _messages(s_j, v_j, t_j, u.to(wd), T.to(wd), w.to(wd), cfg)
    # Sum in fp32 whatever the features' dtype; l=2 repacks before the sum.
    norm = float(np.float32(1.0) / np.sqrt(np.float32(cfg.avg_neighbors)))
    agg_s = segment_sum(ms.float(), seg_dst) * norm
    agg_v = segment_sum(mv.float(), seg_dst) * norm
    agg_t = (segment_sum(pack_t(mt).float(), seg_dst) * norm if mt is not None
             else torch.zeros_like(t))

    # Self-connection + post mix (fp32 residual stream).
    s_new = _mix(lp["sc_w"], s.to(wd)).float() + _mix(lp["mix_s_out"], agg_s)
    v_new = v + _mix(lp["mix_v_out"], agg_v)
    t_new = t + _mix(lp["mix_t_out"], agg_t)

    # Gate nonlinearity: scalars through silu; v and t scaled by sigmoid gates.
    gates = torch.sigmoid(s_new @ _val(lp["gate_w"]))
    gv, gt = gates[:, :C], gates[:, C:]
    return {"s": F.silu(s_new), "v": v_new * gv[:, None, :], "t": t_new * gt[:, None, :]}


# ---------------------------------------------------------------------------
# Full model: energy + forces.
# ---------------------------------------------------------------------------


def _device(params) -> torch.device:
    return _val(params["embed"]).device


def init_features(params, node_input, n_nodes: int, cfg: GNNConfig):
    """node_input: [N, d_feat] float or [N] int species ids."""
    dev = _device(params)
    x = torch.as_tensor(node_input).to(dev)
    if x.ndim == 1:
        x = F.one_hot(x.long(), cfg.n_species).float()
    else:
        x = x.float()
    C = cfg.d_hidden
    return {"s": x @ _val(params["embed"]),
            "v": torch.zeros((n_nodes, 3, C), dtype=torch.float32, device=dev),
            "t": torch.zeros((n_nodes, 5, C), dtype=torch.float32, device=dev)}


def _node_features(params, positions: Tensor, node_input, edges, cfg: GNNConfig):
    """The last block's features of every node (shared by the energy and the
    classifier readout)."""
    require_fp32_products(positions)
    N = positions.shape[0]
    segs = edge_segments(edges, N, positions.device)
    vec = gather(positions, segs[1]) - gather(positions, segs[0])
    r, u, T = edge_harmonics(vec)
    env = poly_cutoff(r, cfg.cutoff)
    # Padding edges (src == dst) and out-of-cutoff edges contribute nothing.
    live = ((segs[0].idx != segs[1].idx) & (r < cfg.cutoff)).float()
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff) * (env * live)[:, None]
    feats = init_features(params, node_input, N, cfg)
    for lp in params["layers"]:
        feats = layer_forward(lp, feats, segs, (rbf, u, T), cfg)
    return feats


def _positions(params, positions) -> Tensor:
    return torch.as_tensor(positions).to(device=_device(params), dtype=torch.float32)


def energy(params, positions, node_input, edges, cfg: GNNConfig, node_mask=None,
           node_graph=None, n_graphs: int = 1) -> Tensor:
    """Total potential energy (or per-graph energies [n_graphs] when batched).

    positions [N,3]; edges (src, dst) [E] (padded edges point at a node with
    src == dst, masked); node_graph: [N] graph id for packed batches.
    """
    feats = _node_features(params, _positions(params, positions), node_input, edges, cfg)
    e_node = (F.silu(feats["s"] @ _val(params["out_w1"])) @ _val(params["out_w2"]))[:, 0]
    if node_mask is not None:
        e_node = e_node * torch.as_tensor(node_mask).to(e_node.device, torch.float32)
    if node_graph is not None:
        seg = Segments(torch.as_tensor(node_graph).to(e_node.device), n_graphs)
        return segment_sum(e_node, seg)
    return torch.sum(e_node)


def energy_and_forces(params, positions, node_input, edges, cfg: GNNConfig, node_mask=None):
    """(E, F = -dE/dpos): the interatomic-potential interface.  F keeps its
    graph (for a further derivative) when a parameter requires grad."""
    graph = torch.is_grad_enabled() and any(
        _val(p).requires_grad for p in tree_leaves(params, is_leaf=is_param))
    pos = _positions(params, positions).detach().requires_grad_(True)
    with torch.enable_grad(), one_thread_backward():
        e = energy(params, pos, node_input, edges, cfg, node_mask)
        (g,) = torch.autograd.grad(e, pos, create_graph=graph)
    return (e if graph else e.detach()), -g


def loss_fn(params, batch: dict, cfg: GNNConfig, energy_weight: float = 1.0,
            force_weight: float = 10.0):
    """Huber energy + force matching loss (the potential-fitting recipe).

    batch: positions [N,3], node_input, edges (src, dst), targets energy [G]
    and forces [N,3], optional node_mask [N], node_graph [N], n_graphs.
    """
    n_graphs = batch.get("n_graphs", 1)
    dev = _device(params)
    pos = _positions(params, batch["positions"]).detach().requires_grad_(True)
    with torch.enable_grad(), one_thread_backward():
        e_graphs = energy(params, pos, batch["node_input"], batch["edges"], cfg,
                          batch.get("node_mask"), batch.get("node_graph"), n_graphs)
        (neg_f,) = torch.autograd.grad(torch.sum(e_graphs), pos, create_graph=True)
    forces = -neg_f

    def target(key):
        return torch.as_tensor(batch[key]).to(device=dev, dtype=torch.float32)

    e_loss = torch.mean(optax_huber(e_graphs - target("energy")))
    f_err = forces - target("forces")
    if batch.get("node_mask") is not None:
        mask = target("node_mask")
        f_err = f_err * mask[:, None]
        denom = torch.clamp_min(torch.sum(mask) * 3, 1.0)
    else:
        denom = f_err.numel()
    f_loss = torch.sum(optax_huber(f_err)) / denom
    loss = energy_weight * e_loss + force_weight * f_loss
    return loss, {"loss": loss, "e_loss": e_loss, "f_loss": f_loss}


def optax_huber(x: Tensor, delta: float = 1.0) -> Tensor:
    ax = torch.abs(x)
    return torch.where(ax <= delta, 0.5 * x * x, delta * (ax - 0.5 * delta))


def node_classifier_loss(params, batch: dict, cfg: GNNConfig, n_classes: int, head):
    """Node-classification readout (the Cora / ogb_products cells): softmax
    cross-entropy on the final scalars.  ``head``: [C, n_classes]."""
    logits = _node_logits(params, batch, cfg, head)
    dev = logits.device
    labels = torch.as_tensor(batch["labels"]).to(device=dev, dtype=torch.long)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    mask = batch.get("label_mask")
    if mask is not None:
        mask = torch.as_tensor(mask).to(device=dev, dtype=torch.float32)
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


def _node_logits(params, batch, cfg: GNNConfig, head):
    pos = _positions(params, batch["positions"])
    feats = _node_features(params, pos, batch["node_input"], batch["edges"], cfg)
    return feats["s"] @ _val(head)
