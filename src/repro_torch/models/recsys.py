"""RecSys substrate: embedding lookups and bags, and the four recommender models.

Port of ``repro/models/recsys.py``:

  * ``dlrm``      -- bottom MLP on the dense features, one table lookup per
                    sparse field, the dot self-interaction of the
                    [n_sparse + 1, D] features (upper triangle), top MLP;
  * ``xdeepfm``   -- CIN (compressed interaction network) over the field
                    embeddings + a DNN + a linear term, summed into one logit;
  * ``bst``       -- Behavior Sequence Transformer: item + position
                    embeddings, post-LN encoder blocks over the session,
                    concatenated with the side fields into an MLP;
  * ``two_tower`` -- user and item MLP towers into one unit-norm space, dot
                    scoring, in-batch sampled softmax with logQ correction;
                    retrieval serves on the kNN engine
                    (``serving.service``, ``distributed.steps``).

Params are plain dicts and lists in the reference's layout.  ``init_dlrm``,
``init_xdeepfm``, ``init_bst`` and ``init_two_tower_params`` return trees of
``nn.Param`` (a tensor and its logical axes, the reference's axes);
``init_two_tower`` returns the towers' values alone, as the serving side
takes them.  ``params_from_reference`` carries a reference init across
(numpy leaves); ``param_leaves`` lists a tree's tensors in the reference's
``jax.tree.leaves`` order.  Every function here reads a leaf through
``_val``, so it takes a ``Param`` tree or a value tree alike.

Training lookups.  Inside a train step (``distributed.steps``) each table
leaf is a ``RowTap``: ``embedding_lookup`` gathers the rows into a fresh
tensor that autograd differentiates and records the ids, so the backward
pass yields one gradient row per lookup, which the step sums per id
(``train.optim.coalesce_rows``).  The table never enters the autograd
graph and no table-sized gradient exists.

Sharded steps.  Inside a body (``distributed.spmd``) the values are
``Local`` values, one part a position, and the parameters' parts are their
blocks by the rule table (``distributed.sharding``).  Where a split
dimension meets a whole one the model moves data between positions, in the
reference's plan (its docstring): a row-sharded table is looked up by a
masked local gather and an all-reduce over its axes (``embedding_lookup``);
a column-split layer's output is gathered before the next layer
(``apply_mlp``, the CIN's maps in ``xdeepfm_logits``); BST's attention runs
on each position's heads and its row-split output projection and second
feed-forward layer are summed (``_bst_block``); the two-tower loss gathers
the item embeddings over the batch's axes before its [B, B] logits
(``two_tower_loss``).  Outside a body none of this runs: the same ops as a
whole step.

The products are IEEE fp32: on the card ``apply_mlp`` raises while the
process lets cuBLAS use TF32 rather than switch it (every model runs an
MLP).  The CIN's contraction is written out as one product of the
[B * D, H_prev * F] outer products with the [H, H_prev * F] weights
(``cin_layer``), the cheapest order there is; its [B, D, H_prev, F]
operand is the step's largest transient, which is why xDeepFM trains its
full batch in micro-batches (``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.segments import group_sums
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels._backend import resolve_device
from repro_torch.models.nn import (
    Param,
    apply_layernorm,
    is_param,
    layernorm_params,
    lecun_init,
    n_params as _n_params,
    normal_init,
    require_fp32_products,
    split_params,
    tree_leaves,
    tree_map,
)

Tensor = torch.Tensor


def _val(p):
    return p.value if is_param(p) else p


def _tensor(x):
    """``torch.as_tensor(x)``; a tensor or a body's ``Local`` as it is."""
    return x if isinstance(x, (torch.Tensor, spmd.Local)) else torch.as_tensor(x)


def default_table_sizes(n: int, lo: int = 10_000, hi: int = 40_000_000) -> list[int]:
    """Deterministic Criteo-like skewed size mix (a few huge, many small),
    each rounded up to a multiple of 1024, as the reference's."""
    out = []
    for i in range(n):
        # log-spaced with a deterministic scramble, heaviest first
        f = ((i * 2654435761) % 997) / 997.0
        s = int(lo * (hi / lo) ** ((1.0 - f) ** 2))
        out.append(s + (-s) % 1024)
    return out


def _device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def _generator(generator, dev):
    if generator is None and dev.type != "meta":
        return torch.Generator(dev).manual_seed(0)
    return generator


# ---------------------------------------------------------------------------
# Embedding lookups.
# ---------------------------------------------------------------------------


class RowTap:
    """A table inside a train step's forward (module docstring): each lookup
    gathers its rows into a new leaf that requires grad and records the ids
    beside it; ``table`` stays out of the autograd graph.  In a body
    (``table`` a ``Local``) each lookup records, a position each, the ids in
    the position's own row numbering, the gathered rows, and which of them
    are its own (``hits``, None where the table is whole): a position's
    gradient rows are its own rows' (``_sharded_lookup``)."""

    def __init__(self, table):
        self.table = table
        self.ids: list = []
        self.rows: list = []
        self.hits: list = []

    def lookup(self, ids: Tensor) -> Tensor:
        rows = self.table[ids].requires_grad_()
        self.ids.append(ids.reshape(-1))
        self.rows.append(rows)
        return rows


def init_table(n_rows: int, dim: int, *, generator=None, device="cuda") -> Param:
    dev = _device(device)
    return Param(normal_init(_generator(generator, dev), (n_rows, dim), 1.0 / dim ** 0.5,
                             device=dev), ("table", None))


def embedding_lookup(table, ids) -> Tensor:
    """Single-valued lookup: ids ``[...]`` -> ``[..., D]`` (int64 offsets, so
    a table past 2^31 elements is read whole).  In a body, the row-sharded
    lookup (``_sharded_lookup``)."""
    t = _val(table)
    base = t.table if isinstance(t, RowTap) else t
    if isinstance(base, spmd.Local):
        return _sharded_lookup(base, ids, t if isinstance(t, RowTap) else None)
    ids = torch.as_tensor(ids).to(device=base.device, dtype=torch.long)
    return t.lookup(ids) if isinstance(t, RowTap) else base[ids]


def _sharded_lookup(table: spmd.Local, ids, tap: RowTap | None):
    """The reference's model-parallel lookup (its docstring): each position
    gathers the ids that fall in its block of rows, in its own numbering,
    zeroes the rest, and the blocks' rows are summed over the table's row
    axes (``spmd.all_reduce``).  Each looked-up row is one position's row
    plus zeros: bit-equal to the whole lookup.  A whole (replicated) table
    is gathered on every position."""
    mesh = spmd.current().mesh
    axes = spmd.split_axes(table, 0)
    R = table.parts[0].shape[0]
    outs = []
    ids_l, rows_l, hits_l = [], [], []
    for p, part in enumerate(table.parts):
        with mesh.on(p):
            idp = _pick_part(ids, p, mesh).to(device=part.device, dtype=torch.long)
            hit = None
            if axes:
                idp = idp - mesh.index_along(p, axes) * R
                idx = idp.clamp(0, R - 1)
                hit = idx == idp
                rows = part[idx]
            else:
                rows = part[idp]
            if tap is not None:
                rows.requires_grad_()
                ids_l.append(idp.reshape(-1))
                rows_l.append(rows)
                hits_l.append(None if hit is None else hit.reshape(-1))
            outs.append(rows if hit is None else torch.where(hit[..., None], rows, 0.0))
    if tap is not None:
        tap.ids.append(spmd.Local(ids_l))
        tap.rows.append(spmd.Local(rows_l))
        tap.hits.append(None if not axes else spmd.Local(hits_l))
    return spmd.all_reduce(spmd.Local(outs), axes)


def _pick_part(x, p: int, mesh):
    if isinstance(x, spmd.Local):
        return x.parts[p]
    return spmd.plain(torch.as_tensor(x), p, mesh)


def embedding_bag(table, ids, bag_ids, n_bags: int, weights=None, mode: str = "sum") -> Tensor:
    """Multi-valued pooled lookup (torch's ``EmbeddingBag``): ids [nnz] row
    indices, bag_ids [nnz] the bag of each (sorted or not); returns
    [n_bags, D].  ``mode``: sum | mean.  The bags are summed in an order set
    by ``bag_ids`` (``core.segments.group_sums``), never by atomics."""
    rows = embedding_lookup(table, ids)
    bag_ids = _tensor(bag_ids).to(device=rows.device, dtype=torch.long)
    if weights is not None:
        rows = rows * _tensor(weights).to(rows.device, rows.dtype)[:, None]
    out, cnt = group_sums(rows, bag_ids, n_bags)
    if mode == "mean":
        out = out / torch.clamp_min(cnt.to(out.dtype), 1.0)[:, None]
    return out


# ---------------------------------------------------------------------------
# MLPs (the recsys towers are plain ReLU stacks).
# ---------------------------------------------------------------------------


def init_mlp(sizes: Sequence[int], *, generator=None, device="cuda", hidden_axis="tensor"):
    """``[{"w": Param [in, out], "b": Param [out]}, ...]``: w N(0, 1/fan_in),
    b zero; the hidden layers' output axis ``hidden_axis``, the last's None."""
    dev = _device(device)
    g = _generator(generator, dev)
    layers = []
    for i in range(len(sizes) - 1):
        ax_out = hidden_axis if i < len(sizes) - 2 else None
        layers.append({"w": Param(lecun_init(g, (sizes[i], sizes[i + 1]), sizes[i], device=dev),
                                  (None, ax_out)),
                       "b": Param(torch.zeros(sizes[i + 1], device=dev), (ax_out,))})
    return layers


def apply_mlp(layers, x: Tensor, act=torch.relu, final_act=None) -> Tensor:
    """``x @ w + b`` per layer, ``act`` between layers, ``final_act`` after
    the last.  In a body, a column-split layer's output is gathered whole
    before the next layer (``spmd.gather_split``).

    On the card the products must be IEEE fp32: this raises while the
    process lets cuBLAS use TF32 (``nn.require_fp32_products``).
    """
    require_fp32_products(x)
    for i, layer in enumerate(layers):
        x = torch.addmm(_val(layer["b"]), x, _val(layer["w"]))
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
        x = spmd.gather_split(x, _val(layer["w"]), 1, -1)
    return x


def _dense_input(x, like: Tensor) -> Tensor:
    return _tensor(x).to(device=like.device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# DLRM (arXiv:1906.00091, RM2 scale).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    table_sizes: tuple[int, ...] = ()  # len == n_sparse; configs fill this

    def sizes(self) -> tuple[int, ...]:
        if self.table_sizes:
            assert len(self.table_sizes) == self.n_sparse
            return self.table_sizes
        return tuple(default_table_sizes(self.n_sparse))


def init_dlrm(cfg: DLRMConfig, *, generator=None, device="cuda"):
    dev = _device(device)
    g = _generator(generator, dev)
    n_feat = cfg.n_sparse + 1
    n_inter = n_feat * (n_feat - 1) // 2
    return {
        "tables": [init_table(s, cfg.embed_dim, generator=g, device=dev) for s in cfg.sizes()],
        "bot": init_mlp((cfg.n_dense,) + tuple(cfg.bot_mlp), generator=g, device=dev),
        "top": init_mlp((n_inter + cfg.embed_dim,) + tuple(cfg.top_mlp), generator=g,
                        device=dev),
    }


def dlrm_logits(params, batch, cfg: DLRMConfig) -> Tensor:
    """batch: dense [B, 13] float, sparse [B, 26] int (one id per field)."""
    w0 = _val(params["bot"][0]["w"])
    x_bot = apply_mlp(params["bot"], _dense_input(batch["dense"], w0))  # [B, D]
    sparse = _tensor(batch["sparse"]).to(device=w0.device, dtype=torch.long)
    embs = [embedding_lookup(t, sparse[:, i]) for i, t in enumerate(params["tables"])]
    feats = constrain(torch.stack([x_bot] + embs, dim=1), ("batch", None, None))  # [B, F, D]
    inter = torch.bmm(feats, feats.transpose(1, 2))  # the dot interaction
    iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], offset=1, device=w0.device)
    top_in = torch.cat([inter[:, iu, ju], x_bot], dim=-1)  # [B, F(F-1)/2 + D]
    return apply_mlp(params["top"], top_in)[:, 0]


# ---------------------------------------------------------------------------
# xDeepFM (arXiv:1803.05170).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    n_sparse: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp: tuple[int, ...] = (400, 400)
    table_sizes: tuple[int, ...] = ()

    def sizes(self):
        if self.table_sizes:
            assert len(self.table_sizes) == self.n_sparse
            return self.table_sizes
        return tuple(default_table_sizes(self.n_sparse, hi=10_000_000))


def init_xdeepfm(cfg: XDeepFMConfig, *, generator=None, device="cuda"):
    dev = _device(device)
    g = _generator(generator, dev)
    F_ = cfg.n_sparse
    tables = [init_table(s, cfg.embed_dim, generator=g, device=dev) for s in cfg.sizes()]
    lin = [Param(normal_init(g, (s, 1), 0.01, device=dev), ("table", None))
           for s in cfg.sizes()]
    cin, h_prev = [], F_
    for h in cfg.cin_layers:
        cin.append(Param(lecun_init(g, (h, h_prev, F_), h_prev * F_, device=dev),
                         ("tensor", None, None)))
        h_prev = h
    return {
        "tables": tables,
        "lin_tables": lin,
        "cin": cin,
        "mlp": init_mlp((F_ * cfg.embed_dim,) + tuple(cfg.mlp) + (1,), generator=g, device=dev),
        "out_cin": Param(lecun_init(g, (sum(cfg.cin_layers), 1), sum(cfg.cin_layers),
                                    device=dev), (None, None)),
        "bias": Param(torch.zeros((), device=dev), ()),
    }


def cin_layer(xs: Tensor, x0: Tensor, w: Tensor) -> Tensor:
    """One CIN layer: ``out[b,h,d] = sum_{i,j} w[h,i,j] xs[b,i,d] x0[b,j,d]``
    (``jnp.einsum("bid,bjd,hij->bhd")``) as the outer products
    [B, D, H_prev, F] times ``w`` reshaped [H, H_prev * F]: one product, no
    [B, H, H_prev, D] or [B, H, F, D] operand."""
    B, Hp, D = xs.shape
    H = w.shape[0]
    z = xs.transpose(1, 2)[:, :, :, None] * x0.transpose(1, 2)[:, :, None, :]  # [B, D, Hp, F]
    out = z.reshape(B * D, Hp * x0.shape[1]) @ w.reshape(H, -1).T  # [B * D, H]
    return out.reshape(B, D, H).transpose(1, 2)


def xdeepfm_logits(params, batch, cfg: XDeepFMConfig) -> Tensor:
    """batch: sparse [B, 39] int.  logit = linear + CIN + DNN + bias."""
    bias = _val(params["bias"])
    sparse = _tensor(batch["sparse"]).to(device=bias.device, dtype=torch.long)
    x0 = torch.stack([embedding_lookup(t, sparse[:, i])
                      for i, t in enumerate(params["tables"])], dim=1)  # [B, F, D]
    x0 = constrain(x0, ("batch", None, None))
    lin = sum(embedding_lookup(t, sparse[:, i])[:, 0]
              for i, t in enumerate(params["lin_tables"]))  # first-order term
    xs, pooled = x0, []
    for wk in params["cin"]:
        xs = constrain(cin_layer(xs, x0, _val(wk)), ("batch", "tensor", None))
        xs = spmd.gather_split(xs, _val(wk), 0, 1)  # a body's maps, split on "tensor"
        pooled.append(xs.sum(-1))  # [B, H]
    cin_out = torch.cat(pooled, dim=-1) @ _val(params["out_cin"])  # [B, 1]
    dnn = apply_mlp(params["mlp"], x0.reshape(x0.shape[0], -1))  # [B, 1]
    return lin + cin_out[:, 0] + dnn[:, 0] + bias


# ---------------------------------------------------------------------------
# BST: Behavior Sequence Transformer (arXiv:1905.06874).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    mlp: tuple[int, ...] = (1024, 512, 256)
    n_items: int = 4_000_000
    n_other: int = 8  # side-feature fields (user profile / context)
    other_sizes: tuple[int, ...] = ()

    def sizes(self):
        if self.other_sizes:
            return self.other_sizes
        return tuple(default_table_sizes(self.n_other, hi=1_000_000))


def init_bst(cfg: BSTConfig, *, generator=None, device="cuda"):
    dev = _device(device)
    g = _generator(generator, dev)
    D = cfg.embed_dim

    def w(shape, fan_in, axes):
        return Param(lecun_init(g, shape, fan_in, device=dev), axes)

    items = init_table(cfg.n_items, D, generator=g, device=dev)
    pos = Param(normal_init(g, (cfg.seq_len, D), 0.02, device=dev), (None, None))
    others = [init_table(s, D, generator=g, device=dev) for s in cfg.sizes()]
    blocks = [{
        "wq": w((D, D), D, (None, "tensor")),
        "wk": w((D, D), D, (None, "tensor")),
        "wv": w((D, D), D, (None, "tensor")),
        "wo": w((D, D), D, ("tensor", None)),
        "ln1": layernorm_params(D, device=dev),
        "ln2": layernorm_params(D, device=dev),
        "ff1": w((D, 4 * D), D, (None, "tensor")),
        "ff2": w((4 * D, D), 4 * D, ("tensor", None)),
    } for _ in range(cfg.n_blocks)]
    # seq_len counts the session including the target item (paper Fig. 1):
    # hist is [B, seq_len - 1], the target appended as the last position.
    mlp_in = cfg.seq_len * D + cfg.n_other * D
    return {"items": items, "pos": pos, "others": others, "blocks": blocks,
            "mlp": init_mlp((mlp_in,) + tuple(cfg.mlp) + (1,), generator=g, device=dev)}


def _bst_block(bp, x: Tensor, n_heads: int) -> Tensor:
    """Post-LN encoder block over [B, S, D] (no causal mask: session
    attention).  In a body, ``wq``/``wk``/``wv``/``ff1`` may be column-split
    and ``wo``/``ff2`` row-split: each position attends over its own heads
    (gathered first where a column block would cut a head in two) and the
    row-split products are summed (``spmd.row_split_matmul``)."""
    B, S, D = x.shape
    hd = D // n_heads
    wq, wk, wv = _val(bp["wq"]), _val(bp["wk"]), _val(bp["wv"])
    q, k, v = x @ wq, x @ wk, x @ wv
    if q.shape[-1] % hd:
        q, k, v = (spmd.gather_split(t, w, 1, -1) for t, w in ((q, wq), (k, wk), (v, wv)))
    Dl = q.shape[-1]
    h = Dl // hd
    q, k, v = (t.reshape(B, S, h, hd) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    a = torch.softmax(s.float(), dim=-1).to(x.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, S, Dl)
    x = apply_layernorm(bp["ln1"], x + spmd.row_split_matmul(o, _val(bp["wo"])))
    ff1 = _val(bp["ff1"])
    hidden = torch.relu(x @ ff1)
    if spmd.split_axes(ff1, 1) != spmd.split_axes(_val(bp["ff2"]), 0):
        hidden = spmd.gather_split(hidden, ff1, 1, -1)
    ff = spmd.row_split_matmul(hidden, _val(bp["ff2"]))
    return apply_layernorm(bp["ln2"], x + ff)


def bst_logits(params, batch, cfg: BSTConfig) -> Tensor:
    """batch: hist [B, S-1] item ids, target [B], others [B, n_other]."""
    pos = _val(params["pos"])
    ids = lambda key: _tensor(batch[key]).to(device=pos.device, dtype=torch.long)  # noqa: E731
    seq_ids = torch.cat([ids("hist"), ids("target")[:, None]], dim=1)  # [B, S]
    x = constrain(embedding_lookup(params["items"], seq_ids) + pos[None], ("batch", None, None))
    for bp in params["blocks"]:
        x = _bst_block(bp, x, cfg.n_heads)
    others = ids("others")
    side = [embedding_lookup(t, others[:, i]) for i, t in enumerate(params["others"])]
    flat = torch.cat([x.reshape(x.shape[0], -1)] + side, dim=-1)
    return apply_mlp(params["mlp"], flat)[:, 0]


# ---------------------------------------------------------------------------
# Two-tower retrieval (YouTube/RecSys'19-style sampled softmax).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    n_user_fields: int = 6
    n_item_fields: int = 4
    user_sizes: tuple[int, ...] = ()
    item_sizes: tuple[int, ...] = ()
    feat_dim: int = 64  # per-field embedding dim fed to the towers
    temperature: float = 0.05

    def u_sizes(self):
        return self.user_sizes or tuple(default_table_sizes(self.n_user_fields, hi=50_000_000))

    def i_sizes(self):
        return self.item_sizes or tuple(default_table_sizes(self.n_item_fields, hi=10_000_000))


def init_two_tower_params(cfg: TwoTowerConfig, *, generator=None, device="cuda"):
    """The towers' initial ``Param`` tree, drawn on ``device`` from
    ``generator`` in the order user tables, item tables, user MLP, item MLP
    (``init_two_tower`` gives its values)."""
    dev = _device(device)
    g = _generator(generator, dev)
    return {
        "user_tables": [init_table(s, cfg.feat_dim, generator=g, device=dev)
                        for s in cfg.u_sizes()],
        "item_tables": [init_table(s, cfg.feat_dim, generator=g, device=dev)
                        for s in cfg.i_sizes()],
        "user_mlp": init_mlp((cfg.n_user_fields * cfg.feat_dim,) + tuple(cfg.tower_mlp),
                             generator=g, device=dev),
        "item_mlp": init_mlp((cfg.n_item_fields * cfg.feat_dim,) + tuple(cfg.tower_mlp),
                             generator=g, device=dev),
    }


def init_two_tower(cfg: TwoTowerConfig, *, generator: torch.Generator | None = None,
                   device="cuda") -> dict:
    """The towers' initial values, drawn on ``device`` from ``generator``.

    Tables N(0, 1/feat_dim), MLP weights N(0, 1/fan_in), biases zero: the
    reference's distributions (``models/nn.py``'s ``normal_init`` and
    ``lecun_init``).  ``generator`` is a ``torch.Generator`` on ``device``'s
    type (default: a fresh one seeded 0); it cannot replay ``jax.random``,
    so the values differ from the reference's (carry those across with
    ``params_from_reference``).  ``device="meta"`` gives the shapes with no
    allocation.
    """
    return split_params(init_two_tower_params(cfg, generator=generator, device=device))[0]


def _tower(tables, mlp, ids) -> Tensor:
    ids = _tensor(ids).to(device=_val(mlp[0]["w"]).device, dtype=torch.long)
    x = torch.cat([embedding_lookup(t, ids[:, i]) for i, t in enumerate(tables)], dim=-1)
    x = apply_mlp(mlp, x)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def user_embedding(params, user_ids) -> Tensor:
    """``[B, n_user_fields]`` ids -> ``[B, embed]`` unit rows."""
    return _tower(params["user_tables"], params["user_mlp"], user_ids)


def item_embedding(params, item_ids) -> Tensor:
    """``[B, n_item_fields]`` ids -> ``[B, embed]`` unit rows."""
    return _tower(params["item_tables"], params["item_mlp"], item_ids)


def two_tower_loss(params, batch, cfg: TwoTowerConfig):
    """In-batch sampled softmax with logQ correction.

    batch: user [B, n_user_fields], item [B, n_item_fields], optional logq
    [B] (the sampling log-probability of each in-batch item).

    In a body whose batch rows are split, each position's rows score every
    item of the global batch: the item embeddings (and ``logq``) are
    gathered over the batch's axes, and a row's label is its global row.
    """
    u = constrain(user_embedding(params, batch["user"]), ("batch", None))  # [B, E]
    v = item_embedding(params, batch["item"])  # [B, E]
    logq = batch.get("logq")
    axes = spmd.batch_axes()
    if axes:
        v = spmd.all_gather(v, 0, axes)
        if logq is not None:
            logq = spmd.all_gather(_dense_input(logq, u), 0, axes)
    logits = (u @ v.T) / cfg.temperature  # [B, B] ([B / n, B] on a position)
    if logq is not None:
        logits = logits - _dense_input(logq, u)[None, :]
    labels = torch.arange(u.shape[0], device=u.device)
    cols = labels
    if axes:
        mesh, b = spmd.current().mesh, u.shape[0]
        cols = spmd.per_position(lambda p: torch.arange(
            b, device=mesh.devices[p]) + b * mesh.index_along(p, axes))
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = torch.mean(-logp[labels, cols])
    acc = torch.mean((torch.argmax(logits, -1) == cols).float())
    return loss, {"loss": loss, "in_batch_acc": acc}


# ---------------------------------------------------------------------------
# Pointwise CTR loss shared by dlrm / xdeepfm / bst.
# ---------------------------------------------------------------------------


def bce_loss(logits: Tensor, labels):
    """Numerically stable binary cross entropy from logits."""
    x = logits.float()
    y = _dense_input(labels, x)
    nll = -(y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    loss = torch.mean(nll)
    return loss, {"loss": loss}


LOGIT_FNS = {
    "dlrm-rm2": dlrm_logits,
    "xdeepfm": xdeepfm_logits,
    "bst": bst_logits,
}

INIT_FNS = {
    "dlrm-rm2": init_dlrm,
    "xdeepfm": init_xdeepfm,
    "bst": init_bst,
    "two-tower-retrieval": init_two_tower_params,
}


# ---------------------------------------------------------------------------
# Crossing from the reference, and the reference's leaf order.
# ---------------------------------------------------------------------------


def params_from_reference(values, *, device="cuda"):
    """A reference value tree (``split_params(init_*(...))[0]`` with numpy
    leaves, any of the four models) as the port's values on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), values)


def param_leaves(params) -> list[Tensor]:
    """The tensors in the reference's ``jax.tree.leaves`` order: dict keys
    sorted, lists in order; for the towers

        item_mlp[i].b, item_mlp[i].w (i = 0, 1, ...), item_tables[j],
        user_mlp[i].b, user_mlp[i].w, user_tables[j].
    """
    return [_val(p) for p in tree_leaves(params, is_leaf=is_param)]


def n_params(params) -> int:
    return _n_params(params)
