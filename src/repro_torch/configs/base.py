"""Architecture/shape registry plumbing.

Port of ``repro/configs/base.py``: the LM, GNN, recsys and kNN families.
Each architecture is an arch object with:

  * ``full_config()``  -- the published hyper-parameters;
  * ``smoke_config()`` -- a reduced config of the same family, small enough
    to train on the CPU;
  * ``shapes``         -- its input-shape cells (``Cell``; ``Skip`` with the
    reason for a cell an arch does not run);
  * ``abstract_params(cfg)`` -- its ``nn.Param`` tree on the meta device
    (shapes, dtypes and logical axes, nothing allocated);
  * ``init_params(cfg, generator=..., device=...)`` -- a drawn ``Param`` tree;
  * ``build(rules, shape, smoke=False)`` -- ``(fn, args)``: the step of the
    cell and its arguments as meta tensors (the train state, the batch,
    the KV cache);
  * ``smoke_batch(shape)`` -- real (small) data for integration tests.

The kNN family (``KNNArch``) has configs as dicts and no params; its
``build`` returns the multi-device solver of ``core.distributed`` for the
cell and its arguments.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.sharding import AxisRules


def pad_to(n: int, mult: int) -> int:
    return n + (-n) % mult


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode | serve | retrieval | allpairs
    params: dict


@dataclasses.dataclass(frozen=True)
class Skip:
    name: str
    reason: str

    @property
    def kind(self) -> str:
        return "skip"


def _spec(shape, dtype) -> torch.Tensor:
    """The port's ``jax.ShapeDtypeStruct``: a tensor on the meta device."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _cells(arch) -> dict:
    return {c.name: c for c in arch.shapes}


# ---------------------------------------------------------------------------
# LM family.
# ---------------------------------------------------------------------------

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


class LMArch:
    family = "lm"

    def __init__(self, arch_id: str, full_cfg: Callable, smoke_cfg: Callable,
                 *, subquadratic: bool, step_overrides: dict | None = None):
        self.id = arch_id
        self.full_config = full_cfg
        self.smoke_config = smoke_cfg
        self.subquadratic = subquadratic
        self.step_overrides = step_overrides or {}

    @property
    def shapes(self):
        cells = [
            Cell("train_4k", "train", dict(seq_len=4096, global_batch=256)),
            Cell("prefill_32k", "prefill", dict(seq_len=32768, global_batch=32)),
            Cell("decode_32k", "decode", dict(seq_len=32768, global_batch=128)),
        ]
        if self.subquadratic:
            cells.append(Cell("long_500k", "decode", dict(seq_len=524288, global_batch=1)))
        else:
            cells.append(Skip(
                "long_500k",
                "pure full attention: a 524288-token dense KV cache per "
                "sequence is the quadratic regime this shape excludes "
                "(DESIGN.md §Shape-cell notes); SWA archs run it instead",
            ))
        return cells

    def abstract_params(self, cfg):
        from repro_torch.models import transformer as Tr

        return Tr.abstract_params(cfg)

    def init_params(self, cfg, *, generator: torch.Generator | None = None, device="cuda"):
        """The ``Param`` tree drawn on ``device`` from ``generator`` (default:
        a fresh one seeded 0), each leaf in its dtype."""
        from repro_torch.models import transformer as Tr

        return Tr.init_params(cfg, generator=generator, device=device)

    def _cache_sds(self, cfg, batch: int, seq_len: int):
        from repro_torch.models import attention as A
        from repro_torch.models import transformer as Tr

        C = Tr.cache_capacity(cfg, seq_len)
        shape = (cfg.n_layers, batch, C, cfg.n_kv_heads, cfg.head_dim)
        return A.KVCache(k=_spec(shape, torch.bfloat16), v=_spec(shape, torch.bfloat16),
                         pos=_spec((batch,), torch.int32))

    def input_specs(self, shape_name: str, cfg=None) -> dict:
        cfg = cfg or self.full_config()
        cell = _cells(self)[shape_name]
        if not isinstance(cell, Cell):
            raise KeyError(f"{self.id}/{shape_name} is skipped: {cell.reason}")
        p = cell.params
        B, S = p["global_batch"], p["seq_len"]
        if cell.kind == "train":
            return {"tokens": _spec((B, S), torch.int32), "labels": _spec((B, S), torch.int32)}
        if cell.kind == "prefill":
            return {"tokens": _spec((B, S), torch.int32), "cache": self._cache_sds(cfg, B, S)}
        if cell.kind == "decode":
            return {"tokens": _spec((B,), torch.int32), "cache": self._cache_sds(cfg, B, S)}
        raise KeyError(cell.kind)

    def build(self, rules: AxisRules, shape_name: str, *, smoke: bool = False,
              step_config=None, variant: str | None = None):
        """``(fn, args)`` for one cell, ``args`` as meta tensors.  ``variant``:
        decode cells take ``"sp"`` (the sequence-parallel cache, the
        flash-decoding merge) or None (the cache's sequence whole).  The
        prefill and decode cells' values and cache are cut over ``rules``'
        mesh where it has more than one position (``sharding.shard_tree``),
        so their steps run sharded; a train cell runs whole."""
        from repro_torch.distributed import steps as ST
        from repro_torch.distributed.sharding import cache_shardings, shard_tree
        from repro_torch.models.nn import split_params

        cfg = self.smoke_config() if smoke else self.full_config()
        cell = _cells(self)[shape_name]
        if not isinstance(cell, Cell):
            raise KeyError(f"{self.id}/{shape_name} is skipped: {cell.reason}")
        specs = self._smoke_specs(cell, cfg) if smoke else self.input_specs(shape_name, cfg)
        abstract = self.abstract_params(cfg)
        values, _ = split_params(abstract)

        if cell.kind == "train":
            loss, baxes = ST.lm_loss(cfg)
            sc = step_config or ST.StepConfig(**self.step_overrides)
            _, jitted, _, optimizer = ST.make_train_step(loss, abstract, rules, baxes, sc)
            batch = {"tokens": specs["tokens"], "labels": specs["labels"]}
            return jitted(batch), (ST.init_state(optimizer, values), batch)
        # A serve cell's values and cache are cut over the mesh (their rule
        # table's specs, ``sharding.cache_shardings``) where it has more
        # than one position, so its step runs sharded.
        sharded = len(rules.mesh.devices) > 1
        sp = cell.kind == "decode" and variant == "sp"
        cache = specs["cache"]
        if sharded:
            values = shard_tree(values, ST.param_shardings(rules, abstract)[0])
            cache = shard_tree(cache, cache_shardings(rules, cache, sp))
        if cell.kind == "prefill":
            _, shard_for, _ = ST.make_lm_prefill_step(cfg, rules, abstract)
            return shard_for(specs["tokens"], cache), (values, specs["tokens"], cache)
        if cell.kind == "decode":
            _, shard_for, _ = ST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=sp)
            return shard_for(cache, specs["tokens"]), (values, cache, specs["tokens"])
        raise KeyError(cell.kind)

    def _smoke_specs(self, cell: Cell, cfg) -> dict:
        b, s = 4, 64
        if cell.kind == "train":
            return {"tokens": _spec((b, s), torch.int32), "labels": _spec((b, s), torch.int32)}
        if cell.kind == "prefill":
            return {"tokens": _spec((b, s), torch.int32), "cache": self._cache_sds(cfg, b, s)}
        return {"tokens": _spec((b,), torch.int32), "cache": self._cache_sds(cfg, b, s)}

    def smoke_batch(self, shape_name: str, seed: int = 0, *, device="cuda") -> dict:
        """``lm_batch(4, 64, vocab, seed)`` of the smoke config, as tensors on
        ``device``."""
        from repro_torch.data.synthetic import lm_batch
        from repro_torch.kernels._backend import resolve_device

        dev = resolve_device(device)
        cfg = self.smoke_config()
        return {k: torch.from_numpy(v.copy()).to(dev)
                for k, v in lm_batch(4, 64, cfg.vocab, seed, 0).items()}


# ---------------------------------------------------------------------------
# GNN family.
# ---------------------------------------------------------------------------


class GNNArch:
    family = "gnn"

    def __init__(self, arch_id: str, full_cfg: Callable, smoke_cfg: Callable):
        self.id = arch_id
        self.full_config = full_cfg
        self.smoke_config = smoke_cfg

    @property
    def shapes(self):
        # Edge counts padded to multiples of 512 (divides every mesh's DP
        # product); the model masks padding as self-loop edges.
        return [
            Cell("full_graph_sm", "train", dict(
                n_nodes=2708, n_edges=pad_to(10556, 512), d_feat=1433,
                n_classes=7, task="classify")),
            Cell("minibatch_lg", "train", dict(
                n_nodes=180224, n_edges=pad_to(168960, 512), d_feat=602,
                n_classes=41, task="classify", sampled=True)),
            Cell("ogb_products", "train", dict(
                n_nodes=2449029, n_edges=pad_to(61859140, 512), d_feat=100,
                n_classes=47, task="classify")),
            Cell("molecule", "train", dict(
                n_nodes=30 * 128, n_edges=pad_to(64 * 128, 512), batch=128,
                task="potential")),
        ]

    def _cfg_for(self, cell: Cell, smoke: bool):
        cfg = self.smoke_config() if smoke else self.full_config()
        if cell.params["task"] == "classify":
            cfg = dataclasses.replace(cfg, d_feat=16 if smoke else cell.params["d_feat"])
        return cfg

    def abstract_params(self, cfg, cell: Cell | None = None):
        return self.init_params(cfg, cell, device="meta")

    def init_params(self, cfg, cell: Cell | None = None, *,
                    generator: torch.Generator | None = None, device="cuda"):
        """The ``Param`` tree drawn on ``device`` from ``generator`` (default:
        a fresh one seeded 0), with a classifier head [C, n_classes] for a
        ``classify`` cell (drawn last)."""
        from repro_torch.models import gnn as G
        from repro_torch.models.nn import Param, lecun_init

        dev = torch.device(device)
        if dev.type != "meta" and generator is None:
            generator = torch.Generator(dev).manual_seed(0)
        params = G.init_params(cfg, generator=generator, device=dev)
        if cell is not None and cell.params["task"] == "classify":
            n_cls = cell.params["n_classes"]
            params = dict(params, cls_head=Param(
                lecun_init(generator, (cfg.d_hidden, n_cls), cfg.d_hidden, device=dev),
                ("tensor", None)))
        return params

    def input_specs(self, shape_name: str, cfg=None, smoke: bool = False) -> dict:
        p = _cells(self)[shape_name].params
        if smoke:
            N, E = 64, 512
            d_feat = 16
        else:
            N, E = p["n_nodes"], p["n_edges"]
            d_feat = p.get("d_feat", 0)
        i32, f32 = torch.int32, torch.float32
        base = {"positions": _spec((N, 3), f32),
                "edges": (_spec((E,), i32), _spec((E,), i32))}
        if p["task"] == "classify":
            base.update(node_input=_spec((N, d_feat), f32), labels=_spec((N,), i32),
                        label_mask=_spec((N,), f32))
        else:
            n_graphs = 4 if smoke else p.get("batch", 1)
            base.update(node_input=_spec((N,), i32), energy=_spec((n_graphs,), f32),
                        forces=_spec((N, 3), f32), node_graph=_spec((N,), i32))
        return base

    def build(self, rules: AxisRules, shape_name: str, *, smoke: bool = False,
              step_config=None, variant: str | None = None):
        """``(fn, args)``: the cell's train step and its arguments (the train
        state and the batch) as meta tensors."""
        from repro_torch.distributed import steps as ST
        from repro_torch.models.nn import split_params

        cell = _cells(self)[shape_name]
        cfg = self._cfg_for(cell, smoke)
        abstract = self.abstract_params(cfg, cell)
        specs = self.input_specs(shape_name, cfg, smoke=smoke)
        if cell.params["task"] == "classify":
            loss, baxes = ST.gnn_classifier_loss(cfg, cell.params["n_classes"])
        else:
            loss, baxes = ST.gnn_potential_loss(cfg, n_graphs=4 if smoke else cell.params["batch"])
        sc = step_config or ST.StepConfig()
        _, jitted, _, optimizer = ST.make_train_step(loss, abstract, rules, baxes, sc)
        values, _ = split_params(abstract)
        return jitted(specs), (ST.init_state(optimizer, values), specs)

    def smoke_batch(self, shape_name: str, seed: int = 0, *, device="cuda") -> dict:
        """Real small data for ``shape_name``, as tensors on ``device``: four
        packed molecules for ``molecule``, a random 64-node graph else."""
        from repro_torch.data.graphs import molecule_batch, random_graph
        from repro_torch.kernels._backend import resolve_device

        dev = resolve_device(device)

        def t(a):
            return tuple(t(x) for x in a) if isinstance(a, tuple) else torch.from_numpy(a).to(dev)

        cell = _cells(self)[shape_name]
        rng = np.random.default_rng(seed)
        if cell.params["task"] == "potential":
            mb = molecule_batch(4, 12, 100, n_species=8, seed=seed)
            return {k: t(v) for k, v in mb.items() if k != "n_graphs"}
        N, E = 64, 512
        g = random_graph(N, E, seed)
        src = np.repeat(np.arange(N), np.diff(g.indptr).astype(int)).astype(np.int32)
        return {k: t(v) for k, v in {
            "positions": rng.standard_normal((N, 3), np.float32) * 2,
            "edges": (src, g.indices.astype(np.int32)),
            "node_input": rng.standard_normal((N, 16), np.float32),
            "labels": rng.integers(0, cell.params["n_classes"], N).astype(np.int32),
            "label_mask": np.ones((N,), np.float32)}.items()}


# ---------------------------------------------------------------------------
# RecSys family.
# ---------------------------------------------------------------------------

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


class RecsysArch:
    family = "recsys"

    def __init__(self, arch_id: str, full_cfg: Callable, smoke_cfg: Callable):
        self.id = arch_id
        self.full_config = full_cfg
        self.smoke_config = smoke_cfg

    @property
    def shapes(self):
        cells = [
            Cell("train_batch", "train", dict(batch=65536)),
            Cell("serve_p99", "serve", dict(batch=512)),
            Cell("serve_bulk", "serve", dict(batch=262144)),
        ]
        if self.id == "two-tower-retrieval":
            cells.append(Cell("retrieval_cand", "retrieval",
                              dict(batch=1, n_candidates=1_000_000)))
        else:
            # Ranking models score the 10^6 candidates pointwise: a bulk
            # serve at batch = n_candidates (one user broadcast over items).
            cells.append(Cell("retrieval_cand", "serve",
                              dict(batch=1_000_000, broadcast_user=True)))
        return cells

    def _cell(self, shape_name: str) -> Cell:
        return {c.name: c for c in self.shapes}[shape_name]

    def _init_fn(self):
        from repro_torch.models import recsys as R

        return R.INIT_FNS[self.id]

    def abstract_params(self, cfg):
        return self._init_fn()(cfg, device="meta")

    def init_params(self, cfg, *, generator: torch.Generator | None = None, device="cuda"):
        """The ``Param`` tree drawn on ``device`` from ``generator`` (default:
        a fresh one seeded 0); ``jax.random`` cannot be replayed, so the
        values are the reference's distributions, not its numbers."""
        return self._init_fn()(cfg, generator=generator, device=device)

    def input_specs(self, shape_name: str, cfg=None, smoke: bool = False) -> dict:
        cfg = cfg or (self.smoke_config() if smoke else self.full_config())
        cell = self._cell(shape_name)
        B = 32 if smoke else cell.params["batch"]
        i32, f32 = torch.int32, torch.float32
        if cell.kind == "retrieval":
            n_cand = 4096 if smoke else cell.params["n_candidates"]
            return {"user": _spec((B, cfg.n_user_fields), i32),
                    "db": _spec((n_cand, cfg.tower_mlp[-1]), f32)}
        if self.id == "dlrm-rm2":
            s = {"dense": _spec((B, cfg.n_dense), f32), "sparse": _spec((B, cfg.n_sparse), i32)}
        elif self.id == "xdeepfm":
            s = {"sparse": _spec((B, cfg.n_sparse), i32)}
        elif self.id == "bst":
            s = {"hist": _spec((B, cfg.seq_len - 1), i32), "target": _spec((B,), i32),
                 "others": _spec((B, cfg.n_other), i32)}
        else:  # two-tower
            s = {"user": _spec((B, cfg.n_user_fields), i32),
                 "item": _spec((B, cfg.n_item_fields), i32)}
        if cell.kind == "train" and self.id != "two-tower-retrieval":
            s["labels"] = _spec((B,), f32)
        return s

    def build(self, rules: AxisRules, shape_name: str, *, smoke: bool = False,
              step_config=None, variant: str | None = None):
        """``(fn, args)`` for one cell: ``fn`` the cell's step
        (``distributed.steps``), ``args`` its arguments as meta tensors, the
        state (or the values) cut over ``rules``' mesh by its rule table
        (``sharding.shard_tree``) where the mesh has more than one position,
        so ``fn`` runs sharded.  A caller that runs the step builds its own
        state and batch of those shapes (``init_params``,
        ``steps.init_state``, ``smoke_batch``)."""
        from repro_torch.distributed import steps as ST
        from repro_torch.distributed.sharding import shard_tree
        from repro_torch.models.nn import split_params

        cfg = self.smoke_config() if smoke else self.full_config()
        cell = self._cell(shape_name)
        abstract = self.abstract_params(cfg)
        specs = self.input_specs(shape_name, cfg, smoke=smoke)
        values, _ = split_params(abstract)
        sharded = len(rules.mesh.devices) > 1
        p_shard, _ = ST.param_shardings(rules, abstract)

        def placed(tree, shardings):
            return shard_tree(tree, shardings) if sharded else tree

        if cell.kind == "train":
            loss, baxes = ST.recsys_loss(self.id, cfg)
            sc = step_config or ST.StepConfig()
            _, jitted, st_shard, optimizer = ST.make_train_step(loss, abstract, rules, baxes, sc)
            return jitted(specs), (placed(ST.init_state(optimizer, values), st_shard), specs)
        if cell.kind == "serve":
            if self.id == "two-tower-retrieval":
                from repro_torch.distributed.sharding import axis_rules
                from repro_torch.models import recsys as R

                def dot(values, batch):  # bulk/online scoring: the two towers' dot
                    u = R.user_embedding(values, batch["user"])
                    v = R.item_embedding(values, batch["item"])
                    return torch.sum(u * v, dim=-1)

                def score(values, batch):
                    if ST.is_sharded_tree(values):
                        return ST.sharded_rows(dot, values, batch, rules,
                                               ST.recsys_loss(self.id, cfg)[1])
                    with torch.no_grad(), axis_rules(rules):
                        return dot(values, batch)

                return score, (placed(values, p_shard), specs)
            _, shard_for, _ = ST.make_recsys_serve_step(self.id, cfg, rules, abstract)
            return shard_for(specs), (placed(values, p_shard), specs)
        if cell.kind == "retrieval":
            _, shard_for, _ = ST.make_retrieval_step(cfg, rules, abstract,
                                                     k=min(100, specs["db"].shape[0]))
            return (shard_for(specs["user"], specs["db"]),
                    (placed(values, p_shard), specs["user"], specs["db"]))
        raise KeyError(cell.kind)

    def smoke_batch(self, shape_name: str, seed: int = 0, *, device="cuda") -> dict:
        """A batch of 32 rows of the smoke config for ``shape_name``, as
        tensors on ``device``."""
        from repro_torch.data.synthetic import recsys_batch
        from repro_torch.kernels._backend import resolve_device

        dev = resolve_device(device)
        b = recsys_batch(self.id, 32, self.smoke_config(), seed=seed)
        if self._cell(shape_name).kind != "train":
            b.pop("labels", None)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


# ---------------------------------------------------------------------------
# The paper's own workload (kNN all-pairs / retrieval service).
# ---------------------------------------------------------------------------


class KNNArch:
    """The paper's k-nearest-vector problem as a first-class config."""

    family = "knn"

    def __init__(self, arch_id: str = "knn-paper"):
        self.id = arch_id

    def full_config(self):
        return dict(d=256, k=100, distance="sqeuclidean")

    def smoke_config(self):
        return dict(d=32, k=8, distance="sqeuclidean")

    @property
    def shapes(self):
        return [
            Cell("allpairs_160k", "allpairs", dict(n=160_000)),  # paper Table 1 max
            Cell("allpairs_2m", "allpairs", dict(n=2_097_152)),  # beyond-paper scale
            Cell("query_1m", "query", dict(m=8192, n=1_048_576)),
        ]

    def build(self, rules: AxisRules, shape_name: str, *, smoke: bool = False,
              step_config=None, variant: str | None = None):
        """``(fn, args)``: the cell's solver over ``rules.mesh`` and its
        arguments, the vectors as meta tensors.  ``allpairs``: the ring
        (``variant`` None, or ``"bf16wire"`` for its bf16 payload) or the
        paper's zigzag triangle (``"triangle"``), ``fn(x, n)``; ``query``:
        queries over the DP axes, the database over "model", on the port's
        ``"fused"`` scan (the reference's plain ``"jnp"`` is the port's
        ``"torch"``), ``fn(q, db, n)``."""
        from repro_torch.core import distributed as KD

        cfg = self.smoke_config() if smoke else self.full_config()
        cell = _cells(self)[shape_name]
        mesh = rules.mesh
        P = int(np.prod(list(mesh.shape.values())))
        if cell.kind == "allpairs":
            n = 256 if smoke else cell.params["n"]
            n_pad = pad_to(n, P)
            if variant == "triangle":
                # The paper's layout: the dataset all-gathered, the zigzag
                # triangle schedule, the log-P butterfly heap merge; n
                # re-padded to gsize * nGrids with nGrids = 2P.
                gsize = max(128, pad_to(-(-n // (2 * P)), 128))
                n_pad = gsize * 2 * P
                fn = KD.make_triangle_allpairs(mesh, k=cfg["k"], gsize=gsize,
                                               distance=cfg["distance"])
            else:
                fn = KD.make_ring_allpairs(
                    mesh, k=cfg["k"], distance=cfg["distance"],
                    wire_dtype=torch.bfloat16 if variant == "bf16wire" else None)
            return fn, (_spec((n_pad, cfg["d"]), torch.float32), n)
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        m = 64 if smoke else cell.params["m"]
        n = 1024 if smoke else cell.params["n"]
        fn = KD.make_query_sharded(mesh, query_axis=dp if len(dp) > 1 else dp[0],
                                   db_axis="model", k=cfg["k"], distance=cfg["distance"],
                                   impl="fused")
        return fn, (_spec((m, cfg["d"]), torch.float32), _spec((n, cfg["d"]), torch.float32), n)

    def smoke_batch(self, shape_name: str, seed: int = 0, *, device="cuda") -> torch.Tensor:
        """256 clustered vectors of the smoke config's width, on ``device``."""
        from repro_torch.data.synthetic import clustered_vectors
        from repro_torch.kernels._backend import resolve_device

        cfg = self.smoke_config()
        return torch.from_numpy(clustered_vectors(256, cfg["d"], seed=seed)).to(
            resolve_device(device))
