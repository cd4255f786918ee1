"""Train and serve step factories, one family of losses and steps each.

Port of ``repro/distributed/steps.py``: ``TrainState``, ``StepConfig``
(field for field), the optimizer choice, ``init_state``, gradient
accumulation over micro-batches, ``make_train_step``, ``lm_loss``,
``recsys_loss``, ``gnn_potential_loss``, ``gnn_classifier_loss``,
``make_lm_decode_step`` (with its sequence-parallel variant),
``make_lm_prefill_step``, ``make_recsys_serve_step`` and
``make_retrieval_step``.

The reference jits each step with shardings derived from the logical axes.
Here a step is a Python function over the params' tensors, eager, updating
them in place, and the factories keep the reference's return shape, so its
callers read the same: ``_, jitted, _, opt = make_train_step(...)``, ``fn =
jitted(batch)``, ``state, metrics = fn(state, batch)``.

A step runs whole or sharded, by its state.  A state of tensors (on one
device) runs whole, as a step of the port always has: the same ops, the
same bits.  A state of ``sharding.Sharded`` leaves (``sharding.shard_tree``
by ``state_shardings``: every leaf cut by the rule table's specs of its
logical axes, one at a time) runs sharded over the rules' mesh, a body a position
(``distributed.spmd``): the batch is cut over the mesh axes of its
``"batch"`` dimension (``recsys_loss``'s batch axes, ``batch_axes`` here),
each position computes on its own blocks, and the model moves data between
positions where a split dimension meets a whole one (``models.recsys``).
The serve steps take sharded values alike and return whole results: the
recommender's (``sharded_rows``) and the language models' prefill and
decode (``sharded_serve``: a ``Sharded`` KV cache, cut by
``sharding.cache_shardings``, written in place on its positions).

Gradients.  Every leaf whose logical axes hold ``"table"`` is an embedding
table; the forward sees it as a ``models.recsys.RowTap``, so its gradient
comes back as one row per lookup and is summed per id
(``train.optim.coalesce_rows``) into a ``RowGrad``: no table-sized
gradient is ever made.  The dense leaves are differentiated by
``torch.autograd`` as usual.  With ``micro_batches`` > 1 the batch's
leading axis is cut into that many slices (an array whose leading axis does
not divide is passed whole, as the reference does); the loss, metrics and
gradients are the slices' means, so the two-tower loss takes an in-batch
softmax within each slice.  Sharded, micro-batch i is the global batch's
rows i B/n ... (i+1) B/n (the reference's ``dynamic_slice_in_dim`` on the
global batch), then cut over the positions; each position's backward is
seeded with 1/P (``spmd``'s docstring), a dense leaf's shares are summed
over its replicas (``optim.sum_replicas``) and a table block's looked-up
rows merged over its replicas (``optim.merge_row_grads``); the clip counts
each block once (``optim.clip_sharded``), and every position applies the
update to its parts, so the replicas stay byte-equal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.segments import one_thread_backward
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import AxisRules, Sharded, Sharding, axis_rules
from repro_torch.models.nn import is_param, split_params, tree_leaves, tree_map
from repro_torch.train import optim as O


class TrainState(NamedTuple):
    params: Any  # value tree (tensors), updated in place by each step
    opt: O.OptState


@dataclasses.dataclass(frozen=True)
class StepConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    micro_batches: int = 1  # gradient accumulation over the batch dim
    # Embedding tables ("table" logical axis) get ROW-WISE ADAGRAD instead
    # of AdamW: one scalar of state a row, and untouched rows never move
    # (train.optim.mixed_table_adamw).
    table_rowwise: bool = True


def table_mask(abstract_params):
    """A bool tree: which leaves are embedding tables (``"table"`` in their axes)."""
    _, axes = split_params(abstract_params)
    return tree_map(lambda ax: isinstance(ax, tuple) and "table" in ax, axes,
                    is_leaf=lambda x: isinstance(x, tuple))


def _make_optimizer(sc: StepConfig, abstract_params=None) -> O.Optimizer:
    if sc.optimizer != "adamw":
        return O.sgdm()
    if sc.table_rowwise and abstract_params is not None:
        is_table = table_mask(abstract_params)
        if any(tree_leaves(is_table)):
            return O.mixed_table_adamw(is_table, weight_decay=sc.weight_decay)
    return O.adamw(weight_decay=sc.weight_decay)


def param_shardings(rules: AxisRules, abstract_params):
    """(a ``Sharding`` tree, the value tree) of a ``Param`` tree."""
    values, axes = split_params(abstract_params)
    return tree_map(lambda v, ax: rules.sharding(ax, tuple(v.shape)), values, axes), values


def state_shardings(rules: AxisRules, abstract_params) -> TrainState:
    p_shard, _ = param_shardings(rules, abstract_params)
    return TrainState(params=p_shard,
                      opt=O.OptState(step=Sharding(rules.mesh, ()), m=p_shard, v=p_shard))


def init_state(optimizer: O.Optimizer, params) -> TrainState:
    """The train state of ``params`` (a ``Param`` tree, its values, or its
    values as ``Sharded`` leaves: the moments then sharded alike)."""
    if any(is_param(leaf) for leaf in tree_leaves(params, is_leaf=is_param)):
        params, _ = split_params(params)
    if is_sharded_tree(params):
        return TrainState(params=params, opt=O.init_sharded(optimizer, params))
    return TrainState(params=params, opt=optimizer.init(params))


def is_sharded_tree(tree) -> bool:
    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], Sharded)


def _slice_batch(batch: dict, i: int, n: int) -> dict:
    def cut(x):
        shape = getattr(x, "shape", ())
        if len(shape) >= 1 and shape[0] % n == 0:
            mb = shape[0] // n
            return x[i * mb : (i + 1) * mb]
        return x

    return {k: cut(v) for k, v in batch.items()}


def _batch_shardings(batch: dict, rules: AxisRules, batch_axes: dict) -> dict:
    """Each batch array's ``Sharding`` by its logical axes (the reference's
    ``batch_sharding_of``); a key without axes, or a scalar, whole."""
    out = {}
    for k, x in batch.items():
        shape = tuple(getattr(x, "shape", ()))
        ax = tuple(batch_axes.get(k) or ())[: len(shape)]
        out[k] = rules.sharding(ax + (None,) * (len(shape) - len(ax)), shape)
    return out


def _rows_axes(shardings: dict, batch_axes: dict) -> tuple[str, ...]:
    """The mesh axes the batch's rows are split over (() whole)."""
    for k, s in shardings.items():
        if (batch_axes.get(k) or (None,))[0] == "batch" and s.spec:
            return s.dim_axes(0)
    return ()


def _local_batch(batch: dict, shardings: dict, mesh) -> dict:
    """Each array's block on each position, as a body's ``Local`` (copied
    on the position's stream)."""
    out = {}
    for k, x in batch.items():
        if x is None:
            out[k] = None
            continue
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
        s = shardings[k]
        parts = []
        for p in range(len(mesh.devices)):
            with mesh.on(p):
                parts.append(spmd.plain(t[s.index(p, t.shape)] if t.ndim else t, p, mesh))
        out[k] = spmd.Local(parts)
    return out


def _first_blocks(x: spmd.Local, axes, mesh) -> list:
    """The first replica of each block along ``axes`` of a body's value, in
    order, copied to position 0."""
    group = mesh.groups(axes)[0] if axes else [0]
    return [x.parts[group[0]]] + [mesh.copy(x.parts[q], q, 0) for q in group[1:]]


def _gather_rows(x: spmd.Local, axes, mesh) -> torch.Tensor:
    """A body's per-position result rows as the whole, on position 0."""
    got = _first_blocks(x, axes, mesh)
    if len(got) == 1:
        return got[0]
    with mesh.on(0):
        return torch.cat(got)


def _global_mean(x: spmd.Local, axes, mesh) -> torch.Tensor:
    """The mean over the batch's blocks of a value each block computes
    (a loss share, a metric), added in order on position 0."""
    got = _first_blocks(x, axes, mesh)
    if len(got) == 1:
        return got[0]
    with mesh.on(0):
        acc = got[0]
        for t in got[1:]:
            acc = acc + t
        return acc * (1.0 / len(got))


def _body_values(params):
    """The params as a body sees them: each ``Sharded`` leaf a ``Local`` of
    its parts (its ``Sharding`` beside them)."""
    return tree_map(lambda v: spmd.Local(v.parts, v.sharding), params)


def sharded_rows(fn, values, batch: dict, rules: AxisRules, batch_axes: dict) -> torch.Tensor:
    """``fn(values, batch)`` (one result row a batch row, no gradient) run
    as a body over the rules' mesh on ``Sharded`` values: the rows cut by
    ``batch_axes``, each position on its block and its shards, the whole
    result on position 0."""
    mesh = rules.mesh
    shardings = _batch_shardings(batch, rules, batch_axes)
    axes = _rows_axes(shardings, batch_axes)
    with torch.no_grad(), spmd.body(mesh, axes), axis_rules(rules):
        out = fn(_body_values(values), _local_batch(batch, shardings, mesh))
        return _gather_rows(out, axes, mesh)


def sharded_loss_and_grads(loss_fn, params, batch: dict, is_table, rules: AxisRules,
                           batch_axes: dict, n_micro: int = 1):
    """``loss_and_grads`` of a ``Sharded`` value tree over the rules' mesh
    (module docstring): ((loss, metrics) on position 0, grads), the grads a
    tree of ``Sharded`` leaves, a table's parts ``RowGrad`` values in its
    blocks' numbering."""
    from repro_torch.models.recsys import RowTap

    mesh = rules.mesh
    P = len(mesh.devices)
    live = []  # the dense leaves, as Locals of parts that require grad

    def wrap(v, tab):
        if tab:
            return None
        d = spmd.Local([t.detach().requires_grad_() for t in v.parts], v.sharding)
        live.append((v, d))
        return d

    live_tree = tree_map(wrap, params, is_table)
    acc = [[None] * P for _ in live]
    lookups = None  # per table: per position (ids, gradient rows) of every slice
    loss_sum, metrics_sum, axes = None, {}, ()
    for i in range(n_micro):
        mb = _slice_batch(batch, i, n_micro) if n_micro > 1 else batch
        shardings = _batch_shardings(mb, rules, batch_axes)
        axes = _rows_axes(shardings, batch_axes)
        taps = []

        def tap(v, tab, d):
            if not tab:
                return d
            taps.append(RowTap(spmd.Local(v.parts, v.sharding)))
            return taps[-1]

        values = tree_map(tap, params, is_table, live_tree)
        with spmd.body(mesh, axes), axis_rules(rules):
            loss, metrics = loss_fn(values, _local_batch(mb, shardings, mesh))
        rows = [r.parts[p] for t in taps for r in t.rows for p in range(P)]
        dense = [d.parts[p] for _, d in live for p in range(P)]
        seeds = [torch.full_like(x, 1.0 / P) for x in loss.parts]
        with one_thread_backward():
            gs = torch.autograd.grad(loss.parts, dense + rows, grad_outputs=seeds,
                                     allow_unused=True)
        with mesh.scope():
            for j, (_, d) in enumerate(live):
                for p in range(P):
                    with mesh.on(p):
                        g = gs[j * P + p]
                        g = torch.zeros_like(d.parts[p]) if g is None else g
                        acc[j][p] = g if acc[j][p] is None else acc[j][p] + g
            if lookups is None:
                lookups = [[([], []) for _ in range(P)] for _ in taps]
            g_rows = iter(gs[len(dense):])
            for per_pos, t in zip(lookups, taps):
                for k, r in enumerate(t.rows):
                    for p in range(P):
                        with mesh.on(p):
                            ids, g = t.ids[k].parts[p], next(g_rows)
                            g = (torch.zeros_like(r.parts[p]) if g is None else g
                                 ).reshape(len(ids), -1)
                            hit = None if t.hits[k] is None else t.hits[k].parts[p]
                            if hit is not None and ids.device.type != "meta":
                                ids, g = ids[hit], g[hit]  # its own rows only
                            per_pos[p][0].append(ids)
                            per_pos[p][1].append(g)
        loss_sum = ([x.detach() for x in loss.parts] if loss_sum is None else
                    [a + x.detach() for a, x in zip(loss_sum, loss.parts)])
        for k, m in metrics.items():
            m = [x.detach() for x in m.parts]
            metrics_sum[k] = m if k not in metrics_sum else [a + b for a, b in
                                                            zip(metrics_sum[k], m)]
    inv = 1.0 / n_micro
    scale = (lambda x: x) if n_micro == 1 else (lambda x: x * inv)
    with mesh.scope():
        dense_g = []
        for (v, _), parts in zip(live, acc):
            scaled = []
            for p, g in enumerate(parts):
                with mesh.on(p):
                    scaled.append(scale(g))
            dense_g.append(O.sum_replicas(Sharded(v.sharding, v.shape, scaled)))
        table_leaves = [v for v, tab in zip(tree_leaves(params), tree_leaves(is_table)) if tab]
        tables = []
        for v, per_pos in zip(table_leaves, lookups or []):
            cat = []
            for p, (ids, grads) in enumerate(per_pos):
                with mesh.on(p):
                    cat.append((torch.cat(ids), torch.cat(grads)))
            rg = O.merge_row_grads(v, [c[0] for c in cat], [c[1] for c in cat])
            parts = []
            for p, g in enumerate(rg.parts):
                with mesh.on(p):
                    parts.append(O.RowGrad(g.ids, scale(g.rows)))
            tables.append(Sharded(v.sharding, v.shape, parts))
        loss = _global_mean(spmd.Local(loss_sum), axes, mesh)
        metrics = {k: _global_mean(spmd.Local(m), axes, mesh) for k, m in metrics_sum.items()}
        with mesh.on(0):
            loss, metrics = scale(loss), {k: scale(m) for k, m in metrics.items()}
    it_t, it_d = iter(tables), iter(dense_g)
    grads = tree_map(lambda v, tab: next(it_t) if tab else next(it_d), params, is_table)
    return (loss, metrics), grads


def loss_and_grads(loss_fn, values, batch: dict, is_table, n_micro: int = 1):
    """((loss, metrics), grads) of ``loss_fn(values, batch)``, averaged over
    ``n_micro`` slices of the batch.  ``grads`` has ``values``' structure:
    a tensor for a dense leaf, a ``RowGrad`` for a table (``is_table``)."""
    from repro_torch.models.recsys import RowTap

    dense = []  # the dense leaves, as tensors that require grad, in traversal order

    def wrap(v, tab):
        if tab:
            return None
        d = v.detach().requires_grad_()
        dense.append(d)
        return d

    live = tree_map(wrap, values, is_table)
    acc_dense = [None] * len(dense)
    lookups: list[tuple[list, list]] = []  # per table: (ids, gradient rows) of every slice
    loss_sum, metrics_sum = None, {}
    for i in range(n_micro):
        taps = []

        def tap(v, tab, d):
            if not tab:
                return d
            taps.append(RowTap(v))
            return taps[-1]

        loss, metrics = loss_fn(tree_map(tap, values, is_table, live),
                                _slice_batch(batch, i, n_micro) if n_micro > 1 else batch)
        rows = [r for t in taps for r in t.rows]
        with one_thread_backward():
            gs = torch.autograd.grad(loss, dense + rows, allow_unused=True)
        for j, (d, g) in enumerate(zip(dense, gs[: len(dense)])):
            g = torch.zeros_like(d) if g is None else g
            acc_dense[j] = g if acc_dense[j] is None else acc_dense[j] + g
        if not lookups:
            lookups = [([], []) for _ in taps]
        g_rows = iter(gs[len(dense):])
        for (ids, grads), t in zip(lookups, taps):
            for lk in t.ids:
                ids.append(lk)
                grads.append(next(g_rows).reshape(len(lk), -1))
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
        for k, m in metrics.items():
            m = m.detach()
            metrics_sum[k] = m if k not in metrics_sum else metrics_sum[k] + m
    inv = 1.0 / n_micro
    scale = (lambda x: x) if n_micro == 1 else (lambda x: x * inv)
    tables = iter([O.RowGrad(rg.ids, scale(rg.rows)) for rg in
                   (O.coalesce_rows(torch.cat(ids), torch.cat(grads)) for ids, grads in lookups)])
    dense_g = iter([scale(g) for g in acc_dense])
    grads = tree_map(lambda v, tab: next(tables) if tab else next(dense_g), values, is_table)
    return (scale(loss_sum), {k: scale(m) for k, m in metrics_sum.items()}), grads


def make_train_step(
    loss_fn: Callable[[Any, Any], tuple[torch.Tensor, dict]],
    abstract_params,
    rules: AxisRules,
    batch_axes: dict[str, tuple],
    sc: StepConfig,
):
    """A train step for ``loss_fn(values, batch) -> (loss, metrics)``.

    Returns ``(step, jitted, state_shardings, optimizer)``;
    ``step(state, batch) -> (state, metrics)`` updates the params and the
    optimizer state in place, whole or sharded by the state (module
    docstring; ``sharding.shard_tree(state, state_shardings)`` cuts a
    whole one).
    Its two halves are ``step.grads(state, batch) -> ((loss, metrics),
    grads)`` (forward and backward) and ``step.update(state, grads,
    metrics) -> (state, metrics)`` (the clip, the schedule and the
    optimizer); ``step`` is the one then the other.  ``jitted(batch)``
    returns ``step``.
    """
    optimizer = _make_optimizer(sc, abstract_params)
    schedule = O.warmup_cosine(sc.peak_lr, sc.warmup_steps, sc.total_steps)
    st_shard = state_shardings(rules, abstract_params)
    is_table = table_mask(abstract_params)

    def grads_of(state: TrainState, batch):
        if is_sharded_tree(state.params):
            return sharded_loss_and_grads(loss_fn, state.params, batch, is_table, rules,
                                          batch_axes, sc.micro_batches)
        with axis_rules(rules):
            return loss_and_grads(loss_fn, state.params, batch, is_table, sc.micro_batches)

    def update(state: TrainState, grads, metrics: dict):
        sharded = is_sharded_tree(state.params)
        if sc.grad_clip > 0:
            if sharded:
                with rules.mesh.scope():
                    grads, gnorm = O.clip_sharded(grads, sc.grad_clip)
            else:
                grads, gnorm = O.clip_by_global_norm(grads, sc.grad_clip)
            metrics = dict(metrics, grad_norm=gnorm)
        lr = schedule(state.opt.step)
        if sharded:
            with rules.mesh.scope():
                new_p, new_opt = O.update_sharded(optimizer, grads, state.opt, state.params, lr)
        else:
            new_p, new_opt = optimizer.update(grads, state.opt, state.params, lr)
        return TrainState(new_p, new_opt), dict(metrics, lr=lr)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        (_, metrics), grads = grads_of(state, batch)
        return update(state, grads, metrics)

    step.grads, step.update = grads_of, update

    def jitted(batch_example):
        return step

    return step, jitted, st_shard, optimizer


# ---------------------------------------------------------------------------
# The loss closures + batch axes.
# ---------------------------------------------------------------------------


def lm_loss(cfg):
    """Next-token cross entropy of the transformer (``models.transformer.loss_fn``)."""
    from repro_torch.models import transformer as Tr

    def loss(values, batch):
        return Tr.loss_fn(values, batch, cfg)

    axes = {"tokens": ("batch", None), "labels": ("batch", None),
            "loss_mask": ("batch", None)}
    return loss, axes


def gnn_potential_loss(cfg, n_graphs: int = 1):
    """NequIP's energy + force loss (``models.gnn.loss_fn``) over ``n_graphs``
    packed graphs; the GNN has no tables, so every leaf is dense."""
    from repro_torch.models import gnn as G

    def loss(values, batch):
        # n_graphs is a segment count: a closure constant, not batch data.
        return G.loss_fn(values, dict(batch, n_graphs=n_graphs), cfg)

    axes = {"positions": (None, None), "node_input": (None,), "edges": ("batch",),
            "forces": (None, None), "energy": (None,), "node_graph": (None,),
            "node_mask": (None,)}
    return loss, axes


def gnn_classifier_loss(cfg, n_classes: int):
    """Node classification on the last block's scalars, head ``cls_head``."""
    from repro_torch.models import gnn as G

    def loss(values, batch):
        body = {k: v for k, v in values.items() if k != "cls_head"}
        l = G.node_classifier_loss(body, batch, cfg, n_classes, values["cls_head"])
        return l, {"loss": l}

    axes = {"positions": (None, None), "node_input": (None, None), "edges": ("batch",),
            "labels": (None,), "label_mask": (None,)}
    return loss, axes


def recsys_loss(arch: str, cfg):
    from repro_torch.models import recsys as R

    if arch == "two-tower-retrieval":
        def loss(values, batch):
            return R.two_tower_loss(values, batch, cfg)
        axes = {"user": ("batch", None), "item": ("batch", None), "logq": ("batch",)}
        return loss, axes

    logit_fn = R.LOGIT_FNS[arch]

    def loss(values, batch):
        return R.bce_loss(logit_fn(values, batch, cfg), batch["labels"])

    axes = {"dense": ("batch", None), "sparse": ("batch", None),
            "hist": ("batch", None), "target": ("batch",),
            "others": ("batch", None), "labels": ("batch",)}
    return loss, axes


# ---------------------------------------------------------------------------
# Serve steps.
# ---------------------------------------------------------------------------


def _body_cache(cache):
    """A ``Sharded`` KV cache as a body sees it: each leaf a ``Local`` of its
    parts (written in place) with its ``Sharding``."""
    return type(cache)(*(spmd.Local(s.parts, s.sharding) for s in cache))


def sharded_serve(fn, values, cache, tokens, rules: AxisRules):
    """``fn(values, cache, tokens) -> (logits [B, V], cache)`` (a prefill or
    a decode step of ``models.transformer``) as a body over the rules'
    mesh on ``Sharded`` values and a ``Sharded`` cache
    (``sharding.cache_shardings``): the tokens' rows cut as the cache's
    batch, each position on its blocks of the params and of the cache,
    the cache's parts written in place; the whole logits on position 0."""
    mesh = rules.mesh
    axes = cache.k.sharding.dim_axes(1)
    t = tokens if isinstance(tokens, torch.Tensor) else torch.as_tensor(tokens)
    ts = rules.sharding(("batch",) + (None,) * (t.ndim - 1), tuple(t.shape))
    if ts.dim_axes(0) != axes:
        raise ValueError(f"tokens {tuple(t.shape)} split over {ts.dim_axes(0)}, the cache's "
                         f"batch over {axes}")
    with torch.no_grad(), spmd.body(mesh, axes, symmetric=True), axis_rules(rules):
        local = _local_batch({"tokens": t}, {"tokens": ts}, mesh)["tokens"]
        logits, _ = fn(_body_values(values), _body_cache(cache), local)
        return _gather_rows(logits, axes, mesh), cache


def make_lm_decode_step(cfg, rules: AxisRules, abstract_params, seq_parallel: bool = False):
    """One-token decode against a (ring) KV cache: the decode_* cells.

    Returns ``(step, shardings_for, param_shardings)``;
    ``step(values, cache, tokens) -> (logits [B, V], cache)`` writes the
    cache in place (``models.transformer.decode_step``), and
    ``shardings_for(cache, tokens)`` returns the step for that cache.

    Sharded: ``values`` by ``param_shardings`` and ``cache`` by
    ``sharding.cache_shardings(rules, cache, seq_parallel)`` (``Sharded``
    leaves, ``sharding.shard_tree``; the cache's cut, not the flag, decides
    where its slots lie), the step runs as a body over the rules' mesh
    (``sharded_serve``): each position holds its blocks of the
    params (heads, KV heads, FFN columns, experts and vocabulary over
    "model", ``"fsdp"`` dimensions over the data axes, gathered a layer at
    a time) and of the cache (its batch rows over the data axes, its KV
    heads over "model"; with ``seq_parallel`` its range of the slots over
    "model" instead, resident there: each position writes the new token
    where its slot lies in its range and runs ``flash_mlo`` over its own
    slots, and the (m, l, o) merge exactly, ``attention.mlo_merge``, as the
    reference's ``pmax`` and two ``psum``s).  The logits come back whole
    on the first position.

    Whole (tensors on one device): the step of the port's whole model;
    with ``seq_parallel`` each "model" position of ``rules.mesh`` takes a
    range of the caller's cache's slots (C / model of them; C must
    divide), the batch rows split over the DP axes ("pod", "data") where
    the batch divides, as the reference's ``bspec``, runs ``flash_mlo``
    over them (``cache_positions_range`` with its offset), and the partial
    (m, l, o) are copied (``Mesh.copy``) to the group's first position and
    merged there (``attention.mlo_merge``), then normalized.
    """
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as Tr

    p_shard, _ = param_shardings(rules, abstract_params)
    mesh = rules.mesh

    def make_sp_attn(batch: int, capacity: int):
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        n_dp = math.prod(mesh.shape[a] for a in dp)
        split = bool(dp) and batch % n_dp == 0
        c_loc = capacity // mesh.shape["model"]
        groups = mesh.groups("model")
        blocks = [mesh.index_along(g[0], dp) if split else 0 for g in groups]
        first = [blocks.index(b) == j for j, b in enumerate(blocks)]
        nb = batch // n_dp if split else batch

        def body(q, ck, cv, pos):
            outs = {}
            with mesh.scope():
                for group, b, keep in zip(groups, blocks, first):
                    if not keep:  # the same block's copy on another DP setting
                        continue
                    rows = slice(b * nb, (b + 1) * nb)
                    parts = []
                    for r, p in enumerate(group):
                        slots = slice(r * c_loc, (r + 1) * c_loc)
                        with mesh.on(p):
                            q_l, pos_l = mesh.put(q[rows], p), mesh.put(pos[rows], p)
                            ck_l = mesh.put(ck[rows, slots], p)
                            cv_l = mesh.put(cv[rows, slots], p)
                            k_pos, k_valid = A.cache_positions_range(pos_l + 1, capacity,
                                                                     r * c_loc, c_loc)
                            parts.append(A.flash_mlo(
                                q_l, ck_l, cv_l, q_pos=pos_l[:, None], k_pos=k_pos,
                                window=cfg.sliding_window, k_valid=k_valid,
                                kv_chunk=min(cfg.kv_chunk, c_loc),
                                logits_soft_cap=cfg.logits_soft_cap))
                    dst = group[0]
                    moved = [parts[0]] + [tuple(mesh.copy(t, p, dst) for t in part)
                                          for p, part in zip(group[1:], parts[1:])]
                    with mesh.on(dst):
                        outs[b] = A.mlo_normalize(*A.mlo_merge(moved), q.dtype)
            return torch.cat([outs[b].to(q.device) for b in sorted(outs)])

        return body

    def decode(values, cache, tokens):
        return Tr.decode_step(values, cache, tokens, cfg)

    def step_with(attn_fn):
        def step(values, cache, tokens):
            if isinstance(cache.k, Sharded):
                return sharded_serve(decode, values, cache, tokens, rules)
            with axis_rules(rules):
                return Tr.decode_step(values, cache, tokens, cfg, attn_fn=attn_fn)
        step.attn_fn = attn_fn  # the step's attention override (None: the plain step)
        return step

    def shardings_for(cache_example, tokens_example):
        if seq_parallel:
            n_model = mesh.shape["model"]
            if cache_example.k.shape[2] % n_model:
                raise ValueError(f"a cache of {cache_example.k.shape[2]} slots does not split "
                                 f"over {n_model} 'model' positions")
        if not seq_parallel or isinstance(cache_example.k, Sharded):
            return step_with(None)
        return step_with(make_sp_attn(cache_example.k.shape[1], cache_example.k.shape[2]))

    return step_with(None), shardings_for, p_shard


def make_lm_prefill_step(cfg, rules: AxisRules, abstract_params):
    """Full-prompt prefill: the prefill_* cells.  ``step(values, tokens,
    cache) -> (last-token logits, cache)``, the cache filled in place;
    ``shardings_for(tokens, cache)`` returns it.  Sharded values and a
    ``Sharded`` cache run it as a body (``sharded_serve``), the prompts'
    rows cut as the cache's batch, each position filling its parts of the
    cache (either of ``make_lm_decode_step``'s cuts)."""
    from repro_torch.models import transformer as Tr

    p_shard, _ = param_shardings(rules, abstract_params)

    def prefill(values, cache, tokens):
        return Tr.prefill(values, tokens, cfg, cache)

    def step(values, tokens, cache):
        if isinstance(cache.k, Sharded):
            return sharded_serve(prefill, values, cache, tokens, rules)
        with axis_rules(rules):
            return Tr.prefill(values, tokens, cfg, cache)

    def shardings_for(tokens_example, cache_example):
        return step

    return step, shardings_for, p_shard


def make_recsys_serve_step(arch: str, cfg, rules: AxisRules, abstract_params):
    """``(step, shardings_for, param_shardings)``; ``step(values, batch)`` is
    the click probability of each row, ``shardings_for(batch)`` returns it.
    ``values`` whole, or ``Sharded`` (``param_shardings``): then the rows
    are cut over the batch's mesh axes, each position scores its block on
    its shards, and the whole [B] comes back on position 0."""
    from repro_torch.models import recsys as R

    p_shard, _ = param_shardings(rules, abstract_params)
    if arch == "two-tower-retrieval":
        raise ValueError("use make_retrieval_step for two-tower serving")
    logit_fn = R.LOGIT_FNS[arch]
    _, batch_axes = recsys_loss(arch, cfg)

    def probs(values, batch):
        return torch.sigmoid(logit_fn(values, batch, cfg))

    def step(values, batch):
        if is_sharded_tree(values):
            return sharded_rows(probs, values, batch, rules, batch_axes)
        with torch.no_grad(), axis_rules(rules):
            return probs(values, batch)

    def shardings_for(batch_example):
        return step

    return step, shardings_for, p_shard


def make_retrieval_step(cfg, rules: AxisRules, abstract_params, *, k: int = 100,
                        impl: str = "fused"):
    """The two-tower ``retrieval_cand`` cell: embed the users with the user
    tower, then score the candidates on the kNN engine
    (``core.distributed.make_query_sharded`` over the rules' mesh, the
    candidates sharded over the "table" axis, the users replicated,
    ``neg_dot``) and keep the top ``k``.

    ``step(values, user_ids [Q, n_user_fields], db [n, E])`` returns
    (scores [Q, k], candidate rows [Q, k]), scores the dot products (the
    engine's negated distances).  ``values`` may be the trained towers'
    ``Sharded`` leaves: the users are embedded over the mesh, each position
    on its shards, before the scan.  ``impl`` defaults to the port's
    ``"fused"`` (the ``fused_knn`` kernel on the card), where the
    reference's defaults to its plain ``"jnp"``.
    """
    from repro_torch.core import distributed as KD
    from repro_torch.models import recsys as R

    p_shard, _ = param_shardings(rules, abstract_params)
    db_axes = rules.rules.get("table", ("model",))
    db_axis = db_axes[0] if db_axes else "model"
    knn = KD.make_query_sharded(rules.mesh, query_axis=(), db_axis=db_axis, k=k,
                                distance="neg_dot", impl=impl)

    def step(values, user_ids, db):
        with torch.no_grad():
            if is_sharded_tree(values):  # the query tower on the towers' shards,
                # the users replicated, as the reference's
                u = sharded_rows(lambda v, b: R.user_embedding(v, b["user"]), values,
                                 {"user": user_ids}, rules, {})
            else:
                with axis_rules(rules):
                    u = R.user_embedding(values, user_ids)  # [Q, E]
            n_db = db.shape[0]
            db = KD.pad_rows_to(db.to(u.device), rules.mesh.shape[db_axis])
            res = knn(u, db, n_db)
        return -res.distances, res.indices

    def shardings_for(user_example, db_example):
        return step

    return step, shardings_for, p_shard
