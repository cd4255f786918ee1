"""Optimizers and LR schedules over trees of tensors, with row-sparse table gradients.

Port of ``repro/train/optim.py``.  An optimizer's state mirrors the
parameter tree; ``update(grads, state, params, lr)`` writes the new
parameters and moments IN PLACE (under ``torch.no_grad()``) and returns
``(params, state)`` with the same tensors, so a step never holds a second
copy of a table.

Table gradients travel as rows (``RowGrad``): the sorted, unique ids a
step looked up and each one's summed gradient.  The reference's autodiff
hands its optimizer a dense, scatter-added gradient as large as the table;
at the two-tower model's full width that is a second 44.5 GB tensor beside
the tables, more than the card holds.  A ``RowGrad`` is the same gradient
with its zero rows left out, so every rule here gives the reference's
result from it:

* ``mixed_table_adamw`` (row-wise Adagrad on tables) reads and writes the
  touched rows only: untouched rows get ``acc += 0`` and ``p -= 0`` in the
  reference, i.e. nothing;
* ``adamw`` and ``sgdm`` decay their moments over the whole table and add
  the rows' terms where the ids point, which is the dense formula with the
  zero rows' ``+ 0`` left out;
* ``global_norm`` sums the squares of the summed rows, which is the dense
  gradient's norm (duplicates of a row are summed before they are squared:
  ``coalesce_rows``).

``coalesce_rows`` sums a row's duplicates in an order fixed by the ids
alone (one stable sort, then ``core.segments.segment_sums``), never by
atomics, so two runs on the card give the same bytes.

Sharded steps (``distributed.steps`` over a mesh; ``distributed.spmd``).
A position's gradient of a block is its share, and the block's is the sum
of the shares over the positions that hold it: ``sum_replicas`` adds a
dense leaf's over its replicas (the data all-reduce of a replicated
weight), ``merge_row_grads`` a table block's ``RowGrad`` values (an all-gather
of ids and rows, then ``coalesce_rows``: never densified), each summed
once and copied, so every replica holds the same bytes.
``clip_sharded`` counts each distinct block once in the global norm, and an
optimizer updates each position's parts (``update_sharded``), every
replica alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import distributed as KD
from repro_torch.core.segments import segment_sums
from repro_torch.distributed.sharding import Sharded, part_tree, zip_parts
from repro_torch.launch import hlo_stats
from repro_torch.models.nn import tree_leaves, tree_map

Tensor = torch.Tensor


class RowGrad:
    """A table's gradient as rows: ``ids`` int64 [U], sorted and unique, and
    ``rows`` [U, D], the summed gradient of each; every other row's is 0."""

    __slots__ = ("ids", "rows")

    def __init__(self, ids: Tensor, rows: Tensor):
        self.ids, self.rows = ids, rows

    def __repr__(self):
        return f"RowGrad(rows={tuple(self.rows.shape)})"


def coalesce_rows(ids: Tensor, rows: Tensor) -> RowGrad:
    """Per-lookup gradients (``ids`` [N], ``rows`` [N, D]) as a ``RowGrad``:
    each id's rows summed, in an order fixed by the ids (module docstring)."""
    sorted_ids, order = torch.sort(ids.long(), stable=True)
    if ids.device.type == "meta":
        # A dry run's trace: the unique ids' count depends on their values,
        # so take its static ceiling, every lookup an id of its own (the
        # most rows a step can touch).
        uniq, cnt = sorted_ids, torch.ones_like(sorted_ids)
    else:
        uniq, cnt = torch.unique_consecutive(sorted_ids, return_counts=True)
    return RowGrad(uniq, segment_sums(rows[order], cnt))


class OptState(NamedTuple):
    step: int  # updates applied so far
    m: Any  # first-moment tree (adamw), momentum (sgdm), row accumulators (tables)
    v: Any  # second-moment tree, or None (sgdm)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], OptState]
    update: Callable[[Any, OptState, Any, Any], tuple[Any, OptState]]
    # update(grads, state, params, lr) -> (params, state), written in place


def _zeros_like_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _bias_corrections(b1: float, b2: float, step: int) -> tuple[float, float]:
    t = np.float32(step)
    return float(np.float32(1) - np.float32(b1) ** t), float(np.float32(1) - np.float32(b2) ** t)


def _decay_add(buf: Tensor, decay: float, g, scale: float) -> None:
    """``buf = decay * buf + scale * g`` in place; ``g`` dense or a ``RowGrad``
    (its term added at its ids only: elsewhere it is ``+ 0``)."""
    buf.mul_(decay)
    if isinstance(g, RowGrad):
        buf.index_copy_(0, g.ids, buf.index_select(0, g.ids) + scale * g.rows.float())
    else:
        buf.add_(scale * g.float())


def _square(g):
    if isinstance(g, RowGrad):
        return RowGrad(g.ids, g.rows.float() * g.rows.float())
    return g.float() * g.float()


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params) -> OptState:
        return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))

    def update(grads, state: OptState, params, lr):
        step = state.step + 1
        c1, c2 = _bias_corrections(b1, b2, step)

        def upd(g, m, v, p):
            _decay_add(m, b1, g, 1 - b1)
            _decay_add(v, b2, _square(g), 1 - b2)
            delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr * delta)

        with torch.no_grad():
            tree_map(upd, grads, state.m, state.v, params)
        return params, OptState(step, state.m, state.v)

    return Optimizer(init=init, update=update)


def sgdm(momentum: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params) -> OptState:
        return OptState(0, _zeros_like_f32(params), None)

    def update(grads, state: OptState, params, lr):
        def upd(g, m, p):
            _decay_add(m, momentum, g, 1.0)
            d = m
            if nesterov:
                d = momentum * m
                _decay_add(d, 1.0, g, 1.0)
            p.copy_(p.float() - lr * d)

        with torch.no_grad():
            tree_map(upd, grads, state.m, params)
        return params, OptState(state.step + 1, state.m, None)

    return Optimizer(init=init, update=update)


def mixed_table_adamw(is_table, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                      weight_decay: float = 0.1, table_lr_scale: float = 1.0) -> Optimizer:
    """AdamW for dense params + ROW-WISE ADAGRAD for embedding tables.

    ``is_table``: a bool tree marking the table leaves (rows x dim).  Their
    state is one accumulator a row ([R, 1] in ``m``, and in ``v`` as the
    reference keeps it), and their gradient must be a ``RowGrad``: for each
    touched row ``acc += mean(g^2)``, then ``p -= lr * g * rsqrt(acc + eps)``;
    no weight decay, so an untouched row keeps its bytes.
    """
    def init(params) -> OptState:
        def one(p, tab):
            shape = (p.shape[0], 1) if tab else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return OptState(0, tree_map(one, params, is_table), tree_map(one, params, is_table))

    def update(grads, state: OptState, params, lr):
        step = state.step + 1
        c1, c2 = _bias_corrections(b1, b2, step)

        def upd(g, m, v, p, tab):
            if not tab:
                _decay_add(m, b1, g, 1 - b1)
                _decay_add(v, b2, _square(g), 1 - b2)
                delta = (m / c1) / (torch.sqrt(v / c2) + eps) + weight_decay * p.float()
                p.copy_(p.float() - lr * delta)
                return
            if not isinstance(g, RowGrad):
                raise TypeError(f"a table's gradient must be a RowGrad, got {type(g).__name__}")
            rows = g.rows.float()
            acc = m.index_select(0, g.ids) + (rows * rows).mean(-1, keepdim=True)
            delta = rows * torch.rsqrt(acc + eps)
            m.index_copy_(0, g.ids, acc)
            new = p.index_select(0, g.ids).float() - (lr * table_lr_scale) * delta
            p.index_copy_(0, g.ids, new.to(p.dtype))

        with torch.no_grad():
            tree_map(upd, grads, state.m, state.v, params, is_table)
        return params, OptState(step, state.m, state.v)

    return Optimizer(init=init, update=update)


OPTIMIZERS = {"adamw": adamw, "sgdm": sgdm}


# ---------------------------------------------------------------------------
# Schedules + grad utilities.  A schedule maps the step count to the float32
# learning rate the reference computes (as a Python float).
# ---------------------------------------------------------------------------


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    f = np.float32

    def schedule(step) -> float:
        t = f(step)
        if t < warmup_steps:
            return float(f(peak_lr) * min(t / f(max(warmup_steps, 1)), f(1)))
        prog = np.clip((t - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1)), f(0), f(1))
        cos = f(peak_lr) * (f(final_frac)
                            + f(1 - final_frac) * f(0.5) * (f(1) + np.cos(f(np.pi) * prog)))
        return float(cos)

    return schedule


def rsqrt_schedule(peak_lr: float, warmup_steps: int):
    f = np.float32

    def schedule(step) -> float:
        t = max(f(step), f(1))
        return float(f(peak_lr) * min(t / f(max(warmup_steps, 1)), np.sqrt(f(warmup_steps) / t)))

    return schedule


def _sum_sq(g) -> Tensor:
    x = g.rows if isinstance(g, RowGrad) else g
    return torch.sum(torch.square(x.float()))


def global_norm(tree) -> Tensor:
    """The L2 norm over every leaf (a ``RowGrad`` counts its summed rows)."""
    return torch.sqrt(torch.sum(torch.stack([_sum_sq(g) for g in tree_leaves(tree)])))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)

    def one(g):
        if isinstance(g, RowGrad):
            return RowGrad(g.ids, (g.rows.float() * scale).to(g.rows.dtype))
        return (g.float() * scale).to(g.dtype)

    return tree_map(one, grads), norm


# ---------------------------------------------------------------------------
# Sharded gradients (module docstring).
# ---------------------------------------------------------------------------


def sum_replicas(g: Sharded) -> Sharded:
    """A dense leaf's shares (one a position) summed over each block's
    replicas, in position order, the sum on every replica."""
    parts = list(g.parts)
    for group in g.replica_groups():
        for q, t in zip(group, KD.all_reduce(g.mesh, group, [parts[q] for q in group])):
            parts[q] = t
    return Sharded(g.sharding, g.shape, parts)


def merge_row_grads(like: Sharded, ids: list, rows: list) -> Sharded:
    """A table block's gradient from each position's lookups (``ids`` and
    ``rows`` one a position, in the block's own numbering): for each block,
    its replicas' lookups gathered in position order and coalesced on the
    first replica, the ``RowGrad`` copied to the others."""
    mesh = like.mesh
    parts = [None] * len(ids)
    for group in like.replica_groups():
        head = group[0]
        with mesh.on(head):
            got_i = [ids[head]] + [mesh.copy(ids[q], q, head) for q in group[1:]]
            got_r = [rows[head]] + [mesh.copy(rows[q], q, head) for q in group[1:]]
            all_i, all_r = torch.cat(got_i), torch.cat(got_r)
            rg = coalesce_rows(all_i, all_r)
        parts[head] = rg
        for q in group[1:]:
            parts[q] = RowGrad(mesh.copy(rg.ids, head, q), mesh.copy(rg.rows, head, q))
        if len(group) > 1:
            hlo_stats.note("all-gather", [all_i, all_r], group)
    return Sharded(like.sharding, like.shape, parts)


def clip_sharded(grads, max_norm: float):
    """``clip_by_global_norm`` of a tree of ``Sharded`` gradients: each
    distinct block's squares counted once (its first replica's), the norm
    and the scale computed on position 0 and the scale copied to every
    position.  Returns (grads, the norm on position 0)."""
    leaves = tree_leaves(grads)
    mesh = leaves[0].mesh
    sq = []
    for g in leaves:
        named = g.sharding.named_axes()
        holders = mesh.groups(named)[0] if named else [0]
        shares = []
        for q in holders:
            with mesh.on(q):
                shares.append(_sum_sq(g.parts[q]))
        shares = [shares[0]] + [mesh.copy(t, q, 0) for q, t in zip(holders[1:], shares[1:])]
        with mesh.on(0):
            sq.append(shares[0] if len(shares) == 1 else torch.sum(torch.stack(shares)))
    with mesh.on(0):
        norm = torch.sqrt(torch.sum(torch.stack(sq)))
        scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    scales = [scale] + [mesh.copy(scale, 0, p) for p in range(1, len(mesh.devices))]

    def one(g):
        parts = []
        for p, t in enumerate(g.parts):
            with mesh.on(p):
                if isinstance(t, RowGrad):
                    parts.append(RowGrad(t.ids, (t.rows.float() * scales[p]).to(t.rows.dtype)))
                else:
                    parts.append((t.float() * scales[p]).to(t.dtype))
        return Sharded(g.sharding, g.shape, parts)

    return tree_map(one, grads), norm


def init_sharded(optimizer: Optimizer, params) -> OptState:
    """``optimizer.init`` of a tree of ``Sharded`` params: each position's
    state from its parts, the moments sharded as their params (ZeRO)."""
    first = tree_leaves(params)[0]
    mesh = first.mesh
    states = []
    for p in range(len(mesh.devices)):
        with mesh.on(p):
            states.append(optimizer.init(part_tree(params, p)))
    m = zip_parts(params, [s.m for s in states])
    v = None if states[0].v is None else zip_parts(params, [s.v for s in states])
    return OptState(states[0].step, m, v)


def update_sharded(optimizer: Optimizer, grads, state: OptState, params, lr):
    """``optimizer.update`` on every position's parts, in place."""
    mesh = tree_leaves(params)[0].mesh
    step = state.step
    for p in range(len(mesh.devices)):
        with mesh.on(p):
            _, st = optimizer.update(
                part_tree(grads, p),
                OptState(state.step, part_tree(state.m, p),
                         None if state.v is None else part_tree(state.v, p)),
                part_tree(params, p), lr)
            step = st.step
    return params, OptState(step, state.m, state.v)
