"""Logical-axis sharding: one rule table maps model-declared axis names to
the axes of a ``launch.mesh.Mesh``, with divisibility-aware fallback, and
the placement of tensors over the mesh's positions by that table.

Port of ``repro/distributed/sharding.py``.  Models annotate parameter
dimensions with logical names ("batch", "table", "tensor", ...); an
``AxisRules`` table resolves them to mesh axes, and a dimension that does
not divide by the product of its mesh axes falls back to replicated (None),
trying prefixes of the axis tuple first, as the reference's does.

``spec`` returns a tuple with one entry per dimension (None, an axis name,
or a tuple of names) and ``sharding`` pairs it with the mesh: a
``Sharding``, the reference's ``NamedSharding``.  A ``Sharding`` places
tensors for real: ``shard(t)`` gives one part a position, the slice of
``t`` along each dimension the spec maps (position p's block along the
dimension's mesh axes), on that position's device, and a copy of the same
slice on every position that differs only along an axis the spec does not
name (the replicas); ``unshard`` is its inverse.  A ``Sharded`` is such a
placed tensor, a leaf of a sharded train state (``shard_tree``): the
recommender's train and serve steps (``distributed.steps``) run one body a
position over the parts (``distributed.spmd``).

``constrain`` is the identity, checking the annotation's rank: a body runs
on each position's own shards, and the models move data between positions
themselves where a split dimension meets a whole one (``spmd``'s
collectives at the reference's ``constrain`` points: ``models.recsys``,
``models.transformer``, ``models.moe``); a whole step keeps its tensors
whole on their device.  ``cache_shardings`` cuts a language model's KV
cache as the reference's serve steps do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, NamedTuple, Sequence

import torch

from repro_torch.models.nn import is_param, tree_map


def _axes(part) -> tuple[str, ...]:
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


class Sharding(NamedTuple):
    """A spec (one entry per dimension) on a mesh: ``NamedSharding``'s place
    (module docstring).  A dimension past the spec's length is whole."""

    mesh: object
    spec: tuple

    def dim_axes(self, d: int) -> tuple[str, ...]:
        """The mesh axes dimension ``d`` is split over (() if whole)."""
        return _axes(self.spec[d]) if d < len(self.spec) else ()

    def named_axes(self) -> tuple[str, ...]:
        """Every mesh axis the spec splits a dimension over, in the mesh's order."""
        named = {a for part in self.spec for a in _axes(part)}
        return tuple(a for a in self.mesh.axis_names if a in named)

    def replica_axes(self) -> tuple[str, ...]:
        """The mesh axes along which the parts are copies of one another."""
        named = self.named_axes()
        return tuple(a for a in self.mesh.axis_names if a not in named)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """The shape of one part of a tensor of global ``shape``."""
        out = list(shape)
        for d in range(len(out)):
            n = math.prod(self.mesh.shape[a] for a in self.dim_axes(d))
            if out[d] % n:
                raise ValueError(f"dimension {d} of {tuple(shape)} does not split {n} ways")
            out[d] //= n
        return tuple(out)

    def index(self, p: int, shape) -> tuple[slice, ...]:
        """Position ``p``'s block of a tensor of global ``shape``."""
        local = self.shard_shape(shape)
        out = []
        for d, size in enumerate(local):
            axes = self.dim_axes(d)
            i = self.mesh.index_along(p, axes) if axes else 0
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def shard(self, t: torch.Tensor) -> list[torch.Tensor]:
        """One part a position: a copy of its block of ``t`` on its device
        (module docstring); ``t`` itself is not kept."""
        parts = []
        for p, dev in enumerate(self.mesh.devices):
            block = t[self.index(p, t.shape)]
            part = torch.empty(block.shape, dtype=t.dtype, device=dev)
            parts.append(part.copy_(block) if dev.type != "meta" else part)
        return parts

    def unshard(self, parts, device=None) -> torch.Tensor:
        """The global tensor of ``parts`` (one a position) on ``device``
        (default: the first part's), from the first replica of each block."""
        first = parts[0]
        shape = tuple(s * math.prod(self.mesh.shape[a] for a in self.dim_axes(d))
                      for d, s in enumerate(first.shape))
        out = torch.empty(shape, dtype=first.dtype,
                          device=first.device if device is None else device)
        if out.device.type == "meta":
            return out
        for p in self.mesh.groups(self.named_axes())[0] if self.named_axes() else [0]:
            out[self.index(p, shape)] = parts[p].to(out.device)
        return out


class Sharded:
    """A tensor placed over a mesh (module docstring): its ``Sharding``, its
    global ``shape`` and ``parts``, one a position (a part may also be a
    ``train.optim.RowGrad``, a table's gradient)."""

    __slots__ = ("sharding", "shape", "parts")

    def __init__(self, sharding: Sharding, shape, parts):
        self.sharding, self.shape, self.parts = sharding, tuple(shape), list(parts)

    @property
    def mesh(self):
        return self.sharding.mesh

    def __repr__(self):
        return f"Sharded({self.shape}, spec={self.sharding.spec}, parts={len(self.parts)})"

    def whole(self, device=None) -> torch.Tensor:
        return self.sharding.unshard(self.parts, device)

    def replica_groups(self) -> list[list[int]]:
        """The positions holding each block, one list a block: the
        participants of a sum over the replicas."""
        return self.mesh.groups(self.sharding.replica_axes())


def shard_tree(tree, shardings):
    """``tree``'s tensors as ``Sharded`` leaves by the matching node of
    ``shardings`` (a ``Sharding`` where ``tree`` has a tensor), one leaf at
    a time: each whole tensor is dropped from ``tree`` (its dicts and lists
    are rewritten in place) once its parts exist, so a caller that holds no
    other reference frees it before the next one is cut.  A leaf that is not
    a tensor (the optimizer's step, a None) is kept."""
    if isinstance(shardings, Sharding):
        if isinstance(tree, torch.Tensor):
            return Sharded(shardings, tree.shape, shardings.shard(tree))
        return tree
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = shard_tree(tree[k], shardings[k])
        return tree
    if isinstance(tree, list):
        for i in range(len(tree)):
            tree[i] = shard_tree(tree[i], shardings[i])
        return tree
    if isinstance(tree, tuple):
        out = [shard_tree(x, s) for x, s in zip(tree, shardings)]
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return tree


def unshard_tree(tree, device=None):
    """A copy of ``tree`` with every ``Sharded`` leaf whole on ``device``."""
    return tree_map(lambda x: x.whole(device) if isinstance(x, Sharded) else x, tree)


def part_tree(tree, p: int):
    """Position ``p``'s view of ``tree``: each ``Sharded`` leaf its part."""
    return tree_map(lambda x: x.parts[p] if isinstance(x, Sharded) else x, tree)


def zip_parts(like, trees: list):
    """The inverse of ``part_tree``: ``trees`` (one a position, each of
    ``like``'s structure) as ``Sharded`` leaves with ``like``'s shardings
    (the global shapes from the parts')."""
    def one(s, *ps):
        if not isinstance(s, Sharded) or ps[0] is None:
            return ps[0]
        sh = s.sharding
        shape = tuple(n * math.prod(sh.mesh.shape[a] for a in sh.dim_axes(d))
                      for d, n in enumerate(ps[0].shape))
        return Sharded(sh, shape, ps)

    return tree_map(one, like, *trees)


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Logical name -> mesh axes for one mesh.

    ``rules`` values are tuples of mesh axis names (a logical name may map to
    several, e.g. fsdp -> ("pod", "data")).  ``mesh`` gives the axis sizes
    for the divisibility checks.
    """

    mesh: object
    rules: Mapping[str, tuple[str, ...]]

    def _size(self, axes) -> int:
        return math.prod(self.mesh.shape[a] for a in axes)

    def physical(self, logical: str | None, dim: int | None = None):
        """Mesh axes for one logical name; None if unmapped or indivisible."""
        if logical is None:
            return None
        axes = self.rules.get(logical)
        if not axes:
            return None
        if dim is not None and dim % self._size(axes) != 0:
            for cut in range(len(axes) - 1, 0, -1):
                sub = axes[:cut]
                if dim % self._size(sub) == 0:
                    return sub if len(sub) > 1 else sub[0]
            return None
        return axes if len(axes) > 1 else axes[0]

    def spec(self, logical_axes: Sequence[str | None], shape=None) -> tuple:
        """One entry per dimension.  A mesh axis may be claimed by only one
        dimension; later claims fall back to replicated."""
        used: set[str] = set()
        parts = []
        for i, name in enumerate(logical_axes):
            phys = self.physical(name, None if shape is None else shape[i])
            flat = () if phys is None else (phys,) if isinstance(phys, str) else tuple(phys)
            if any(a in used for a in flat):
                parts.append(None)
                continue
            used.update(flat)
            parts.append(phys)
        return tuple(parts)

    def sharding(self, logical_axes: Sequence[str | None], shape=None) -> Sharding:
        return Sharding(self.mesh, self.spec(logical_axes, shape))


_LOCAL = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_LOCAL, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None):
    """Install the rule table that ``constrain`` sees, for this thread."""
    prev = getattr(_LOCAL, "rules", None)
    _LOCAL.rules = rules
    try:
        yield rules
    finally:
        _LOCAL.rules = prev


def constrain(x, logical_axes: Sequence[str | None]):
    """The annotation point of an activation: the identity (module
    docstring), checking its rank against the annotation under a rule
    table (inside a body, each position's own part)."""
    if current_rules() is not None and len(logical_axes) != x.ndim:
        raise ValueError(f"axes {tuple(logical_axes)} for a tensor of shape {tuple(x.shape)}")
    return x


def logical_to_spec(rules: AxisRules, axes, shape=None) -> tuple:
    return rules.spec(axes, shape)


def spec_tree_for_params(rules: AxisRules, params):
    """A ``Param`` tree (or its axes tree) as a tree of ``Sharding``s."""

    def one(p):
        if is_param(p):
            return rules.sharding(p.axes, tuple(p.value.shape))
        return rules.sharding(p if isinstance(p, tuple) else (None,))

    return tree_map(one, params, is_leaf=lambda x: is_param(x) or isinstance(x, tuple))


def cache_shardings(rules: AxisRules, cache, seq_parallel: bool = False):
    """A KV cache's ``Sharding`` of each leaf, a tree of ``cache``'s type:
    the reference's ``cache_spec`` (``repro/distributed/steps.py``), ``k``
    and ``v`` [L, B, C, Hkv, D] by ``(None, "batch", "seq", "kv_heads",
    None)``, ``"kv_seq"`` in place of ``"seq"`` with ``seq_parallel``, and
    ``pos`` [B] by ``("batch",)``; an axis that does not divide falls back
    to whole, and a mesh axis claimed twice to whole for the later claim
    (``AxisRules.spec``)."""
    kv = (None, "batch", "kv_seq" if seq_parallel else "seq", "kv_heads", None)
    return type(cache)(rules.sharding(kv, tuple(cache.k.shape)),
                       rules.sharding(kv, tuple(cache.v.shape)),
                       rules.sharding(("batch",), tuple(cache.pos.shape)))


def make_rules(mesh) -> AxisRules:
    """Default rule table for (data, model) or (pod, data, model) meshes:
    batch and fsdp over the data-parallel axes, tensor, expert, vocab,
    kv_heads and the embedding tables' rows over model, seq over data, the
    kNN ring over all of them."""
    names = mesh.axis_names
    dp: tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    tp = ("model",) if "model" in names else ()
    return AxisRules(
        mesh=mesh,
        rules={
            "batch": dp,
            "fsdp": dp,
            "seq": ("data",) if "data" in names else (),
            "kv_seq": tp,
            "tensor": tp,
            "expert": tp,
            "vocab": tp,
            "kv_heads": tp,
            "table": tp,
            "ring": dp + tp,
        },
    )
