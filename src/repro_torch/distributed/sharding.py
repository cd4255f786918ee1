"""Logical-axis sharding: one rule table maps model-declared axis names to
the axes of a ``launch.mesh.Mesh``, with divisibility-aware fallback.

Port of ``repro/distributed/sharding.py``.  Models annotate parameter
dimensions with logical names ("batch", "table", "tensor", ...); an
``AxisRules`` table resolves them to mesh axes, and a dimension that does
not divide by the product of its mesh axes falls back to replicated (None),
trying prefixes of the axis tuple first, as the reference's does.

What a spec means differs from the reference's.  There a ``PartitionSpec``
places a jitted array's shards; the port's training tensors live whole on
one device (the step runs in one process on one card), so a spec is a
description: ``spec`` returns a tuple with one entry per dimension (None,
an axis name, or a tuple of names), ``sharding`` pairs it with the mesh,
and ``constrain`` returns its input unchanged.  The serving path shards for
real: ``core.distributed`` splits a database over a mesh axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Mapping, NamedTuple, Sequence

from repro_torch.models.nn import is_param, tree_map


class Sharding(NamedTuple):
    """A spec (one entry per dimension) on a mesh: ``NamedSharding``'s place."""

    mesh: object
    spec: tuple


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
    docstring), checking its rank against the annotation under a rule table."""
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
