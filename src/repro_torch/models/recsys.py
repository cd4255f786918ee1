"""The two-tower retrieval model: user and item towers into one embedding space.

Port of the two-tower part of ``repro/models/recsys.py``: the config, the
table sizes, the initial state and the forward pass of both towers.  Each
tower looks up one row per id field in its own table, concatenates the rows,
runs a ReLU MLP and L2-normalises the output, so that ``-dot`` ranks by
cosine (``serving.service``'s ``neg_dot``).

Params are a plain dict in the reference's layout (``split_params`` of
``init_two_tower``): ``user_tables`` / ``item_tables``, lists of
``[rows, feat_dim]`` fp32 tables, and ``user_mlp`` / ``item_mlp``, lists of
``{"w": [in, out], "b": [out]}`` layers applied as ``x @ w + b``.
``params_from_reference`` carries the reference's values across (numpy
leaves); ``param_leaves`` lists them in the reference's leaf order.

The products are plain fp32 matmuls (no Pallas kernel computes them in the
reference).  The precision is the process's to set: on the card the towers
refuse to run while TF32 is on (``apply_mlp``), rather than switch it off
and on again around each call, which would change it under other threads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels._backend import resolve_device

Tensor = torch.Tensor


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


# -- initial state -----------------------------------------------------------


def _device(device) -> torch.device:
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def _normal(shape, std: float, generator, device) -> Tensor:
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device).mul_(std)


def _mlp(sizes, generator, device) -> list[dict]:
    """ReLU stack weights: w N(0, 1/fan_in) ``[in, out]``, b zero."""
    return [{"w": _normal((sizes[i], sizes[i + 1]), 1.0 / math.sqrt(max(sizes[i], 1)),
                          generator, device),
             "b": torch.zeros(sizes[i + 1], device=device)}
            for i in range(len(sizes) - 1)]


def init_two_tower(cfg: TwoTowerConfig, *, generator: torch.Generator | None = None,
                   device="cuda") -> dict:
    """The towers' initial state, drawn on ``device`` from ``generator``.

    Tables N(0, 1/feat_dim), MLP weights N(0, 1/fan_in), biases zero: the
    reference's distributions (``models/nn.py``'s ``normal_init`` and
    ``lecun_init``).  ``generator`` is a ``torch.Generator`` on ``device``'s
    type (default: a fresh one seeded 0), drawn in the order user tables,
    item tables, user MLP, item MLP; it cannot replay ``jax.random``, so
    the values differ from the reference's (carry those across with
    ``params_from_reference``).  ``device="meta"`` gives the shapes with no
    allocation.
    """
    dev = _device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(dev).manual_seed(0)
    std = 1.0 / math.sqrt(cfg.feat_dim)
    return {
        "user_tables": [_normal((s, cfg.feat_dim), std, generator, dev) for s in cfg.u_sizes()],
        "item_tables": [_normal((s, cfg.feat_dim), std, generator, dev) for s in cfg.i_sizes()],
        "user_mlp": _mlp((cfg.n_user_fields * cfg.feat_dim,) + tuple(cfg.tower_mlp),
                         generator, dev),
        "item_mlp": _mlp((cfg.n_item_fields * cfg.feat_dim,) + tuple(cfg.tower_mlp),
                         generator, dev),
    }


def params_from_reference(values, *, device="cuda") -> dict:
    """The reference's two-tower values (``split_params(init_two_tower(...))[0]``
    with numpy leaves) as the port's params on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {
        "user_tables": [t(a) for a in values["user_tables"]],
        "item_tables": [t(a) for a in values["item_tables"]],
        "user_mlp": [{"w": t(layer["w"]), "b": t(layer["b"])} for layer in values["user_mlp"]],
        "item_mlp": [{"w": t(layer["w"]), "b": t(layer["b"])} for layer in values["item_mlp"]],
    }


def param_leaves(params) -> list[Tensor]:
    """The leaves in the reference's ``jax.tree.leaves`` order: dict keys
    sorted, lists in order, so

        item_mlp[i].b, item_mlp[i].w (i = 0, 1, ...), item_tables[j],
        user_mlp[i].b, user_mlp[i].w, user_tables[j].
    """
    out = []
    for key in ("item_mlp", "item_tables", "user_mlp", "user_tables"):
        for leaf in params[key]:
            out.extend((leaf["b"], leaf["w"]) if isinstance(leaf, dict) else (leaf,))
    return out


def n_params(params) -> int:
    return sum(leaf.numel() for leaf in param_leaves(params))


# -- forward -----------------------------------------------------------------


def embedding_lookup(table: Tensor, ids: Tensor) -> Tensor:
    """Single-valued lookup: ids ``[...]`` -> ``[..., D]``."""
    return table[ids]


def apply_mlp(layers, x: Tensor) -> Tensor:
    """``x @ w + b`` per layer, ReLU between layers, none after the last.

    On the card the products must be IEEE fp32: this raises while the
    process lets cuBLAS use TF32 (``torch.backends.cuda.matmul.allow_tf32``,
    or a ``torch.set_float32_matmul_precision`` below ``"highest"``).
    """
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the towers' products are fp32, but TF32 is on: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False and "
                           "torch.set_float32_matmul_precision('highest')")
    for i, layer in enumerate(layers):
        x = torch.addmm(layer["b"], x, layer["w"])
        if i < len(layers) - 1:
            x = torch.relu_(x)
    return x


def _tower(tables, mlp, ids: Tensor) -> Tensor:
    ids = ids.to(device=tables[0].device, dtype=torch.long)
    x = torch.cat([embedding_lookup(t, ids[:, i]) for i, t in enumerate(tables)], dim=-1)
    x = apply_mlp(mlp, x)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def user_embedding(params, user_ids) -> Tensor:
    """``[B, n_user_fields]`` ids -> ``[B, embed]`` unit rows."""
    return _tower(params["user_tables"], params["user_mlp"], torch.as_tensor(user_ids))


def item_embedding(params, item_ids) -> Tensor:
    """``[B, n_item_fields]`` ids -> ``[B, embed]`` unit rows."""
    return _tower(params["item_tables"], params["item_mlp"], torch.as_tensor(item_ids))
