"""Minimal functional NN substrate: params as trees of tensors + logical axes.

Port of ``repro/models/nn.py``.  Every ``init_*`` returns a tree (dicts and
lists) whose leaves are ``Param(value, axes)``; ``split_params`` separates
the value tree (what the steps train) from the logical-axes tree (mapped to
mesh axes by ``repro_torch.distributed.sharding``).  Plain dicts, lists and
``torch`` tensors: no module objects, no framework.

The tree helpers walk a tree the way ``jax.tree`` does: dict keys in sorted
order, lists and tuples in order, so ``tree_leaves`` gives the reference's
``jax.tree.leaves`` order.  Initializers draw from an explicit
``torch.Generator`` on the tensor's device (``device="meta"`` gives shapes
with no allocation); torch cannot replay ``jax.random``, so the values are
the reference's distributions, not its numbers.  ``model_scan`` is a plain
loop: the port has no trace to unroll.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


class Param:
    """A weight and its logical sharding axes."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes: tuple[str | None, ...]):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        shape = tuple(getattr(self.value, "shape", ()))
        return f"Param(shape={shape}, axes={self.axes})"


def is_param(x) -> bool:
    return isinstance(x, Param)


# -- trees -------------------------------------------------------------------


def _is_container(x) -> bool:
    return isinstance(x, (dict, list)) or (isinstance(x, tuple) and not hasattr(x, "_fields"))


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``), keeping the structure: dicts, lists and plain tuples are
    nodes, anything else (a tensor, a ``Param``, None) is a leaf unless
    ``is_leaf`` says so first."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_container(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest), is_leaf=is_leaf) for k in tree}
    out = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf) for i, t in enumerate(tree)]
    return out if isinstance(tree, list) else tuple(out)


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order (dict keys sorted)."""
    if (is_leaf is not None and is_leaf(tree)) or not _is_container(tree):
        return [tree]
    items = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else tree
    return [leaf for t in items for leaf in tree_leaves(t, is_leaf)]


def split_params(tree):
    """(values, axes) trees with the same structure as ``tree``."""
    values = tree_map(lambda p: p.value, tree, is_leaf=is_param)
    axes = tree_map(lambda p: p.axes, tree, is_leaf=is_param)
    return values, axes


def n_params(tree) -> int:
    leaves = tree_leaves(tree, is_leaf=is_param)
    return sum(int((p.value if is_param(p) else p).numel()) for p in leaves)


# -- initializers ------------------------------------------------------------


def normal_init(generator, shape, stddev: float, *, device="cpu", dtype=torch.float32) -> Tensor:
    """``stddev`` times standard normals from ``generator`` (empty on meta)."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, device=device, dtype=dtype)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(stddev)


def lecun_init(generator, shape, fan_in: int, *, device="cpu", dtype=torch.float32) -> Tensor:
    return normal_init(generator, shape, 1.0 / math.sqrt(max(fan_in, 1)), device=device,
                       dtype=dtype)


def dense(generator, d_in: int, d_out: int, axes, *, bias=False, device="cpu",
          dtype=torch.float32):
    p = {"kernel": Param(lecun_init(generator, (d_in, d_out), d_in, device=device,
                                    dtype=dtype), axes)}
    if bias:
        p["bias"] = Param(torch.zeros((d_out,), device=device, dtype=dtype), (axes[-1],))
    return p


def _v(p):
    return p.value if is_param(p) else p


def require_fp32_products(x: Tensor) -> None:
    """The models' fp32 products are IEEE fp32: on the card this raises
    while the process lets cuBLAS use TF32
    (``torch.backends.cuda.matmul.allow_tf32``, or a
    ``torch.set_float32_matmul_precision`` below ``"highest"``), rather than
    switch it, since the switch is the whole process's."""
    if x.is_cuda and x.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the models' products are fp32, but TF32 is on: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False and "
                           "torch.set_float32_matmul_precision('highest')")


def require_bf16_products(x: Tensor) -> None:
    """The models' bf16 products accumulate in fp32, as the reference's do:
    on the card this raises while the process lets cuBLAS reduce a bf16
    product in reduced precision
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``,
    on by default), rather than switch it for the whole process."""
    if (x.is_cuda and x.dtype == torch.bfloat16
            and torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction):
        raise RuntimeError("the models' bf16 products accumulate in fp32, but reduced-precision "
                           "reductions are on: set torch.backends.cuda.matmul."
                           "allow_bf16_reduced_precision_reduction = False")


def require_exact_products(x: Tensor) -> None:
    """``require_fp32_products`` and ``require_bf16_products`` of ``x``."""
    require_fp32_products(x)
    require_bf16_products(x)


def apply_dense(p, x: Tensor, *, compute_dtype=None) -> Tensor:
    k = _v(p["kernel"])
    if compute_dtype is not None:
        x, k = x.to(compute_dtype), k.to(compute_dtype)
    require_fp32_products(x)
    y = x @ k
    if "bias" in p:
        y = y + _v(p["bias"]).to(y.dtype)
    return y


def mlp(generator, sizes: Sequence[int], axes_hidden: str | None = "mlp", *, bias=True,
        device="cpu"):
    """Plain MLP stack params: sizes = [d_in, h1, ..., d_out]."""
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(dense(generator, sizes[i], sizes[i + 1],
                            (None, axes_hidden if i < len(sizes) - 2 else None),
                            bias=bias, device=device))
    return {"layers": layers}


def apply_mlp(p, x: Tensor, *, act=torch.relu, final_act=None, compute_dtype=None) -> Tensor:
    n = len(p["layers"])
    for i, layer in enumerate(p["layers"]):
        x = apply_dense(layer, x, compute_dtype=compute_dtype)
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


# -- norms -------------------------------------------------------------------


def rmsnorm_params(d: int, axes=(None,), *, device="cpu"):
    return {"scale": Param(torch.zeros((d,), device=device), axes)}


def apply_rmsnorm(p, x: Tensor, *, eps=1e-6, offset=1.0) -> Tensor:
    """RMSNorm with (offset + scale) weight: offset 1.0 covers llama and gemma."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * (offset + _v(p["scale"]).float())).to(x.dtype)


def layernorm_params(d: int, axes=(None,), *, device="cpu"):
    return {"scale": Param(torch.ones((d,), device=device), axes),
            "bias": Param(torch.zeros((d,), device=device), axes)}


def apply_layernorm(p, x: Tensor, *, eps=1e-6) -> Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias``, written out as the
    reference writes it (population variance)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * _v(p["scale"]) + _v(p["bias"])).to(x.dtype)


def rounded_to(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python number (an op with a Python
    number computes in fp32 and rounds once, as the reference's op with
    the rounded constant does; and it copies nothing to the card)."""
    return float(torch.tensor(v, dtype=torch.float32).to(dtype))


def silu(x: Tensor) -> Tensor:
    """``jax.nn.silu``: x * (1 / (1 + exp(-x))), each op rounded to x's
    dtype as the reference's (in bf16 ``F.silu``'s one rounding differs in
    about 4 of 10 elements)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: Tensor) -> Tensor:
    """``jax.nn.gelu(approximate=True)``, op by op in x's dtype, its two
    constants rounded to that dtype first, x ** 3 as two products."""
    inner = x + rounded_to(0.044715, x.dtype) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(rounded_to(math.sqrt(2 / math.pi), x.dtype) * inner)))


# The recommenders' activations (one rounding each; fp32 models).
ACTS = {
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "silu": F.silu,
    "tanh": torch.tanh,
}


def set_unroll_scans(value: bool):
    """The reference's switch to unrolled scans; ``model_scan`` is a loop
    here, so this only sets the accounting flag (``repro_torch.accounting``)."""
    from repro_torch import accounting

    accounting.set_unroll(value)


def model_scan(body, init, xs, length=None):
    """``lax.scan`` as a loop: ``body(carry, x) -> (carry, y)`` over the
    leading axis of ``xs`` (a tree of tensors, or None with ``length``);
    returns (carry, the ys stacked along a new leading axis, or None)."""
    n = length if xs is None else tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = body(carry, None if xs is None else tree_map(lambda t: t[i], xs))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *ts: torch.stack(ts), ys[0], *ys[1:])
