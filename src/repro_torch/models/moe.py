"""Mixture-of-experts FFN: GShard-style top-k routing with dispatch/combine
einsums.

Port of ``repro/models/moe.py``.  Routing is a k-smallest selection (k
experts of E by negated gate score), and the port runs it on the paper's
phase-2 kernel: ``kernels.ops.stream_topk`` over the ``[G * Sg, E]``
scores, the ``stream_topk`` kernel on the card and its plain version (a
stable sort) on a CPU tensor.  Both keep the K smallest by (value,
column), so at exact ties they pick the lower expert id, as the
reference's ``jax.lax.top_k`` does: the ids equal the reference's.

Capacity-factor token dropping with position priority (GShard: token
order, then choice order); dropped tokens pass through on the residual
stream.  The aux load-balance loss (Switch eq. 4) is returned for the
trainer.  The expert path is bf16 in every config, as the reference's:
the dispatch and combine one-hots, the gates, the tokens and the expert
weights are cast to bf16, the products accumulate in fp32
(``models.nn.require_bf16_products`` refuses reduced-precision reductions
on the card), and ``y`` returns through bf16 before it takes x's dtype.
The router's product is fp32.

The reference's sharding regimes (``"ep"``: experts over "expert";
``"tp"``: per-expert d_ff over "tensor") live in the params' logical axes.
A whole step computes every expert on the params' device.  In a body
(``distributed.spmd``) ``apply_moe`` runs the regime over the mesh:

  * ``"ep"``: the experts are cut over the "expert" axes and the router is
    whole on every position, so the positions along those axes compute the
    same routing, dispatch, combine and capacity drops as the whole step;
    each runs only its own experts, and the partial combines are summed
    over the expert axes in fp32 (``spmd.all_reduce``) before the bf16
    rounding of the whole step's one combine (the reference's all-to-all
    and back, up to the order of the fp32 sum);
  * ``"tp"``: each expert's d_ff is cut over "tensor": the gate and up
    products make a position's columns of h, and its rows of ``wo`` a
    partial expert output, summed likewise in fp32 before the rounding.

The routing groups are the whole step's: where the batch's rows are cut
(``spmd.batch_axes``) and a position's tokens are whole groups of the
whole step's, each position routes its own; otherwise (fewer tokens than
a group a position: decode) the tokens are gathered over the batch's axes,
every position routes the whole step's groups, and keeps its own rows.
The router's ``stream_topk`` runs once a position, on its stream
(``spmd.call``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import spmd
from repro_torch.kernels import ops as kops
from repro_torch.models.nn import Param, lecun_init, require_exact_products, silu

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    capacity_factor: float = 1.25
    group_size: int = 2048  # tokens per routing group (bounds dispatch tensor)
    router_norm: str = "softmax_topk"  # mixtral: softmax over top-k logits
    #                "topk_softmax"    # qwen3: top-k of softmax, renormalized
    sharding: str = "ep"  # "ep" | "tp"
    aux_loss_weight: float = 0.01


def init_moe(generator, d_model: int, cfg: MoEConfig, dtype=torch.float32, *, device="cuda",
             layers: int | None = None):
    """Expert-parallel ("ep"): E sharded; tensor-parallel ("tp"): d_ff
    sharded.  ``layers``: a leading [layers] axis on every leaf (the
    transformer's stacked layers), each slice drawn alike."""
    e_ax = "expert" if cfg.sharding == "ep" else None
    f_ax = None if cfg.sharding == "ep" else "tensor"
    E, D, Fd = cfg.n_experts, d_model, cfg.d_ff
    lead, la = ((layers,), (None,)) if layers is not None else ((), ())

    def w(shape, fan_in, dt, axes):
        return Param(lecun_init(generator, lead + shape, fan_in, device=device, dtype=dt),
                     la + axes)

    return {
        "router": w((D, E), D, torch.float32, ("fsdp", None)),
        "wi_gate": w((E, D, Fd), D, dtype, (e_ax, "fsdp", f_ax)),
        "wi_up": w((E, D, Fd), D, dtype, (e_ax, "fsdp", f_ax)),
        "wo": w((E, Fd, D), Fd, dtype, (e_ax, f_ax, "fsdp")),
    }


def _v(p):
    return p.value if isinstance(p, Param) else p


def one_hot(ids: Tensor, n: int, dtype) -> Tensor:
    """``torch.nn.functional.one_hot`` by a comparison: on the card it checks its
    ids' range on the host, a synchronisation each call."""
    return (ids.long()[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def route_topk(scores: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k smallest of each row of ``scores`` [..., E] (fp32), ascending,
    and their int64 columns.  The columns come from ``stream_topk`` over
    the rows flattened; the values are ``scores`` gathered at them (the
    same numbers, and a gradient to the selected scores, as
    ``jax.lax.top_k``'s)."""
    E = scores.shape[-1]
    with torch.no_grad():
        _, ids = spmd.call(kops.stream_topk, scores.detach().reshape(-1, E), k)
    ids = ids.reshape(*scores.shape[:-1], k).long()
    return scores.gather(-1, ids), ids


def _router_probs(logits: Tensor, cfg: MoEConfig) -> tuple[Tensor, Tensor]:
    """Top-k expert ids + combine weights per token.  logits: [G, S, E]."""
    if cfg.router_norm == "topk_softmax":
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        # k smallest of negated probs == top-k probs (the paper's selection).
        neg_top, ids = route_topk(-probs, cfg.top_k)
        gates = -neg_top
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    else:  # softmax_topk (mixtral)
        neg_top, ids = route_topk(-logits.to(torch.float32), cfg.top_k)
        gates = torch.softmax(-neg_top, dim=-1)
    return ids.to(torch.int32), gates


def _load_balance_loss(probs_mean: Tensor, frac_tokens: Tensor, E: int) -> Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e."""
    return E * torch.sum(frac_tokens * probs_mean)


def capacity(cfg: MoEConfig, group: int) -> int:
    """Slots per expert per routing group of ``group`` tokens (Python's
    ``round``, as the reference's)."""
    K, E = cfg.top_k, cfg.n_experts
    return min(int(max(K, round(group * K / E * cfg.capacity_factor))), group)


def expert_slots(ids: Tensor, E: int, C: int) -> tuple[Tensor, Tensor]:
    """(pos, keep) of each (token, choice) of ``ids`` [G, Sg, K]: its place
    in its expert's queue, priority by token order then choice order
    (GShard §3.2), and whether that place is within the capacity C."""
    G, Sg, K = ids.shape
    flat = one_hot(ids, E, torch.int32).reshape(G, Sg * K, E)
    pos_in_expert = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = (pos_in_expert * flat).sum(-1, dtype=torch.int32).reshape(G, Sg, K)
    return pos, pos < C


def apply_moe(params, x: Tensor, cfg: MoEConfig, *, act=silu) -> tuple[Tensor, dict]:
    """x: [B, S, D] -> (y [B, S, D], metrics incl. aux_loss).

    Tokens are flattened to routing groups of ``group_size``, so the
    dispatch tensors stay O(T * E * C / G): the GShard grouping.  In a
    body, the regimes over the mesh (module docstring); whole, every
    expert here, the partial sums none.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    rows_axes = spmd.batch_axes()
    mesh = spmd.current().mesh if rows_axes else None
    n_rows = math.prod(mesh.shape[a] for a in rows_axes) if rows_axes else 1
    Sg = min(cfg.group_size, B * S * n_rows)
    own = (B * S) % Sg == 0  # a position's tokens are whole groups of the whole step's
    if not own:
        x = spmd.all_gather(x, 0, rows_axes)
    tokens = x.reshape(-1, D)
    Tn = tokens.shape[0]
    if Tn % Sg:
        raise ValueError(f"{Tn} tokens do not split into routing groups of {Sg}")
    G = Tn // Sg
    xg = tokens.reshape(G, Sg, D)

    router = _v(params["router"])
    xf = xg.to(torch.float32)
    require_exact_products(xf)
    logits = torch.matmul(xf, router)  # [G, Sg, E] fp32
    ids, gates = _router_probs(logits, cfg)  # [G, Sg, K]
    C = capacity(cfg, Sg)  # per group, per expert
    pos, keep = expert_slots(ids, E, C)

    probs_for_aux = torch.softmax(logits, dim=-1)
    frac = (one_hot(ids[..., 0], E, torch.float32).sum(1) / Sg).mean(0)
    aux = _load_balance_loss(probs_for_aux.mean(dim=(0, 1)), frac, E)

    gates = torch.where(keep, gates, 0.0)
    bf = torch.bfloat16
    wg, wu, wo = (_v(params[n]) for n in ("wi_gate", "wi_up", "wo"))
    e_axes, f_axes = spmd.split_axes(wg, 0), spmd.split_axes(wg, 2)
    e_loc = wg.shape[0]  # the experts here
    if e_axes:  # each position's experts, numbered from its first
        mesh = spmd.current().mesh
        ids = spmd.per_position(lambda p: spmd.part(ids, p) - mesh.index_along(p, e_axes) * e_loc)
    # Dispatch one-hot [G, Sg, e_loc, C] (bf16: pure permutation weights); a
    # dropped choice's slot is C, past the one-hot's C columns.
    slot = torch.where(keep, pos, C)
    disp = one_hot(ids, e_loc, bf)[..., None] * one_hot(slot, C, bf)[:, :, :, None, :]
    dispatch = disp.sum(2)
    combine = (disp * gates[..., None, None].to(bf)).sum(2)
    del disp

    # Expert inputs [e_loc, G, C, D]: which token each slot holds.
    xb = xg.to(bf)
    require_exact_products(xb)
    ein = torch.einsum("gsec,gsd->egcd", dispatch, xb).reshape(e_loc, G * C, D)
    h = act(torch.bmm(ein, wg.to(bf))) * torch.bmm(ein, wu.to(bf))  # [e_loc, G*C, F here]
    if f_axes:  # this position's rows of wo: a partial sum, summed in fp32
        eout = spmd.all_reduce(torch.bmm(h.float(), wo.to(bf).float()), f_axes).to(bf)
    else:
        eout = torch.bmm(h, wo.to(bf))
    eout = eout.reshape(e_loc, G, C, D)
    if e_axes:  # this position's experts' share of each token: summed in fp32
        y = spmd.all_reduce(torch.einsum("gsec,egcd->gsd", combine.float(), eout.float()),
                            e_axes).to(bf)
    else:
        y = torch.einsum("gsec,egcd->gsd", combine, eout)  # back to token layout
    y = y.reshape(x.shape).to(x.dtype)
    if not own:
        y = spmd.narrow_along(y, 0, rows_axes, B)

    metrics = {
        "aux_loss": cfg.aux_loss_weight * aux,
        "drop_frac": 1.0 - keep.to(torch.float32).mean(),
    }
    return y, metrics


def moe_flops_per_token(d_model: int, cfg: MoEConfig) -> int:
    """Active-parameter MACs per token (for MODEL_FLOPS accounting)."""
    return 2 * cfg.top_k * 3 * d_model * cfg.d_ff
