"""Int8 error-feedback gradient compression for the data-parallel all-reduce.

Port of ``repro/train/compression.py``, over a ``launch.mesh.Mesh`` and a
list of its positions, as ``core.distributed``'s collectives take them:
each function takes one tensor (or tree) a position and returns one a
position.  The wire is a ring reduce-scatter followed by an all-gather,
both carrying int8 payloads (+ one fp32 scale a hop): about 2n bytes a
position on the wire against 8n for the fp32 ring all-reduce.

Quantization error at the SOURCE is not discarded: the residual
(g - dequant(quant(g))) is returned, to be added to the next step's
gradient (error feedback).  Each hop's requantization of the partial sums
in flight is the standard compressed-ring approximation (at most 1/254 of
the hop's max, not fed back), as in the reference.

The arithmetic is the reference's as XLA compiles it, so the two agree
bit for bit: ``clamp(round(x / scale), -127, 127)`` (``torch.round``
rounds half to even, as ``jnp.round`` does); a scale is ``max * (1 /
127)``, the division by a constant that XLA turns into a product with its
fp32 reciprocal; and a product feeding a sum (each hop's ``rq * rs +
deq``, the residual ``chunk - q * scale``) is one fused multiply-add, as
XLA contracts it: in fp64, which holds an int8-by-fp32 product and its sum
with an fp32 term exactly here, then rounded once to fp32.  No TPU kernel
is involved: the int8 tensors on the wire are the algorithm.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import all_gather, permute
from repro_torch.launch import hlo_stats
from repro_torch.models.nn import tree_map

Tensor = torch.Tensor

_TINY = 1e-12
_INV_127 = float(np.float32(1) / np.float32(127))  # the fp32 reciprocal XLA multiplies by


def _quantize(x: Tensor, scale: Tensor) -> Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _scale(peak: Tensor) -> Tensor:
    """max(peak / 127, tiny) for a 0-d fp32 ``peak``, as XLA computes it."""
    return torch.clamp_min(peak * _INV_127, _TINY)


def _fma(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """``a * b + c`` rounded once to fp32 (module docstring)."""
    return (a.double() * b.double() + c.double()).float()


def _all_max(mesh, pos, vals: list) -> list:
    """``pmax`` of one 0-d tensor a position: each position's copy of the max."""
    out = []
    for d in range(len(pos)):
        got = [v if s == d else mesh.copy(v, pos[s], pos[d]) for s, v in enumerate(vals)]
        with mesh.on(pos[d]):
            out.append(torch.max(torch.stack(got)))
    hlo_stats.note("all-reduce", out[:1], pos)
    return out


def compressed_psum(mesh, pos, gs: list, errs: list) -> tuple[list, list]:
    """Error-feedback int8 ring all-reduce of ``gs[p]`` (position
    ``pos[p]``'s gradient) with its residual ``errs[p]`` (fp32, ``gs[p]``'s
    shape).

    Returns (each position's copy of the fp32 sum, each position's new
    residual).
    """
    P = len(pos)
    shape = gs[0].shape
    n = gs[0].numel()
    pad = (-n) % P
    m = (n + pad) // P
    chunks, local_max = [], []
    for p in range(P):
        with mesh.on(pos[p]):
            flat = (gs[p].float() + errs[p]).reshape(-1)
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            chunks.append(flat.reshape(P, m))  # chunks[c]: this position's part of chunk c
            local_max.append(torch.max(torch.abs(flat)))

    # The shared symmetric scale (a scalar all-reduce), so int8 payloads add.
    scale0 = []
    for p, mx in enumerate(_all_max(mesh, pos, local_max)):
        with mesh.on(pos[p]):
            scale0.append(_scale(mx))
    q0, deq0, err_new = [], [], []
    for p in range(P):
        with mesh.on(pos[p]):
            q = _quantize(chunks[p], scale0[p])
            deq = q.float() * scale0[p]  # what the wire carries
            # The source residual: everything this position failed to send.
            e = _fma(-q.float(), scale0[p], chunks[p]).reshape(-1)
            q0.append(q)
            deq0.append(deq)
            err_new.append(e[:n].reshape(shape))

    def unpad(flat):
        return flat[:n].reshape(shape)

    if P == 1:
        return [unpad(deq0[0].reshape(-1))], err_new

    # Ring reduce-scatter: the partial for chunk p starts at position p with
    # its own contribution; each hop it moves +1, and the host adds its own
    # part of the visiting chunk c = (p - s) mod P.
    ring = [(i, (i + 1) % P) for i in range(P)]
    send_q = [q0[p][p] for p in range(P)]
    send_s = list(scale0)
    for s in range(1, P):
        rq = permute(mesh, pos, send_q, ring)
        rs = permute(mesh, pos, send_s, ring)
        for p in range(P):
            with mesh.on(pos[p]):
                acc = _fma(rq[p].float(), rs[p], deq0[p][(p - s) % P])
                send_s[p] = _scale(torch.max(torch.abs(acc)))
                send_q[p] = _quantize(acc, send_s[p])
    # After P-1 hops position p holds the reduced chunk (p + 1) mod P.
    allq = all_gather(mesh, pos, [q[None] for q in send_q])  # [P, m] int8 on the wire
    allsc = all_gather(mesh, pos, [sc[None] for sc in send_s])  # [P] fp32
    sums = []
    for p in range(P):
        with mesh.on(pos[p]):
            rows = allq[p].float() * allsc[p][:, None]
            # Position d's row is chunk (d + 1) mod P: chunk c is row (c - 1) mod P.
            sums.append(unpad(torch.roll(rows, 1, dims=0).reshape(-1)))
    return sums, err_new


class _Leaf:
    __slots__ = ("sums", "errs")

    def __init__(self, sums, errs):
        self.sums, self.errs = sums, errs


def compressed_psum_tree(mesh, pos, grads: list, errs: list) -> tuple[list, list]:
    """``compressed_psum`` leaf by leaf over gradient trees: ``grads[p]`` and
    ``errs[p]`` position ``pos[p]``'s trees.  Returns (the sum trees, the
    residual trees), one a position."""
    P = len(pos)
    done = tree_map(lambda *ls: _Leaf(*compressed_psum(mesh, pos, ls[:P], ls[P:])),
                    grads[0], *grads[1:], *errs)
    sums = [tree_map(lambda o, p=p: o.sums[p], done) for p in range(P)]
    new_errs = [tree_map(lambda o, p=p: o.errs[p], done) for p in range(P)]
    return sums, new_errs


def init_error_state(params):
    """A zero fp32 residual for each leaf of ``params``, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
