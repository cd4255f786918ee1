"""Cumulatively computable distance functions (paper Sect. 3).

PyTorch port of ``repro/core/distances.py``.  Every distance has two
evaluation paths:

* ``accumulate(x_chunk, y_chunk, acc)``: the faithful cumulative form over a
  coordinate chunk of both operands (``Distance.pairwise``);
* ``matmul_form``: the rewrite ``finalize(alpha * f(x) @ g(y)^T + h(x) +
  h(y))`` that the kernels compute.

All distances are smaller-is-nearer; similarities (dot, cosine) are negated.
The matmul-form kernels take the finalizer as one of two kinds,
``"identity"`` and ``"sqrt"`` (``sqrt(max(a, 0))``), see ``finalize_kind``;
the per-coordinate kernel takes a distance's accumulator and finalizer by
name, see ``cumulative_kind``.

Row quantization for the two-stage scan (``quantize_rows``) builds the
bf16 / int8 scan replicas in ``gy`` space.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Distance:
    """A cumulatively computable distance function.

    ``accumulate``: ``(x_chunk[m,c], y_chunk[n,c], acc[m,n]) -> acc[m,n]``;
    ``finalize`` runs once after all chunks; ``pre`` is a whole-vector
    transform before chunking (row normalisation for cosine).
    """

    name: str
    init: float
    accumulate: Callable[[Tensor, Tensor, Tensor], Tensor]
    finalize: Callable[[Tensor], Tensor]
    matmul_form: "MatmulForm | None" = None
    pre: Callable[[Tensor], Tensor] | None = None
    needs_positive: bool = False

    def pairwise(self, x: Tensor, y: Tensor, chunk: int | None = None) -> Tensor:
        """Reference pairwise evaluation (cumulative path), O(m*n*d)."""
        if self.pre is not None:
            x = self.pre(x)
            y = self.pre(y)
        m, d = x.shape
        n, _ = y.shape
        c = d if chunk is None else chunk
        dtype = torch.promote_types(x.dtype, torch.float32)
        acc = torch.full((m, n), self.init, dtype=dtype, device=x.device)
        for lo in range(0, d, c):
            acc = self.accumulate(x[:, lo : lo + c], y[:, lo : lo + c], acc)
        return self.finalize(acc)


@dataclasses.dataclass(frozen=True)
class MatmulForm:
    """tile = finalize(hx[:, None] + hy[None, :] + alpha * fx @ gy^T)."""

    fx: Callable[[Tensor], Tensor]
    gy: Callable[[Tensor], Tensor]
    hx: Callable[[Tensor], Tensor]  # (m, d) -> (m,)
    hy: Callable[[Tensor], Tensor]  # (n, d) -> (n,)
    alpha: float = 1.0

    def pairwise(self, x: Tensor, y: Tensor, finalize) -> Tensor:
        fx = self.fx(x).float()
        gy = self.gy(y).float()
        tile = self.alpha * fx @ gy.T
        tile = tile + self.hx(x)[:, None] + self.hy(y)[None, :]
        return finalize(tile)


_EPS = 1e-12


def _sqrt0(a: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(a, 0.0))


def _sqnorm(x: Tensor) -> Tensor:
    return torch.sum(x.float() ** 2, dim=-1)


def _zeros(x: Tensor) -> Tensor:
    return torch.zeros(x.shape[:1], dtype=torch.float32, device=x.device)


def _normalize(x: Tensor) -> Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), _EPS)


def _sqeuclidean_acc(xc, yc, acc):
    diff = xc[:, None, :] - yc[None, :, :]
    return acc + torch.sum(diff * diff, dim=-1)


def _neg_dot_acc(xc, yc, acc):
    return acc - torch.einsum("mc,nc->mn", xc, yc)


def _hellinger_acc(xc, yc, acc):
    # H^2(p, q) = 1/2 * sum (sqrt(p_i) - sqrt(q_i))^2 ; accumulate the sum.
    diff = torch.sqrt(torch.clamp_min(xc[:, None, :], 0.0)) - torch.sqrt(
        torch.clamp_min(yc[None, :, :], 0.0))
    return acc + torch.sum(diff * diff, dim=-1)


def _kl_acc(xc, yc, acc):
    # KL(p || q) = sum p_i * (log p_i - log q_i); asymmetric but cumulative.
    p = torch.clamp_min(xc[:, None, :], _EPS)
    q = torch.clamp_min(yc[None, :, :], _EPS)
    return acc + torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1)


def _identity(a: Tensor) -> Tensor:
    return a


_SQEUCLIDEAN_MF = MatmulForm(fx=_identity, gy=_identity, hx=_sqnorm,
                             hy=_sqnorm, alpha=-2.0)

SQEUCLIDEAN = Distance(
    name="sqeuclidean", init=0.0, accumulate=_sqeuclidean_acc,
    finalize=_identity, matmul_form=_SQEUCLIDEAN_MF)

EUCLIDEAN = Distance(
    name="euclidean", init=0.0, accumulate=_sqeuclidean_acc,
    finalize=_sqrt0, matmul_form=_SQEUCLIDEAN_MF)

NEG_DOT = Distance(
    name="neg_dot", init=0.0, accumulate=_neg_dot_acc, finalize=_identity,
    matmul_form=MatmulForm(fx=_identity, gy=_identity, hx=_zeros, hy=_zeros,
                           alpha=-1.0))

NEG_COSINE = Distance(
    name="neg_cosine", init=0.0, accumulate=_neg_dot_acc, finalize=_identity,
    pre=_normalize,
    matmul_form=MatmulForm(fx=_normalize, gy=_normalize, hx=_zeros, hy=_zeros,
                           alpha=-1.0))


def _sqrt_pos(x: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def _half_mass(x: Tensor) -> Tensor:
    return 0.5 * torch.sum(torch.clamp_min(x.float(), 0.0), dim=-1)


def _half_sqrt0(a: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(0.5 * a, 0.0))


HELLINGER = Distance(
    name="hellinger", init=0.0, accumulate=_hellinger_acc, finalize=_half_sqrt0,
    # sqrt-space inner product: H^2 = 1 - <sqrt p, sqrt q> for distributions.
    matmul_form=MatmulForm(fx=_sqrt_pos, gy=_sqrt_pos, hx=_half_mass,
                           hy=_half_mass, alpha=-1.0),
    needs_positive=True)


def _kl_fx(x: Tensor) -> Tensor:
    return torch.clamp_min(x, _EPS)


def _kl_gy(y: Tensor) -> Tensor:
    return -torch.log(torch.clamp_min(y, _EPS))


def _kl_hx(x: Tensor) -> Tensor:
    p = torch.clamp_min(x.float(), _EPS)
    return torch.sum(p * torch.log(p), dim=-1)


KL = Distance(
    name="kl", init=0.0, accumulate=_kl_acc, finalize=_identity,
    # KL(p||q) = sum p log p - sum p log q = hx + p @ (-log q)^T.
    matmul_form=MatmulForm(fx=_kl_fx, gy=_kl_gy, hx=_kl_hx, hy=_zeros,
                           alpha=1.0),
    needs_positive=True)

REGISTRY: dict[str, Distance] = {
    d.name: d
    for d in (SQEUCLIDEAN, EUCLIDEAN, NEG_DOT, NEG_COSINE, HELLINGER, KL)
}


def get_distance(name: str) -> Distance:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown distance {name!r}; have {sorted(REGISTRY)}") from None


def is_symmetric(name: str) -> bool:
    """Paper Sect. 3: symmetric distances admit the half-triangle schedule."""
    return name != "kl"


def finalize_kind(dist: Distance) -> str:
    """The matmul-form finalizer as the kernels take it.

    The Hellinger matmul form already carries the 1/2 prefactor in ``hx``,
    ``hy`` and ``alpha``, so its finalizer is a plain ``sqrt(max(a, 0))``
    rather than the cumulative ``sqrt(max(a / 2, 0))``.
    """
    if dist.name in ("euclidean", "hellinger"):
        return "sqrt"
    return "identity"


FINALIZERS: dict[str, Callable[[Tensor], Tensor]] = {
    "identity": _identity,
    "sqrt": _sqrt0,
}


def matmul_finalize(dist: Distance) -> Callable[[Tensor], Tensor]:
    """Finalizer to use with the matmul form (accounts for prefactor folding)."""
    return FINALIZERS[finalize_kind(dist)]


# The cumulative route's four accumulators and three finalizers, by the names
# the per-coordinate kernel takes (``kernels/pairwise_distance.py``).
ACCUMULATORS: dict[str, Callable[[Tensor, Tensor, Tensor], Tensor]] = {
    "sqeuclidean": _sqeuclidean_acc,
    "neg_dot": _neg_dot_acc,
    "hellinger": _hellinger_acc,
    "kl": _kl_acc,
}
CUMULATIVE_FINALIZERS: dict[str, Callable[[Tensor], Tensor]] = {
    "identity": _identity,
    "sqrt": _sqrt0,
    "half_sqrt": _half_sqrt0,
}


def cumulative_kind(dist: Distance) -> tuple[str, str]:
    """(accumulator, finalizer) names of ``dist``'s cumulative route."""
    acc = next(k for k, f in ACCUMULATORS.items() if f is dist.accumulate)
    fin = next(k for k, f in CUMULATIVE_FINALIZERS.items() if f is dist.finalize)
    return acc, fin


# ---------------------------------------------------------------------------
# Row quantization for the two-stage scan (DESIGN.md §Quantized).
# ---------------------------------------------------------------------------

# Canonical scan dtypes, plus the short spellings the CLIs accept.
SCAN_DTYPES = ("float32", "bfloat16", "int8")
_SCAN_DTYPE_ALIASES = {"fp32": "float32", "f32": "float32", "bf16": "bfloat16"}
_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_QUANT_BLOCK = 1 << 26  # elements of y quantized at a time

# Distances whose ``gy`` map is row-local, so that the rank-1 ``hy`` term of
# the dequantized rows is ``mf.hy`` applied to them directly.  KL and
# Hellinger quantize log/sqrt-space rows nonlinearly and stay out.
QUANTIZABLE = ("sqeuclidean", "euclidean", "neg_dot", "neg_cosine")


def canonical_scan_dtype(name: str) -> str:
    name = _SCAN_DTYPE_ALIASES.get(str(name), str(name))
    if name not in SCAN_DTYPES:
        raise ValueError(f"unknown scan dtype {name!r}; have {SCAN_DTYPES}")
    return name


def _require_quantizable(distance: str) -> Distance:
    if distance not in QUANTIZABLE:
        raise ValueError(f"distance {distance!r} has no row-local gy map; have {QUANTIZABLE}")
    return get_distance(distance)


def gy_rows(y: Tensor, distance: str) -> Tensor:
    """Rows mapped to ``gy`` space, the geometry every compressed replica
    (scalar, IVF cells) is built in.  Only ``QUANTIZABLE`` distances."""
    return _require_quantizable(distance).matmul_form.gy(y.float()).float()


class QuantizedRows(NamedTuple):
    """A low-precision replica of a database, pre-mapped to ``gy`` space.

    The scan computes ``finalize(alpha * (fx @ data^T) * scale + hx + hy)``:
    the per-row scale folds into the rank-1 epilogue beside ``hy``.

    data:  [n, d] rows in float32 / bfloat16 / int8.
    scale: [n] fp32 per-row symmetric scales (int8 only, else None).
    hy:    [n] fp32 rank-1 term of the DEQUANTIZED rows, so a scanned value
           is the exact distance to the dequantized row; the exact rescore
           repairs the candidate order.
    """

    data: Tensor
    scale: Tensor | None
    hy: Tensor


def quantize_rows(y: Tensor, scan_dtype: str, *, distance: str = "sqeuclidean") -> QuantizedRows:
    """The quantized scan replica of database rows ``y`` [n, d], on ``y``'s device.

    int8 uses per-row symmetric scales ``max|row| / 127`` and
    ``torch.round`` (half to even, as ``jnp.round``), so codes, scales and
    bf16 data equal the reference's bit for bit.  Every step is row-local,
    so the rows go through a block at a time into the preallocated replica:
    the temporaries stay a block in size however large the corpus (a
    cell-packed corpus can be many times the rows).
    """
    scan_dtype = canonical_scan_dtype(scan_dtype)
    mf = _require_quantizable(distance).matmul_form
    n, d = y.shape
    step = max(1, _QUANT_BLOCK // max(d, 1))
    hy = torch.empty(n, dtype=torch.float32, device=y.device)
    if scan_dtype == "float32":
        data, scale = mf.gy(y.float()).float(), None  # no copy where gy is the identity
    else:
        data = torch.empty((n, d), dtype=_STORAGE[scan_dtype], device=y.device)
        scale = (torch.empty(n, dtype=torch.float32, device=y.device)
                 if scan_dtype == "int8" else None)
    for r in range(0, n, step):
        rows = slice(r, r + step)
        if scan_dtype == "int8":
            g = mf.gy(y[rows].float()).float()
            scale[rows] = torch.clamp_min(g.abs().amax(dim=-1), _EPS) / 127.0
            data[rows] = torch.clamp(torch.round(g / scale[rows, None]), -127, 127)
        elif scan_dtype == "bfloat16":
            data[rows] = mf.gy(y[rows].float()).float()
        hy[rows] = mf.hy(_dequantize(data[rows], None if scale is None else scale[rows]))
    return QuantizedRows(data, scale, hy)


def _dequantize(data: Tensor, scale: Tensor | None) -> Tensor:
    deq = data.float()
    return deq if scale is None else deq * scale[:, None]


def dequantize_rows(q: QuantizedRows) -> Tensor:
    """fp32 rows the quantized scan effectively scores against."""
    return _dequantize(q.data, q.scale)
