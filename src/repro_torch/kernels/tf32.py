"""The 3xTF32 split of the matmul-form kernels' tile product, in plain PyTorch.

``csrc/gemm_tc.cuh`` computes ``fx @ gy^T`` on the tensor cores in TF32
(10 explicit mantissa bits), which alone would move distances by about 1e-3
relative.  So each fp32 operand is split, ``hi = tf32(x)`` and ``lo =
tf32(x - hi)``, and three products are summed in fp32, the small ones first:
``lo_a hi_b + hi_a lo_b + hi_a hi_b``.  A bf16 or int8 operand is exact in
TF32 (its ``lo`` is zero), so two products suffice.

``tf32_split`` rounds as ``cvt.rna.tf32.f32`` does (to nearest, ties away
from zero), by bit arithmetic on the int32 view, as the kernel does too;
the tests hold the kernel's arithmetic to float64 through
``tf32x3_matmul``, which repeats it pass by pass.  Each product of two
TF32 values is exact in fp32, so only the sums differ from the kernel's:
it adds 32-wide slices of d on the tensor cores and the slices' sums in
fp32.
"""
from __future__ import annotations

import torch

_LOW13 = (1 << 13) - 1
_HALF = 1 << 12
_EXPONENT = 0x7F800000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to TF32, to nearest with ties away from zero;
    inf and nan pass through."""
    u = x.contiguous().view(torch.int32)
    r = ((u + _HALF) & ~_LOW13).view(torch.float32)
    return torch.where((u & _EXPONENT) == _EXPONENT, x, r)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` with ``hi = tf32(x)``, ``lo = tf32(x - hi)``: ``hi + lo``
    is within 2^-22 |x| of ``x``.  A non-finite ``hi`` carries the value
    alone (``lo = 0``)."""
    x = x.float()
    hi = tf32_round(x)
    lo = torch.where(torch.isfinite(hi), tf32_round(x - hi), torch.zeros_like(x))
    return hi, lo


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b^T`` as the kernels' product forms it: a [m, d] fp32, b [n, d]
    fp32, bf16 or int8 (widened; exact in TF32, so its lo pass is skipped)."""
    a_hi, a_lo = tf32_split(a)
    if b.dtype == torch.float32:
        b_hi, b_lo = tf32_split(b)
        return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T
    b_hi = b.float()
    return a_lo @ b_hi.T + a_hi @ b_hi.T
