"""Phase 1 of the paper: the matmul-form distance matrix, as a CUDA kernel.

Replaces ``repro/kernels/pairwise_distance.py::pairwise_distance_pallas``
(body ``_matmul_kernel``).  Source: ``csrc/pairwise_distance.cu``.

Bound on the H100: operations (2·m·n·d fp32 FMAs on the CUDA cores; TF32 is
ruled out because it moves distances by about 1e-3 relative).  The kernel
keeps each 128 x 128 tile product in registers, applies the rank-1 epilogue
and the finalizer there, and writes every output element once; ragged edges
are masked inside the kernel, so no operand is padded or copied.

``pairwise_distance_plain`` is the same function in plain PyTorch: the
wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import FINALIZERS
from repro_torch.kernels import _backend as B

LAUNCHES = 0
FINALIZE_CODES = {"identity": 0, "sqrt": 1}


def pairwise_distance_plain(fx, gy, hx, hy, *, alpha: float, finalize: str):
    """``finalize(alpha * fx @ gy^T + hx + hy)``; hx [m, 1], hy [1, n]."""
    return FINALIZERS[finalize](alpha * (fx @ gy.T) + hx + hy)


# pairwise_distance_f32(fx, gy, hx, hy, out, m, n, d, alpha, finalize, stream)
C_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])



def pairwise_distance(fx, gy, hx, hy, *, alpha: float, finalize: str):
    """[m, n] fp32 distance matrix from matmul-form operands.

    ``fx`` [m, d], ``gy`` [n, d], ``hx`` [m, 1], ``hy`` [1, n], all fp32 and
    contiguous; ``finalize`` is ``"identity"`` or ``"sqrt"``.  CPU tensors
    run the plain version; CUDA tensors launch the kernel (d % 4 == 0).
    """
    global LAUNCHES
    m, d = fx.shape
    n = gy.shape[0]
    B.require(finalize in FINALIZE_CODES, f"unknown finalizer {finalize!r}")
    for name, t, shape in (("fx", fx, (m, d)), ("gy", gy, (n, d)),
                           ("hx", hx, (m, 1)), ("hy", hy, (1, n))):
        B.require_f32(name, t, shape)
    if not B.on_cuda(fx, gy, hx, hy):
        return pairwise_distance_plain(fx, gy, hx, hy, alpha=alpha, finalize=finalize)
    B.require_vec4(d, fx, gy)
    out = torch.empty((m, n), dtype=torch.float32, device=fx.device)
    B.launch("pairwise_distance", "pairwise_distance_f32", C_ARGTYPES, fx.device,
             B.ptr(fx), B.ptr(gy), B.ptr(hx), B.ptr(hy), B.ptr(out), m, n, d,
             float(alpha), FINALIZE_CODES[finalize])
    LAUNCHES += 1
    return out
