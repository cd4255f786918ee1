"""Phase 1 of the paper: the distance matrix, as two CUDA kernels.

The matmul form replaces
``repro/kernels/pairwise_distance.py::pairwise_distance_pallas`` (body
``_matmul_kernel``); source ``csrc/pairwise_distance.cu``.  The
per-coordinate (cumulative) route replaces
``pairwise_distance_cumulative_pallas`` (bodies ``_cumulative_kernel``,
``_coord_accumulate``); source ``csrc/pairwise_cumulative.cu``, described
at ``pairwise_distance_cumulative`` below.

Bound on the H100: operations (2·m·n·d as three TF32 passes on the tensor
cores, ``csrc/gemm_tc.cuh``: one pass would move distances by about 1e-3
relative, so each operand is split into TF32 halves, ``kernels/tf32.py``).
The kernel forms each 128 x 128 tile product with ``wgmma``, applies the
rank-1 epilogue and the finalizer to it in registers, and writes every
output element once; ragged edges are masked inside the kernel, so no
operand is padded or copied.

``pairwise_distance_plain`` is the same function in plain PyTorch: the
wrapper runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import ACCUMULATORS, CUMULATIVE_FINALIZERS, FINALIZERS
from repro_torch.kernels import _backend as B
from repro_torch.kernels.scan import PLAIN_CHUNK

LAUNCHES = 0
CUMULATIVE_LAUNCHES = 0
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
    m, d = fx.shape
    n = gy.shape[0]
    B.require(finalize in FINALIZE_CODES, lambda: f"unknown finalizer {finalize!r}")
    for name, t, shape in (("fx", fx, (m, d)), ("gy", gy, (n, d)),
                           ("hx", hx, (m, 1)), ("hy", hy, (1, n))):
        B.require_f32(name, t, shape)
    if B.on_meta(fx, gy, hx, hy):
        B.require_vec4(d, fx, gy)
        out = torch.empty((m, n), dtype=torch.float32, device="meta")
        B.shape_call("pairwise_distance", flops=2.0 * m * n * d,
                     nbytes=B.nbytes(fx, gy, hx, hy, out))
        return out
    if not B.on_cuda(fx, gy, hx, hy):
        return pairwise_distance_plain(fx, gy, hx, hy, alpha=alpha, finalize=finalize)
    B.require_vec4(d, fx, gy)
    out = torch.empty((m, n), dtype=torch.float32, device=fx.device)
    B.launch("pairwise_distance", "pairwise_distance_f32", C_ARGTYPES, fx.device,
             B.ptr(fx), B.ptr(gy), B.ptr(hx), B.ptr(hy), B.ptr(out), m, n, d,
             float(alpha), FINALIZE_CODES[finalize])
    B.count_launch(__name__, LAUNCHES=1)
    return out


# The cumulative kernel's accumulators and finalizers, by the codes its C
# entry point takes.
ACCUMULATE_CODES = {"sqeuclidean": 0, "neg_dot": 1, "hellinger": 2, "kl": 3}
CUMULATIVE_FINALIZE_CODES = {"identity": 0, "sqrt": 1, "half_sqrt": 2}
# fp32 operations per (pair, coordinate), counted by the fp32 pipe's instruction
# slots: an FSUB and an FFMA (four) for each accumulator but neg_dot's one
# FFMA (two); roots and logarithms are per element.
CUMULATIVE_OPS = {"sqeuclidean": 4, "neg_dot": 2, "hellinger": 4, "kl": 4}
# pairwise_cumulative(x, y, out, m, n, d, acc, fin, init, stream)
CUMULATIVE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])


def pairwise_cumulative_plain(x, y, *, accumulate: str, finalize: str, init: float = 0.0):
    """The per-coordinate route in plain PyTorch: the distance's own
    ``accumulate`` folded over coordinate chunks from ``init``, then its
    ``finalize``, over blocks of rows and columns small enough that the
    broadcast [rows, columns, chunk] temporaries stay near ``PLAIN_CHUNK``
    elements."""
    m, d = x.shape
    n = y.shape[0]
    acc_fn, fin = ACCUMULATORS[accumulate], CUMULATIVE_FINALIZERS[finalize]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    c = max(1, min(d, 32))
    bn = max(1, min(n, 4096))
    bm = max(1, PLAIN_CHUNK // (bn * c))
    for r0 in range(0, m, bm):
        xr = x[r0 : r0 + bm]
        for c0 in range(0, n, bn):
            yc = y[c0 : c0 + bn]
            acc = torch.full((xr.shape[0], yc.shape[0]), init, dtype=torch.float32,
                             device=x.device)
            for k0 in range(0, d, c):
                acc = acc_fn(xr[:, k0 : k0 + c], yc[:, k0 : k0 + c], acc)
            out[r0 : r0 + bm, c0 : c0 + bn] = fin(acc)
    return out


def pairwise_distance_cumulative(x, y, *, accumulate: str, finalize: str, init: float = 0.0):
    """[m, n] fp32 distance matrix by the per-coordinate route.

    ``x`` [m, d] and ``y`` [n, d] fp32, contiguous, after the distance's
    ``pre`` map; ``accumulate`` one of ``ACCUMULATE_CODES`` and
    ``finalize`` one of ``CUMULATIVE_FINALIZE_CODES``
    (``core.distances.cumulative_kind``).  CPU tensors run the plain
    version; CUDA tensors launch the kernel (d % 4 == 0; zero coordinates
    add nothing under any of the accumulators, so callers pad d with them).

    Bound on the H100: operations, 2 (``neg_dot``) or 3 fp32 operations per
    pair and coordinate.  Each CTA stages coordinate chunks of 128 rows and
    128 columns through shared memory (coalesced float4 loads, the
    square roots and logarithms taken once per element there) and each
    thread folds an 8 x 8 register tile one coordinate at a time, the
    paper's own phase-1 design; ragged edges are masked in the kernel.
    """
    m, d = x.shape
    n = y.shape[0]
    B.require(accumulate in ACCUMULATE_CODES, lambda: f"unknown accumulator {accumulate!r}")
    B.require(finalize in CUMULATIVE_FINALIZE_CODES, lambda: f"unknown finalizer {finalize!r}")
    B.require_f32("x", x, (m, d))
    B.require_f32("y", y, (n, d))
    if B.on_meta(x, y):
        B.require_vec4(d, x, y)
        out = torch.empty((m, n), dtype=torch.float32, device="meta")
        B.shape_call("pairwise_cumulative", flops=1.0 * m * n * d * CUMULATIVE_OPS[accumulate],
                     nbytes=B.nbytes(x, y, out))
        return out
    if not B.on_cuda(x, y):
        return pairwise_cumulative_plain(x, y, accumulate=accumulate, finalize=finalize,
                                         init=init)
    B.require_vec4(d, x, y)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    B.launch("pairwise_cumulative", "pairwise_cumulative", CUMULATIVE_ARGTYPES, x.device,
             B.ptr(x), B.ptr(y), B.ptr(out), m, n, d, ACCUMULATE_CODES[accumulate],
             CUMULATIVE_FINALIZE_CODES[finalize], float(init))
    B.count_launch(__name__, CUMULATIVE_LAUNCHES=1)
    return out
