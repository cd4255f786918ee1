"""Exact rescore of gathered candidate rows, as a CUDA kernel.

Stage 2 of the two-stage quantized scan and of IVF: each query row is
scored exactly against its own ``Kp`` candidate rows, and the K smallest
are kept.  Replaces ``repro/kernels/rescore.py::rescore_topk_pallas``
(body ``_kernel``).  Source: ``csrc/rescore.cu``, selection in
``csrc/select.cuh``.  The gather of the candidate rows and their ``gy`` /
``hy`` maps stay outside, in ``ops.rescore_topk``, as the reference leaves
them to XLA.

Bound on the H100: bytes (the gathered [m, Kp, d] block is read once, for
2 FLOP a float).  A CTA of 8 warps takes ``qb`` query rows (``kernel_shape``:
enough that every warp gets 32 candidates a stage, as many as shared memory
holds); each warp streams its candidates' rows through a ``cp.async`` ring
in shared memory, 32 rows by 32 floats a slot, and lane j dots candidate j
in fp32.  The selection is the staged bulk merge of ``csrc/select.cuh`` at
every K up to ``stream_topk.MAX_SELECT_K`` = 4096: each row's K-buffer and
staging area lie in shared memory, one kernel for every K.

Result contract: per row the K = next_pow2(k) smallest of
``finalize(alpha * <fx[i], cand[i, c]> + hx[i] + hy_cand[i, c])`` by
(value, position), as values and POSITIONS into the candidate axis;
``+inf`` candidates (``hy_cand = +inf``, an empty slot) never enter, and
an unfilled slot reads (``+inf``, ``-1``).  ``rescore_topk_plain`` is that
contract in plain PyTorch: a batched dot, the epilogue, a stable sort.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import topk as T
from repro_torch.core.distances import FINALIZERS
from repro_torch.kernels import _backend as B
from repro_torch.kernels.pairwise_distance import FINALIZE_CODES
from repro_torch.kernels.stream_topk import MAX_K, require_card_k, sorted_prefix

LAUNCHES = 0
WIDE_LAUNCHES = 0  # launches at K > MAX_K (counted in LAUNCHES too)


def rescore_topk_plain(fx, cand, hx, hy_cand, k: int, *, alpha: float, finalize: str):
    """(values [m, K], positions [m, K]) by a batched dot and a stable sort."""
    acc = (fx[:, None, :] * cand).sum(-1)
    tile = FINALIZERS[finalize](alpha * acc + hx + hy_cand)
    return sorted_prefix(tile, T.next_pow2(k))


# rescore_f32(fx, cand, hx, hy_cand, out_v, out_pos, m, Kp, d, K, alpha,
#             finalize, stream)
C_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
              + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# rescore_occupancy(Kp, d, K, out[3])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SHAPES: dict = {}


def kernel_shape(device: torch.device, Kp: int, d: int, K: int) -> tuple[int, int, int]:
    """(query rows a CTA takes, CTAs resident per SM, shared-memory bytes
    per CTA) of the kernel for candidates [*, Kp, d] at width K."""
    dev = torch.device(device)
    key = (dev.index, Kp, d, K)
    if key not in _SHAPES:
        out = (ctypes.c_int * 3)()
        B.call("rescore", "rescore_occupancy", OCCUPANCY_ARGTYPES, dev, Kp, d, K, out)
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]


def rescore_topk(fx, cand, hx, hy_cand, k: int, *, alpha: float, finalize: str):
    """Exact top-K of each row's candidates; (values [m, K], positions [m, K]).

    ``fx`` [m, d], ``cand`` [m, Kp, d] (the gathered rows in ``gy`` form),
    ``hx`` [m, 1] and ``hy_cand`` [m, Kp] (``+inf`` on an empty slot), all
    fp32 and contiguous.  CPU tensors run the plain version; CUDA tensors
    launch the kernel (d % 4 == 0, K <= 4096).
    """
    m, d = fx.shape
    Kp = cand.shape[1]
    K = T.next_pow2(k)
    B.require(finalize in FINALIZE_CODES, lambda: f"unknown finalizer {finalize!r}")
    for name, t, shape in (("fx", fx, (m, d)), ("cand", cand, (m, Kp, d)),
                           ("hx", hx, (m, 1)), ("hy_cand", hy_cand, (m, Kp))):
        B.require_f32(name, t, shape)
    if B.on_meta(fx, cand, hx, hy_cand):
        require_card_k(K, "rescore_topk")
        B.require_vec4(d, fx, cand)
        v, i = B.meta_topk((m,), K)
        B.shape_call("rescore_topk", flops=2.0 * m * Kp * d,
                     nbytes=B.nbytes(fx, cand, hx, hy_cand, v, i))
        return v, i
    if not B.on_cuda(fx, cand, hx, hy_cand):
        return rescore_topk_plain(fx, cand, hx, hy_cand, k, alpha=alpha, finalize=finalize)
    require_card_k(K, "rescore_topk")
    B.require_vec4(d, fx, cand)
    vals = torch.empty((m, K), dtype=torch.float32, device=fx.device)
    pos = torch.empty((m, K), dtype=torch.int32, device=fx.device)
    if m == 0 or Kp == 0:
        return vals.fill_(T.POS_INF), pos.fill_(-1)
    B.launch("rescore", "rescore_f32", C_ARGTYPES, fx.device, B.ptr(fx), B.ptr(cand),
             B.ptr(hx), B.ptr(hy_cand), B.ptr(vals), B.ptr(pos), m, Kp, d, K, float(alpha),
             FINALIZE_CODES[finalize])
    B.count_launch(__name__, LAUNCHES=1, WIDE_LAUNCHES=K > MAX_K)
    return vals, pos
