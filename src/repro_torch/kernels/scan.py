"""What the two scan kernels share: operand checks, the plain tile, the
block and split plan, and the occupancy query.

Both are the kernel of ``csrc/fused_knn.cuh`` on the 3xTF32 product of
``csrc/gemm_tc.cuh``: ``csrc/fused_knn.cu`` walks contiguous 128-column
tiles of the whole database, ``csrc/ivf_scan.cu`` a table of the tiles of
the cells a probe list names; both fold the tiles into per-row K-buffers
(``csrc/select.cuh``).  Each is compiled once per storage type of ``gy``
(fp32, bf16, int8) and per presence of the ``gy_scale`` operand; its C
entry point takes the storage type as a code (``GY_CODES``, switched on in
``csrc/scan.cuh``) and the scale as a nullable pointer.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distances import FINALIZERS
from repro_torch.kernels import _backend as B

PLAIN_CHUNK = 1 << 27  # elements of a plain version's tile
# The storage types of a scanned database, by the code the C entry points take.
GY_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# <library>_occupancy(bm, K, gy_dtype, scaled, out[3])
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SHAPES: dict = {}


def scan_tile_plain(fx, gy, hx, hy, *, alpha: float, finalize: str, gy_scale=None):
    """``finalize(alpha * (fx @ gy^T) * gy_scale + hx + hy)`` in the
    reference's order, with ``gy`` of any storage type widened to fp32."""
    t = alpha * (fx @ gy.float().T)
    if gy_scale is not None:
        t = t * gy_scale
    return FINALIZERS[finalize](t + hx + hy)


def check_scan_operands(fx, gy, hx, hy, gy_scale) -> None:
    """Types and shapes of a scan kernel's operands: fx [m, d], hx [m, 1],
    hy [1, n] and gy_scale [1, n] fp32; gy [n, d] fp32, bf16 or int8; all
    contiguous."""
    m, d = fx.shape
    n = gy.shape[0]
    B.require(gy.dtype in GY_CODES, lambda: f"gy: want float32, bfloat16 or int8, got {gy.dtype}")
    B.require(tuple(gy.shape) == (n, d) and gy.is_contiguous(),
              lambda: f"gy: want contiguous [{n}, {d}], got {tuple(gy.shape)}")
    for name, t, shape in (("fx", fx, (m, d)), ("hx", hx, (m, 1)), ("hy", hy, (1, n))):
        B.require_f32(name, t, shape)
    if gy_scale is not None:
        B.require_f32("gy_scale", gy_scale, (1, n))


WIDE_MAX_K = 32  # the widest K of the scan kernel's 128-row layout (fused_knn.cuh kWideMaxK)


def block_rows(m: int, K: int) -> int:
    """BM, the query rows of a CTA: 128 where the K-buffers leave the room
    (K <= 32) and the batch fills them, else 64 (K-buffers in shared memory
    up to K = 256, in the output above)."""
    return 128 if (K <= WIDE_MAX_K and m > 64) else 64


def split_plan(m: int, n: int, bm: int, tile_n: int, resident: int) -> tuple[int, int]:
    """(splits, units per split) of the scanned axis: ``n`` columns in tiles
    of ``tile_n`` (or ``n`` probe-list slots, ``tile_n`` = 1).

    The axis is split until the grid fills the card's ``resident`` CTAs
    once, and never past that: a second, partial wave would take as long
    as the first.  With at least ``resident`` query tiles it is not split.
    """
    row_tiles = -(-m // bm)
    n_tiles = -(-n // tile_n)
    splits = max(1, min(n_tiles, resident // row_tiles))
    tps = -(-n_tiles // splits)
    return -(-n_tiles // tps), tps


def kernel_shape(library: str, device: torch.device, bm: int, K: int,
                 gy_dtype=torch.float32, scaled: bool = False) -> tuple[int, int, int]:
    """(CTAs resident per SM, columns per tile, shared-memory bytes per CTA)
    of scan kernel ``library`` (``fused_knn``, ``fused_knn_masked`` or
    ``ivf_scan``) as compiled
    for BM, K, the storage type of gy and the scale, as the CUDA occupancy
    calculator gives them for its registers and shared memory."""
    key = (library, torch.device(device).index, bm, K, gy_dtype, scaled)
    if key not in _SHAPES:
        out = (ctypes.c_int * 3)()
        B.call(library, f"{library}_occupancy", OCCUPANCY_ARGTYPES, device, bm, K,
               GY_CODES[gy_dtype], int(scaled), out)
        B.require(out[0] > 0, lambda: f"the {library} kernel does not fit an SM at BM={bm}, K={K}")
        _SHAPES[key] = tuple(out)
    return _SHAPES[key]
