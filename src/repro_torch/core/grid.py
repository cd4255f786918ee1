"""Problem decomposition and multi-device workload balancing (paper Sect. 4).

The port's own copy of ``repro/core/grid.py`` (numpy only; the port imports
nothing of the JAX package).  The n x n pairwise-distance problem is a
square where point (x, y) is delta(v_x, v_y).  For a symmetric delta only
the upper triangle is computed.  The square is cut into GSIZE x GSIZE
*grids* and grid-row i goes to device j by the paper's boustrophedon
("zigzag") rule:

    i mod 2*nDevices == j   or   i mod 2*nDevices == 2*nDevices - j - 1

Grid-row i of the triangle holds (nGrids - i) tiles, so pairing rows
forward and backward gives each device the same tile count to within one
zigzag period.  The schedule drives ``core.distributed``'s triangle: the
assignment is static, and every position's tile list is padded to the
common maximum.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def device_for_grid_row(i: int, n_devices: int) -> int:
    """Paper's zigzag assignment: which device owns grid-row ``i``."""
    r = i % (2 * n_devices)
    return r if r < n_devices else 2 * n_devices - r - 1


def rows_for_device(j: int, n_grids: int, n_devices: int) -> list[int]:
    return [i for i in range(n_grids) if device_for_grid_row(i, n_devices) == j]


def tiles_for_device(j: int, n_grids: int, n_devices: int) -> list[tuple[int, int]]:
    """All (X, Y) upper-triangle tiles (X >= Y) owned by device ``j``.

    Diagonal tiles (X == Y) are included: they hold the triangle's diagonal
    blocks and are half-wasted, as in the paper (each GPU "virtually
    computes the mirror side").
    """
    out = []
    for Y in rows_for_device(j, n_grids, n_devices):
        for X in range(Y, n_grids):
            out.append((X, Y))
    return out


def workload(n_grids: int, n_devices: int) -> list[int]:
    return [len(tiles_for_device(j, n_grids, n_devices)) for j in range(n_devices)]


def workload_imbalance(n_grids: int, n_devices: int) -> int:
    w = workload(n_grids, n_devices)
    return max(w) - min(w)


@dataclasses.dataclass(frozen=True)
class GridSchedule:
    """Static padded per-device tile schedule.

    Attributes:
      n: number of vectors.
      gsize: side of one grid (rows of vectors per grid).
      n_grids: ceil(n / gsize).
      tiles: int32 [n_devices, max_tiles, 2]; tiles[j, t] = (X, Y) or (0, 0)
        padding where valid[j, t] is False.
      valid: bool [n_devices, max_tiles].
    """

    n: int
    gsize: int
    n_grids: int
    tiles: np.ndarray
    valid: np.ndarray

    @property
    def n_devices(self) -> int:
        return self.tiles.shape[0]

    @property
    def max_tiles(self) -> int:
        return self.tiles.shape[1]


def make_schedule(n: int, gsize: int, n_devices: int) -> GridSchedule:
    n_grids = -(-n // gsize)  # paper line 2: floor((n-1)/GSIZE) + 1
    per_dev = [tiles_for_device(j, n_grids, n_devices) for j in range(n_devices)]
    max_tiles = max(len(t) for t in per_dev) if per_dev else 0
    tiles = np.zeros((n_devices, max_tiles, 2), np.int32)
    valid = np.zeros((n_devices, max_tiles), bool)
    for j, ts in enumerate(per_dev):
        for t, (X, Y) in enumerate(ts):
            tiles[j, t] = (X, Y)
            valid[j, t] = True
    return GridSchedule(n=n, gsize=gsize, n_grids=n_grids, tiles=tiles, valid=valid)


def choose_gsize(n: int, n_devices: int, target_tiles_per_device: int = 8) -> int:
    """GSIZE such that each device gets >= target tiles (paper: "GSIZE is
    determined depending on n so that the problem can be divided
    effectively").

    Total triangle tiles = G(G+1)/2 for G = n/gsize grid rows; we want
    G(G+1)/2 >= target * n_devices, gsize a multiple of 128 (the
    reference's lane width, kept so both packages pick the same GSIZE).
    """
    need = max(1, target_tiles_per_device * n_devices)
    G = 1
    while G * (G + 1) // 2 < need:
        G += 1
    gsize = max(128, ((n // G) // 128) * 128 if n >= 128 * G else 128)
    return min(gsize, max(128, n))
