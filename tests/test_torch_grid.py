"""The port's zigzag schedule (``repro_torch.core.grid``) against the
reference's ``repro.core.grid``: every function, over n_grids 1..40 and
1..8 devices.  Integers and integer arrays, so equality is exact."""
import numpy as np
import pytest

from repro.core import grid as RG
from repro_torch.core import grid as PG


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_grid_functions_equal_the_reference(n_devices):
    for n_grids in range(1, 41):
        for i in range(n_grids):
            assert PG.device_for_grid_row(i, n_devices) == RG.device_for_grid_row(i, n_devices)
        for j in range(n_devices):
            assert PG.rows_for_device(j, n_grids, n_devices) == RG.rows_for_device(
                j, n_grids, n_devices)
            assert PG.tiles_for_device(j, n_grids, n_devices) == RG.tiles_for_device(
                j, n_grids, n_devices)
        assert PG.workload(n_grids, n_devices) == RG.workload(n_grids, n_devices)
        assert PG.workload_imbalance(n_grids, n_devices) == RG.workload_imbalance(
            n_grids, n_devices)
        for gsize in (128, 256):
            n = n_grids * gsize - 37
            got, want = PG.make_schedule(n, gsize, n_devices), RG.make_schedule(n, gsize, n_devices)
            assert (got.n, got.gsize, got.n_grids, got.n_devices, got.max_tiles) == (
                want.n, want.gsize, want.n_grids, want.n_devices, want.max_tiles)
            np.testing.assert_array_equal(got.tiles, want.tiles)
            np.testing.assert_array_equal(got.valid, want.valid)
        for n in (n_grids, 128 * n_grids, 1000 * n_grids + 7):
            for target in (1, 8):
                assert PG.choose_gsize(n, n_devices, target) == RG.choose_gsize(
                    n, n_devices, target)
