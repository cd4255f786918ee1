"""Split the ``ivf_scan`` kernel's time between its walk and its data, on one card.

    python3 src/repro_torch/ivf_walk_probe.py

At ``chip_smoke.py`` phase 6's shape (``clustered_vectors(1,048,576 +
8,192, 256, n_clusters=4096, seed=0)``, the k-means of 4096 cells seeded 1,
1024 queries, nprobe 8, union tiles of 256, K' 64, fp32, every row live),
with the plan's BM and splits, times by CUDA events (median of five, after
a warm-up):

- ``table``: the kernel on its own tile table, the first T entries of
  each union tile's (T the fewest any union tile has);
- ``contiguous``: the kernel on a table of the same length whose entries
  are the packed slots' first T 128-column tiles in order (mostly pad rows,
  hy = +inf, which never enter the selection);
- ``fused``: ``fused_knn``'s contiguous walk over those same rows, with the
  same BM and splits;

each at the full length and at half and a quarter of it.  ``table`` minus
``contiguous`` is what the live, clustered candidates cost the selection;
``contiguous`` against ``fused`` is what the table walk costs.  Prints the
card's name and power limit, then one JSON object.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from repro_torch.core.ivf import (  # noqa: E402
    pack_cells,
    packed_live,
    probe_cells,
    train_centroids,
)
from repro_torch.data.synthetic import clustered_vectors  # noqa: E402
from repro_torch.kernels import _backend as B  # noqa: E402
from repro_torch.kernels import fused_knn as FK  # noqa: E402
from repro_torch.kernels import ivf_scan as IVS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def timed(fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("ivf_walk_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    n, m, K = 1 << 20, 1024, 64
    x = clustered_vectors(n + 8192, 256, n_clusters=4096, seed=0)
    db, q = torch.from_numpy(x[:n]).to(dev), torch.from_numpy(x[n:][:m]).to(dev)
    cells = pack_cells(db, *train_centroids(db, 4096, distance="neg_dot",
                                            generator=torch.Generator().manual_seed(1)))
    del db
    cq = probe_cells(q, cells.centroids, 8, distance="neg_dot")
    probes, fx, gy, gs, hx, hy, alpha, tile_m, extent = ops.ivf_scan_operands(
        q, cells.packed, cq, K, cell_cap=cells.cell_cap, distance="neg_dot",
        packed_live=packed_live(cells))
    table, bounds, bm, splits = IVS.plan(probes, extent, cells.cell_cap, m, tile_m, K, dev)
    nt = len(probes)
    T = int(bounds[:, -1].min())  # entries every union tile's table holds
    e = torch.arange(T, device=dev)
    contiguous = torch.stack([(e * IVS.TILE_COLS).expand(nt, T),
                              torch.full((nt, T), gy.shape[0], device=dev)], 2).int().contiguous()

    def launch(tab, bnd):
        vals = torch.empty((splits, m, K), device=dev)
        idx = torch.empty((splits, m, K), dtype=torch.int32, device=dev)
        B.launch("ivf_scan", "ivf_scan", IVS.C_ARGTYPES, dev, B.ptr(tab), B.ptr(bnd), B.ptr(fx),
                 B.ptr(gy), B.ptr(gs), B.ptr(hx), B.ptr(hy), B.ptr(vals), B.ptr(idx), m,
                 fx.shape[1], gy.shape[0], tab.shape[1], K, tile_m, 1, float(alpha), 0,
                 0, bm, splits)

    out = {"bm": bm, "splits": splits, "union_tiles": nt, "entries": T}
    plan = FK.plan
    for frac in (1, 2, 4):
        per = T // frac // splits  # entries a split
        bnd = (torch.arange(splits + 1, device=dev) * per).int().expand(nt, -1).contiguous()
        cols = per * splits * IVS.TILE_COLS
        hy_c = hy[:, :cols].contiguous()
        FK.plan = lambda *a, **k: (bm, splits, per)  # noqa: E731
        out[f"tiles_per_cta_{per}"] = {
            "table": timed(lambda: launch(table, bnd)),
            "contiguous": timed(lambda: launch(contiguous, bnd)),
            "fused": timed(lambda: FK.fused_knn_partials(
                fx, gy[:cols], hx, hy_c, K, distance_finalize="identity", alpha=alpha,
                n_real=cols))}
        FK.plan = plan
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
