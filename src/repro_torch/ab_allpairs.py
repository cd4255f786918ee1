"""Time the kernels of several source trees, in turn, on one card.

    python3 src/repro_torch/ab_allpairs.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` is imported from there, and its kernels are built beside
it, in that checkout's ``build/``.  Each SRC runs in a process of its own,
which times these calls, each after one warm-up call (the first of which
builds the kernels), five times by CUDA events:

- ``allpairs``: ``knn_allpairs(x, 100, impl="fused")`` at the
  ``allpairs_160k`` cell (n = 160,000 ``random_vectors(seed=0)``, d = 256,
  sqeuclidean);
- ``pairwise``: the ``pairwise_distance`` kernel on rows 0..8191 of that x
  against all 160,000 (sqeuclidean operands);
- ``serving``: one fused serving batch, the ``fused_knn`` kernel (with its
  merge) on 1024 queries over the ``query_1m`` rows (1,048,576 x 256
  ``random_vectors(seed=0)``), ``neg_dot``, k = 10;
- ``ivf_<dtype>_<m>``: the ``ivf_scan`` kernel (with its merge) at
  ``chip_smoke.py`` phase 6's shape: ``clustered_vectors(1,048,576 +
  8,192, 256, n_clusters=4096, seed=0)``, 4096 cells of the k-means that
  phase 6 trains (seeded 1; trained once, by the first process, and kept
  in ``build/ab_ivf_cells.pt``), ``nprobe`` 8, ``neg_dot``, K' 64, union
  tiles of up to 256 queries, every row live; batches of 1024 and 8
  queries over the fp32 and the int8 packed rows;
- ``merge_<S>x<m>x<K>``: the ``merge_partials`` kernel on random ascending
  partial sets at the serving batch's shape (16 x 1024 x 16) and at a
  filtered fetch's (8 x 1024 x 512), and beside it ``torch.topk`` over the
  ``[m, S K]`` concatenation (``library_ms``);
- ``topk_<m>x160000_k<k>``: the ``stream_topk`` kernel (with its merge,
  where it splits) on rows of the ``pairwise`` matrix, self excluded as in
  ``chip_smoke.py`` phase 3: 8192 rows at k 100, 1024 rows at k 4096 and at
  k 100 (phase 3b's shape), each beside ``torch.topk`` (``library_ms``);
- ``wide_k512_masked`` and ``wide_k2048_int8_masked``: the ``fused_knn``
  kernel (with its merge) on the serving batch's queries and rows under
  ``chip_smoke.py`` phase 8's tenant filter with 500 exclusions a query
  (tags drawn with shares proportional to 1 / (t + 1), 8 tenants; 500
  drawn columns cleared in each query's bitmap), at k 510 (K 512, the flat
  tier) and k 2048 over the int8 replica (K' 2048, the two-stage tier),
  each beside k 64 on the same operands (``wide_k64_*``: the same 64-row
  walk with K-buffers in shared memory);
- ``ivf_float32_1024_k2048``: ``ivf_scan`` as above at k 2048 (the IVF
  tier's fetch under 500 exclusions);
- ``rescore_<m>x<Kp>_k<k>``: the ``rescore_topk`` kernel on drawn
  candidates, d 256, at the two-stage tier's shape (1024 x 64, k 10), a
  filtered fetch's (1024 x 2048, k 510) and the card's cap (128 x 8192,
  k 4096), also by a CUDA graph (``graph_ms``);
- ``pq_<m>`` and ``pq_1024_k2048``: the ``pq_scan`` kernel (with its merge)
  at ``chip_smoke.py`` phase 7's shape (also by a CUDA graph, ``graph_ms``,
  where the call can be captured), on phase 6's cells and an IVF-PQ
  replica of them (``pq_m`` 32, 8 bits, residual, ``neg_dot``; codebooks
  trained once by the first process, seeded 1, into ``build/ab_pq.pt``):
  batches of 1024 and 8 queries at K' 128 (a fetch of 80, overfetch 8),
  and 1024 at K 2048 (the fetch under 500 exclusions).

Listing two trees as A B B A compares them within one run of this script,
on one card, under one power limit.  The card's name and power limit head
the output; each process prints one JSON line (its times, and checksums of
the ids, so that the trees are seen to compute the same result), and the
lines also go to ``chiprun_out/ab_allpairs.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
IVF_CASES = tuple(f"ivf_{sd}_{m}" for sd in ("float32", "int8") for m in (1024, 8))
MERGE_SHAPES = ((16, 1024, 16), (8, 1024, 512))
MERGE_CASES = tuple(f"merge_{s}x{m}x{k}" for s, m, k in MERGE_SHAPES)
TOPK_SHAPES = ((8192, 100), (1024, 4096), (1024, 100))
TOPK_CASES = tuple(f"topk_{m}x160000_k{k}" for m, k in TOPK_SHAPES)
PQ_CASES = ("pq_1024", "pq_8", "pq_1024_k2048")
WIDE_CASES = ("wide_k64_masked", "wide_k512_masked", "wide_k64_int8_masked",
              "wide_k2048_int8_masked", "ivf_float32_1024_k2048")
RESCORE_SHAPES = ((1024, 64, 10), (1024, 2048, 510), (128, 8192, 4096))
RESCORE_CASES = tuple(f"rescore_{m}x{kp}_k{k}" for m, kp, k in RESCORE_SHAPES)
LIBRARY_CASES = (*MERGE_CASES, *TOPK_CASES)
CASES = ("allpairs", "pairwise", "serving", *IVF_CASES, *MERGE_CASES, *TOPK_CASES, *PQ_CASES,
         *WIDE_CASES, *RESCORE_CASES)

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.knn import knn_allpairs
from repro_torch.data.synthetic import random_vectors
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ops
from repro_torch.kernels import pairwise_distance as PD

torch.backends.cuda.matmul.allow_tf32 = False


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return out, {"median_ms": statistics.median(times), "runs_ms": times, "first_call_s": first_s}


# Device ms of one call: n calls captured in a CUDA graph and replayed, so
# that the host's share drops out; None where a call cannot be captured (it
# reads back from the card).
def graph_ms(fn, n=10):
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        return timed(g.replay)[1]["median_ms"] / n
    except Exception:
        torch.cuda.synchronize()
        return None


report = {"src": sys.argv[1]}
x = torch.from_numpy(random_vectors(160_000, 256, seed=0)).to("cuda")
res, report["allpairs"] = timed(lambda: knn_allpairs(x, 100, impl="fused"))
report["allpairs"]["ids_checksum"] = int(res.indices.long().sum())
del res
fx, gy, hx, hy, alpha = ops._mxu_operands(x[:8192].contiguous(), x, "sqeuclidean")
out, report["pairwise"] = timed(
    lambda: PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity"))
report["pairwise"]["argmin_checksum"] = int(out.argmin(1).long().sum())
del fx, gy, hx, hy, x
from repro_torch.kernels import stream_topk as ST

out.diagonal().fill_(float("inf"))  # exclude self, as chip_smoke.py phase 3 does
for m, k in ((8192, 100), (1024, 4096), (1024, 100)):
    dm = out[:m]
    key = f"topk_{m}x160000_k{k}"
    (v, i), report[key] = timed(lambda: ST.stream_topk(dm, k))
    report[key]["ids_checksum"] = int(i[:, :k].long().sum())
    _, lib = timed(lambda: torch.topk(dm, k, dim=1, largest=False))
    report[key]["library_ms"] = lib["median_ms"]
    del v, i
del out, dm
db = torch.from_numpy(random_vectors(1 << 20, 256, seed=0)).to("cuda")
fx, gy, hx, hy, alpha = ops._mxu_operands(db[:1024].contiguous(), db, "neg_dot")
(v, i), report["serving"] = timed(lambda: FK.fused_knn(
    fx, gy, hx, hy, 10, distance_finalize="identity", alpha=alpha, n_real=gy.shape[0]))
report["serving"]["ids_checksum"] = int(i[:, :10].long().sum())
del v, i
from repro_torch.core.distances import quantize_rows

gt = torch.Generator(device="cuda").manual_seed(22)
share = 1.0 / torch.arange(1, 9, device="cuda")
tags = torch.multinomial(share, db.shape[0], replacement=True, generator=gt)
q_ten = torch.randint(0, 8, (1024,), device="cuda", generator=gt)
allowed = tags[None, :] == q_ten[:, None]
allowed.scatter_(1, torch.randint(0, db.shape[0], (1024, 500), device="cuda", generator=gt),
                 False)
words = FK.pack_mask(allowed)
del allowed, tags
q8 = quantize_rows(db, "int8", distance="neg_dot")
for key, k, g_, gs_ in (("wide_k64_masked", 64, gy, None), ("wide_k512_masked", 510, gy, None),
                        ("wide_k64_int8_masked", 64, q8.data, q8.scale.float()[None, :]),
                        ("wide_k2048_int8_masked", 2048, q8.data, q8.scale.float()[None, :])):
    (v, i), report[key] = timed(lambda: FK.fused_knn(
        fx, g_, hx, hy, k, distance_finalize="identity", alpha=alpha, n_real=gy.shape[0],
        gy_scale=gs_, q_mask=words))
    report[key]["ids_checksum"] = int(i.long().sum())
    del v, i
del db, fx, gy, hx, hy, q8, words

from repro_torch.kernels import rescore as RS

for m, kp, k in ((1024, 64, 10), (1024, 2048, 510), (128, 8192, 4096)):
    fx = torch.randn(m, 256, device="cuda", generator=gt)
    cand = torch.randn(m, kp, 256, device="cuda", generator=gt)
    hx = torch.randn(m, 1, device="cuda", generator=gt)
    hy = torch.randn(m, kp, device="cuda", generator=gt).abs()
    key = f"rescore_{m}x{kp}_k{k}"
    (v, i), report[key] = timed(lambda: RS.rescore_topk(fx, cand, hx, hy, k, alpha=-2.0,
                                                        finalize="identity"))
    report[key]["ids_checksum"] = int(i.long().sum())
    report[key]["graph_ms"] = graph_ms(lambda: RS.rescore_topk(fx, cand, hx, hy, k, alpha=-2.0,
                                                               finalize="identity"))
    del fx, cand, hx, hy, v, i

from repro_torch.core.ivf import pack_cells, packed_live, probe_cells
from repro_torch.data.synthetic import clustered_vectors
from repro_torch.kernels import ivf_scan as IVS
from repro_torch.kernels import merge_partials as MP

xc = torch.from_numpy(clustered_vectors((1 << 20) + 8192, 256, n_clusters=4096, seed=0))
db, q = xc[: 1 << 20].to("cuda"), xc[1 << 20 :][:1024].to("cuda")
cent, assign = torch.load(sys.argv[2])
cells = pack_cells(db, cent.to("cuda"), assign.to("cuda"))
live = packed_live(cells)
for sd in ("float32", "int8"):
    packed_q = quantize_rows(cells.packed, sd, distance="neg_dot")
    for m, k in ((1024, 64), (8, 64)) + (((1024, 2048),) if sd == "float32" else ()):
        cq = probe_cells(q[:m], cells.centroids, 8, distance="neg_dot")
        probes, fx, gy, gs, hx, hy, alpha, tile_m, extent = ops.ivf_scan_operands(
            q[:m], packed_q, cq, k, cell_cap=cells.cell_cap, distance="neg_dot",
            packed_live=live)
        key = f"ivf_{sd}_{m}" + ("" if k == 64 else f"_k{k}")
        (v, i), report[key] = timed(lambda: IVS.ivf_scan(
            probes, fx, gy, hx, hy, k, cell_cap=cells.cell_cap, tile_m=tile_m,
            distance_finalize="identity", alpha=alpha, gy_scale=gs, cell_extent=extent))
        report[key]["ids_checksum"] = int(i[:, :10].long().sum())
    del packed_q

from repro_torch.core.knn import scan_width
from repro_torch.core.pq import pq_from_arrays
from repro_torch.kernels import pq_scan as PQS

pcb, pcodes = pq_from_arrays({key: val.numpy() for key, val in torch.load(sys.argv[3]).items()},
                             device="cuda")
k_scan = scan_width(1 << 20, 10, 8)
for m, k in ((1024, k_scan), (8, k_scan), (1024, min(2048, cells.cell_cap))):
    cq = probe_cells(q[:m], cells.centroids, 8, distance="neg_dot")
    probes, luts, cds, hx, hy, qc, tile_m, extent = ops.pq_scan_operands(
        q[:m], pcb, pcodes, cq, k, cell_cap=cells.cell_cap, centroids=cells.centroids,
        distance="neg_dot", packed_live=live)
    key = f"pq_{m}" + ("_k2048" if k > k_scan else "")
    (v, i), report[key] = timed(lambda: PQS.pq_scan(
        probes, luts, cds, hx, hy, k, cell_cap=cells.cell_cap, ncodes=pcb.ncodes,
        tile_m=tile_m, cell_extent=extent, qc=qc, distance_finalize="identity"))
    report[key]["ids_checksum"] = int(i[:, :10].long().sum())
    report[key]["graph_ms"] = graph_ms(lambda: PQS.pq_scan(
        probes, luts, cds, hx, hy, k, cell_cap=cells.cell_cap, ncodes=pcb.ncodes,
        tile_m=tile_m, cell_extent=extent, qc=qc, distance_finalize="identity"))
    del probes, luts, cds, hx, hy, qc, v, i
del db, cells, live, xc, pcb, pcodes

g = torch.Generator().manual_seed(0)
for S, m, K in ((16, 1024, 16), (8, 1024, 512)):
    pv = torch.sort(torch.randn(S, m, K, generator=g), dim=2).values.to("cuda")
    cols = torch.sort(torch.rand(S, m, 4 * K, generator=g).argsort(2)[:, :, :K], dim=2).values
    pi = (cols + torch.arange(S)[:, None, None] * 4 * K).int().to("cuda")
    key = f"merge_{S}x{m}x{K}"
    (v, i), report[key] = timed(lambda: MP.merge_partials(pv, pi))
    report[key]["ids_checksum"] = int(i.long().sum())
    cat_v = pv.permute(1, 0, 2).reshape(m, S * K).contiguous()
    _, lib = timed(lambda: torch.topk(cat_v, K, dim=1, largest=False))
    report[key]["library_ms"] = lib["median_ms"]
print(json.dumps(report))
"""

# Trains phase 6's cells once (the k-means of chip_smoke.py, seeded 1) and
# keeps the centroids and the assignment for the timing processes; then the
# IVF-PQ replica of those cells (phase 7's pq_m 32, 8 bits, seeded 1).
SETUP = r"""
import sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.ivf import train_centroids
from repro_torch.data.synthetic import clustered_vectors

torch.backends.cuda.matmul.allow_tf32 = False
xc = clustered_vectors((1 << 20) + 8192, 256, n_clusters=4096, seed=0)
db = torch.from_numpy(xc[: 1 << 20]).to("cuda")
cent, assign = train_centroids(db, 4096, distance="neg_dot",
                               generator=torch.Generator().manual_seed(1))
torch.save((cent.cpu(), assign.cpu()), sys.argv[2])

from repro_torch.core.ivf import pack_cells
from repro_torch.core.pq import encode_ivfpq, pq_to_arrays, train_ivfpq

cells = pack_cells(db, cent, assign)
cb = train_ivfpq(db, cells, 32, nbits=8, distance="neg_dot",
                 generator=torch.Generator().manual_seed(1))
arrays = pq_to_arrays(cb, encode_ivfpq(cb, cells, distance="neg_dot"))
torch.save({key: torch.from_numpy(val) for key, val in arrays.items()}, sys.argv[3])
"""


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    cells = ROOT / "build" / "ab_ivf_cells.pt"
    pq = ROOT / "build" / "ab_pq.pt"
    if not (cells.exists() and pq.exists()):
        cells.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([sys.executable, "-c", SETUP, os.path.abspath(argv[1]), str(cells),
                               str(pq)], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
    runs = []
    for src in argv[1:]:
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(src), str(cells),
                               str(pq)], capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    srcs = list(dict.fromkeys(r["src"] for r in runs))
    summary = {case: {src: statistics.median(r[case]["median_ms"] for r in runs
                                             if r["src"] == src) for src in srcs}
               for case in CASES}
    summary.update({f"{case}_library": {src: statistics.median(
        r[case]["library_ms"] for r in runs if r["src"] == src) for src in srcs}
        for case in LIBRARY_CASES})
    same = {case: len({json.dumps({k: v for k, v in r[case].items() if "checksum" in k})
                       for r in runs}) == 1 for case in CASES}
    report = {"card": card.splitlines()[0], "runs": runs, "median_ms_by_src": summary,
              "same_checksums": same}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_allpairs.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"median_ms_by_src": summary, "same_checksums": same}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
