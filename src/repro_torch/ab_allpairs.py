"""Time the matmul-form kernels of several source trees, in turn, on one card.

    python3 src/repro_torch/ab_allpairs.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` is imported from there, and its kernels are built beside
it, in that checkout's ``build/``.  Each SRC runs in a process of its own,
which times three calls, each after one warm-up call (the first of which
builds the kernels), five times by CUDA events:

- ``allpairs``: ``knn_allpairs(x, 100, impl="fused")`` at the
  ``allpairs_160k`` cell (n = 160,000 ``random_vectors(seed=0)``, d = 256,
  sqeuclidean);
- ``pairwise``: the ``pairwise_distance`` kernel on rows 0..8191 of that x
  against all 160,000 (sqeuclidean operands);
- ``serving``: one fused serving batch, the ``fused_knn`` kernel (with its
  merge) on 1024 queries over the ``query_1m`` rows (1,048,576 x 256
  ``random_vectors(seed=0)``), ``neg_dot``, k = 10.

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
CASES = ("allpairs", "pairwise", "serving")

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


report = {"src": sys.argv[1]}
x = torch.from_numpy(random_vectors(160_000, 256, seed=0)).to("cuda")
res, report["allpairs"] = timed(lambda: knn_allpairs(x, 100, impl="fused"))
report["allpairs"]["ids_checksum"] = int(res.indices.long().sum())
del res
fx, gy, hx, hy, alpha = ops._mxu_operands(x[:8192].contiguous(), x, "sqeuclidean")
out, report["pairwise"] = timed(
    lambda: PD.pairwise_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity"))
report["pairwise"]["argmin_checksum"] = int(out.argmin(1).long().sum())
del out, fx, gy, hx, hy, x
db = torch.from_numpy(random_vectors(1 << 20, 256, seed=0)).to("cuda")
fx, gy, hx, hy, alpha = ops._mxu_operands(db[:1024].contiguous(), db, "neg_dot")
(v, i), report["serving"] = timed(lambda: FK.fused_knn(
    fx, gy, hx, hy, 10, distance_finalize="identity", alpha=alpha, n_real=gy.shape[0]))
report["serving"]["ids_checksum"] = int(i[:, :10].long().sum())
print(json.dumps(report))
"""


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    runs = []
    for src in argv[1:]:
        proc = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    srcs = list(dict.fromkeys(r["src"] for r in runs))
    summary = {case: {src: statistics.median(r[case]["median_ms"] for r in runs
                                             if r["src"] == src) for src in srcs}
               for case in CASES}
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
