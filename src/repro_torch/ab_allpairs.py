"""Time the fused all-pairs kNN of several source trees, in turn, on one card.

    python3 src/repro_torch/ab_allpairs.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` is imported from there, and its kernels are built beside
it, in that checkout's ``build/``.  Each SRC runs in a process of its own:
``knn_allpairs(x, 100, impl="fused")`` at the ``allpairs_160k`` cell (n =
160,000 ``random_vectors(seed=0)``, d = 256, sqeuclidean), one warm-up call
(which builds the kernel) and five calls timed by CUDA events.  Listing two
trees as A B B A compares them within one run of this script, on one card,
under one power limit.  The card's name and power limit head the output;
each process prints one JSON line (its times and a checksum of the ids, so
that the trees are seen to compute the same result), and the lines also go
to ``chiprun_out/ab_allpairs.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.core.knn import knn_allpairs
from repro_torch.data.synthetic import random_vectors

torch.backends.cuda.matmul.allow_tf32 = False
x = torch.from_numpy(random_vectors(160_000, 256, seed=0)).to("cuda")
t0 = time.perf_counter()
res = knn_allpairs(x, 100, impl="fused")
torch.cuda.synchronize()
first_s = time.perf_counter() - t0
times = []
for _ in range(5):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    res = knn_allpairs(x, 100, impl="fused")
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
print(json.dumps({"src": sys.argv[1], "median_ms": statistics.median(times), "runs_ms": times,
                  "first_call_s": first_s, "ids_checksum": int(res.indices.long().sum())}))
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
    summary = {src: statistics.median(r["median_ms"] for r in runs if r["src"] == src)
               for src in dict.fromkeys(r["src"] for r in runs)}
    checksums = {r["ids_checksum"] for r in runs}
    report = {"card": card.splitlines()[0], "runs": runs, "median_ms_by_src": summary,
              "same_ids_checksum": len(checksums) == 1}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ab_allpairs.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"median_ms_by_src": summary, "same_ids_checksum": len(checksums) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
