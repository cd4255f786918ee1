"""Snapshot round-trip check: save, restore in a FRESH process, compare.

Port of ``repro/launch/snapshot_check.py``.  For each serving configuration
(flat fp32, int8 two-stage, IVF, IVF-PQ) it:

  1. builds a RetrievalIndex on ``--device`` and churns it (deletes, delta
     upserts, an id upserted twice inside the delta), so that the snapshot
     carries tombstones and a non-empty journal;
  2. searches a fixed query set and records the exact (distances, ids);
  3. saves the index under ``--out/<config>``, and the queries and results
     beside it (``<config>.expected.npz``);
  4. restores the snapshot in a fresh Python process on ``--device``, with
     ``repro_torch.core.kmeans.lloyd`` replaced by a tripwire (so any
     training on the restore path fails the run), and requires the restored
     search to be bit-identical, values and ids.

A fresh process shares no state with the one that built the index: the
snapshot alone must carry everything.  The exit code is nonzero on any mismatch; the snapshot
directories stay on disk.

    PYTHONPATH=src python -m repro_torch.launch.snapshot_check --out snapshots [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIGS = {
    "flat": {},
    "int8": {"scan_dtype": "int8"},
    "ivf": {"ivf_cells": 16, "nprobe": 4},
    "ivfpq": {"ivf_cells": 16, "nprobe": 8, "pq_m": 8},
}

SRC = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_RESTORE_SNIPPET = """
import json
import sys

import repro_torch.core.kmeans as KM


def _tripwire(*a, **kw):
    raise AssertionError("kmeans.lloyd entered on the restore path")


KM.lloyd = _tripwire

from repro_torch.launch.snapshot_check import verify_restore

print(json.dumps(verify_restore(*sys.argv[1:4])))
"""


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def verify_restore(snap: str, expected_path: str, device: str) -> dict:
    """Restore ``snap`` on ``device`` and search the recorded queries; exit
    with a message unless values and ids are bit-identical to the recorded
    ones.  Returns the restore's seconds (read, CRC, upload of the device
    state) and the live row count."""
    import numpy as np

    from repro_torch.serving import RetrievalIndex

    with np.load(expected_path) as z:
        q, want_v, want_i, k = z["q"], z["v"], z["i"], int(z["k"])
    t0 = time.perf_counter()
    idx = RetrievalIndex.restore(snap, device=device)
    idx._device_state()
    synchronize(device)
    restore_s = time.perf_counter() - t0
    res = idx.search(q, k)
    if not np.array_equal(res.ids.cpu().numpy(), want_i):
        sys.exit(f"restored ids differ from the source index ({snap})")
    if not np.array_equal(res.distances.cpu().numpy(), want_v):
        sys.exit(f"restored distances differ bitwise from the source index ({snap})")
    return {"restore_s": restore_s, "live_rows": len(idx), "bit_identical": True}


def save_expected(idx, snap: str, q, k: int, **extra) -> str:
    """Search ``q`` on ``idx``, save ``idx`` under ``snap`` and the queries
    and results beside it; returns the path of the expected results."""
    import numpy as np

    res = idx.search(q, k)
    idx.save(snap)
    expected = snap.rstrip("/") + ".expected.npz"
    np.savez(expected, q=q, v=res.distances.cpu().numpy(), i=res.ids.cpu().numpy(), k=k,
             **extra)
    return expected


def run_fresh(snippet: str, *args: str, timeout: int = 1200) -> dict:
    """Run ``snippet`` in a fresh interpreter with this checkout's sources
    first on the path; its last line of output is a JSON object, returned.
    Raises with the child's error output if it fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", snippet, *args], capture_output=True,
                          text=True, env=env, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"fresh process failed (rc {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def build_and_snapshot(name: str, kw: dict, out: str, device: str, *, n: int = 2048,
                       d: int = 32, k: int = 10, seed: int = 0) -> tuple[str, str]:
    """Build and churn an index, save it; (snapshot dir, expected results)."""
    import numpy as np

    from repro_torch.serving import RetrievalIndex

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(n), vecs, device=device, **kw)
    idx.delete(np.arange(0, n, 17))
    idx.upsert(np.arange(n, n + 96), rng.normal(size=(96, d)).astype(np.float32))
    idx.upsert(np.arange(n, n + 8), rng.normal(size=(8, d)).astype(np.float32))
    idx.delete([n + 3])
    q = rng.normal(size=(32, d)).astype(np.float32)
    snap = os.path.join(out, name)
    return snap, save_expected(idx, snap, q, k)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="snapshots", help="directory for the snapshots")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), metavar="NAME",
                    help=f"subset of {list(CONFIGS)}")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for name in args.configs:
        kw = CONFIGS[name]
        print(f"[snapshot-check] {name}: build + churn + save ({kw}) on {args.device}")
        snap, expected = build_and_snapshot(name, kw, args.out, args.device)
        try:
            got = run_fresh(_RESTORE_SNIPPET, snap, expected, args.device)
            print(f"[snapshot-check] {name}: PASS {got}")
        except RuntimeError as e:
            print(f"[snapshot-check] {name}: FAIL {e}")
            failures.append(name)
    if failures:
        raise SystemExit(f"snapshot round-trip failed: {failures}")
    print(f"[snapshot-check] all {len(args.configs)} configs round-trip bit-identically "
          f"in fresh processes")


if __name__ == "__main__":
    main()
