"""Lifecycle crash-replay check: journal, crash, recover in a FRESH process.

Port of ``repro/launch/lifecycle_check.py``.  For each serving
configuration (flat fp32, int8 two-stage, IVF, IVF-PQ) it:

  1. builds a RetrievalIndex on ``--device``, arms the crash-safe lifecycle
     (``LifecycleIndex.attach``: a full WAL image, then fsync-acked
     journaling) and acks a batch of inserts, upserts and deletes;
  2. searches a fixed query set and records the exact (distances, ids);
  3. simulates a crash mid-append: the process state is dropped and a torn
     half-frame is left at the journal's tail, what a SIGKILL between
     ``write`` and ``fsync`` leaves on disk;
  4. recovers snapshot and WAL in a fresh Python process on ``--device``,
     with ``repro_torch.core.kmeans.lloyd`` replaced by a tripwire, and
     requires every acked record replayed, the torn bytes dropped and the
     search bit-identical, values and ids.

The exit code is nonzero on any mismatch; the directories stay on disk.

    PYTHONPATH=src python -m repro_torch.launch.lifecycle_check --out wal_snapshots [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import struct
import sys
import time

from repro_torch.launch.snapshot_check import CONFIGS, run_fresh, synchronize

_RECOVER_SNIPPET = """
import json
import sys

import repro_torch.core.kmeans as KM


def _tripwire(*a, **kw):
    raise AssertionError("kmeans.lloyd entered on the recovery path")


KM.lloyd = _tripwire

from repro_torch.launch.lifecycle_check import verify_recover

print(json.dumps(verify_recover(*sys.argv[1:4])))
"""

# A crash mid-append: a frame header that promises 1 MiB, 40 bytes landed.
TORN = struct.pack("<4sII", b"ADD\0", 1 << 20, 0) + b"\0" * 40


def verify_recover(snap: str, expected_path: str, device: str) -> dict:
    """Recover ``snap`` on ``device``; exit with a message unless every acked
    record was replayed, exactly the torn bytes were dropped and the search
    is bit-identical to the recorded one.  Returns the recovery's seconds
    and what the journal held."""
    import numpy as np

    from repro_torch.serving import LifecycleConfig, LifecycleIndex

    with np.load(expected_path) as z:
        q, want_v, want_i = z["q"], z["v"], z["i"]
        k, acked, torn = int(z["k"]), int(z["acked"]), int(z["torn"])
    t0 = time.perf_counter()
    lc, rec = LifecycleIndex.recover(LifecycleConfig(snapshot_dir=snap), device=device)
    lc.index._device_state()
    synchronize(device)
    recover_s = time.perf_counter() - t0
    if rec.tail_records != acked:
        sys.exit(f"replayed {rec.tail_records} acked records, wanted {acked} ({snap})")
    if rec.torn_bytes != torn:
        sys.exit(f"dropped {rec.torn_bytes} torn bytes, wanted {torn} ({snap})")
    res = lc.search(q, k)
    if not np.array_equal(res.ids.cpu().numpy(), want_i):
        sys.exit(f"recovered ids differ from the pre-crash writer ({snap})")
    if not np.array_equal(res.distances.cpu().numpy(), want_v):
        sys.exit(f"recovered distances differ bitwise from the writer ({snap})")
    lc.close()
    return {"recover_s": recover_s, **rec.as_dict(), "bit_identical": True}


def crash(lc, snap: str, q, k: int, acked: int) -> str:
    """Search ``q`` on ``lc``, close it and leave ``TORN`` at its journal's
    tail; returns the path of the expected results beside ``snap``."""
    import numpy as np

    from repro_torch.serving.snapshot import _JOURNAL

    res = lc.search(q, k)
    lc.close()
    with open(os.path.join(snap, _JOURNAL), "ab") as f:
        f.write(TORN)
    expected = snap.rstrip("/") + ".expected.npz"
    np.savez(expected, q=q, v=res.distances.cpu().numpy(), i=res.ids.cpu().numpy(), k=k,
             acked=acked, torn=len(TORN))
    return expected


def journal_and_crash(name: str, kw: dict, out: str, device: str, *, n: int = 1024,
                      d: int = 32, k: int = 10, seed: int = 0) -> tuple[str, str]:
    """Build, arm, ack three mutations, then crash; (snapshot, expected)."""
    import numpy as np

    from repro_torch.serving import LifecycleConfig, LifecycleIndex, RetrievalIndex

    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    idx = RetrievalIndex.build(np.arange(n), vecs, device=device, **kw)
    snap = os.path.join(out, name)
    lc = LifecycleIndex.attach(idx, LifecycleConfig(snapshot_dir=snap))
    lc.insert(np.arange(n, n + 64), rng.normal(size=(64, d)).astype(np.float32))
    lc.upsert(np.arange(n + 60, n + 72), rng.normal(size=(12, d)).astype(np.float32))
    lc.delete(np.arange(0, n, 17))
    q = rng.normal(size=(32, d)).astype(np.float32)
    return snap, crash(lc, snap, q, k, acked=3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="wal_snapshots", help="directory for the crashed images")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), metavar="NAME",
                    help=f"subset of {list(CONFIGS)}")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for name in args.configs:
        kw = CONFIGS[name]
        print(f"[lifecycle-check] {name}: journal + crash mid-append ({kw}) on {args.device}")
        snap, expected = journal_and_crash(name, kw, args.out, args.device)
        try:
            got = run_fresh(_RECOVER_SNIPPET, snap, expected, args.device)
            print(f"[lifecycle-check] {name}: PASS {got}")
        except RuntimeError as e:
            print(f"[lifecycle-check] {name}: FAIL {e}")
            failures.append(name)
    if failures:
        raise SystemExit(f"lifecycle crash-replay failed: {failures}")
    print(f"[lifecycle-check] all {len(args.configs)} configs recover bit-identically "
          f"in fresh processes")


if __name__ == "__main__":
    main()
