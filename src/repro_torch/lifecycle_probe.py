"""Serving-batch stalls beside a background transfer: what holds a batch up
while the lifecycle's worker writes an epoch's image.

One thread serves batches, each timed: 1 MiB of queries uploaded from
pageable host memory, their product with 65,536 rows of 256 on the card
and a row max, the serving stream synchronised.  Another thread runs one
background job at a time on a CUDA stream of its own, as the lifecycle's
worker does:

* ``none``: no job (the baseline);
* ``d2h_whole``: a 4 GiB tensor copied to pageable host memory in one copy;
* ``d2h_blocks``: the same in blocks of 32 MiB (``core.ivf._copy_rows``);
* ``d2h_pinned``: the same in blocks of 32 MiB through one pinned staging
  buffer;
* ``h2d_blocks``: a 1 GiB host array uploaded in blocks of 32 MiB;
* ``savez``: ``np.savez`` of a 4 GiB host array to disk (no card);
* ``crc``: ``zlib.crc32`` over that array in blocks of 4 MiB (as
  ``snapshot._file_stamp`` reads a file back);
* ``rmtree``: ``shutil.rmtree`` of the directory that ``savez`` wrote (as
  a handoff removes the old image).

Prints one JSON line per job (its seconds; the batches served meanwhile,
their p50 and max ms), then the card's name and power limit.  Needs one
CUDA device and about 5 GiB of it, 10 GiB of host memory and 5 GiB of disk
under ``build/``.

    python3 src/repro_torch/lifecycle_probe.py
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 1 << 25


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("lifecycle_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    db = torch.randn(65536, 256, device=dev)
    queries = rng.standard_normal((1024, 256)).astype(np.float32)
    big = torch.ones(1 << 30, device=dev)  # 4 GiB of fp32
    host_big = np.ones(1 << 30, np.float32)
    host_small = np.ones(1 << 28, np.float32)  # 1 GiB
    out_dir = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build", "lifecycle_probe")
    os.makedirs(out_dir, exist_ok=True)

    def batch():
        q = torch.as_tensor(queries, device=dev)
        (q @ db.T).amax(1)
        torch.cuda.current_stream(dev).synchronize()

    def d2h_whole():
        big.cpu()

    def d2h_blocks():
        out = torch.empty(big.shape)
        for r in range(0, big.numel(), BLOCK // 4):
            out[r : r + BLOCK // 4].copy_(big[r : r + BLOCK // 4])

    def d2h_pinned():
        out = torch.empty(big.shape)
        stage = torch.empty(BLOCK // 4, pin_memory=True)
        stream = torch.cuda.current_stream(dev)
        for r in range(0, big.numel(), BLOCK // 4):
            n = min(BLOCK // 4, big.numel() - r)
            stage[:n].copy_(big[r : r + n], non_blocking=True)
            stream.synchronize()
            out[r : r + n].copy_(stage[:n])

    def h2d_blocks():
        out = torch.empty(host_small.shape, device=dev)
        src = torch.from_numpy(host_small)
        for r in range(0, src.numel(), BLOCK // 4):
            out[r : r + BLOCK // 4].copy_(src[r : r + BLOCK // 4])

    image = os.path.join(out_dir, "image")

    def savez():
        os.makedirs(image, exist_ok=True)
        with open(os.path.join(image, "big.npz"), "wb") as f:
            np.savez(f, big=host_big)

    def crc():
        view = memoryview(host_big).cast("B")
        c = 0
        for r in range(0, len(view), 1 << 22):
            c = zlib.crc32(view[r : r + (1 << 22)], c)

    for _ in range(20):
        batch()
    jobs = {"none": lambda: time.sleep(5.0), "d2h_whole": d2h_whole, "d2h_blocks": d2h_blocks,
            "d2h_pinned": d2h_pinned, "h2d_blocks": h2d_blocks, "savez": savez, "crc": crc,
            "rmtree": lambda: shutil.rmtree(image)}
    for name, job in jobs.items():
        done, took = threading.Event(), {}

        def work(job=job, done=done, took=took):
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                t0 = time.perf_counter()
                job()
                stream.synchronize()
                took["s"] = time.perf_counter() - t0
            done.set()

        times = []
        thread = threading.Thread(target=work)
        thread.start()
        while not done.is_set():
            t0 = time.perf_counter()
            batch()
            times.append((time.perf_counter() - t0) * 1e3)
        thread.join()
        print(json.dumps({"job": name, "job_s": took["s"], "batches": len(times),
                          "p50_ms": statistics.median(times), "max_ms": max(times)}), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
