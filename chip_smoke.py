"""Drive the PyTorch/CUDA port on one card; hold every kernel against its plain version.

    python3 chip_smoke.py          # from the root of a checkout, on a machine with a CUDA card

Phases (each one raises on a failed check; nothing is caught):

1. Build the kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time and each kernel's registers.
2. The paper's problem at the repo's ``allpairs_160k`` cell: n = 160,000
   random vectors, d = 256, k = 100, sqeuclidean, through
   ``knn_allpairs(impl="fused")``; held against the plain version on the
   card for every row (values slot by slot, ids tie-aware: an id that
   differs must be a near-tie whose own distance, recomputed, is the value
   it is reported at), against float64 brute force on sampled rows.
3. The paper's two phases: rows 0..8191 against all 160,000 through the
   ``pairwise_distance`` kernel, then ``stream_topk``; held against phase 2's
   result and each kernel against its plain version.  Then the per-tile
   ``knn_allpairs(impl="kernel", symmetric=True)`` at n = 32,768.
4. Flat serving at the ``query_1m`` cell: 1,048,576 x 256 fp32 rows,
   ``neg_dot``, k = 10, batches 8..1024 (the two-tower serving defaults):
   8,192 queries through ``QueryEngine``, ragged flushes, then churn (upsert,
   delete 1% of main, compact), each step held against brute force; then a
   steady window of 100 batches of 1024 queries.  A batch of 1024 there
   splits the database axis, so the fused kernel's partial sets and the
   merge kernel are each timed and held against their plain versions.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after.  The line before the last is ``{"kernels": [...]}``: per
kernel its launches, max |difference| against its plain version, its time,
the plain version's time, the least time the card could take (bytes over
3.35 TB/s or fp32 operations over 67 TFLOP/s, whichever is larger) and, where
one PyTorch call computes the same function, that call's time.  The last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.  Everything it prints also goes, in full, to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_HBM = 3.35e12  # H100 SXM HBM3, bytes/s
REPORT: dict = {}


def say(key, obj) -> None:
    REPORT[key] = obj
    print(f"{key}: {json.dumps(obj)}", flush=True)


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, reps=3, warmup=1):
    """Median wall time of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def exact_ids_check(torch, x, rows, ids, vals, k, exclude_self):
    """Float64 brute force on the card for a few rows: the ids are the true
    k nearest up to near-ties at the k-th distance, and each reported value
    is that id's distance."""
    x64 = x.double()
    for r in rows.tolist():
        dd = ((x64 - x64[r]) ** 2).sum(1)
        if exclude_self:
            dd[r] = float("inf")
        kth = torch.sort(dd).values[k - 1]
        got = ids[r, :k].long()
        true = dd[got]
        check(torch.allclose(true, vals[r, :k].double(), rtol=1e-4, atol=1e-2),
              f"row {r}: reported values are not the ids' distances")
        check(bool((true <= kth * (1 + 1e-5) + 1e-3).all()), f"row {r}: an id beyond the k-th")
        check(len(set(got.tolist())) == k, f"row {r}: duplicate ids")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core.knn import knn_allpairs
    from repro_torch.data.synthetic import random_vectors
    from repro_torch.kernels import _backend as B
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as PD
    from repro_torch.kernels import stream_topk as ST
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("card", {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    modules = {"fused_knn": FK, "merge_partials": MP, "pairwise_distance": PD,
               "stream_topk": ST}
    launches = {name: 0 for name in modules}

    def run_path(label, fn):
        """Drive one main path with the counts zeroed just before and read just after."""
        for mod in modules.values():
            mod.LAUNCHES = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = {name: mod.LAUNCHES for name, mod in modules.items()}
        for name in counts:
            launches[name] += counts[name]
        say(f"path_{label}", {"launches": counts, "wall_s": time.perf_counter() - t0})
        return out, counts

    # 1. Build.
    build_s = B.build()
    regs = {}
    for name in B.KERNEL_SOURCES:
        log = B.library_path(name).with_suffix(".log")
        regs[name] = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
    say("build", {"seconds": build_s, "ptxas": regs})

    # 2. The paper's problem: allpairs_160k, fused.
    n, d, k = 160_000, 256, 100
    K = 128
    x = torch.from_numpy(random_vectors(n, d, seed=0)).to(dev)
    fused_times = []

    def allpairs():
        res = None
        for rep in range(4):  # one warm-up, then three timed runs
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = knn_allpairs(x, k, impl="fused")
            end.record()
            end.synchronize()
            if rep:
                fused_times.append(start.elapsed_time(end))
        return res

    res, counts = run_path("allpairs_160k_fused", allpairs)
    check(counts["fused_knn"] == 4, f"fused kernel launches {counts}")
    check(res.indices.shape == (n, k) and bool(torch.isfinite(res.distances).all()),
          "allpairs result shape / finiteness")
    fx, gy, hx, hy, alpha = ops._mxu_operands(x, x, "sqeuclidean")
    t0 = time.perf_counter()
    pv, pi = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=alpha, finalize="identity",
                                n_real=n, exclude_self=True)
    torch.cuda.synchronize()
    fused_plain_ms = (time.perf_counter() - t0) * 1e3
    dist = operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity")
    fused_cmp = check_topk(res.distances, res.indices, pv[:, :k], pi[:, :k], n=n,
                           rtol=1e-5, atol=2e-3, dist=dist)
    fused_err = fused_cmp["max_abs_err"]
    del pv, pi
    sample = torch.from_numpy(np.sort(np.random.default_rng(0).choice(n, 16, replace=False)))
    exact_ids_check(torch, x, sample, res.indices, res.distances, k, True)
    bm, splits, _ = FK.plan(n, n, K, dev)
    ctas = -(-n // bm) * splits
    fused_bound, fused_by = bound_ms(2.0 * n * n * d, 2 * n * d * 4 + 2 * n * 4 + n * K * 8)
    say("allpairs_160k", {"median_ms": statistics.median(fused_times), "runs_ms": fused_times,
                          "plain_ms": fused_plain_ms, "vs_plain": fused_cmp, "bm": bm,
                          "splits": splits, "ctas_per_sm": FK.kernel_shape(dev, bm, K)[0],
                          "ctas": ctas, "bound_ms": fused_bound})

    # 3. The paper's two phases on rows 0..8191, and the symmetric per-tile path.
    m2 = 8192
    xq = x[:m2]

    def two_phase():
        dm = ops.pairwise_distance(xq, x)
        dm.diagonal().fill_(float("inf"))  # exclude self, as the all-pairs problem does
        return dm, ops.stream_topk(dm, k)

    (dm, (tv, ti)), counts = run_path("two_phase_8192x160k", two_phase)
    check(counts["pairwise_distance"] == 1 and counts["stream_topk"] == 1, f"launches {counts}")
    say("two_phase_vs_fused", check_topk(tv, ti, res.distances[:m2], res.indices[:m2], n=n,
                                         rtol=1e-5, atol=2e-3, dist=dist))
    fq, gq, hxq, hyq, _ = ops._mxu_operands(xq, x, "sqeuclidean")
    pd_args = (fq, gq, hxq, hyq)
    pd_ms = time_ms(torch, lambda: PD.pairwise_distance(*pd_args, alpha=alpha, finalize="identity"))
    plain = PD.pairwise_distance_plain(*pd_args, alpha=alpha, finalize="identity")
    pd_err = float((PD.pairwise_distance(*pd_args, alpha=alpha, finalize="identity")
                    - plain).abs().max())
    scale = float(fq.abs().max() * gq.abs().max()) * d
    check(pd_err <= 1e-5 * scale, f"pairwise kernel vs plain: {pd_err}")
    del plain
    pd_plain_ms = time_ms(torch, lambda: PD.pairwise_distance_plain(
        *pd_args, alpha=alpha, finalize="identity"))
    pd_lib_ms = time_ms(torch, lambda: torch.addmm(hxq + hyq, fq, gq.T, alpha=alpha))
    pd_bound, pd_by = bound_ms(2.0 * m2 * n * d + 3.0 * m2 * n,
                               (m2 + n) * d * 4 + (m2 + n) * 4 + m2 * n * 4)
    st_ms = time_ms(torch, lambda: ST.stream_topk(dm, k))
    t0 = time.perf_counter()
    sv, si = ST.stream_topk_plain(dm, k)
    torch.cuda.synchronize()
    st_plain_ms = (time.perf_counter() - t0) * 1e3
    st_err = float((tv[:, :k] - sv[:, :k]).abs().max())
    check(st_err == 0.0 and torch.equal(ti, si[:, :k]), "stream_topk kernel vs plain")
    del sv, si
    st_lib_ms = time_ms(torch, lambda: torch.topk(dm, k, dim=1, largest=False))
    st_bound, st_by = bound_ms(1.0 * m2 * n, m2 * n * 4 + m2 * K * 8)
    del dm

    n3 = 32_768
    x3 = x[:n3]
    sym, counts = run_path("allpairs_32k_kernel_symmetric",
                           lambda: knn_allpairs(x3, k, impl="kernel", symmetric=True))
    check(counts["pairwise_distance"] > 0, f"launches {counts}")
    ref3 = knn_allpairs(x3, k, impl="fused")
    say("symmetric_kernel_vs_fused_32k", check_topk(
        sym.distances, sym.indices, ref3.distances, ref3.indices, n=n3, rtol=1e-5, atol=2e-3,
        dist=dist))
    del x, xq, x3, res, fx, gy, hx, hy, fq, gq, hxq, hyq, pd_args, dist
    torch.cuda.empty_cache()

    # 4. Flat serving at query_1m with the two-tower serving defaults.
    n4, k4 = 1 << 20, 10
    db = random_vectors(n4, d, seed=1)
    index = RetrievalIndex.build(np.arange(n4), db, distance="neg_dot", impl="fused",
                                 device="cuda")
    engine = QueryEngine(index, EngineConfig(k=k4, min_batch=8, max_batch=1024))
    queries = random_vectors(8192 + 1 + 37 + 300 + 4 * 1024, d, seed=2)

    def brute_check(step, q):
        vecs, ids = index._live_rows()
        vt = torch.from_numpy(vecs).to(dev)
        ids_t = torch.from_numpy(ids).to(dev).long()
        qt = torch.from_numpy(q).to(dev)
        bv, bi = ST.sorted_prefix(-(qt @ vt.T), 16)
        want_ids = ids_t[bi[:, :k4].long()]
        pos = torch.full((int(ids_t.max()) + 1,), -1, dtype=torch.long, device=dev)
        pos[ids_t] = torch.arange(len(ids_t), device=dev)

        def dist(rows, ext):  # an external id's distance, from the live rows
            p = pos[ext]
            check(bool((p >= 0).all()), f"{step}: a served id is not live")
            return -(qt[rows] * vt[p]).sum(1)

        got = engine.search(q)
        cmp = check_topk(got.distances, got.ids.long(), bv[:, :k4], want_ids, n=len(pos),
                         rtol=1e-5, atol=1e-3, dist=dist)
        say(f"serving_check_{step}", {**cmp, "live": len(index)})

    def serve():
        out = engine.search(queries[:8192])
        check(out.ids.shape == (8192, k4), "served shape")
        o = 8192
        for size in (1, 37, 300):
            for j in range(size):
                engine.submit(("flush", size, j), queries[o + j])
            got = engine.flush()
            check(len(got) == size, "flush size")
            o += size
        brute_check("initial", queries[:64])
        ins = random_vectors(4096, d, seed=3)
        new_ids = np.concatenate([np.arange(0, n4, n4 // 2048)[:2048],  # replaced
                                  np.arange(n4, n4 + 2048)])  # new
        index.upsert(new_ids, ins)
        engine.search(queries[o : o + 1024])
        brute_check("upsert", queries[o : o + 64])
        dead = np.random.default_rng(4).choice(n4, n4 // 100, replace=False)
        index.delete(dead)
        engine.search(queries[o + 1024 : o + 2048])
        brute_check("delete", queries[o + 1024 : o + 1088])
        index.compact()
        engine.search(queries[o + 2048 : o + 3072])
        engine.search(queries[o + 3072 : o + 4096])
        brute_check("compact", queries[o + 2048 : o + 2112])
        # A steady window after the churn: 100 full batches on one engine of
        # its own, so the percentiles rest on more than a handful of samples.
        steady = QueryEngine(index, EngineConfig(k=k4, min_batch=8, max_batch=1024))
        for b in range(101):  # the first batch is tagged cold
            steady.search(random_vectors(1024, d, seed=100 + b))
        return engine.meter.summary(), steady.meter

    (meter, steady), counts = run_path("serving_query_1m", serve)
    check(counts["fused_knn"] > 0, f"serving launches {counts}")
    say("serving_meter", meter)
    say("serving_steady", {**steady.summary(), "p90_ms": steady.latency_ms(90)})
    vecs_t = index._device_state()["main"][0]
    qb = torch.from_numpy(queries[:1024]).to(dev)
    sf = ops._mxu_operands(qb, vecs_t, "neg_dot")
    nn = vecs_t.shape[0]
    kw = dict(distance_finalize="identity", alpha=-1.0, n_real=nn)
    bm4, splits4, _ = FK.plan(1024, nn, 16, dev)
    outs = {}
    serve_ms = time_ms(torch, lambda: outs.__setitem__("kernel", FK.fused_knn(*sf[:4], k4, **kw)))
    serve_plain_ms = time_ms(torch, lambda: outs.__setitem__("plain", FK.fused_knn_plain(
        *sf[:4], k4, alpha=-1.0, finalize="identity", n_real=nn)), reps=1)
    serve_cmp = check_topk(outs["kernel"][0][:, :k4], outs["kernel"][1][:, :k4],
                           outs["plain"][0][:, :k4], outs["plain"][1][:, :k4], n=nn, rtol=1e-5,
                           atol=1e-3, dist=operand_distance(*sf[:4], alpha=-1.0,
                                                            finalize="identity"))
    partials_ms = time_ms(torch, lambda: outs.__setitem__("partials",
                                                          FK.fused_knn_partials(*sf[:4], k4, **kw)))
    part_v, part_i = outs["partials"]
    check(part_v.shape[0] == splits4 > 1, f"serving batch: {part_v.shape[0]} splits")
    mg_ms = time_ms(torch, lambda: outs.__setitem__("merge", MP.merge_partials(part_v, part_i)))
    mg_plain_ms = time_ms(torch, lambda: outs.__setitem__(
        "merge_plain", MP.merge_partials_plain(part_v, part_i)))
    (mv, mi), (mpv, mpi) = outs["merge"], outs["merge_plain"]
    check(torch.equal(mi, mpi), "merge kernel vs plain: ids")
    mg_err = float((mv - mpv).abs().nan_to_num(0.0).max())
    check(mg_err == 0.0 and torch.equal(mv.isinf(), mpv.isinf()), "merge kernel vs plain: values")
    check(torch.equal(mi, outs["kernel"][1]), "merge kernel vs the fused call's result")
    mg_bound, mg_by = bound_ms(0.0, part_v.numel() * 8 + mv.numel() * 8)
    say("serving_batch_1024", {"kernel_ms": serve_ms, "partials_ms": partials_ms,
                               "merge_ms": mg_ms, "plain_ms": serve_plain_ms,
                               "merge_plain_ms": mg_plain_ms, "vs_plain": serve_cmp,
                               "bm": bm4, "splits": splits4, "ctas": -(-1024 // bm4) * splits4,
                               "ctas_per_sm": FK.kernel_shape(dev, bm4, 16)[0],
                               "bound_ms": bound_ms(2.0 * 1024 * nn * d,
                                                    (1024 + nn) * d * 4 + 1024 * 16 * 8)[0],
                               "merge_bound_ms": mg_bound})

    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    kernels = [
        {"name": "fused_knn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_knn.cu",
         "replaces": "src/repro/kernels/fused_knn.py:129", "launches": launches["fused_knn"],
         "max_abs_err": fused_err, "ms": statistics.median(fused_times),
         "plain_ms": fused_plain_ms, "bound_ms": fused_bound, "bound_by": fused_by,
         "library_ms": None, "shape": "allpairs 160000 x 160000, d 256, k 100"},
        {"name": "merge_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merge_partials.cu",
         "replaces": "src/repro/kernels/fused_knn.py:129", "launches": launches["merge_partials"],
         "max_abs_err": mg_err, "ms": mg_ms, "plain_ms": mg_plain_ms, "bound_ms": mg_bound,
         "bound_by": mg_by, "library_ms": None,
         "shape": f"{splits4} splits x 1024 x 16 (serving batch, k 10)"},
        {"name": "pairwise_distance", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_distance.cu",
         "replaces": "src/repro/kernels/pairwise_distance.py:85",
         "launches": launches["pairwise_distance"], "max_abs_err": pd_err, "ms": pd_ms,
         "plain_ms": pd_plain_ms, "bound_ms": pd_bound, "bound_by": pd_by,
         "library_ms": pd_lib_ms, "shape": "8192 x 160000, d 256"},
        {"name": "stream_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stream_topk.cu",
         "replaces": "src/repro/kernels/stream_topk.py:88", "launches": launches["stream_topk"],
         "max_abs_err": st_err, "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": st_bound,
         "bound_by": st_by, "library_ms": st_lib_ms, "shape": "8192 x 160000, k 100"},
    ]
    say("wall", {"seconds": time.perf_counter() - t_start})
    REPORT["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
