"""Retrieval serving launcher: a thin CLI over ``repro_torch.serving``.

Port of ``repro/launch/serve.py``, every flag and check, with two
differences: ``--impl`` takes the port's scorer names and defaults to
``fused``, and ``--device`` (default ``cuda``, the card) says where the
towers, the index and any shard workers live.

Builds a two-tower model, embeds an item corpus into a RetrievalIndex, then
serves batched user queries through the QueryEngine, optionally exercising the
online index lifecycle (ingest into the delta segment, deletes, compaction)
while traffic flows:

  PYTHONPATH=src python -m repro_torch.launch.serve --corpus 16384 --queries 64 \
      --batches 20 --k 10 --churn 256 --repeat-frac 0.5 [--device cpu]

Flags (see README.md "CLI reference"):
  --corpus N        item corpus size (embedded offline, packed main segment)
  --queries M       users per served batch
  --batches B       number of online batches (first at a shape is cold, excluded)
  --k K             neighbors per query
  --impl {torch,kernel,fused}  segment scorer (fused = the one-pass
                    distance+select kernel, the default)
  --device D        cuda (the default: the card) or cpu (the plain versions)
  --scan-dtype {float32,bf16,int8}  two-stage quantized main-segment scan
                    (DESIGN.md §Quantized; float32 = exact, the default)
  --overfetch O     scan candidate multiple for the quantized path
  --ivf-cells C     IVF cell-probed main-segment scan: train C k-means cells
                    and probe only the nearest per query (DESIGN.md §IVF;
                    0 = flat scan, the default)
  --nprobe P        cells probed per query (>= C probes everything = exact
                    with a float32 scan)
  --pq-m M          product-quantized ADC main-segment scan: M uint8 codes
                    per row instead of d coordinates (DESIGN.md §PQ; needs
                    --ivf-cells > 0 — the IVFADC recipe; 0 = off)
  --pq-nbits B      bits per PQ code (codebook = 2^B words per subspace)
  --churn C         items upserted into the delta segment per batch (0 = off)
  --compact-every E compact() after every E batches (0 = never)
  --repeat-frac F   fraction of each batch drawn from repeat users (cache hits)
  --cache N         user embedding cache capacity (0 disables)
  --mesh            shard the main segment over the host mesh (query-sharded
                    butterfly scoring, the paper's multi-device serving path;
                    every CUDA card, or one position with --device cpu)
  --shards S        shard-routed serving (DESIGN.md §13): cut the built index
                    into S cell-range shard images, restore them into
                    ShardWorkers and serve through the probe-set router +
                    butterfly aggregator (needs --ivf-cells > 0; shard
                    images land under --snapshot-dir or a temp dir)
  --replicas R      fault-tolerance tier (DESIGN.md §14): restore each shard
                    image into R independent workers with per-query failover
                    and per-worker health tracking (needs --shards)
  --fault-rate F    chaos demo: wrap every worker in a seeded Bernoulli
                    FaultPolicy injecting failures/latency/garbage at rate F
                    and report coverage + health afterwards (needs --shards)
  --degraded P      "refuse" (default: a lost shard raises the structured
                    error) | "partial" (serve survivors, report coverage)
  --workers B       "inproc" (default: the restored fleet lives in this
                    process) | "proc" (DESIGN.md §15: one supervised OS
                    process per replica behind the RPC transport — real
                    crash detection, heartbeats, snapshot respawn; needs
                    --shards)
  --heartbeat-s S   idle seconds before the supervisor PING-probes a proc
                    worker (0 disables; needs --workers proc)
  --queue-depth N   per-worker bound on abandoned in-flight requests before
                    calls fail over with BackpressureError (needs
                    --workers proc)
  --snapshot-dir D  persist the index under D after the corpus build
                    (DESIGN.md §Persistence: versioned, atomic, CRC-stamped)
  --restore         cold-start from the --snapshot-dir snapshot instead of
                    re-embedding + retraining (prints the wall-clock saved)
  --wal             crash-safe lifecycle (DESIGN.md §16): journal every churn
                    mutation fsync-acked into --snapshot-dir between
                    compacts, train post-compact epochs in the background,
                    and finish with a simulated crash-restart (torn journal
                    tail) + recovery-stats report; with --restore the run
                    starts by recovering snapshot + WAL instead of
                    re-embedding (needs --snapshot-dir; excludes
                    --shards/--mesh)
  --delta-budget N  admission control: mutations that would grow the delta
                    past N rows raise BackpressureError — the launcher then
                    compacts and retries (0 = unbounded; needs --wal)
  --sync-compact    disable background retrain: compact() blocks through
                    repack + IVF/PQ training + full save (the latency-cliff
                    baseline the lifecycle bench compares against)
  --filter-mode M   filtered-search execution policy for ``recommend()``
                    calls that carry a QueryFilter (DESIGN.md §17):
                    "auto" (default: selectivity-driven pre/post choice) |
                    "pre" (mask inside the scan) | "post" (widened fetch,
                    filter after)
  --seed S
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", type=int, default=16384)
    ap.add_argument("--queries", type=int, default=64, help="queries per batch")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--impl", choices=("torch", "kernel", "fused"), default="fused")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--scan-dtype", default="float32",
                    choices=("float32", "fp32", "bf16", "bfloat16", "int8"))
    ap.add_argument("--overfetch", type=int, default=4)
    ap.add_argument("--ivf-cells", type=int, default=0,
                    help="IVF cells for the main-segment scan (0 = flat)")
    ap.add_argument("--nprobe", type=int, default=8, help="IVF cells probed per query")
    ap.add_argument("--pq-m", type=int, default=0,
                    help="PQ codes per row for the main-segment ADC scan "
                         "(0 = off; needs --ivf-cells)")
    ap.add_argument("--pq-nbits", type=int, default=8,
                    help="bits per PQ code (2^nbits codewords per subspace)")
    ap.add_argument("--churn", type=int, default=0,
                    help="items upserted into the delta per batch")
    ap.add_argument("--compact-every", type=int, default=0)
    ap.add_argument("--repeat-frac", type=float, default=0.0,
                    help="fraction of repeat users per batch (cache hits)")
    ap.add_argument("--cache", type=int, default=4096)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the main segment over the host mesh and score "
                         "it with the query-sharded butterfly path")
    ap.add_argument("--shards", type=int, default=0,
                    help="cut the index into this many cell-range shard images and "
                         "serve through the probe-set router (DESIGN.md §13; needs "
                         "--ivf-cells > 0; 0 = off)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="workers per shard cell range with per-query failover "
                         "(DESIGN.md §14; needs --shards)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject seeded worker faults at this per-call rate "
                         "(chaos demo; needs --shards)")
    ap.add_argument("--degraded", choices=("refuse", "partial"), default="refuse",
                    help="what a shard with all replicas dead costs: refuse = structured "
                         "error, partial = serve survivors with per-query coverage")
    ap.add_argument("--workers", choices=("inproc", "proc"), default="inproc",
                    help="worker backend (DESIGN.md §15): inproc = restored fleet in "
                         "this process; proc = one supervised OS process per replica "
                         "over the RPC transport (needs --shards)")
    ap.add_argument("--heartbeat-s", type=float, default=5.0,
                    help="idle seconds before a proc worker is PING-probed "
                         "(0 = no heartbeat; needs --workers proc)")
    ap.add_argument("--queue-depth", type=int, default=8,
                    help="per-proc-worker in-flight request bound before "
                         "BackpressureError (needs --workers proc)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="persist the built index here (DESIGN.md §Persistence)")
    ap.add_argument("--restore", action="store_true",
                    help="cold-start from --snapshot-dir instead of re-embedding + retraining")
    ap.add_argument("--wal", action="store_true",
                    help="crash-safe lifecycle: fsync-acked journaling + background epoch "
                         "handoff + simulated crash-restart report (DESIGN.md §16; needs "
                         "--snapshot-dir)")
    ap.add_argument("--delta-budget", type=int, default=0,
                    help="max delta rows before mutations raise BackpressureError "
                         "(0 = unbounded; needs --wal)")
    ap.add_argument("--sync-compact", action="store_true",
                    help="block compact() through retrain + full save instead of "
                         "background handoff (needs --wal)")
    ap.add_argument("--filter-mode", choices=("auto", "pre", "post"), default="auto",
                    help="execution policy for filtered recommend() calls (DESIGN.md §17): "
                         "auto = selectivity-driven, pre = mask in scan, post = widened "
                         "fetch + filter")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The reference's flag checks; each failure is ``ap.error`` (exit 2)."""
    if args.restore and not args.snapshot_dir:
        ap.error("--restore needs --snapshot-dir")
    if args.wal and not args.snapshot_dir:
        ap.error("--wal needs --snapshot-dir (the journal lives inside the snapshot)")
    if args.wal and (args.shards or args.mesh):
        ap.error("--wal is the single-host lifecycle tier; --shards/--mesh have their "
                 "own persistence (DESIGN.md §13-§15)")
    if (args.delta_budget or args.sync_compact) and not args.wal:
        ap.error("--delta-budget/--sync-compact need --wal")
    if args.delta_budget < 0:
        ap.error("--delta-budget must be >= 0")
    if args.shards:
        if not args.ivf_cells:
            ap.error("--shards needs --ivf-cells > 0 (cells are the partition unit)")
        if args.mesh:
            ap.error("--shards and --mesh are alternative scale-out paths; pick one")
        if args.churn or args.compact_every:
            ap.error("--shards serves immutable shard images; delta churn is a "
                     "single-host path (--churn/--compact-every)")
    if not args.shards and (args.replicas != 1 or args.fault_rate):
        ap.error("--replicas/--fault-rate need --shards (they are fleet properties)")
    if args.workers == "proc" and not args.shards:
        ap.error("--workers proc needs --shards (process workers serve shard images)")
    if args.queue_depth < 1:
        ap.error("--queue-depth must be >= 1")
    if args.heartbeat_s < 0:
        ap.error("--heartbeat-s must be >= 0")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if not 0.0 <= args.fault_rate < 1.0:
        ap.error("--fault-rate must be in [0, 1)")
    if args.device not in ("cuda", "cpu") and not args.device.startswith("cuda:"):
        ap.error("--device must be cuda (or cuda:N) or cpu")


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)

    import time

    import numpy as np
    import torch

    from repro_torch.configs.two_tower import serving_defaults, smoke_config
    from repro_torch.core.topk import next_pow2
    from repro_torch.kernels._backend import resolve_device
    from repro_torch.models.recsys import init_two_tower
    from repro_torch.serving import ServiceConfig, TwoTowerRetrievalService

    device = resolve_device(args.device)  # CUDA without a card raises here
    cfg = smoke_config()
    params = init_two_tower(cfg, generator=torch.Generator(device).manual_seed(args.seed),
                            device=device)

    defaults = serving_defaults()
    defaults.update(k=args.k, impl=args.impl, cache_capacity=args.cache,
                    max_batch=next_pow2(max(64, args.queries)),
                    scan_dtype=args.scan_dtype, overfetch=args.overfetch,
                    ivf_cells=args.ivf_cells, nprobe=args.nprobe,
                    pq_m=args.pq_m, pq_nbits=args.pq_nbits,
                    snapshot_dir=args.snapshot_dir,
                    replicas=args.replicas, degraded=args.degraded,
                    workers=args.workers, heartbeat_s=args.heartbeat_s,
                    queue_depth=args.queue_depth,
                    wal=args.wal, delta_budget=args.delta_budget,
                    background_retrain=not args.sync_compact,
                    filter_mode=args.filter_mode)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(devices=None if device.type == "cuda" else [device])
        print(f"[serve] query-sharded over mesh {dict(mesh.shape)}")
    svc = TwoTowerRetrievalService(params, cfg, ServiceConfig(**defaults), mesh=mesh,
                                   device=device)

    # Offline: embed + pack the corpus, or restore a snapshot and skip the
    # whole pass (the cold-start path, DESIGN.md §Persistence).
    rng = np.random.default_rng(args.seed)
    item_lim = min(cfg.i_sizes())
    user_lim = min(cfg.u_sizes())
    corpus_fields = rng.integers(
        0, item_lim, size=(args.corpus, cfg.n_item_fields)).astype(np.int32)
    if args.restore and args.wal:
        t0 = time.perf_counter()
        rec = svc.recover_lifecycle()
        print(f"[serve] recovered {len(svc.lifecycle)} rows from snapshot + WAL at "
              f"{args.snapshot_dir} in {time.perf_counter() - t0:.2f}s")
        print(f"[serve] recovery: {rec.tail_records} acked tail record(s) replayed past "
              f"the {rec.stamped_bytes}-byte stamp, {rec.torn_bytes} torn in-flight "
              f"byte(s) dropped")
    elif args.restore:
        t0 = time.perf_counter()
        svc.restore_index()
        print(f"[serve] restored {len(svc.index)} x {svc.index.dim} from "
              f"{args.snapshot_dir} in {time.perf_counter() - t0:.2f}s "
              f"(no embedding, no training)")
    else:
        t0 = time.perf_counter()
        svc.build_corpus(np.arange(args.corpus), corpus_fields)
        print(f"[serve] corpus embedded + indexed: {len(svc.index)} x {svc.index.dim} "
              f"in {time.perf_counter() - t0:.2f}s on {device}")
        if args.wal:
            # The lifecycle's attach writes the full WAL image itself: from
            # here every churn mutation is one fsync-acked journal record.
            t0 = time.perf_counter()
            svc.enable_lifecycle()
            print(f"[serve] lifecycle armed -> {args.snapshot_dir} in "
                  f"{time.perf_counter() - t0:.2f}s (WAL journaling, "
                  f"{'sync' if args.sync_compact else 'background'} compaction, delta "
                  f"budget {args.delta_budget or 'unbounded'})")
        elif args.snapshot_dir:
            # save() finalizes any lazily pending IVF/PQ training first: the
            # work a later --restore run skips.
            t0 = time.perf_counter()
            svc.save_index()
            print(f"[serve] snapshot -> {args.snapshot_dir} in "
                  f"{time.perf_counter() - t0:.2f}s (--restore skips the embedding pass "
                  f"and all IVF/PQ training)")

    if args.shards:
        # Shard-routed serving (DESIGN.md §13): cut cell-range images,
        # restore each into a ShardWorker (or a worker process), rebind the
        # engine onto the probe-set router.
        import tempfile

        shard_root = (args.snapshot_dir + "-shards" if args.snapshot_dir
                      else tempfile.mkdtemp(prefix="repro-shards-"))
        t0 = time.perf_counter()
        paths = svc.save_shards(shard_root, args.shards)
        svc.restore_shards(shard_root)
        r = svc.router
        backend = "proc" if r.supervisor is not None else "inproc"
        print(f"[serve] {len(paths)} shard images -> {shard_root} + routed restore in "
              f"{time.perf_counter() - t0:.2f}s (zero retraining; {r.n_replicas} "
              f"replica(s)/shard, workers={backend!r}, degraded={r.degraded!r})")
        for w in r.workers:
            pid = f" pid={w.pid}" if backend == "proc" else ""
            print(f"[serve]   {w.key}: cells [{w.spec.cell_lo}, {w.spec.cell_hi}) "
                  f"{w.n_slots} slots, {w.n_live} live rows{pid}")
        if args.fault_rate:
            # Chaos demo (DESIGN.md §14): every worker behind a seeded
            # Bernoulli FaultPolicy; the router fails over / degrades.
            from repro_torch.serving import inject_faults

            svc.router = inject_faults(r, rate=args.fault_rate, seed=args.seed)
            svc.engine.rebind(svc.router)
            print(f"[serve] fault injection armed: rate={args.fault_rate} seed={args.seed}")

    try:
        _serve(args, svc, cfg, rng, user_lim, item_lim, params, defaults, device)
    finally:
        # A proc fleet's workers are real OS processes: drain and reap them.
        svc.shutdown_shards()


def _serve(args, svc, cfg, rng, user_lim, item_lim, params, defaults, device) -> None:
    import time

    import numpy as np

    from repro_torch.serving import (
        BackpressureError,
        MissingShardError,
        ServiceConfig,
        TwoTowerRetrievalService,
    )

    # Online: batches of user queries with optional churn/compaction.
    n_users = 4 * args.queries
    user_pool = rng.integers(0, user_lim, size=(n_users, cfg.n_user_fields)).astype(np.int32)
    next_item = args.corpus
    refused = 0
    backpressured = 0
    ids = scores = None
    for b in range(args.batches):
        n_rep = int(args.queries * args.repeat_frac)
        keys = np.concatenate([
            rng.integers(0, n_users, size=n_rep),  # repeat visitors
            np.arange(args.queries - n_rep) + n_users + b * args.queries,
        ])
        fields = np.concatenate([
            user_pool[keys[:n_rep]],
            rng.integers(0, user_lim, size=(args.queries - n_rep, cfg.n_user_fields)),
        ]).astype(np.int32)
        if args.fault_rate:
            # Under degraded="refuse" a lost shard refuses the whole batch:
            # that IS the contract; count it instead of crashing the demo.
            try:
                ids, scores = svc.recommend(keys, fields)
            except MissingShardError as e:
                refused += 1
                print(f"[serve] batch {b} refused: shards {list(e.shard_ids)} unavailable "
                      f"({len(e.attempts)} failover attempts)")
                continue
        else:
            ids, scores = svc.recommend(keys, fields)

        if args.churn:
            churn_ids = np.arange(next_item, next_item + args.churn)
            next_item += args.churn
            churn_fields = rng.integers(
                0, item_lim, size=(args.churn, cfg.n_item_fields)).astype(np.int32)
            if args.wal:
                try:
                    svc.ingest_items(churn_ids, churn_fields)
                except BackpressureError:
                    # Admission control fired: fold the delta down (blocking:
                    # the budget says it must not grow) and retry once.
                    backpressured += 1
                    svc.compact(wait=True)
                    svc.ingest_items(churn_ids, churn_fields)
                # Incremental save between compacts: manifest-only; the acked
                # records are already durable.
                if not svc.lifecycle.handoff_pending:
                    svc.lifecycle.checkpoint()
            else:
                svc.ingest_items(churn_ids, churn_fields)
        if args.compact_every and (b + 1) % args.compact_every == 0:
            svc.compact()

    st = svc.stats()
    s, e = st["serving"], st["engine"]
    print(f"[serve] {s['batches']} steady-state batches of {args.queries} queries, "
          f"k={args.k} (+{s['compile_batches']} cold batches, {s['compile_s']:.2f}s)")
    print(f"[serve] end-to-end ms (embed+scan): p50={s['p50_ms']:.2f} p99={s['p99_ms']:.2f} "
          f"mean={s['mean_ms']:.2f}  throughput={s['qps']:.0f} qps")
    print(f"[serve] kNN scan only ms: p50={e['p50_ms']:.2f} p99={e['p99_ms']:.2f}")
    c = st["cache"]
    print(f"[serve] index: {st['index_rows']} rows, {st['index_dead']} dead; cache "
          f"hit-rate={c['hit_rate']:.2f} ({c['hits']}/{c['hits'] + c['misses']})")
    if ids is not None:
        print(f"[serve] top-1 sample: ids={ids[0, :5]} score={scores[0, :5].round(3)}")
    fleet = st.get("fleet")
    if fleet is not None and (args.fault_rate or args.replicas > 1):
        d = fleet["dispatch"]
        print(f"[serve] fleet: {fleet['n_shards']} shards x {fleet['replicas']} replicas, "
              f"degraded={fleet['degraded']!r}; dispatches={d['calls']} "
              f"failures={d['failures']} (error rate {d['error_rate']:.3f}); refused "
              f"batches={refused}")
        for key, h in fleet["health"].items():
            print(f"[serve]   {key}: {h['state']} (ok={h['successes']} fail={h['failures']})")
        sup = fleet.get("supervisor")
        if sup is not None:
            print(f"[serve] supervisor: {sup['respawns']} respawn(s), "
                  f"heartbeat={sup['heartbeat_s']}s queue_depth={sup['queue_depth']}")
    lc = st.get("lifecycle")
    if lc is None:
        return
    w = lc["wal"]
    print(f"[serve] lifecycle: epoch {lc['epoch']}, {lc['handoffs']} background handoff(s) "
          f"(last train {lc['last_train_s']:.2f}s off the query path); WAL: "
          f"{w['records']} fsync-acked record(s), {w['bytes']} B, "
          f"{w['seconds'] * 1e3 / max(w['records'], 1):.2f} ms/ack; backpressure "
          f"retries={backpressured} rejected={lc['rejected']}")

    # Simulated crash-restart: tear the journal mid-append (an in-flight
    # frame a kill -9 would leave), then recover in a fresh service and
    # verify the served results are bit-identical to the pre-crash ones.
    import os
    import struct

    probe_keys = np.arange(8) + 10_000_000
    probe_fields = rng.integers(0, user_lim, size=(8, cfg.n_user_fields)).astype(np.int32)
    want_ids, want_scores = svc.recommend(probe_keys, probe_fields)
    svc.lifecycle._wal.close()  # the "crash": no checkpoint, no goodbye
    jpath = os.path.join(args.snapshot_dir, "journal.bin")
    with open(jpath, "ab") as f:
        f.write(struct.pack("<4sII", b"ADD\0", 1 << 20, 0))
        f.write(b"\x00" * 37)  # header promises 1 MiB; the crash hit here
    svc2 = TwoTowerRetrievalService(params, cfg, ServiceConfig(**defaults), device=device)
    t0 = time.perf_counter()
    rec = svc2.recover_lifecycle()
    got_ids, got_scores = svc2.recommend(probe_keys, probe_fields)
    identical = np.array_equal(want_ids, got_ids) and np.array_equal(want_scores, got_scores)
    print(f"[serve] crash-restart: recovered in {time.perf_counter() - t0:.2f}s: "
          f"{rec.tail_records} acked tail record(s) replayed, {rec.torn_bytes} torn "
          f"in-flight byte(s) dropped; post-recovery results "
          f"{'bit-identical' if identical else 'DIVERGED'}")
    svc2.lifecycle.close()
    if not identical:
        raise SystemExit("recovered service diverged from pre-crash")


if __name__ == "__main__":
    main()
