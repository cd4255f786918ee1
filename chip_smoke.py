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
   result and each kernel against its plain version; ``stream_topk``'s stage
   ring, CTAs per SM, shared memory and column splits reported.  Then
   ``stream_topk`` at the card's cap, k = 4096, on rows 0..1023 of that
   matrix, equal to its plain version.  Then the per-tile
   ``knn_allpairs(impl="kernel", symmetric=True)`` at n = 16,384.
3b. The paper's two phases with the generic distance: rows 0..1023 against
   all 160,000 through ``pairwise_distance(cumulative=True)`` (the
   per-coordinate kernel, sqeuclidean) then ``stream_topk`` at k = 100; the
   matrix held against its plain version and against the matmul-form
   kernel, the ids tie-aware against phase 2's, and ``stream_topk`` on that
   matrix equal to its plain version.  Then hellinger and kl on
   non-negative rows (``abs``, each row normalised to sum 1) at 1024 x
   16,384, each held against its plain version.
4. Flat serving at the ``query_1m`` cell: 1,048,576 x 256 fp32 rows,
   ``neg_dot``, k = 10, batches 8..1024 (the two-tower serving defaults):
   8,192 queries through ``QueryEngine``, ragged flushes, then churn (upsert,
   delete 1% of main, compact), each step held against brute force; then a
   steady window of 25 batches of 1024 queries.  A batch of 1024 there
   splits the database axis, so the fused kernel's partial sets and the
   merge kernel are each timed and held against their plain versions (the
   merge's and ``torch.topk``'s device time also by a CUDA graph); and
   the fused kernel with its merge at the card's cap, K = 4096, on 64 of
   the batch's queries.
5. Two-stage quantized serving at the same shape: ``random_vectors(seed=0)``
   rows, ``RetrievalIndex(scan_dtype=...)`` for int8 and for bf16 (overfetch
   4): 8,192 queries, churn (the replica must be kept at a delete and rebuilt
   at compact), a steady window of 25 batches; recall@10 against brute force
   (floor 0.9).  A float32 replica through ``two_stage_query`` must equal
   brute force.  At a batch of 1024 the fp32, bf16 and int8 fused scans, the
   merge and the rescore kernel are timed and held against their plain
   versions.  The int8 index carries tenant tags, and after its churn one
   batch of 1024 carries phase 8's tenant filter with 500 exclusions a
   query: the masked fused scan at K' = 4 x 512 = 2048, its merge, and the
   rescore at K 512 (``filtered_wide_batch``: no excluded id, no id of
   another tenant, every served id live at its own distance, each wide
   launch equal to its plain version; recall against the filtered brute
   force reported).  The rescore kernel at K = 4096 on 8192 drawn
   candidates of 128 queries.
6. IVF serving at the same width: ``clustered_vectors(1,048,576 + 8,192,
   256, n_clusters=4096, seed=0)``, the last 8,192 rows held out as queries;
   ``ivf_cells=4096, nprobe=8``, float32 then int8.  Build time (k-means on
   the card, then the packing), cell sizes, and per query tile the union
   width and the share of cells it scans, at batches of 1024 and 8.  The
   fused kernel held against its plain version at the path's own shapes:
   the probe shortlist (k 8 over the centroids) and a k-means assignment
   pass (k 1).  Full-probe IVF must equal brute force before and after
   churn; recall@10 at nprobe = 8, served and on 256 queries through the
   kernel path and the plain path, at least 0.9; a steady window of 25
   batches; the ``ivf_scan`` kernel held against its plain version at both
   batch sizes, its bound counted from the rows of the cells it scans.
   The kernel that builds the scan's tile table on the card
   (``ivf_scan_table``) is held against its plain version at both batch
   sizes.  The fp32 index's tags also serve the filtered batch with 500
   exclusions (the scan at K = min(2048, cell_cap)), gated as in phase 5.
7. IVF-PQ serving on phase 6's data: ``ivf_cells=4096, nprobe=8, pq_m=32,
   pq_nbits=8`` (faiss's "IVF4096,PQ32": 32 bytes a row), ``neg_dot``,
   k = 10.  First, for comparison, the reference's start (Lloyd from a
   uniform draw of rows, cells and codebooks): recall@10 at overfetch 4, 8
   and 16 beside the fp32 IVF scan of the same cells.  Then the index's own
   epoch (the port's k-means++ start), the same figures, and its build time
   split into k-means, packing, PQ training and encoding; the replica's
   bytes on the card; per union tile the live rows the scan needs.  The fused kernel held against its plain version at the
   encoding's shape (k 1 over 256 codewords of 8 coordinates); served
   recall@10 against brute force at least 0.85 at overfetch 8 (the
   reference's floor and setting, ``tests/test_pq.py``), reported at
   overfetch 4; after churn (upsert, delete 1% of main, compact) no deleted
   id is served and the retrained replica meets the floor; a steady window
   of 25 batches; the ``pq_scan`` kernel held against its plain version at
   batches of 1024 and 8, its partial sets and the merge timed apart, its
   bound counted from the live rows of each tile's cells and its
   shared-memory lookup floor beside it, its mode, QB, code ring, CTAs per
   SM and shared memory reported; and at ``pq_m`` 256, 8 bits (a 256 KiB
   table a query, walked in chunks: ROADMAP F2) on the same cells, 64
   queries with drawn codes and tables, against its plain version.  The index
   carries tenant tags, and serves the filtered batch with 500 exclusions
   (the scan at K = min(4096, cell_cap)), gated as in phase 5.
8. Filtered and multi-tenant serving (DESIGN.md §17) on phase 4's rows:
   1,048,576 x 256 fp32, ``neg_dot``, k = 10, through ``QueryEngine``.
   Each row carries one of 8 tenant tags drawn with shares 1/(t+1) (the
   smallest about 4.6%); an allow-list holds 70% of the ids.  Per batch of
   1024: a tenant filter ("auto" resolves to pre: the fused kernel's
   bitmap), the allow-list ("auto": post, at a fetch of widen(10, 0.7) =
   15), the tenant filter with 500 exclusions a query (its unfiltered top 5
   and 495 drawn ids: k + E = 510, so the fused kernel and the merge at
   K = 512), and an all-False filter; each held against a brute force over
   the allowed, live, not excluded rows, before churn, after an upsert with
   tags and a delete of 1% of main, and after the compact.  An all-True
   bitmap through ``knn_query`` must equal no bitmap bit for bit.  Steady
   windows of 25 batches for the tenant filter and the allow-list; at 1024 x
   1,048,576 the masked partial sets beside the unmasked ones, the bitmap
   build, the K = 512 call and its merge, each timed and held against its
   plain version.  Phase 6's fp32 IVF index carries tags of the same kind,
   and one tenant-filtered batch of 1024 there must serve no id of another
   tenant; its recall against the filtered brute force is reported.
9. Snapshots and the crash-safe lifecycle (DESIGN.md §12, §16) on phase 7's
   IVF-PQ index and phase 5's int8 index, each churned again (1% of the
   main rows deleted, 8,192 rows upserted into the delta, 1,024 of them
   twice), under ``build/phase9`` (the free disk printed first; removed at
   the end).  9a: each index searched on a fixed batch of 1024 and saved
   (file bytes and save time printed), then restored in a fresh process on
   the card with ``kmeans.lloyd`` a tripwire (``launch/snapshot_check.py``):
   values and ids bit-identical; the restore time (read, CRC, upload) beside
   the build time of the state it restores (phase 7's k-means, packing, PQ
   training and encoding; the int8 replica's quantization).  9b: the int8
   index under ``LifecycleIndex``, 1,000 fsync-acked single-row upserts and
   deletes (ack p50/p99), a torn half-frame at the journal's tail, recovery
   in a fresh process (``launch/lifecycle_check.py``): every acked record
   replayed, only the torn bytes dropped, the search bit-identical.  9c: the
   IVF-PQ index under ``LifecycleIndex``; ``compact()`` trains the next
   epoch in a worker thread on its own stream while ``QueryEngine`` serves
   batches of 1024 (p50/p90/max before, while the worker trains, while it
   writes the next image, after), and a few acked writes land in the
   window; the handoff at a batch boundary; gates: k-means never on the
   serving thread, the handed-off epoch's search bit-identical to a
   synchronous compact and first search of a copy of the state, and an
   fp32 scan of its cells at nprobe = ncells equal to brute force over the
   live main rows.  Peak device memory with both epochs on the card, the
   training seconds, and the worker's launches (its own tally) apart from
   the serving thread's.

10. The multi-device core (``core.distributed`` over a ``launch.mesh.Mesh``)
   with four positions: on four cards where the machine has them, else all
   four on the one card, each on its own stream (so no time here is a
   scaling figure).  10a: the ring at ``allpairs_160k`` (phase 2's x, k
   100, ``impl="kernel"``: ``pairwise_distance`` tiles walked in blocks of
   8,192 columns, ``stream_topk`` on each side), ids tie-aware equal to
   phase 2's fused result, values within its tolerance; then the bf16 wire,
   recall@100 printed.  10b: the paper's triangle on the same x, gsize
   20,096 by ``configs/base.py``'s rule (n padded to 160,768), gated as
   10a.  10c: the ``query_1m`` cell, 8,192 queries over 1,048,576 rows, k
   100, on a (1, 4) mesh: the fused scan per shard and the butterfly, ids
   tie-aware equal to the single-device ``knn_query``; then the int8
   two-stage with the bf16 wire, recall@100 at least 0.9.  10d: the
   ``RetrievalIndex`` on that mesh at 1,048,576 x 256 (neg_dot, k 10, phase
   8's tenant tags), churned (1% deleted, 8,192 rows upserted into the
   delta), 20 batches of 1024 through ``QueryEngine``, exact against a
   brute force of the live rows, one tenant-filtered batch serving no id of
   another tenant; then IVF fp32 (4,096 cells, 1,024 a shard) on phase 6's
   rows, recall@10 at nprobe 8 at least 0.9 and, at nprobe = ncells, equal
   to brute force, and IVF-PQ (``pq_m`` 32 on the same cells, overfetch 8):
   the sharded scorer on an fp32 wire at recall@10 at least 0.85, and the
   index, whose merge ships bf16 values as the reference's does, at least
   0.85 counting as hits the ids within one bf16 rounding of the exact 10th
   distance (its id-for-id recall printed beside it).  Each sub-phase prints its time, its launches
   and the peak memory; phase 10 must launch ``pairwise_distance``,
   ``stream_topk``, ``fused_knn``, ``rescore_topk``, ``ivf_scan`` and
   ``pq_scan``, and each kernel's entry in the ``kernels`` line carries its
   phase 10 launches (``launches_phase10``).
11. The shard fleet (``serving.shards``, ``transport``, ``supervisor``) at
   ``query_1m`` on one card: phase 10's IVF-PQ cells and codes cut into 4
   shard images of 1,024 cells under ``build/phase11`` (a fleet manifest
   of 2 replicas; the free disk printed first, the root removed at the
   end).  11a: the in-process fleet, recall@10 at least 0.85 against brute
   force on a fixed batch of 1024, coverage all ones, bit for bit the
   (1, 4)-mesh scorer over the same cells, codes and live slots; 25 warm
   batches through ``QueryEngine``.  11b: 4 x 2 worker processes on the
   card (spawn and HELLO seconds, the card's memory), bit for bit the
   in-process fleet on the fp32 and the bf16 wire, one batch's frame
   bytes beside ``rpc_bytes_per_batch``, 25 warm batches.  11c: a SIGKILL
   mid-batch and one replica of every shard killed between batches (bit
   for bit the healthy result), their respawn into probation and back to
   healthy, both replicas of shard 1 dead under ``"partial"`` (coverage
   < 1, the flat sort of the surviving shards' runs) and ``"refuse"``
   (``ShardUnavailableError``), and a drain that leaves no worker
   process.  Phase 11 must launch ``fused_knn``, ``pq_scan`` and
   ``rescore_topk`` (the router's process; each worker launches its own),
   and each kernel's entry carries ``launches_phase11``.
12. The two-tower retrieval service (``serving.service``) at the full width
   of ``configs/two_tower.py::full_config()``: 11.12 x 10^9 parameters
   (44.5 GB of tables) drawn on the card from a seed, the towers held on
   1,024 rows of each tower (every table's last row among them) against a
   CPU computation of the same rows; 10^6 items (the arch's
   ``retrieval_cand`` cell) embedded and served with ``serving_defaults()``:
   12b the flat service, one user and batches of 1024 (half repeat users)
   each equal to a brute force of the live corpus through an ingest, a
   delete of 1%, a compact and an exclusion batch, a steady window, the
   params fingerprint and a save and restore; 12c IVF-PQ at phase 7's
   settings (no deleted id served, recall@10 reported) and a full-probe fp32
   IVF service equal to brute force.  Phase 12 must launch ``fused_knn``,
   ``merge_partials``, ``pq_scan`` and ``rescore_topk``, and each kernel's
   entry carries ``launches_phase12``; the peak device memory is printed.
13. The recommender's trainer (``distributed.steps``, ``train.optim``) at
   each recsys arch's ``full_config()`` and the ``train_batch`` cell (65,536
   rows a step), through ``RecsysArch.build``: 13a the two-tower model (44.5
   GB of tables, 8 micro-batches), each sampled touched row equal to
   row-wise Adagrad recomputed on the host, untouched rows (past element
   2^31 among them) byte-equal, then its trained towers served through ``TwoTowerRetrievalService``
   (10^6 items, 1,024 users) and ``make_retrieval_step`` (1 x 10^6, k 100),
   each equal to brute force, then 14a (below) in place of a plain repeat;
   13b ``dlrm-rm2``, ``xdeepfm`` and ``bst``
   trained and served at ``serve_p99``; 13c the four at ``smoke_config()``
   on the card and on the CPU from one start, allclose.  Per arch: step ms
   (first, median) as forward-and-backward and update, rows touched, peak
   memory.  The training path reaches no kernel (none of the reference's
   Pallas kernels has a backward); phase 13 must launch ``fused_knn`` and
   ``merge_partials`` (the retrieval), and each entry carries
   ``launches_phase13``.
14. The training loop, checkpoints, the launcher and the NequIP potential
   (``train.loop``, ``train.checkpoint``, ``launch.train``,
   ``models.gnn``, ``data.graphs``).  14a, inside 13a: a ``TrainLoop`` of
   3 steps from a fresh draw of the two-tower model, its final sync save
   streaming the full-width state (45.9 GB) from the card to disk (the
   free disk checked first), the state freed, seed 0 drawn afresh and
   auto-resumed in place by a second ``TrainLoop`` to step 5: every leaf
   equal to 13a's first run there; save and restore seconds, GB/s, fsync
   seconds, peak memory.  14b: BST at full width, async saves every 2
   steps, each kept step's bytes equal to its state's digests; the train
   launcher SIGKILLed after its first checkpoint and resumed, its losses
   bit-equal to a whole run's.  14c: NequIP at ``full_config()`` on the
   ``molecule`` cell (3,840 atoms, 8,192 edges), 40 steps, the loss
   falling, a 3-step repeat byte-equal, the CPU within rtol 1e-4.  14d:
   the relaxation of ``examples/potential_md.py`` over the 128 molecules in
   one system, the neighbour list rebuilt by ``radius_graph`` on the card
   every 5 steps, each rebuild's edges equal to a float64 brute force
   except at near-ties, the first rebuild's ``fused_knn`` launches held
   against their plain version.  Then ``coalesce_rows`` against the
   ``torch.unique`` + ``argsort`` form, in turns.  Phase 14 must launch
   ``fused_knn`` (14d), and each entry carries ``launches_phase14``.
15. The language models (``models.attention``, ``models.moe``,
   ``models.transformer``, the LM steps, the LM launcher; ``phase_lm``).
   15a: qwen3-moe-30b-a3b at ``full_config()`` (61.1 GB of weights drawn on
   the card) serves 2 prompts of 4,096 tokens: prefill, 8 greedy decode
   steps, the same steps sequence-parallel on a (1, 4) mesh of the card
   (logits held against the plain decode); at capacity factor 8, prefill
   and decode held against ``forward``; layer 0 held against the CPU; every
   router launch of the first prefill and decode step held against the
   plain version.  15b: h2o-danube-3-4b at ``full_config()`` decodes past
   its window of 4,096 (a prompt of 6,144), held against ``forward`` and
   the sequence-parallel decode against the plain one.  15c: the five LMs
   at ``smoke_config()`` on the card and the CPU (serving and 3 train
   steps), then ``launch.train --preset lm100m`` on the card.  Prefill and
   decode times beside the decode bound (the weights' bytes over 3.35
   TB/s), peak memory, the router's ``stream_topk`` beside ``torch.topk``.
   Phase 15 must launch ``stream_topk`` (the MoE router), and each entry
   carries ``launches_phase15``.
16. The dry run (``launch/dryrun.py``, ``launch/hlo_stats.py``,
   ``train/compression.py``; ``phase_dryrun``).  16a: each kernel wrapper
   of the ``kernels`` line at a shape the script launches, on the card and
   on meta tensors: the meta outputs' shapes and dtypes must be the card's
   and the meta call must record one shape call and launch nothing.  16b:
   the dry run's counters over qwen3-moe-30b-a3b's prefill of 2 x 4,096
   tokens (15a's) and over the two-tower train step at 8 micro-batches
   (13a's), printed beside the peaks and times those phases measured (not
   a gate).  16c: ``compressed_psum_tree`` on a (4,) mesh of the card over
   DLRM-RM2's ``full_config()`` dense leaves, drawn per position from
   seeds 0-3: every leaf within 0.05 of the fp32 sum, sums and residuals
   equal to the CPU's on the same draws; its median ms a call and its
   wire bytes beside an fp32 ring's.  Its launches are outside every path.
17. The recommender sharded over a (data, model) mesh
   (``distributed.spmd``, ``distributed.steps``' sharded steps,
   ``train.optim``'s replica sums; ``phase_sharded``), a (2, 2) mesh whose
   positions cycle over the visible cards (all four on the one card).
   17a: DLRM-RM2 at ``full_config()`` drawn from seed 0 as in 13b, cut one
   leaf at a time (each table's row halves replicated over "data": 55.3
   GB), the first batch's looked-up rows of all 26 tables bit-equal to the
   whole lookup on every position, then 13b's 5 steps at 65,536 rows, held
   within rtol 1e-4 / atol 1e-5 (13c's tolerance) of 13b's whole run: the
   5 losses, and after step 2 (the first at a nonzero learning rate) the
   dense leaves and 2,048 touched rows of each of the three largest tables;
   every replica of every block byte-equal after every step.  After step 5
   the same params are reported against 13b beside a floor, the sharded run
   at 2 micro-batches against itself at 1 (the same gradients summed in
   another order): AdamW and row-wise Adagrad turn a last-bit difference in
   a near-zero gradient into a step of about the learning rate, so no two
   summation orders agree to 1e-4 there.  Step ms and peak memory.  17b: the four archs at ``smoke_config()``, 5
   steps on the card's mesh against the same on four CPU positions
   (13c's tolerance), replicas byte-equal, then ``make_recsys_serve_step``
   over both meshes.  17c: the two-tower model trained in 17b serves
   ``make_retrieval_step`` over the card's mesh at ``retrieval_cand`` (1 x
   10^6 candidates, k 100), the user tower on its shards, the candidates
   on "model": ids equal to a brute force.  17a.sgdm: 13b's 5 steps with
   ``StepConfig(optimizer="sgdm")`` on a DLRM-RM2 whose tables are cut to
   2^20 rows, whole and on the (2, 2) mesh, the params after steps 2 and
   5 reported (step 2 held within 13c's tolerance).  Phase 17 must launch
   ``fused_knn`` and ``merge_partials`` (17c), and each entry carries
   ``launches_phase17``.
18. The language models' prefill and decode sharded over a (data, model)
   mesh of the card (``distributed.steps``' LM serve steps over
   ``sharding.shard_tree`` values and ``cache_shardings`` caches).  18a,
   inside phase 15 right after 15a: qwen3-moe-30b-a3b's 61.1 GB cut in
   place onto a (1, 4) mesh (each position a quarter of the experts, heads
   and vocabulary: 15.31 GB), 15a's prompts prefilled into a cache cut over
   the KV heads and 8 decode steps fed 15a's tokens, then the
   sequence-parallel decode over a cache cut over its slots, each held
   against 15a's logits by ``LM_TOL``; every router launch at every
   position held against ``stream_topk_plain``; every cache part the same
   storage from step to step.  18b, inside phase 15 after 15b:
   h2o-danube-3-4b on a (2, 2) mesh (FSDP over "data"), 2 prompts of
   6,144 tokens against the whole step on the card.  18c: the five LMs at
   ``smoke_config()`` on a (2, 2) mesh against their whole steps.  Prefill
   tokens/s, decode ms a step, peaks and each position's bytes beside
   15a-b's whole figures.  Phase 18 must launch ``stream_topk`` (the
   routers of 18a and 18c), and each entry carries ``launches_phase18``.

Each path runs with the kernels' launch counts set to 0 just before it and
read just after; a background worker's launches (phase 9) go to its own
tally, never to those counts.  The line before the last is ``{"kernels": [...]}``: per
kernel its launches, max |difference| against its plain version, its time,
the plain version's time, the least time the card could take (bytes over
3.35 TB/s or operations over the peak rate, whichever is larger) and, where
one PyTorch call computes the same function, that call's time.  The
operations of a matmul-form kernel (``fused_knn``, ``pairwise_distance``,
``ivf_scan``) are its 2 m n d product in three TF32 passes at 495 TFLOP/s
(two for a bf16 or int8 database), the least work at an accuracy the checks
accept, with the same work in fp32 FMAs at 67 TFLOP/s beside it as
``bound_fp32_ms``; the others' are fp32 operations at 67 TFLOP/s.  Those
three kernels also name the tile ``product`` they ran.  Each of the six
selection kernels also carries variants at K > 256: its launches in the
filtered batches of phases 5-7 and its call at the card's cap (K = 4096;
``ivf_scan`` and ``pq_scan`` at K = ``cell_cap``, their widest fetch), each
timed and held against its plain version on the same inputs.  The last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.  Everything it prints also goes, in full, to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_TF32 = 495e12  # H100 SXM dense TF32 on the tensor cores, FLOP/s
PEAK_HBM = 3.35e12  # H100 SXM HBM3, bytes/s
PRODUCT = "wgmma 3xTF32 (gemm_tc.cuh)"  # the tile product of the matmul-form kernels
QUERY_ROWS = 1 << 20  # the query_1m cell (src/repro/configs/base.py:489)
IVF_CELLS = 4096  # 4 * sqrt(n), the low end of faiss's IVF guideline for ~1M rows
N_TENANTS = 8  # phase 8's tenant tags, drawn with shares proportional to 1 / (t + 1)
MESH_QUERIES = 8192  # phase 10c: the query_1m cell's m (src/repro/configs/base.py:489)
SERVICE_ITEMS = 1_000_000  # phase 12: the two-tower retrieval_cand cell (configs/base.py:354-356)
# Batches of 1024 in a steady window (phases 4-8, 11), after one cold batch:
# 25 (50 once), to keep the script near 900 s of its own clock.
STEADY_BATCHES = 25
SERVICE_STEADY = 25  # phase 12b: batches of 1024 users in the steady window
SERVICE_CONFIG = None  # phase 12's towers: None is configs/two_tower.py::full_config()
TRAIN_ROWS = None  # phase 13's rows a step: None is the train_batch cell's 65536 (configs/base.py:350)
TRAIN_STEPS = {"two-tower-retrieval": 10, "dlrm-rm2": 5, "xdeepfm": 5, "bst": 5}
# micro_batches: the two-tower's 8 give each slice an 8192-row in-batch
# softmax (a [65536, 65536] one would not fit); xDeepFM's CIN outer products
# of 65,536 rows (about 45 GB for the three layers) do not fit one pass.
TRAIN_MICRO = {"two-tower-retrieval": 8, "dlrm-rm2": 1, "xdeepfm": 2, "bst": 1}
TRAIN_STEP = dict(peak_lr=5e-3, warmup_steps=2, total_steps=100)  # the rest StepConfig's defaults
PQ_M, PQ_NBITS = 32, 8  # faiss's "IVF4096,PQ32": dsub 8, as the reference's d 128, pq_m 16
# fp32 operations per (pair, coordinate) of the cumulative accumulators
# (csrc/pairwise_cumulative.cu), counted by the fp32 pipe's slots: an FFMA
# is one instruction and two operations at the 67 TFLOP/s peak, and an FADD
# or FSUB beside it takes a slot of its own, so it counts as two too.  acc + (a - b)^2, acc + (sqrt a - sqrt b)^2 and acc + p (log p -
# log q) are each an FSUB and an FFMA (four); acc + a b one FFMA (two).
# Roots and logarithms are per element.
CUMULATIVE_OPS = {"sqeuclidean": 4, "neg_dot": 2, "hellinger": 4, "kl": 4}
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


def graph_ms(torch, fn, n=20):
    """Device ms of one call of ``fn``: ``n`` calls captured in a CUDA graph,
    the graph replayed and timed by CUDA events, so that the host's launch
    overhead, which ``time_ms`` sees for a small kernel, drops out."""
    fn()
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
    return time_ms(torch, g.replay, reps=5) / n


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def mm_bound(flops: float, nbytes: float, gy_exact: bool = False) -> dict:
    """The bound of a matmul-form kernel (fused_knn, pairwise_distance,
    ivf_scan): ``flops`` = 2 m n d of its tile product in three TF32 passes
    (two where gy is bf16 or int8, exact in TF32), the least the card needs
    for the product at an accuracy the checks accept, or its bytes over
    3.35 TB/s, whichever is larger; and beside it the same work in fp32 FMAs
    on the CUDA cores (``bound_fp32_ms``)."""
    t_ops, t_bytes = (2 if gy_exact else 3) * flops / PEAK_TF32, nbytes / PEAK_HBM
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_fp32_ms": bound_ms(flops, nbytes)[0]}


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


def brute_topk(torch, q, vecs, K, chunk=256):
    """Exact top-K of -q.v (neg_dot) by (value, row), a chunk of queries at a time."""
    from repro_torch.kernels.stream_topk import sorted_prefix

    outs = [sorted_prefix(-(q[r : r + chunk] @ vecs.T), K) for r in range(0, len(q), chunk)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def recall_at(torch, got_ids, want_ids, chunk=8192) -> float:
    """Share of the true k nearest ids that the result holds, over all rows
    (a chunk of rows at a time: k 100 over 160,000 rows would hold 1.6 G
    comparisons at once)."""
    hits = sum(float((got_ids[r : r + chunk].long()[:, :, None]
                      == want_ids[r : r + chunk].long()[:, None, :]).any(1).sum())
               for r in range(0, len(want_ids), chunk))
    return hits / want_ids.numel()


def true_ids(torch, q, vecs, k, chunk=1024):
    """The k largest dot products' row ids (the neg_dot k nearest)."""
    return torch.cat([torch.topk(q[r : r + chunk] @ vecs.T, k, dim=1).indices
                      for r in range(0, len(q), chunk)])


def tenant_tags(n: int, seed: int) -> np.ndarray:
    """``n`` tags of ``N_TENANTS`` tenants, tenant t drawn with a share
    proportional to 1 / (t + 1)."""
    share = 1.0 / np.arange(1, N_TENANTS + 1)
    return np.random.default_rng(seed).choice(N_TENANTS, n, p=share / share.sum()).astype(
        np.int32)


def neg_dot_distance(qt, vt):
    return lambda rows, cols: -(qt[rows] * vt[cols]).sum(1)


def time_plain(torch, fn):
    """Host-clock ms of one call of a plain version (too slow to repeat)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def rows_close(torch, got, want, atol, rtol, what):
    """max |got - want| over the finite entries; raise past atol + rtol |want|
    or where the two disagree on which entries are +inf."""
    check(torch.equal(torch.isinf(got), torch.isinf(want)), f"{what}: +inf entries differ")
    fin = torch.isfinite(want)
    diff = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    err = float(diff.max())
    check(bool((diff <= atol + rtol * want.abs().nan_to_num(0.0, 0.0, 0.0)).all()),
          f"{what}: max |difference| {err} past atol {atol} + rtol {rtol}")
    return err


class WideLaunches:
    """While active, record every call of a selection kernel's wrapper at
    K > 256 (its arguments and its result), so that each launch can be held
    against its plain version at that shape afterwards."""

    def __init__(self, torch):
        from repro_torch.kernels import fused_knn as FK
        from repro_torch.kernels import ivf_scan as IVS
        from repro_torch.kernels import merge_partials as MP
        from repro_torch.kernels import pq_scan as PQS
        from repro_torch.kernels import rescore as RS
        from repro_torch.kernels import stream_topk as ST

        from repro_torch.core import topk as T
        from repro_torch.kernels import ops

        def wide_out(a, kw, out):
            return out[0].shape[-1] > 256

        def wide_k(a, kw, out):  # ops.rescore_operands(q, db, cand_idx, k, ...)
            return T.next_pow2(a[3] if len(a) > 3 else kw["k"]) > 256

        # (kernel, module of its wrapper, wrapper, modules that import it by
        # name, whether a call is wide); "rescore_gather" is the rescore's
        # gather, recorded to be timed beside the launch that follows it.
        self.targets = [("fused_knn", FK, "fused_knn_partials", [], wide_out),
                        ("ivf_scan", IVS, "ivf_scan_partials", [], wide_out),
                        ("pq_scan", PQS, "pq_scan_partials", [], wide_out),
                        ("rescore_gather", ops, "rescore_operands", [], wide_k),
                        ("rescore_topk", RS, "rescore_topk", [], wide_out),
                        ("merge_partials", MP, "merge_partials", [FK, IVS, PQS], wide_out),
                        ("stream_topk", ST, "stream_topk", [], wide_out)]
        self.records, self.saved = [], []

    def __enter__(self):
        for name, mod, attr, users, wide in self.targets:
            orig = getattr(mod, attr)

            def wrap(*a, _orig=orig, _name=name, _wide=wide, **kw):
                out = _orig(*a, **kw)
                if _wide(a, kw, out):
                    self.records.append((_name, _orig, a, kw, out))
                return out

            for m in (mod, *users):
                self.saved.append((m, attr, orig))
                setattr(m, attr, wrap)
        return self

    def __exit__(self, *exc):
        for m, attr, orig in reversed(self.saved):
            setattr(m, attr, orig)
        self.saved = []


def ivf_pairs(torch, probes, live_per_cell, tile_m, m):
    """(query, row) pairs a cell-probed scan needs, and the rows it reads:
    each union tile's queries against the live rows of the distinct cells
    of its list."""
    fresh = torch.ones_like(probes, dtype=torch.bool)
    fresh[:, 1:] = probes[:, 1:] != probes[:, :-1]
    rows_per_tile = (live_per_cell[probes.long()] * fresh).sum(1)
    q_per_tile = torch.tensor([min(tile_m, m - t * tile_m) for t in range(len(probes))],
                              device=probes.device)
    pairs = int((q_per_tile * rows_per_tile).sum())
    read = int(live_per_cell[torch.unique(probes).long()].sum())
    return pairs, read, rows_per_tile


def pq_shape(PQS, probes, m, pq_m, ncodes, K, dev, tile_m) -> dict:
    """The pq_scan launch's plan: mode, QB, chunk, splits, CTAs, and CTAs
    resident per SM and shared memory per CTA."""
    pl = PQS.plan(probes, m, pq_m, ncodes, K, dev, tile_m)
    per_sm, smem = PQS.kernel_shape(dev, pl.qb, pl.ring, pl.chunk, pq_m, ncodes, K)
    return {"mode": "ring" if pl.ring else "generic", "qb": pl.qb, "chunk": pl.chunk,
            "code_ring_units": PQS.RING_UNITS if pl.ring else 0, "splits": pl.splits,
            "ctas": -(-m // pl.qb) * pl.splits, "ctas_per_sm": per_sm, "smem_bytes": smem,
            "tile_m": tile_m}


def hold_wide(torch, records):
    """Each recorded wide launch against its plain version on the same
    inputs: times (the kernel again, by CUDA events; the plain version
    once), the bound from these inputs, and the comparison (exact for the
    merge and stream_topk, tie-aware for the scans).  {kernel: [entry]}."""
    import inspect

    from repro_torch.core.distances import FINALIZERS
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import ivf_scan as IVS
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import pq_scan as PQS
    from repro_torch.kernels import rescore as RS
    from repro_torch.kernels import stream_topk as ST
    from repro_torch.kernels.ref import check_topk, operand_distance

    out, gather = {}, None
    for name, fn, a, kw, res in records:
        if name == "rescore_gather":  # timed beside the launch it feeds
            gather = (fn, a, kw, res)
            continue
        v, i = res
        more = {}  # what a kernel's entry adds: the rescore's plan and its gather's time
        arg = inspect.signature(fn).bind(*a, **kw)
        arg.apply_defaults()
        p = dict(arg.arguments)
        p.update(p.pop("kw", {}))
        ms = time_ms(torch, lambda: fn(*a, **kw))
        K = v.shape[-1]
        lib_ms = None
        if name == "merge_partials":
            plain_ms, (pv, pi) = time_plain(torch, lambda: MP.merge_partials_plain(*a))
            check(torch.equal(v, pv) and torch.equal(i, pi), "a wide merge vs its plain version")
            cmp = {"max_abs_err": 0.0}
            bnd = bound_ms(0.0, a[0].numel() * 8 + v.numel() * 8)
            shape = f"{a[0].shape[0]} splits x {a[0].shape[1]} x {K}"
            cat_v = a[0].permute(1, 0, 2).reshape(a[0].shape[1], -1).contiguous()
            lib_ms = time_ms(torch, lambda: torch.topk(cat_v, K, dim=1, largest=False))
            del cat_v
        elif name == "stream_topk":
            x = p["x"]
            plain_ms, (pv, pi) = time_plain(torch, lambda: ST.stream_topk_plain(x, p["k"]))
            check(torch.equal(v, pv) and torch.equal(i, pi), "a wide stream_topk vs plain")
            cmp = {"max_abs_err": 0.0}
            bnd = bound_ms(1.0 * x.numel(), x.numel() * 4 + v.numel() * 8)
            shape = f"{x.shape[0]} x {x.shape[1]}, k {p['k']}"
            lib_ms = time_ms(torch, lambda: torch.topk(x, p["k"], dim=1, largest=False))
        elif name == "rescore_topk":
            fx, cand, hx, hy = p["fx"], p["cand"], p["hx"], p["hy_cand"]
            fin = FINALIZERS[p["finalize"]]
            plain_ms, (pv, pi) = time_plain(torch, lambda: RS.rescore_topk_plain(
                fx, cand, hx, hy, p["k"], alpha=p["alpha"], finalize=p["finalize"]))
            cmp = check_topk(v, i, pv, pi, n=cand.shape[1], rtol=1e-5, atol=1e-3,
                             dist=lambda r, c: fin(p["alpha"] * (fx[r] * cand[r, c]).sum(1)
                                                   + hx[r, 0] + hy[r, c]))
            bnd = bound_ms(2.0 * cand.numel(), (cand.numel() + fx.numel() + hx.numel()
                                                + hy.numel()) * 4 + v.numel() * 8)
            shape = f"candidates {list(cand.shape)}, k {p['k']}"
            qb, per_sm, smem = RS.kernel_shape(cand.device, cand.shape[1], cand.shape[2], K)
            more["plan"] = {"rows_a_cta": qb, "ctas_per_sm": per_sm, "smem_bytes": smem}
            if gather is not None and gather[3][1] is cand:
                # the gather db[cand_idx] and its gy / hy maps (ops.rescore_operands):
                # the [m, Kp, d] rows read and the block written, once each
                g_fn, g_a, g_kw, _ = gather
                db = g_a[1]
                more["gather_ms"] = time_ms(torch, lambda: g_fn(*g_a, **g_kw))
                more["gather_bound_ms"] = bound_ms(
                    0.0, g_a[2].numel() * (db.shape[1] * db.element_size() + 4)
                    + (cand.numel() + hy.numel()) * 4)[0]
                more["gather_db_dtype"] = str(db.dtype)[6:]
            gather = None
        elif name == "fused_knn":
            fx, gy, hx, hy, gs, qm = p["fx"], p["gy"], p["hx"], p["hy"], p["gy_scale"], p["q_mask"]
            plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
                fx, gy, hx, hy, p["k"], alpha=p["alpha"], finalize=p["distance_finalize"],
                n_real=p["n_real"], exclude_self=p["exclude_self"], gy_scale=gs, q_mask=qm))
            mv, mi = MP.merge_partials_plain(v, i)
            cmp = check_topk(mv, mi, pv, pi, n=gy.shape[0], rtol=1e-5, atol=1e-3,
                             dist=operand_distance(fx, gy, hx, hy, alpha=p["alpha"],
                                                   finalize=p["distance_finalize"],
                                                   gy_scale=gs))
            m_, n_, d_ = fx.shape[0], gy.shape[0], fx.shape[1]
            extra = (0 if gs is None else n_ * 4) + (0 if qm is None else qm.numel() * 4)
            bnd_d = mm_bound(2.0 * m_ * n_ * d_, m_ * d_ * 4 + n_ * d_ * gy.element_size()
                             + (m_ + n_) * 4 + extra + v.numel() * 8,
                             gy_exact=gy.dtype != torch.float32)
            bnd = (bnd_d["bound_ms"], bnd_d["bound_by"])
            shape = (f"partial sets, {m_} x {n_} (gy {str(gy.dtype)[6:]}), d {d_}, k {p['k']}"
                     + ("" if qm is None else ", bitmap"))
        elif name == "ivf_scan":
            probes, fx, gy, gs = p["probes"], p["fx"], p["gy"], p["gy_scale"]
            hx, hy = p["hx"], p["hy"]
            cap, extent = p["cell_cap"], p["cell_extent"]
            plain_ms, (pv, pi) = time_plain(torch, lambda: IVS.ivf_scan_plain(
                probes, fx, gy, hx, hy, p["k"], cell_cap=cap, tile_m=p["tile_m"],
                cell_extent=extent, alpha=p["alpha"], finalize=p["distance_finalize"],
                gy_scale=gs))
            mv, mi = MP.merge_partials_plain(v, i)
            cmp = check_topk(mv, mi, pv, pi, n=gy.shape[0], rtol=1e-5, atol=1e-3,
                             dist=operand_distance(fx, gy, hx, hy, alpha=p["alpha"],
                                                   finalize=p["distance_finalize"],
                                                   gy_scale=gs))
            live = torch.isfinite(hy[0]).view(-1, cap).sum(1)
            m_, d_ = fx.shape
            pairs, read, _ = ivf_pairs(torch, probes, live, p["tile_m"], m_)
            bnd_d = mm_bound(2.0 * pairs * d_, m_ * d_ * 4 + read * d_ * gy.element_size()
                             + read * 4 * (1 if gs is None else 2) + v.numel() * 8,
                             gy_exact=gy.dtype != torch.float32)
            bnd = (bnd_d["bound_ms"], bnd_d["bound_by"])
            shape = (f"{m_} queries, tile_m {p['tile_m']}, cell_cap {cap}, gy "
                     f"{str(gy.dtype)[6:]}, k {p['k']}")
        elif name == "pq_scan":
            probes, luts, codes, hx, hy, qc = (p["probes"], p["luts"], p["codes"], p["hx"],
                                               p["hy"], p["qc"])
            cap, nc = p["cell_cap"], p["ncodes"]
            plain_ms, (pv, pi) = time_plain(torch, lambda: PQS.pq_scan_plain(
                probes, luts, codes, hx, hy, p["k"], cell_cap=cap, ncodes=nc,
                tile_m=p["tile_m"], cell_extent=p["cell_extent"],
                finalize=p["distance_finalize"], qc=qc))
            mv, mi = MP.merge_partials_plain(v, i)
            m_, pq_m = luts.shape[0], codes.shape[1]
            lut3 = luts.view(m_, pq_m, nc)
            sub = torch.arange(pq_m, device=luts.device)[None, :]

            def adc(rows, cols):
                s_ = lut3[rows[:, None], sub, codes[cols].long()].sum(1) + hx[rows, 0] + hy[0, cols]
                return s_ if qc is None else s_ + qc[rows, cols // cap]

            cmp = check_topk(mv, mi, pv, pi, n=codes.shape[0], rtol=1e-5, atol=1e-4, dist=adc)
            live = torch.isfinite(hy[0]).view(-1, cap).sum(1)
            pairs, read, _ = ivf_pairs(torch, probes, live, p["tile_m"], m_)
            bnd = bound_ms(1.0 * pairs * pq_m, read * (pq_m + 4) + luts.numel() * 4
                           + (0 if qc is None else qc.numel() * 4) + m_ * 4 + v.numel() * 8)
            shape = f"{m_} queries, tile_m {p['tile_m']}, cell_cap {cap}, pq_m {pq_m}, k {p['k']}"
        out.setdefault(name, []).append({
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "max_abs_err": cmp["max_abs_err"], "vs_plain": cmp, "library_ms": lib_ms, "K": K,
            "shape": shape, **more})
    return out


def filtered_wide_batch(torch, dev, run_path, index, engine, queries, k, label, seed):
    """One batch through ``engine`` under phase 8's tenant filter with 500
    exclusions a query (its unfiltered top 5 and 495 drawn ids: k + E = 510,
    a fetch of K = 512 and, overfetched, up to 4096).  Gates: no excluded
    id and no id of another tenant is served; every served id is live, at
    its own distance; each wide launch equals its plain version at its
    shape.  Recall@k against the filtered brute force is reported."""
    from repro_torch.serving.filters import QueryFilter

    m = len(queries)
    rng = np.random.default_rng(seed)
    qten = rng.integers(0, N_TENANTS, m).astype(np.int32)
    top5 = engine.search(queries).ids[:, :5].cpu().numpy().astype(np.int64)
    vecs, ids = index._live_rows()
    ex = np.concatenate([top5, rng.integers(0, int(ids.max()) + 1, (m, 495))], 1)
    f = QueryFilter(tenant=qten, exclude_ids=ex)
    with WideLaunches(torch) as rec:
        got, counts = run_path(label, lambda: engine.search(queries, filter=f))
    tens = index._live_tenants()
    vt = torch.from_numpy(vecs).to(dev)
    ids_t = torch.from_numpy(ids).to(dev).long()
    pos = torch.full((int(ids_t.max()) + 1,), -1, dtype=torch.long, device=dev)
    pos[ids_t] = torch.arange(len(ids_t), device=dev)
    qt = torch.from_numpy(queries).to(dev)
    tt, qten_t = torch.from_numpy(tens).to(dev), torch.from_numpy(qten).to(dev)
    ex_t = torch.from_numpy(ex).to(dev)
    r, c = (got.ids >= 0).nonzero(as_tuple=True)
    gid = got.ids[r, c].long()
    check(bool((gid < len(pos)).all()) and bool((pos[gid.clamp(max=len(pos) - 1)] >= 0).all()),
          f"{label}: a served id is not live")
    p = pos[gid]
    check(bool((tt[p] == qten_t[r]).all()), f"{label}: an id of another tenant was served")
    check(not bool((ex_t[r] == gid[:, None]).any()), f"{label}: an excluded id was served")
    want = -(qt[r] * vt[p]).sum(1)
    err = (got.distances[r, c] - want).abs()
    check(bool((err <= 1e-3 + 1e-5 * want.abs()).all()), f"{label}: a served value is not its id's")
    truth = []
    for r0 in range(0, m, 256):
        dm = torch.where(tt[None, :] == qten_t[r0 : r0 + 256, None], qt[r0 : r0 + 256] @ vt.T,
                         float("-inf"))
        e = ex_t[r0 : r0 + 256]
        pe = pos[e.clamp(0, len(pos) - 1)]
        hit = (e >= 0) & (e < len(pos)) & (pe >= 0)
        rows = torch.arange(len(e), device=dev)[:, None].expand_as(e)
        dm[rows[hit], pe[hit]] = float("-inf")
        top = torch.topk(dm, k, dim=1)
        truth.append(torch.where(torch.isfinite(top.values), ids_t[top.indices], -1))
    wide = hold_wide(torch, rec.records)
    out = {"recall_at_10": recall_at(torch, got.ids, torch.cat(truth)),
           "empty_slots": int((got.ids < 0).sum()), "max_abs_err": float(err.max()),
           "launches": counts, "wide": wide}
    say(label, out)
    return out


def phase_cumulative(torch, dev, run_path, x, res):
    """Phase 3b: the paper's two phases with the per-coordinate kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as PD
    from repro_torch.kernels import stream_topk as ST
    from repro_torch.kernels.ref import check_topk

    m, k = 1024, 100
    n, d = x.shape
    xq = x[:m]
    eps = 2.0 ** -24

    def two_phase():
        dm = ops.pairwise_distance(xq, x, cumulative=True)
        dm.diagonal().fill_(float("inf"))  # exclude self, as phase 2 does
        return dm, ops.stream_topk(dm, k)

    (dm, (tv, ti)), counts = run_path("two_phase_cumulative_1024x160k", two_phase)
    check(counts["pairwise_cumulative"] == 1 and counts["stream_topk"] == 1, f"launches {counts}")
    out = {}
    # Against the plain version: both fold 256 positive terms in fp32, so
    # each is within 255 * 2^-24 of the exact sum, relatively; twice that.
    plain_ms, plain = time_plain(torch, lambda: PD.pairwise_cumulative_plain(
        xq, x, accumulate="sqeuclidean", finalize="identity"))
    plain.diagonal().fill_(float("inf"))
    err = rows_close(torch, dm, plain, 0.0, 2 * 255 * eps, "cumulative kernel vs plain")
    del plain
    # Against the matmul-form kernel: hx + hy - 2 x.y rounds its sums of d
    # terms of up to |x|^2 + |y|^2: d * 2^-24 * max(hx + hy) bounds it.
    mm = ops.pairwise_distance(xq, x)
    mm.diagonal().fill_(float("inf"))
    sq = (x * x).sum(1)
    mm_atol = d * eps * float(sq[:m].max() + sq.max())
    mm_err = rows_close(torch, dm, mm, mm_atol, 0.0, "cumulative vs matmul form")
    del mm

    def exact(rows, cols):  # the per-coordinate distance of each pair, in fp32
        return ((xq[rows] - x[cols]) ** 2).sum(1)

    ids = check_topk(tv, ti, res.distances[:m], res.indices[:m], n=n, rtol=1e-5,
                     atol=mm_atol, dist=exact)
    K = 128
    lib_ms = time_ms(torch, lambda: torch.cdist(xq, x) ** 2)
    out["sqeuclidean"] = {
        "ms": time_ms(torch, lambda: ops.pairwise_distance(xq, x, cumulative=True)),
        "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
        "max_abs_vs_matmul_form": mm_err, "matmul_form_atol": mm_atol, "ids_vs_fused": ids,
        "stream_topk_ms": time_ms(torch, lambda: ops.stream_topk(dm, k)),
        "shape": f"{m} x {n}, d {d}"}
    bnd = bound_ms(1.0 * m * n * d * CUMULATIVE_OPS["sqeuclidean"],
                   (m + n) * d * 4 + m * n * 4)
    out["sqeuclidean"].update(bound_ms=bnd[0], bound_by=bnd[1])
    # Phase 2 of this path: stream_topk on the per-coordinate matrix, held
    # against its plain version exactly.
    st_plain_ms, (sv, si) = time_plain(torch, lambda: ST.stream_topk_plain(dm, k))
    check(torch.equal(tv, sv[:, :k]) and torch.equal(ti, si[:, :k]),
          "3b: stream_topk kernel vs plain")
    st_bnd = bound_ms(1.0 * m * n, m * n * 4 + m * K * 8)
    out["sqeuclidean"]["stream_topk"] = {
        "ms": out["sqeuclidean"]["stream_topk_ms"], "plain_ms": st_plain_ms,
        "bound_ms": st_bnd[0], "bound_by": st_bnd[1], "max_abs_err": 0.0,
        "library_ms": time_ms(torch, lambda: torch.topk(dm, k, dim=1, largest=False)),
        "shape": f"{m} x {n}, k {k} (per-coordinate distances)"}
    del dm, tv, ti, sv, si

    # Hellinger and KL on distributions: rows |x|, each normalised to sum 1.
    n2 = 16384
    p = x[:n2].abs()
    p = p / p.sum(1, keepdim=True)
    pq_ = p[:m]

    def generic():
        return {name: ops.pairwise_distance(pq_, p, distance=name, cumulative=True)
                for name in ("hellinger", "kl")}

    mats, counts = run_path("cumulative_hellinger_kl_1024x16k", generic)
    check(counts["pairwise_cumulative"] == 2, f"launches {counts}")
    for name, got in mats.items():
        acc, fin = ("hellinger", "half_sqrt") if name == "hellinger" else ("kl", "identity")
        pms, want = time_plain(torch, lambda: PD.pairwise_cumulative_plain(
            pq_, p, accumulate=acc, finalize=fin))
        # Sums of d terms (KL's signed): d * 2^-24 of the largest value,
        # plus 1e-5 relative for the roots and logarithms.
        atol = d * eps * float(want.abs().max())
        out[name] = {"ms": time_ms(torch, lambda: ops.pairwise_distance(
            pq_, p, distance=name, cumulative=True)), "plain_ms": pms, "library_ms": None,
            "max_abs_err": rows_close(torch, got, want, atol, 1e-5, f"{name} kernel vs plain"),
            "atol": atol, "shape": f"{m} x {n2}, d {d}"}
        bnd = bound_ms(1.0 * m * n2 * d * CUMULATIVE_OPS[acc], (m + n2) * d * 4 + m * n2 * 4)
        out[name].update(bound_ms=bnd[0], bound_by=bnd[1])
    say("cumulative_two_phase", out)
    return out


def phase_two_stage(torch, dev, run_path):
    """Phase 5: the two-stage quantized tier at the query_1m shape."""
    from repro_torch.core.distances import quantize_rows
    from repro_torch.core.topk import next_pow2
    from repro_torch.core.knn import scan_width, two_stage_query
    from repro_torch.data.synthetic import random_vectors
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import ops
    from repro_torch.kernels import rescore as RS
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex

    n, d, k = QUERY_ROWS, 256, 10
    db = random_vectors(n, d, seed=0)
    queries = random_vectors(8192 + 3 * 1024, d, seed=5)
    db_t = torch.from_numpy(db).to(dev)
    q_t = torch.from_numpy(queries[:8192]).to(dev)
    truth = true_ids(torch, q_t, db_t, k)
    qb = q_t[:1024]

    # The reference's exactness hatch: a float32 replica is exact.
    ev, ei = brute_topk(torch, qb, db_t, 16)
    res = two_stage_query(qb, db_t, quantize_rows(db_t, "float32", distance="neg_dot"), k,
                          distance="neg_dot", impl="fused")
    say("two_stage_float32_vs_brute", check_topk(
        res.distances, res.indices.long(), ev[:, :k], ei[:, :k].long(), n=n, rtol=1e-5,
        atol=1e-3, dist=neg_dot_distance(qb, db_t)))
    del res, ev, ei

    k_scan = scan_width(n, k, 4)
    out = {"k_scan": k_scan}
    kept = None  # the int8 index, for phase 9
    fx32, gy32, _, hx32, hy32, _ = ops._scan_operands(qb, db_t, "neg_dot")
    kw32 = dict(distance_finalize="identity", alpha=-1.0, n_real=n)
    out["float32"] = {
        "partials_ms": time_ms(torch, lambda: FK.fused_knn_partials(fx32, gy32, hx32, hy32,
                                                                    k_scan, **kw32)),
        **mm_bound(2.0 * 1024 * n * d, 1024 * d * 4 + n * d * 4 + n * 4)}
    del fx32, gy32, hx32, hy32
    for sd in ("int8", "bfloat16"):
        index = RetrievalIndex.build(np.arange(n), db, distance="neg_dot", impl="fused",
                                     device=dev, scan_dtype=sd, overfetch=4,
                                     tenants=tenant_tags(n, 30) if sd == "int8" else None)
        engine = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))

        def serve():
            got = engine.search(queries[:8192])
            rec = recall_at(torch, got.ids, truth)
            replica = index._dev["main_q"]
            rng = np.random.default_rng(6)
            new_ids = np.concatenate([np.arange(0, n, n // 2048)[:2048],
                                      np.arange(n, n + 2048)])
            index.upsert(new_ids, random_vectors(4096, d, seed=7))
            engine.search(queries[8192:9216])
            index.delete(rng.choice(n, n // 100, replace=False))
            engine.search(queries[9216:10240])
            check(index._dev["main_q"] is replica, f"{sd}: a delete requantized the replica")
            index.compact()
            got2 = engine.search(queries[10240:11264])
            check(index._dev["main_q"] is not replica, f"{sd}: compact kept the old replica")
            vecs, ids = index._live_rows()
            vt = torch.from_numpy(vecs).to(dev)
            q2 = torch.from_numpy(queries[10240:11264]).to(dev)
            ids_t = torch.from_numpy(ids).to(dev)
            rec2 = recall_at(torch, got2.ids, ids_t[true_ids(torch, q2, vt, k)])
            steady = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))
            for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
                steady.search(queries[(b % 8) * 1024 : (b % 8 + 1) * 1024])
            return rec, rec2, engine.meter.summary(), steady.meter

        (rec, rec2, meter, steady), counts = run_path(f"serving_two_stage_{sd}", serve)
        for name in ("fused_knn", "rescore_topk", "merge_partials"):
            check(counts[name] > 0, f"two-stage {sd}: {name} never launched: {counts}")
        check(rec >= 0.9 and rec2 >= 0.9, f"two-stage {sd}: recall@10 {rec}, {rec2} < 0.9")
        say(f"two_stage_{sd}_serving", {"recall_at_10": rec, "recall_at_10_after_churn": rec2,
                                        "meter": meter, "steady": steady.summary(),
                                        "steady_p90_ms": steady.latency_ms(90)})
        if sd == "int8":  # phase 8's tenant filter with 500 exclusions: K' = 4 * 512
            flt = filtered_wide_batch(torch, dev, run_path, index, engine, queries[:1024], k,
                                      "two_stage_int8_filtered_exclude", 31)
            for name in ("fused_knn_wide", "merge_partials_wide", "rescore_topk_wide"):
                check(flt["launches"][name] > 0, f"two-stage filtered: {name} never launched")

        # The kernels at a batch of 1024, against their plain versions.
        vecs_t, main_q = index._dev["main_vecs"], index._dev["main_q"]
        nn = vecs_t.shape[0]
        fx, gy, gs, hx, hy, alpha = ops._scan_operands(qb, main_q, "neg_dot")
        kw = dict(distance_finalize="identity", alpha=alpha, n_real=nn, gy_scale=gs)
        parts = {}
        part_ms = time_ms(torch, lambda: parts.__setitem__(
            "p", FK.fused_knn_partials(fx, gy, hx, hy, k_scan, **kw)))
        part_v, part_i = parts["p"]
        v, i = MP.merge_partials(part_v, part_i)
        plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
            fx, gy, hx, hy, k_scan, alpha=alpha, finalize="identity", n_real=nn, gy_scale=gs))
        cmp = check_topk(v[:, :k_scan], i[:, :k_scan], pv[:, :k_scan], pi[:, :k_scan], n=nn,
                         rtol=1e-5, atol=1e-3,
                         dist=operand_distance(fx, gy, hx, hy, alpha=alpha,
                                               finalize="identity", gy_scale=gs))
        mv, mi = MP.merge_partials_plain(part_v, part_i)
        check(torch.equal(mi, i) and torch.equal(mv, v), f"{sd}: merge kernel vs plain")
        bm, splits, _ = FK.plan(1024, nn, next_pow2(k_scan), dev, gy.dtype, gs is not None)
        epilogue = nn * 4 * (1 if gs is None else 2)  # hy, and the int8 scales
        out[sd] = {"partials_ms": part_ms, "plain_ms": plain_ms, "vs_plain": cmp,
                   "splits": splits, "bm": bm,
                   **mm_bound(2.0 * 1024 * nn * d,
                              1024 * d * 4 + nn * d * gy.element_size() + epilogue
                              + part_v.numel() * 8, gy_exact=True)}
        # The rescore kernel on the scan's candidates (main-segment rows).
        rfx, rcand, rhx, rhy, _ = ops.rescore_operands(qb, vecs_t, i[:, :k_scan], k,
                                                       distance="neg_dot")
        res_out = {}
        rs_ms = time_ms(torch, lambda: res_out.__setitem__(
            "k", RS.rescore_topk(rfx, rcand, rhx, rhy, k, alpha=-1.0, finalize="identity")))
        rs_plain_ms, (rpv, rpp) = time_plain(torch, lambda: RS.rescore_topk_plain(
            rfx, rcand, rhx, rhy, k, alpha=-1.0, finalize="identity"))
        rv, rp = res_out["k"]
        rs_cmp = check_topk(rv, rp, rpv, rpp, n=rcand.shape[1], rtol=1e-5, atol=1e-3,
                            dist=lambda r, c: -(rfx[r] * rcand[r, c]).sum(1) + rhx[r, 0]
                            + rhy[r, c])
        out[sd]["rescore"] = {
            "ms": rs_ms, "plain_ms": rs_plain_ms, "vs_plain": rs_cmp,
            "shape": list(rcand.shape),
            "bound_ms": bound_ms(2.0 * rcand.numel(), rcand.numel() * 4 + rfx.numel() * 4
                                 + rhx.numel() * 4 + rhy.numel() * 4 + 1024 * 16 * 8)}
        del rcand, rfx, rhx, rhy
        if sd == "int8":
            out[sd]["filtered_exclude"] = flt
            # The rescore kernel at the card's cap: 128 queries, 8192 drawn
            # candidate rows each, K 4096.
            cidx = torch.randint(0, nn, (128, 8192), generator=torch.Generator().manual_seed(32),
                                 dtype=torch.int32).to(dev)
            with WideLaunches(torch) as rec:
                w = ops.rescore_operands(qb[:128], vecs_t, cidx, 4096, distance="neg_dot")
                RS.rescore_topk(*w[:4], 4096, alpha=-1.0, finalize="identity")
            out[sd]["rescore_k4096"] = hold_wide(torch, rec.records)["rescore_topk"][0]
            del w, rec, cidx
            kept = index
        del index, engine, fx, gy, gs, hx, hy, parts, part_v, part_i, pv, pi
        torch.cuda.empty_cache()
    say("two_stage_batch_1024", out)
    return out, kept, queries


def union_widths(torch, probes, ncells):
    """Per query tile: the distinct cells of its probe list, and their share."""
    fresh = 1 + (probes[:, 1:] != probes[:, :-1]).sum(1)
    return [{"distinct_cells": int(w), "share_of_cells": int(w) / ncells} for w in fresh]


def phase_ivf(torch, dev, run_path, x):
    """Phase 6: the IVF tier at the query_1m width, on clustered rows ``x``
    (the last 8,192 the queries)."""
    from repro_torch.core.distances import gy_rows
    from repro_torch.core.ivf import pack_cells, packed_live, probe_cells, train_centroids
    from repro_torch.core.knn import ivf_query, scan_width
    from repro_torch.core.topk import next_pow2
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import ivf_scan as IVS
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex

    n, d, k, ncells, nprobe = QUERY_ROWS, 256, 10, IVF_CELLS, 8
    db, queries = x[:n], x[n:]
    db_t = torch.from_numpy(db).to(dev)
    q_t = torch.from_numpy(queries).to(dev)
    truth = true_ids(torch, q_t, db_t, k)

    # The cells of the float32 index, built by hand so that k-means and the
    # packing (the permutation on the host, the row scatter on the card) are
    # timed apart; seeded as the index seeds its own (the main epoch, 1).
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cent, assign = train_centroids(db_t, ncells, distance="neg_dot",
                                   generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cells = pack_cells(db_t, cent, assign)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = cells.counts
    say("ivf_build", {"kmeans_on_card_s": t1 - t0, "packing_s": t2 - t1,
                      "ncells": ncells, "cell_cap": cells.cell_cap,
                      "largest_cell": int(counts.max()), "smallest_cell": int(counts.min()),
                      "empty_cells": int((counts == 0).sum()),
                      "packed_slots": cells.packed.shape[0],
                      "packed_over_corpus": cells.packed.shape[0] / n,
                      "packed_bytes_fp32": cells.packed.numel() * 4,
                      "packed_bytes_int8": cells.packed.numel()})
    widths = {}
    for m in (1024, 8):
        cq = probe_cells(q_t[:m], cells.centroids, nprobe, distance="neg_dot")
        operands = ops.ivf_scan_operands(q_t[:m], cells.packed, cq, 64,
                                         cell_cap=cells.cell_cap, distance="neg_dot")
        probes, tile_m = operands[0], operands[7]
        del operands  # it holds the packed rows, which a compact must be able to free
        widths[m] = {"tile_m": tile_m, "W": probes.shape[1],
                     "tiles": union_widths(torch, probes, ncells)}
    say("ivf_union_per_tile", widths)

    # The fused kernel at the shapes the IVF path gives it, against its plain
    # version: the probe shortlist (K 8 over the centroids, a batch of 1024)
    # and one k-means assignment pass (K 1: every row against the centroids).
    fused_ivf = {}
    for label, (xq, yc, kk, dname) in {
            "probe_shortlist": (q_t[:1024], cells.centroids, nprobe, "neg_dot"),
            "kmeans_assign": (gy_rows(db_t, "neg_dot"), cent, 1, "sqeuclidean")}.items():
        fx, gy, hx, hy, alpha = ops._mxu_operands(xq, yc, dname)
        kw = dict(distance_finalize="identity", alpha=alpha, n_real=gy.shape[0])
        outs = {}
        ms = time_ms(torch, lambda: outs.__setitem__("k", FK.fused_knn(fx, gy, hx, hy, kk, **kw)))
        plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
            fx, gy, hx, hy, kk, alpha=alpha, finalize="identity", n_real=gy.shape[0]))
        v, i = outs["k"]
        cmp = check_topk(v[:, :kk], i[:, :kk], pv[:, :kk], pi[:, :kk], n=gy.shape[0],
                         rtol=1e-5, atol=1e-3,
                         dist=operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity"))
        m_, n_ = fx.shape[0], gy.shape[0]
        bnd = mm_bound(2.0 * m_ * n_ * d, (m_ + n_) * d * 4 + (m_ + n_) * 4
                       + m_ * next_pow2(kk) * 8)
        fused_ivf[label] = {"ms": ms, "plain_ms": plain_ms, "vs_plain": cmp, **bnd,
                            "shape": f"{m_} x {n_}, d {d}, k {kk}"}
        del fx, gy, hx, hy, outs, v, i, pv, pi
    say("ivf_fused_knn_vs_plain", fused_ivf)
    del cent, assign

    empty = (np.zeros((0, d), np.float32), np.zeros(0, np.int32), np.zeros(0, bool), 0)
    out = {}
    for sd in ("float32", "int8"):
        if sd == "float32":
            index = RetrievalIndex.from_arrays(
                db, np.arange(n), np.ones(n, bool), *empty, distance="neg_dot", impl="fused",
                device=dev, ivf=cells, scan_dtype=sd, overfetch=4, nprobe=nprobe,
                main_tenant=tenant_tags(n, 28))
            del cells  # the index owns them now; a compact must be able to free them
        else:  # trains its own cells in its first search
            index = RetrievalIndex.build(np.arange(n), db, distance="neg_dot", impl="fused",
                                         device=dev, ivf_cells=ncells, nprobe=nprobe,
                                         scan_dtype=sd, overfetch=4)
        engine = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))

        def full_probe_gate(step, q):
            """nprobe = ncells with an fp32 scan is exact: against brute force."""
            vecs, ids = index._live_rows()
            vt = torch.from_numpy(vecs).to(dev)
            ids_t = torch.from_numpy(ids).to(dev).long()
            qt = torch.from_numpy(q).to(dev)
            index.nprobe = 10 ** 6
            got = engine.search(q)
            index.nprobe = nprobe
            bv, bi = brute_topk(torch, qt, vt, 16)
            pos = torch.full((int(ids_t.max()) + 1,), -1, dtype=torch.long, device=dev)
            pos[ids_t] = torch.arange(len(ids_t), device=dev)
            cmp = check_topk(got.distances, got.ids.long(), bv[:, :k], ids_t[bi[:, :k].long()],
                             n=len(pos), rtol=1e-5, atol=1e-3,
                             dist=lambda r, c: -(qt[r] * vt[pos[c]]).sum(1))
            say(f"ivf_full_probe_{step}", cmp)

        def serve():
            t0 = time.perf_counter()
            got = engine.search(queries)
            first_s = time.perf_counter() - t0
            rec = recall_at(torch, got.ids, truth)
            if sd == "float32":
                full_probe_gate("initial", queries[:1024])
            # The epoch's centroids stand for its cells: holding the cells
            # themselves would keep their packed copy on the card.
            cent0 = index._dev["main_ivf"].centroids
            rng = np.random.default_rng(8)
            ins = db[rng.choice(n, 4096, replace=False)] + 0.05 * rng.standard_normal(
                (4096, d)).astype(np.float32)
            index.upsert(np.concatenate([np.arange(0, n, n // 2048)[:2048],
                                         np.arange(n, n + 2048)]), ins)
            engine.search(queries[:1024])
            index.delete(rng.choice(n, n // 100, replace=False))
            engine.search(queries[1024:2048])
            check(index._dev["main_ivf"].centroids is cent0,
                  f"ivf {sd}: a delete retrained the cells")
            if sd == "float32":
                full_probe_gate("churned", queries[2048:3072])
            index.compact()
            engine.search(queries[3072:4096])
            check(index._dev["main_ivf"].centroids is not cent0,
                  f"ivf {sd}: compact kept the old cells")
            if sd == "float32":
                full_probe_gate("compacted", queries[4096:5120])
            steady = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))
            for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
                steady.search(queries[(b % 8) * 1024 : (b % 8 + 1) * 1024])
            return rec, first_s, engine.meter.summary(), steady.meter

        (rec, first_s, meter, steady), counts_ = run_path(f"serving_ivf_{sd}", serve)
        for name in ("fused_knn", "ivf_scan", "rescore_topk"):
            check(counts_[name] > 0, f"ivf {sd}: {name} never launched: {counts_}")
        check(rec >= 0.9, f"ivf {sd}: served recall@10 {rec} < 0.9")
        say(f"ivf_{sd}_serving", {"recall_at_10": rec, "first_search_s": first_s,
                                  "meter": meter, "steady": steady.summary(),
                                  "steady_p90_ms": steady.latency_ms(90)})

        # Kernel path and plain path on the same 256 queries, at nprobe = 8,
        # on the compacted index.
        vecs_t, live = index._dev["main_vecs"], index._dev["main_mask"][0]
        ivf, ivf_q = index._dev["main_ivf"], index._dev["main_ivf_q"]
        vecs, ids = index._live_rows()
        q256 = q_t[:256]
        want = torch.from_numpy(ids).to(dev)[true_ids(torch, q256, torch.from_numpy(vecs).to(dev), k)]
        main_ids = index._dev["main_mask"][1]
        recs = {}
        for impl in ("fused", "torch"):
            r = ivf_query(q256, vecs_t, ivf, k, nprobe=nprobe, distance="neg_dot", impl=impl,
                          db_live=live, packed_q=ivf_q)
            recs[impl] = recall_at(torch, main_ids[r.indices.clamp(min=0).long()], want)
        # The floor of the reference's tests (0.9), on both paths.
        check(min(recs.values()) >= 0.9, f"ivf {sd}: recall@10 on 256 queries {recs} < 0.9")
        res = {"recall_at_10_256q": recs}
        if sd == "float32":
            res["filtered_tenant_batch"] = ivf_filtered_batch(torch, dev, run_path, index, engine,
                                                              queries[:1024], k)
            # Phase 8's tenant filter with 500 exclusions: a fetch of 512,
            # the scan at K = min(4 * 512, cell_cap).
            flt = filtered_wide_batch(torch, dev, run_path, index, engine, queries[:1024], k,
                                      "ivf_float32_filtered_exclude", 33)
            for name in ("ivf_scan_wide", "rescore_topk_wide"):
                check(flt["launches"][name] > 0, f"ivf filtered: {name} never launched")
            res["filtered_exclude"] = flt

        # The ivf_scan kernel against its plain version, at batches of 1024 and 8.
        live_p = packed_live(ivf, live)
        k_scan = min(scan_width(len(vecs), k, 4), ivf.cell_cap)
        for m in (1024, 8):
            qm = q_t[:m]
            cq = probe_cells(qm, ivf.centroids, nprobe, distance="neg_dot")
            probes, fx, gy, gs, hx, hy, alpha, tile_m, extent = ops.ivf_scan_operands(
                qm, ivf_q, cq, k_scan, cell_cap=ivf.cell_cap, distance="neg_dot",
                packed_live=live_p)
            kw = dict(cell_cap=ivf.cell_cap, tile_m=tile_m, distance_finalize="identity",
                      alpha=alpha, gy_scale=gs, cell_extent=extent)
            outs = {}
            ms = time_ms(torch, lambda: outs.__setitem__(
                "k", IVS.ivf_scan(probes, fx, gy, hx, hy, k_scan, **kw)))
            plain_ms, (pv, pi) = time_plain(torch, lambda: IVS.ivf_scan_plain(
                probes, fx, gy, hx, hy, k_scan, cell_cap=ivf.cell_cap, tile_m=tile_m,
                cell_extent=extent, alpha=alpha, finalize="identity", gy_scale=gs))
            v, i = outs["k"]
            cmp = check_topk(v, i, pv, pi, n=gy.shape[0], rtol=1e-5, atol=1e-3,
                             dist=operand_distance(fx, gy, hx, hy, alpha=alpha,
                                                   finalize="identity", gy_scale=gs))
            # The bound counts the rows the function needs: each tile's
            # queries against the rows of the distinct cells in its list (pad
            # slots are +inf and never selected; the compacted index has no
            # dead rows), each of those rows read once.
            pairs, read, _ = ivf_pairs(torch, probes, ivf.counts.long(), tile_m, m)
            K = next_pow2(k_scan)
            bnd = mm_bound(2.0 * pairs * d, m * d * 4 + read * d * gy.element_size()
                           + read * 4 * (1 if gs is None else 2) + m * K * 8,
                           gy_exact=gy.dtype != torch.float32)
            # What the kernel walks: per CTA (a block of a union tile's rows
            # and a split of its tile table), 128-column tiles.
            _, bounds, bm, splits = IVS.plan(probes, extent, ivf.cell_cap, m, tile_m, K, dev,
                                             gy.dtype, gs is not None)
            walk = (bounds[:, 1:] - bounds[:, :-1]).long()  # [union tiles, splits]
            # The tile-table kernel against its plain version (tile_table and
            # split_bounds on the same tensors): equal on every live entry.
            tabs = {}
            table_ms = time_ms(torch, lambda: tabs.__setitem__(
                "k", IVS.build_table(probes, extent, ivf.cell_cap, splits)))
            table_plain_ms, (want, counts) = time_plain(
                torch, lambda: IVS.tile_table(probes, extent, ivf.cell_cap))
            table, tbounds = tabs["k"]
            check(torch.equal(tbounds, IVS.split_bounds(counts, splits)), "table bounds vs plain")
            for t_, c_ in enumerate(counts.tolist()):
                check(torch.equal(table[t_, :c_], want[t_, :c_]), "tile table vs plain")
            table_bnd = bound_ms(0.0, probes.numel() * 4 + extent.numel() * 4
                                 + int(counts.sum()) * 8 + tbounds.numel() * 4)
            q_per_tile = torch.tensor([min(tile_m, m - t * tile_m) for t in range(len(probes))],
                                      device=dev)
            part_ms = time_ms(torch, lambda: IVS.ivf_scan_partials(probes, fx, gy, hx, hy,
                                                                   k_scan, **kw))
            res[f"ivf_scan_batch_{m}"] = {
                "ms": ms, "partials_ms": part_ms, "plain_ms": plain_ms, "vs_plain": cmp,
                **bnd, "rows_scored": pairs, "rows_read": read,
                "columns_walked": int((q_per_tile[:, None] * walk).sum()) * 128,
                "bm": bm, "splits": splits,
                "ctas": len(probes) * -(-min(tile_m, m) // bm) * splits,
                "tiles_per_cta_max": int(walk.max()),
                "tiles_per_cta_mean": float(walk.float().mean()),
                "tile_m": tile_m, "k_scan": k_scan, "product": PRODUCT,
                "table": {"ms": table_ms, "plain_ms": table_plain_ms, "max_abs_err": 0.0,
                          "bound_ms": table_bnd[0], "bound_by": table_bnd[1],
                          "library_ms": None, "entries": int(counts.sum()),
                          "shape": f"{len(probes)} union tiles x {probes.shape[1]} slots, "
                                   f"{splits} splits"}}
        out[sd] = res
        say(f"ivf_{sd}_kernels", res)
        del index, engine, ivf, ivf_q, vecs_t, live, fx, gy, gs, hx, hy, outs
        torch.cuda.empty_cache()
    out["fused_knn"] = fused_ivf
    return out


def ivf_filtered_batch(torch, dev, run_path, index, engine, queries, k):
    """One tenant-filtered batch through an IVF index whose rows carry
    tags: "auto" pre-filters, which on the cell-probed kernel drops the
    scan's candidates of other tenants at scan width (as the reference
    does), so no id of another tenant may be served; recall@k against the
    filtered brute force is reported, not gated."""
    from repro_torch.serving.filters import QueryFilter

    m = len(queries)
    qten = np.random.default_rng(27).integers(0, N_TENANTS, m).astype(np.int32)
    got, counts = run_path("serving_ivf_float32_filtered",
                           lambda: engine.search(queries, filter=QueryFilter(tenant=qten)))
    for name in ("fused_knn", "ivf_scan", "rescore_topk"):
        check(counts[name] > 0, f"ivf filtered: {name} never launched: {counts}")
    vecs, ids = index._live_rows()
    tens = index._live_tenants()
    tag_of = np.full(int(ids.max()) + 1, -1, np.int64)
    tag_of[ids] = tens
    gi = got.ids.cpu().numpy()
    check(bool(((tag_of[gi.clip(0)] == qten[:, None]) | (gi < 0)).all()),
          "ivf filtered: an id of another tenant was served")
    vt, tt = torch.from_numpy(vecs).to(dev), torch.from_numpy(tens).to(dev)
    qt, qten_t = torch.from_numpy(queries).to(dev), torch.from_numpy(qten).to(dev)
    want = torch.cat([torch.topk(torch.where(tt[None, :] == qten_t[r0 : r0 + 256, None],
                                             qt[r0 : r0 + 256] @ vt.T, float("-inf")),
                                 k, dim=1).indices for r0 in range(0, m, 256)])
    out = {"recall_at_10": recall_at(torch, got.ids, torch.from_numpy(ids).to(dev)[want]),
           "empty_slots": int((got.ids < 0).sum()), "launches": counts}
    say("ivf_float32_filtered_tenant_batch", out)
    return out


def phase_ivfpq(torch, dev, run_path, x):
    """Phase 7: the IVF-PQ tier at the query_1m width, on phase 6's rows."""
    from repro_torch.core.ivf import pack_cells, packed_live, probe_cells, train_centroids
    from repro_torch.core.knn import ivf_query, ivfpq_query, scan_width
    from repro_torch.core.pq import decode_pq, encode_ivfpq, train_ivfpq
    from repro_torch.core.topk import next_pow2
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import ops
    from repro_torch.kernels import pq_scan as PQS
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex

    n, d, k, ncells, nprobe = QUERY_ROWS, 256, 10, IVF_CELLS, 8
    db, queries = x[:n], x[n:]
    db_t = torch.from_numpy(db).to(dev)
    q_t = torch.from_numpy(queries).to(dev)
    truth = true_ids(torch, q_t, db_t, k)

    def quality(cells, cb, codes):
        """On 1024 queries: recall@10 of the fp32 IVF scan of these cells
        (the probe ceiling) and of IVF-PQ at overfetch 4, 8 and 16; the
        share of rows in cells of more than 300 (the mean is 256), and for
        those rows and the others the mean squared residual to the cell's
        centroid and the mean squared error of its decoded row."""
        q1, t1 = q_t[:1024], truth[:1024]
        cnt = cells.counts.long()
        sums = torch.zeros(2, 3, dtype=torch.float64, device=dev)  # [small, big] x [rows, resid, err]
        for r0 in range(0, n, 1 << 18):
            slot = cells.slot_of_row[r0 : r0 + (1 << 18)].long()
            base = cells.centroids[slot // cells.cell_cap]
            g = db_t[r0 : r0 + (1 << 18)]
            big = (cnt[slot // cells.cell_cap] > 300).long()
            stats = torch.stack([torch.ones_like(g[:, 0]), ((g - base) ** 2).sum(1),
                                 ((g - base - decode_pq(cb, codes.codes[slot])) ** 2).sum(1)], 1)
            sums.index_add_(0, big, stats.double())
        mean = (sums[:, 1:] / sums[:, :1].clamp(min=1)).tolist()
        return {"cell_cap": cells.cell_cap, "largest_cell": int(cnt.max()),
                "rows_in_cells_over_300": float(cnt[cnt > 300].sum()) / n,
                "residual_sq_and_error_sq": {"cells_to_300": mean[0], "cells_over_300": mean[1]},
                "ivf_fp32_recall": recall_at(torch, ivf_query(
                    q1, db_t, cells, k, nprobe=nprobe, distance="neg_dot").indices, t1),
                "ivfpq_recall_by_overfetch": {of: recall_at(torch, ivfpq_query(
                    q1, db_t, cells, cb, codes, k, nprobe=nprobe, distance="neg_dot",
                    overfetch=of).indices, t1) for of in (4, 8, 16)}}

    # The reference's start, for comparison: Lloyd from a uniform draw of
    # rows (its jax.random.permutation), for the cells and each codebook.
    g = torch.Generator().manual_seed(1)
    cells = pack_cells(db_t, *train_centroids(db_t, ncells, distance="neg_dot",
                                              init_perm=torch.randperm(n, generator=g)))
    cb = train_ivfpq(db_t, cells, PQ_M, nbits=PQ_NBITS, distance="neg_dot",
                     init_perms=[torch.randperm(n, generator=g) for _ in range(PQ_M)])
    uniform = quality(cells, cb, encode_ivfpq(cb, cells, distance="neg_dot"))
    say("ivfpq_uniform_start", uniform)
    del cells, cb
    torch.cuda.empty_cache()

    # The index's first epoch, built by hand so that each step is timed
    # apart; seeded as the index seeds its own (the main epoch, 1).
    times = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    cent, assign = step("kmeans_s", lambda: train_centroids(
        db_t, ncells, distance="neg_dot", generator=torch.Generator().manual_seed(1)))
    cells = step("packing_s", lambda: pack_cells(db_t, cent, assign))
    del cent, assign
    cb = step("pq_training_s", lambda: train_ivfpq(
        db_t, cells, PQ_M, nbits=PQ_NBITS, distance="neg_dot",
        generator=torch.Generator().manual_seed(1)))
    codes = step("encoding_s", lambda: encode_ivfpq(cb, cells, distance="neg_dot"))
    drawn = quality(cells, cb, codes)
    say("ivfpq_kmeanspp_start", drawn)
    res_build = dict(times)
    say("ivfpq_build", {**times, "ncells": ncells, "cell_cap": cells.cell_cap,
                        "packed_slots": cells.packed.shape[0],
                        "pq_replica_bytes": codes.codes.numel() + codes.hy.numel() * 4
                        + cb.codebooks.numel() * 4,
                        "codes_bytes": codes.codes.numel(),
                        "packed_fp32_bytes": cells.packed.numel() * 4,
                        "corpus_fp32_bytes": n * d * 4})

    # The fused kernel at the encoding's shape: one block of packed slots'
    # residuals, one subspace, k 1 over the 256 codewords.
    nb = min(1 << 18, cells.packed.shape[0])
    rows = cells.packed[:nb] - cells.centroids[torch.arange(nb, device=dev) // cells.cell_cap]
    sub = rows[:, : d // PQ_M].contiguous()
    fx, gy, hx, hy, alpha = ops._mxu_operands(sub, cb.codebooks[0], "sqeuclidean")
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=gy.shape[0])
    outs = {}
    enc_ms = time_ms(torch, lambda: outs.__setitem__("k", FK.fused_knn(fx, gy, hx, hy, 1, **kw)))
    enc_plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
        fx, gy, hx, hy, 1, alpha=alpha, finalize="identity", n_real=gy.shape[0]))
    v, i = outs["k"]
    enc_cmp = check_topk(v[:, :1], i[:, :1], pv[:, :1], pi[:, :1], n=gy.shape[0], rtol=1e-5,
                         atol=1e-4, dist=operand_distance(fx, gy, hx, hy, alpha=alpha,
                                                          finalize="identity"))
    enc_bound = mm_bound(2.0 * fx.shape[0] * gy.shape[0] * fx.shape[1],
                         (fx.shape[0] + gy.shape[0]) * (fx.shape[1] + 1) * 4 + fx.shape[0] * 8)
    fused_enc = {"ms": enc_ms, "plain_ms": enc_plain_ms, "vs_plain": enc_cmp, **enc_bound,
                 "shape": f"{fx.shape[0]} x {gy.shape[0]} codewords, d {d // PQ_M}, k 1"}
    say("ivfpq_fused_knn_encode_vs_plain", fused_enc)
    del rows, sub, fx, gy, hx, hy, outs, v, i, pv, pi

    empty = (np.zeros((0, d), np.float32), np.zeros(0, np.int32), np.zeros(0, bool), 0)
    index = RetrievalIndex.from_arrays(
        db, np.arange(n), np.ones(n, bool), *empty, distance="neg_dot", impl="fused",
        device=dev, ivf=cells, pq=(cb, codes), overfetch=8, nprobe=nprobe,
        main_tenant=tenant_tags(n, 29))
    del cells, cb, codes  # the index owns them now; a compact must be able to free them
    engine = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))
    rng = np.random.default_rng(9)
    dead = rng.choice(n, n // 100, replace=False)

    def no_dead(got, what):
        check(not bool(torch.isin(got.ids.long(), torch.from_numpy(dead).to(dev)).any()),
              f"ivfpq: a deleted id was served {what}")

    def live_truth(q):
        vecs, ids = index._live_rows()
        vt = torch.from_numpy(vecs).to(dev)
        return torch.from_numpy(ids).to(dev)[true_ids(torch, torch.from_numpy(q).to(dev), vt, k)]

    def serve():
        t0 = time.perf_counter()
        got = engine.search(queries)
        first_s = time.perf_counter() - t0
        rec8 = recall_at(torch, got.ids, truth)
        index.overfetch = 4
        rec4 = recall_at(torch, engine.search(queries[:2048]).ids, truth[:2048])
        index.overfetch = 8
        cb0 = index._dev["main_pq"][0].codebooks  # the epoch's codebooks stand for its replica
        ins = db[rng.choice(n, 4096, replace=False)] + 0.05 * rng.standard_normal(
            (4096, d)).astype(np.float32)
        index.upsert(np.concatenate([np.arange(0, n, n // 2048)[:2048],
                                     np.arange(n, n + 2048)]), ins)
        engine.search(queries[:1024])
        index.delete(dead)
        no_dead(engine.search(queries[1024:2048]), "after the delete")
        check(index._dev["main_pq"][0].codebooks is cb0, "ivfpq: a delete retrained the codes")
        index.compact()
        got2 = engine.search(queries[2048:4096])
        check(index._dev["main_pq"][0].codebooks is not cb0, "ivfpq: compact kept the old codes")
        no_dead(got2, "after the compact")
        rec8_churn = recall_at(torch, got2.ids, live_truth(queries[2048:4096]))
        steady = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))
        for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
            no_dead(steady.search(queries[(b % 8) * 1024 : (b % 8 + 1) * 1024]), "steady")
        return rec8, rec4, rec8_churn, first_s, engine.meter.summary(), steady.meter

    (rec8, rec4, rec8_churn, first_s, meter, steady), counts = run_path("serving_ivfpq", serve)
    for name in ("fused_knn", "pq_scan", "rescore_topk"):
        check(counts[name] > 0, f"ivfpq: {name} never launched: {counts}")
    res = {"recall_at_10_overfetch_8": rec8, "recall_at_10_overfetch_4": rec4,
           "recall_at_10_overfetch_8_after_churn": rec8_churn, "first_search_s": first_s,
           "meter": meter, "steady": steady.summary(), "steady_p90_ms": steady.latency_ms(90)}
    say("ivfpq_serving", res)
    # Phase 8's tenant filter with 500 exclusions: a fetch of 512, the scan at
    # K = min(8 * 512, cell_cap).
    flt = filtered_wide_batch(torch, dev, run_path, index, engine, queries[:1024], k,
                              "ivfpq_filtered_exclude", 34)
    for name in ("pq_scan_wide", "rescore_topk_wide"):
        check(flt["launches"][name] > 0, f"ivfpq filtered: {name} never launched")
    res["filtered_exclude"] = flt

    # The pq_scan kernel against its plain version on the compacted index,
    # at batches of 1024 and 8, at the served fetch width.
    vecs_t, live = index._dev["main_vecs"], index._dev["main_mask"][0]
    ivf = index._dev["main_ivf"]
    cb, codes = index._dev["main_pq"]
    live_p = packed_live(ivf, live)
    live_cnt = live_p.view(ivf.ncells, ivf.cell_cap).sum(1).long()
    k_scan = min(scan_width(vecs_t.shape[0], k, 8), ivf.cell_cap)
    K = next_pow2(k_scan)
    for m in (1024, 8):
        qm = q_t[:m]
        cq = probe_cells(qm, ivf.centroids, nprobe, distance="neg_dot")
        probes, luts, cds, hx, hy, qc, tile_m, extent = ops.pq_scan_operands(
            qm, cb, codes, cq, k_scan, cell_cap=ivf.cell_cap, centroids=ivf.centroids,
            distance="neg_dot", packed_live=live_p)
        kw = dict(cell_cap=ivf.cell_cap, ncodes=cb.ncodes, tile_m=tile_m, cell_extent=extent,
                  qc=qc, distance_finalize="identity")
        outs = {}
        ms = time_ms(torch, lambda: outs.__setitem__(
            "k", PQS.pq_scan(probes, luts, cds, hx, hy, k_scan, **kw)))
        part_ms = time_ms(torch, lambda: outs.__setitem__(
            "p", PQS.pq_scan_partials(probes, luts, cds, hx, hy, k_scan, **kw)))
        part_v, part_i = outs["p"]
        merge_ms = (time_ms(torch, lambda: MP.merge_partials(part_v, part_i))
                    if part_v.shape[0] > 1 else 0.0)
        plain_ms, (pv, pi) = time_plain(torch, lambda: PQS.pq_scan_plain(
            probes, luts, cds, hx, hy, k_scan, cell_cap=ivf.cell_cap, ncodes=cb.ncodes,
            tile_m=tile_m, cell_extent=extent, finalize="identity", qc=qc))
        v, i = outs["k"]
        lut3 = luts.view(m, PQ_M, cb.ncodes)
        cap = ivf.cell_cap

        def adc(rows, cols):  # the ADC value of each (query, packed slot)
            s_ = lut3[rows[:, None], torch.arange(PQ_M, device=dev)[None, :],
                      cds[cols].long()].sum(1)
            return s_ + qc[rows, cols // cap] + hx[rows, 0] + hy[0, cols]

        cmp = check_topk(v, i, pv, pi, n=cds.shape[0], rtol=1e-5, atol=1e-4, dist=adc)
        # The bound counts what the function needs: each tile's queries
        # against the live rows of its union's distinct cells, pq_m adds a
        # pair; each input read once (the codes and hy of the rows read, the
        # tables, hx and the cell bias), each output written once.
        pairs, read, rows_per_tile = ivf_pairs(torch, probes, live_cnt, tile_m, m)
        bnd = bound_ms(1.0 * pairs * PQ_M, read * (PQ_M + 4) + luts.numel() * 4
                       + qc.numel() * 4 + m * 4 + m * K * 8)
        res[f"pq_scan_batch_{m}"] = {
            "ms": ms, "partials_ms": part_ms, "merge_ms": merge_ms, "plain_ms": plain_ms,
            "vs_plain": cmp, "bound_ms": bnd[0], "bound_by": bnd[1],
            "lookup_floor_ms": PQS.lookup_floor_ms(pairs, PQ_M), "rows_scored": pairs,
            "rows_read": read, "live_rows_per_tile": rows_per_tile.tolist(),
            **pq_shape(PQS, probes, m, PQ_M, cb.ncodes, K, dev, tile_m), "k_scan": k_scan}
        del probes, luts, cds, hx, hy, qc, outs, part_v, part_i, pv, pi, v, i
    # ROADMAP F2: pq_m 256 at 8 bits (a 256 KiB table a query, past a CTA's
    # shared memory) on the same cells and probes, 64 queries, codes and
    # tables drawn from a seeded generator: the generic mode's chunks.
    m, pq_big = 64, 256
    g = torch.Generator(device=dev).manual_seed(256)
    cq = probe_cells(q_t[:m], ivf.centroids, nprobe, distance="neg_dot")
    probes, _, _, hx, hy, qc, tile_m, extent = ops.pq_scan_operands(
        q_t[:m], cb, codes, cq, k_scan, cell_cap=ivf.cell_cap, centroids=ivf.centroids,
        distance="neg_dot", packed_live=live_p)
    cds = torch.randint(0, 256, (codes.codes.shape[0], pq_big), generator=g, device=dev,
                        dtype=torch.uint8)
    luts = torch.randn((m, pq_big * 256), generator=g, device=dev)
    kw = dict(cell_cap=ivf.cell_cap, ncodes=256, tile_m=tile_m, cell_extent=extent, qc=qc)
    outs = {}
    ms = time_ms(torch, lambda: outs.__setitem__("k", PQS.pq_scan(
        probes, luts, cds, hx, hy, k_scan, distance_finalize="identity", **kw)))
    plain_ms, (pv, pi) = time_plain(torch, lambda: PQS.pq_scan_plain(
        probes, luts, cds, hx, hy, k_scan, finalize="identity", **kw))
    lut3 = luts.view(m, pq_big, 256)
    sub = torch.arange(pq_big, device=dev)[None, :]
    cmp = check_topk(*outs["k"], pv, pi, n=cds.shape[0], rtol=1e-5, atol=1e-3,
                     dist=lambda r, c: lut3[r[:, None], sub, cds[c].long()].sum(1)
                     + qc[r, c // ivf.cell_cap] + hx[r, 0] + hy[0, c])
    pairs, read, _ = ivf_pairs(torch, probes, live_cnt, tile_m, m)
    bnd = bound_ms(1.0 * pairs * pq_big, read * (pq_big + 4) + luts.numel() * 4
                   + qc.numel() * 4 + m * 4 + m * K * 8)
    res["pq_scan_pq_m256_batch_64"] = {
        "ms": ms, "plain_ms": plain_ms, "vs_plain": cmp, "max_abs_err": cmp["max_abs_err"],
        "bound_ms": bnd[0], "bound_by": bnd[1],
        "lookup_floor_ms": PQS.lookup_floor_ms(pairs, pq_big), "rows_scored": pairs,
        **pq_shape(PQS, probes, m, pq_big, 256, K, dev, tile_m),
        "shape": f"{m} queries, nprobe {nprobe}, pq_m {pq_big}, 8 bits, k {k_scan}"}
    del probes, luts, cds, hx, hy, qc, outs, pv, pi, lut3
    # Kernel path and plain path of the whole query on the same 256 queries.
    main_ids = index._dev["main_mask"][1]
    vecs, ids = index._live_rows()
    q256 = q_t[:256]
    want = torch.from_numpy(ids).to(dev)[true_ids(torch, q256, torch.from_numpy(vecs).to(dev), k)]
    recs = {}
    for impl in ("fused", "torch"):
        r = ivfpq_query(q256, vecs_t, ivf, cb, codes, k, nprobe=nprobe, distance="neg_dot",
                        impl=impl, overfetch=8, db_live=live)
        recs[impl] = recall_at(torch, main_ids[r.indices.clamp(min=0).long()], want)
    res["recall_at_10_256q"] = recs
    res["build"] = res_build
    res["fused_knn_encode"] = fused_enc
    res["start"] = {"uniform": uniform, "kmeanspp": drawn}
    say("ivfpq_kernels", {key: val for key, val in res.items() if key.startswith(("pq_", "rec"))})
    # The reference's IVF-PQ floor and setting (tests/test_pq.py:163-185),
    # checked once everything above is reported.
    check(rec8 >= 0.85 and rec8_churn >= 0.85,
          f"ivfpq: served recall@10 at overfetch 8 {rec8}, after churn {rec8_churn} < 0.85")
    check(min(recs.values()) >= 0.85, f"ivfpq: recall@10 on 256 queries {recs} < 0.85")
    del engine, ivf, cb, codes, vecs_t, live, live_p
    torch.cuda.empty_cache()
    return res, index


def phase_filtered(torch, dev, run_path, db):
    """Phase 8: filtered and multi-tenant serving at the query_1m shape on
    rows ``db`` (DESIGN.md §17)."""
    from repro_torch.core.knn import knn_query
    from repro_torch.data.synthetic import random_vectors
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.kernels.stream_topk import sorted_prefix
    from repro_torch.serving import filters as F
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.filters import QueryFilter
    from repro_torch.serving.index import RetrievalIndex

    n, d, k, m = db.shape[0], db.shape[1], 10, 1024
    rng = np.random.default_rng(21)
    tags = tenant_tags(n, 22)
    allow = np.sort(rng.choice(n, int(0.7 * n), replace=False))
    queries = random_vectors(6 * m, d, seed=23)
    q_tenant = rng.integers(0, N_TENANTS, 6 * m).astype(np.int32)
    index = RetrievalIndex.build(np.arange(n), db, tenants=tags, distance="neg_dot",
                                 impl="fused", device=dev)
    engine = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))

    def batch(b):
        return queries[b * m : (b + 1) * m], q_tenant[b * m : (b + 1) * m]

    def brute(q, f):
        """Exact top-16 of each query over the live rows its canonical
        filter allows and does not exclude, a chunk of queries at a time:
        (values, external ids, and a check of served (values, ids) that each
        id is a live row the filter allows, at its own distance)."""
        vecs, ids = index._live_rows()
        vt = torch.from_numpy(vecs).to(dev)
        ids_t = torch.from_numpy(ids).to(dev).long()
        tt = torch.from_numpy(index._live_tenants()).to(dev)
        pos = torch.full((int(ids_t.max()) + 1,), -1, dtype=torch.long, device=dev)
        pos[ids_t] = torch.arange(len(ids_t), device=dev)
        row_ok = torch.ones(len(ids), dtype=torch.bool, device=dev)
        if f.allowed_ids is not None:
            row_ok = torch.from_numpy(np.isin(ids, f.allowed_ids)).to(dev)
        qt = torch.from_numpy(q).to(dev)
        vals, rows = [], []
        for r0 in range(0, len(q), 256):
            dm = -(qt[r0 : r0 + 256] @ vt.T)
            ok = row_ok[None, :].expand_as(dm)
            if f.tenant is not None:
                ok = ok & (tt[None, :] == torch.from_numpy(f.tenant[r0 : r0 + 256]).to(dev)[:, None])
            dm = torch.where(ok, dm, float("inf"))
            if f.exclude_ids is not None:
                ex = torch.from_numpy(f.exclude_ids[r0 : r0 + 256]).to(dev).long()
                p = pos[ex.clamp(0, len(pos) - 1)]
                hit = (ex >= 0) & (ex < len(pos)) & (p >= 0)
                r = torch.arange(len(ex), device=dev)[:, None].expand_as(ex)
                dm[r[hit], p[hit]] = float("inf")
            v, i = sorted_prefix(dm, 16)
            vals.append(v)
            rows.append(i)
        v, i = torch.cat(vals), torch.cat(rows)

        def served_ok(got):
            r, c = (got.ids >= 0).nonzero(as_tuple=True)
            p = pos[got.ids[r, c].long()]
            check(bool((p >= 0).all()), "a served id is not live")
            ok = row_ok[p]
            if f.tenant is not None:
                ok = ok & (tt[p] == torch.from_numpy(f.tenant).to(dev)[r])
            check(bool(ok.all()), "a served id is not allowed")
            want = -(qt[r] * vt[p]).sum(1)
            err = (got.distances[r, c] - want).abs()
            check(bool((err <= 1e-3 + 1e-5 * want.abs()).all()), "a served value is not its id's")
            return float(err.max()) if err.numel() else 0.0

        return v, torch.where(i >= 0, ids_t[i.clamp(min=0).long()], -1), pos, vt, qt, served_ok

    def held(step, name, q, f):
        """Serve ``f`` through the engine and hold it against the brute force.

        Pre mode is exact: the brute force's top k, ties allowed for.  Post
        mode drops the disallowed rows of a fetch widened by 1/s, so it may
        miss rows (the reference's contract; the main segment's fetch also
        bounds what merges in from the delta): each served id must be a
        live row the filter allows, at its own distance, and the share of
        the brute force's top k served is reported."""
        got = engine.search(q, filter=f)
        fc = F.normalize(f, len(q))
        nd = index._delta_n
        s = F.selectivity(fc, live=np.concatenate([index._main_live, index._delta_live[:nd]]),
                          ids=np.concatenate([index._main_ids, index._delta_ids[:nd]]),
                          tenants=np.concatenate([index._main_tenant, index._delta_tenant[:nd]]))
        state = index._device_state()
        check(index._selectivity(fc, state, index._memberships(fc, state)) == s,
              f"filtered {step} {name}: the index's count of the selectivity vs the host's")
        mode = F.resolve_mode(fc.mode, s)
        bv, bi, pos, vt, qt, served_ok = brute(q, fc)
        bv, bi = bv[:, :k], bi[:, :k]
        fin = torch.isfinite(got.distances)
        short = int((~fin & torch.isfinite(bv)).any(1).sum())
        recall = recall_at(torch, torch.where(fin, got.ids, -2), bi)
        err = served_ok(got)
        if mode == "post":
            cmp = {"max_abs_err": err}
        else:
            cmp = check_topk(got.distances, got.ids.long(), bv, bi, n=len(pos), rtol=1e-5,
                             atol=1e-3, dist=lambda r, e: -(qt[r] * vt[pos[e]]).sum(1))
        out = {**cmp, "selectivity": s, "mode": mode, "exclusion_width": F.exclusion_width(fc),
               "rows_short_of_k": short, "recall_at_10": recall}
        say(f"filtered_{step}_{name}", out)
        return out

    def cases(step, b):
        q, qt = batch(b)
        unfiltered_top5 = engine.search(q).ids[:, :5].cpu().numpy().astype(np.int64)
        ex = np.concatenate([unfiltered_top5, rng.integers(0, n, (m, 495))], 1)
        res = {"tenant": held(step, "tenant", q, QueryFilter(tenant=qt)),
               "allow": held(step, "allow", q, QueryFilter(allowed_ids=allow)),
               "tenant_exclude": held(step, "tenant_exclude", q,
                                      QueryFilter(tenant=qt, exclude_ids=ex))}
        check(res["tenant"]["mode"] == "pre" and res["allow"]["mode"] == "post"
              and res["tenant_exclude"]["mode"] == "pre"
              and res["tenant_exclude"]["exclusion_width"] == 500,
              f"filtered {step}: modes {res}")
        none = engine.search(q, filter=QueryFilter(allowed_ids=np.zeros(0, np.int64)))
        check(bool((none.ids == -1).all() and torch.isinf(none.distances).all()),
              f"filtered {step}: an all-False filter served a row")
        return res

    def serve():
        out = {"initial": cases("initial", 0)}
        new_ids = np.concatenate([np.arange(0, n, n // 2048)[:2048], np.arange(n, n + 2048)])
        index.upsert(new_ids, random_vectors(4096, d, seed=24), tenants=tenant_tags(4096, 25))
        index.delete(np.random.default_rng(26).choice(n, n // 100, replace=False))
        out["churned"] = cases("churned", 1)
        index.compact()
        out["compacted"] = cases("compacted", 2)
        # An all-True bitmap through knn_query is no bitmap, bit for bit.
        vecs_t, live = index._dev["main_vecs"], index._dev["main_mask"][0]
        qb = torch.from_numpy(batch(3)[0]).to(dev)
        ones = torch.full((m, FK.mask_words(vecs_t.shape[0])), -1, dtype=torch.int32, device=dev)
        full = knn_query(qb, vecs_t, k, distance="neg_dot", db_live=live, q_allowed=ones)
        bare = knn_query(qb, vecs_t, k, distance="neg_dot", db_live=live)
        check(torch.equal(full.indices, bare.indices) and torch.equal(full.distances,
                                                                      bare.distances),
              "an all-True bitmap changed knn_query's result")
        # The index keeps nothing of a filter between searches; the
        # "allow_fresh" window draws a new allow-list for every batch, and
        # "tenant_exclude" serves each batch's tenants with 500 exclusions
        # a query (its unfiltered top 5 and 495 drawn: K = 512).
        fresh = [np.sort(rng.choice(n, int(0.7 * n), replace=False)) for _ in range(5)]
        excl = [np.concatenate([engine.search(batch(b)[0]).ids[:, :5].cpu().numpy(),
                                rng.integers(0, n, (m, 495))], 1) for b in range(6)]

        def window_filter(name, b, qt):
            if name == "tenant":
                return QueryFilter(tenant=qt)
            if name == "tenant_exclude":
                return QueryFilter(tenant=qt, exclude_ids=excl[b % 6])
            return QueryFilter(allowed_ids=allow if name == "allow" else fresh[b % 5])

        steady = {}
        for name in ("tenant", "allow", "allow_fresh", "tenant_exclude"):
            eng = QueryEngine(index, EngineConfig(k=k, min_batch=8, max_batch=1024))
            for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
                q, qt = batch(b % 6)
                eng.search(q, filter=window_filter(name, b, qt))
            steady[name] = {**eng.meter.summary(), "p90_ms": eng.meter.latency_ms(90)}
        check(F.exclusion_width(F.normalize(QueryFilter(tenant=batch(0)[1], exclude_ids=excl[0]),
                                            m)) == 500, "the exclusion window's width")
        return out, steady

    (out, steady), counts = run_path("filtered_query_1m", serve)
    for name in ("fused_knn", "fused_knn_masked", "fused_knn_wide", "merge_partials",
                 "merge_partials_wide"):
        check(counts[name] > 0, f"filtered: {name} never launched: {counts}")
    say("filtered_steady", steady)

    # The kernels at a batch of 1024 over the compacted main, against their
    # plain versions: the tenant bitmap's partial sets beside the unmasked
    # ones, the bitmap build, and the K = 512 call with its merge.
    q, qt = batch(4)
    f = F.normalize(QueryFilter(tenant=qt), m)
    vecs_t = index._dev["main_vecs"]
    nn = vecs_t.shape[0]
    fx, gy, hx, hy, alpha = ops._mxu_operands(torch.from_numpy(q).to(dev), vecs_t, "neg_dot")
    kw = dict(distance_finalize="identity", alpha=alpha, n_real=nn)
    words = index._allowed_bitmap("main", f, m)
    tags_t = torch.from_numpy(index._main_tenant).to(dev)
    qt_t = torch.from_numpy(qt).to(dev)
    plain_words = lambda: FK.pack_mask(tags_t[None, :] == qt_t[:, None])  # noqa: E731
    check(torch.equal(words, plain_words()), "the tenant bitmap vs its plain build")
    for cache in (index._dev, index._dev_version):  # time the per-tenant rows' build
        cache.pop("main_tenant_words")
    bitmap = {"tenant_rows_build_ms": time_ms(torch, lambda: index._tenant_words("main"),
                                              reps=1, warmup=0),
              "gather_ms": time_ms(torch, lambda: index._allowed_bitmap("main", f, m)),
              "plain_ms": time_ms(torch, plain_words), "bytes": words.numel() * 4,
              "shape": list(words.shape)}
    # What every allow-list search pays before its scan: the rows'
    # membership, and the selectivity counted from it.
    fa = F.normalize(QueryFilter(allowed_ids=allow), m)
    state = index._device_state()
    members = index._memberships(fa, state)
    bitmap["allow_membership_ms"] = time_ms(torch, lambda: index._memberships(fa, state))
    bitmap["allow_selectivity_ms"] = time_ms(torch, lambda: index._selectivity(fa, state,
                                                                               members))
    bitmap["allow_row_pack_ms"] = time_ms(torch, lambda: index._allowed_bitmap(
        "main", fa, m, members["main"]))
    del state, members
    outs = {}
    unmasked_ms = time_ms(torch, lambda: FK.fused_knn_partials(fx, gy, hx, hy, k, **kw))
    call_ms = time_ms(torch, lambda: FK.fused_knn(fx, gy, hx, hy, k, **kw))
    masked_ms = time_ms(torch, lambda: outs.__setitem__(
        "p", FK.fused_knn_partials(fx, gy, hx, hy, k, q_mask=words, **kw)))
    part_v, part_i = outs["p"]
    v, i = MP.merge_partials(part_v, part_i)
    plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
        fx, gy, hx, hy, k, alpha=alpha, finalize="identity", n_real=nn, q_mask=words))
    dist = operand_distance(fx, gy, hx, hy, alpha=alpha, finalize="identity")
    cmp = check_topk(v[:, :k], i[:, :k], pv[:, :k], pi[:, :k], n=nn, rtol=1e-5, atol=1e-3,
                     dist=dist)
    check(bool((tags_t[i[:, :k].clamp(min=0).long()] == qt_t[:, None])[i[:, :k] >= 0].all()),
          "the masked kernel served a row of another tenant")
    bm, splits, _ = FK.plan(m, nn, 16, dev)
    masked = {"ms": masked_ms, "unmasked_ms": unmasked_ms, "fused_call_unmasked_ms": call_ms,
              "plain_ms": plain_ms, "vs_plain": cmp, "library_ms": None, "bm": bm,
              "splits": splits,
              **mm_bound(2.0 * m * nn * d, (m + nn) * d * 4 + nn * 4 + words.numel() * 4
                         + part_v.numel() * 8),
              "shape": f"partial sets, {m} x {nn}, d {d}, k {k}, tenant bitmap"}
    del outs, part_v, part_i, pv, pi
    # K = 512: the tenant filter with 500 exclusions fetches k + E = 510.
    outs = {}
    wide_ms = time_ms(torch, lambda: outs.__setitem__(
        "p", FK.fused_knn_partials(fx, gy, hx, hy, 510, q_mask=words, **kw)))
    part_v, part_i = outs["p"]
    merge_ms = time_ms(torch, lambda: outs.__setitem__("m", MP.merge_partials(part_v, part_i)))
    mv, mi = outs["m"]
    merge_plain_ms, (mpv, mpi) = time_plain(torch, lambda: MP.merge_partials_plain(
        part_v, part_i))
    check(torch.equal(mi, mpi) and torch.equal(mv, mpv), "the K = 512 merge vs plain")
    cat_v = part_v.permute(1, 0, 2).reshape(m, -1).contiguous()
    merge_lib_ms = time_ms(torch, lambda: torch.topk(cat_v, 512, dim=1, largest=False))
    merge_graph = {"graph_ms": graph_ms(torch, lambda: MP.merge_partials(part_v, part_i)),
                   "library_graph_ms": graph_ms(torch, lambda: torch.topk(
                       cat_v, 512, dim=1, largest=False))}
    del cat_v
    wide_plain_ms, (pv, pi) = time_plain(torch, lambda: FK.fused_knn_plain(
        fx, gy, hx, hy, 510, alpha=alpha, finalize="identity", n_real=nn, q_mask=words))
    wide_cmp = check_topk(mv, mi, pv, pi, n=nn, rtol=1e-5, atol=1e-3, dist=dist)
    bm_w, splits_w, _ = FK.plan(m, nn, 512, dev)
    wide = {"ms": wide_ms, "plain_ms": wide_plain_ms, "vs_plain": wide_cmp, "library_ms": None,
            "bm": bm_w, "splits": splits_w,
            **mm_bound(2.0 * m * nn * d, (m + nn) * d * 4 + nn * 4 + words.numel() * 4
                       + part_v.numel() * 8),
            "shape": f"partial sets, {m} x {nn}, d {d}, k 510 (K 512), tenant bitmap"}
    mb = bound_ms(0.0, part_v.numel() * 8 + mv.numel() * 8)
    merge = {"ms": merge_ms, "plain_ms": merge_plain_ms, "library_ms": merge_lib_ms,
             **merge_graph,
             "max_abs_err": float((mv - mpv).abs().nan_to_num(0.0).max()),
             "bound_ms": mb[0], "bound_by": mb[1],
             "shape": f"{part_v.shape[0]} splits x {m} x 512"}
    res = {"cases": out, "steady": steady, "bitmap": bitmap, "masked_partials": masked,
           "wide_k512": wide, "merge_k512": merge}
    say("filtered_kernels", {key: res[key] for key in ("bitmap", "masked_partials",
                                                       "wide_k512", "merge_k512")})
    del index, engine, fx, gy, hx, hy, words, outs, part_v, part_i, pv, pi, mv, mi
    torch.cuda.empty_cache()
    return res


def host_twin(RetrievalIndex, idx):
    """A new index with ``idx``'s host state (segments, ids, liveness, tags,
    epoch) and nothing on the card: what a synchronous compact of that state
    would start from."""
    twin = RetrievalIndex(idx.dim, **idx.config_kwargs())
    for name in ("_main_vecs", "_main_ids", "_main_live", "_main_tenant", "_delta_vecs",
                 "_delta_ids", "_delta_live", "_delta_tenant"):
        setattr(twin, name, getattr(idx, name).copy())
    twin._delta_n, twin._main_epoch = idx._delta_n, idx._main_epoch
    twin._loc, twin._version = dict(idx._loc), dict(idx._version)
    return twin


def phase_persistence(torch, dev, run_path, held, pq_build, pq_queries, int8_queries):
    """Phase 9: snapshots and the crash-safe lifecycle at query_1m, on
    phase 7's IVF-PQ index and phase 5's int8 two-stage index, taken out of
    ``held`` (so that the old epoch's device state can go at the handoff)."""
    import shutil
    import threading

    import repro_torch.core.ivf as IV
    import repro_torch.core.kmeans as KM
    import repro_torch.core.pq as PQ
    import repro_torch.serving.index as IX
    import repro_torch.serving.lifecycle as L
    import repro_torch.serving.snapshot as SS
    from repro_torch.accounting import ServingMeter
    from repro_torch.core.distances import quantize_rows
    from repro_torch.core.knn import ivf_query
    from repro_torch.kernels.ref import check_topk
    from repro_torch.launch import lifecycle_check as LC
    from repro_torch.launch import snapshot_check as SN
    from repro_torch.serving import LifecycleConfig, LifecycleIndex
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex

    k, d, new_base = 10, 256, 1 << 21  # new ids start past every id of phases 5-7
    pq_index, int8_index = held.pop("ivfpq"), held.pop("int8")
    root = os.path.join(HERE, "build", "phase9")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    # The IVF-PQ image holds the fp32 cell-packed rows: ncells x cell_cap x d x 4.
    image_bytes = (pq_index._dev["main_ivf"].packed.numel() * 4
                   + len(pq_index._main_vecs) * (d * 4 + 9))
    say("persistence_disk", {"path": root, "total_bytes": disk.total, "free_bytes": disk.free,
                             "ivfpq_image_bytes_estimate": image_bytes})
    check(disk.free > 2.5 * image_bytes,
          f"phase 9: {disk.free} bytes free, the IVF-PQ images need {2.5 * image_bytes}")

    # 9a. Snapshot round trip: churn, save, restore in a fresh process.
    def churn(idx, seed, rows):
        rng = np.random.default_rng(seed)
        live_main = idx._main_ids[idx._main_live]
        idx.delete(rng.choice(live_main, len(idx._main_ids) // 100, replace=False))
        new = np.arange(new_base, new_base + 8192)
        idx.upsert(new, rows(rng, 8192))
        idx.upsert(new[:1024], rows(rng, 1024))  # a dead and a live delta row under one id

    def near_main(idx):
        return lambda rng, m: (idx._main_vecs[rng.choice(len(idx._main_vecs), m)]
                               + 0.05 * rng.standard_normal((m, d)).astype(np.float32))

    def gauss(rng, m):
        return rng.standard_normal((m, d)).astype(np.float32) / np.sqrt(d)

    def round_trip(label, idx, q, rows, build_s):
        churn(idx, 91, rows)
        snap = os.path.join(root, f"snapshot_{label}")
        res = idx.search(q, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.save(snap)
        save_s = time.perf_counter() - t0
        expected = snap + ".expected.npz"
        np.savez(expected, q=q, v=res.distances.cpu().numpy(), i=res.ids.cpu().numpy(), k=k)
        files = {f: os.path.getsize(os.path.join(snap, f)) for f in sorted(os.listdir(snap))}
        if build_s is None:  # the int8 tier's derived state is its replica
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            quantize_rows(idx._dev["main_vecs"], "int8", distance="neg_dot")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = SN.run_fresh(SN._RESTORE_SNIPPET, snap, expected, str(dev))
        fresh_s = time.perf_counter() - t0
        check(got["bit_identical"] and got["live_rows"] == len(idx),
              f"9a {label}: fresh restore {got}")
        shutil.rmtree(snap)
        return {"live_rows": len(idx), "delta_rows": int(idx._delta_n), "file_bytes": files,
                "total_bytes": sum(files.values()), "save_s": save_s,
                "restore_s": got["restore_s"], "fresh_process_s": fresh_s, "build_s": build_s,
                "build_split": pq_build if label == "ivfpq" else {"int8_replica_s": build_s},
                "bit_identical": True}

    out = {"snapshot_ivfpq": round_trip("ivfpq", pq_index, pq_queries[:1024],
                                        near_main(pq_index), sum(pq_build.values())),
           "snapshot_int8": round_trip("int8", int8_index, int8_queries[:1024], gauss, None)}
    for label in ("ivfpq", "int8"):
        say(f"persistence_snapshot_{label}", out[f"snapshot_{label}"])

    # 9b. WAL and crash recovery on the int8 index: 1,000 fsync-acked
    # single-row writes, a torn half-frame, recovery in a fresh process.
    snap = os.path.join(root, "wal_int8")
    meter = ServingMeter()
    t0 = time.perf_counter()
    lc = LifecycleIndex.attach(int8_index, LifecycleConfig(snapshot_dir=snap), meter=meter)
    attach_s = time.perf_counter() - t0
    rng = np.random.default_rng(92)
    live = np.fromiter(lc.index._loc, np.int64, len(lc.index._loc))
    victims = rng.choice(live, 500, replace=False)
    for j in range(500):
        target = new_base + 8192 + j if j % 2 else int(victims[(j + 250) % 500])
        lc.upsert([target], gauss(rng, 1))
        lc.delete([int(victims[j])])
    expected = LC.crash(lc, snap, int8_queries[:1024], k, acked=1000)
    t0 = time.perf_counter()
    got = SN.run_fresh(LC._RECOVER_SNIPPET, snap, expected, str(dev))
    fresh_s = time.perf_counter() - t0
    check(got["tail_records"] == 1000 and got["torn_bytes"] == len(LC.TORN)
          and got["bit_identical"], f"9b: recovery {got}")
    out["wal_int8"] = {"attach_s": attach_s, "acks": meter.summary()["wal_records"],
                       "wal_bytes": meter.summary()["wal_bytes"],
                       "ack_mean_ms": meter.summary()["wal_fsync_ms"],
                       "ack_p50_ms": meter.wal_ack_ms(50), "ack_p99_ms": meter.wal_ack_ms(99),
                       "ack_max_ms": meter.wal_ack_ms(100), "recover": got,
                       "fresh_process_s": fresh_s}
    say("persistence_wal_int8", out["wal_int8"])
    shutil.rmtree(snap)
    del lc, int8_index
    torch.cuda.empty_cache()

    # 9c. Background handoff while serving, on the IVF-PQ index.
    snap = os.path.join(root, "lifecycle_ivfpq")
    t0 = time.perf_counter()
    lc = LifecycleIndex.attach(pq_index, LifecycleConfig(snapshot_dir=snap))
    attach_s = time.perf_counter() - t0
    del pq_index
    meters = {w: ServingMeter() for w in ("before", "training", "imaging", "after")}
    engine = QueryEngine(lc, EngineConfig(k=k, min_batch=8, max_batch=1024),
                         meter=meters["before"])
    batches = [pq_queries[b * 1024 : (b + 1) * 1024] for b in range(8)]
    rng = np.random.default_rng(93)
    mutations = [("upsert", (np.arange(new_base + 9000, new_base + 9016),
                             near_main(lc.index)(rng, 16))),
                 ("delete", (rng.choice(lc.index._main_ids, 16, replace=False),)),
                 ("upsert", (lc.index._main_ids[:8], near_main(lc.index)(rng, 8)))]
    real_lloyd, on_serving, in_worker = KM.lloyd, [], []

    def guarded(*a, **kw):  # k-means must run in the worker only
        if threading.current_thread() is threading.main_thread():
            on_serving.append(1)
            raise AssertionError("9c: kmeans.lloyd entered on the serving thread")
        in_worker.append(1)
        return real_lloyd(*a, **kw)

    # The lifecycle's stages, traced: each call's span, the serving thread's
    # tagged, to set beside the window's slowest batches (timed here with
    # the engine's batch-boundary hook, where the swap runs, which the
    # meter leaves out).
    spans, traced = [], [(IX, "build_ivf"), (IX, "build_ivfpq"), (IX, "_tensor"),
                         (IV, "ivf_to_arrays"), (PQ, "pq_to_arrays"), (SS, "_npz_atomic"),
                         (SS, "_file_stamp"), (L, "_replace_dir"), (L, "checkpoint_journal"),
                         (L, "read_journal"), (L, "replay_record"), (lc, "_finish_handoff")]
    originals = [getattr(mod, name) for mod, name in traced]

    def tracer(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                serving = threading.current_thread() is threading.main_thread()
                spans.append(("serving:" * serving + name, t0, time.perf_counter()))
        return call

    def window():
        for b in range(21):  # the first batch is tagged cold
            engine.search(batches[b % 8])
        twin = host_twin(RetrievalIndex, lc.index)
        epoch0 = lc.stats()["epoch"]
        KM.lloyd = guarded
        for (mod, name), fn in zip(traced, originals):
            setattr(mod, name, tracer(name, fn))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            lc.compact()
            for op, args in mutations:  # acked during the window, replayed onto N+1
                getattr(lc, op)(*args)
            b, slow = 0, []
            while lc.handoff_pending:
                p = lc._pending
                engine.meter = meters["training" if "train_s" not in p.out else "imaging"]
                tb = time.perf_counter()
                engine.search(batches[b % 8])
                slow.append((time.perf_counter() - tb, tb))
                b += 1
            window_s, window_batches = time.perf_counter() - t0, b
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            KM.lloyd = real_lloyd
            for (mod, name), fn in zip(traced, originals):
                setattr(mod, name, fn)
            del lc._finish_handoff  # the method again, not the traced copy
        slowest = [{"ms": dt * 1e3, "at_s": tb - t0,
                    "stages": sorted({n for n, s0, s1 in spans if s0 < tb + dt and s1 > tb})}
                   for dt, tb in sorted(slow, reverse=True)[:8]]
        stages = {}
        for n, s0, s1 in spans:
            stages[n] = stages.get(n, 0.0) + (s1 - s0)
        engine.meter = meters["after"]
        for b in range(21):
            engine.search(batches[b % 8])
        check(not on_serving and in_worker, f"9c: k-means calls {len(on_serving)} on the "
              f"serving thread, {len(in_worker)} in the worker")
        check(lc.stats()["epoch"] == epoch0 + 1, f"9c: epoch {lc.stats()}")
        return twin, {"window_s": window_s, "window_batches": window_batches,
                      "peak_allocated_bytes": peak, "slowest_batches": slowest,
                      "stage_s": stages}

    (twin, info), counts = run_path("lifecycle_handoff_ivfpq", window)
    for name in ("fused_knn", "pq_scan", "rescore_topk"):
        check(counts[name] > 0, f"9c: {name} never launched on the serving thread: {counts}")
    worker = lc.stats()["worker_launches"]
    check(worker.get("fused_knn.LAUNCHES", 0) > 0, f"9c: the worker launched no kernel {worker}")
    # Gate: the handed-off epoch serves what a synchronous compact and first
    # search of the same state serve, bit for bit, on the card (ROADMAP F3).
    qfix = pq_queries[:1024]
    got = lc.search(qfix, k)
    twin.compact()
    for op, args in mutations:
        getattr(twin, op)(*args)
    t0 = time.perf_counter()
    want = twin.search(qfix, k)
    torch.cuda.synchronize()
    sync_first_search_s = time.perf_counter() - t0
    check(torch.equal(got.ids, want.ids) and torch.equal(got.distances, want.distances),
          "9c: the handed-off epoch differs from a synchronous compact")
    del twin, want
    torch.cuda.empty_cache()
    # Gate: the handed-off cells hold every live main row: an fp32 scan of
    # them at nprobe = ncells equals brute force over the live main rows.
    new = lc.index
    vecs_t, live_t, ids_t = new._device_state()["main"]
    cells = new._dev["main_ivf"]
    q64 = torch.from_numpy(pq_queries[:64]).to(dev)
    r = ivf_query(q64, vecs_t, cells, k, nprobe=cells.ncells, distance="neg_dot",
                  db_live=live_t)
    rows = torch.nonzero(live_t).flatten()
    bv, bi = brute_topk(torch, q64, vecs_t[rows], 16)
    full_probe = check_topk(r.distances, r.indices.long(), bv[:, :k], rows[bi[:, :k].long()],
                            n=vecs_t.shape[0], rtol=1e-5, atol=1e-3,
                            dist=lambda rr, c: -(q64[rr] * vecs_t[c]).sum(1))
    vecs, ids = new._live_rows()
    qt = torch.from_numpy(qfix).to(dev)
    truth = torch.from_numpy(ids).to(dev)[true_ids(torch, qt, torch.from_numpy(vecs).to(dev), k)]
    summ = {w: {**m.summary(), "p90_ms": m.latency_ms(90), "max_ms": m.latency_ms(100)}
            for w, m in meters.items()}
    out["handoff_ivfpq"] = {
        "attach_s": attach_s, **info, "train_s": lc.stats()["last_train_s"],
        "windows": summ, "serving_launches": counts, "worker_launches": worker,
        "sync_compact_first_search_s": sync_first_search_s, "bit_identical_to_sync": True,
        "full_probe_vs_brute": full_probe, "recall_at_10_after": recall_at(torch, got.ids, truth),
        "rows": len(new), "delta_rows": int(new._delta_n)}
    say("persistence_handoff_ivfpq", out["handoff_ivfpq"])
    lc.close()
    del lc, new, vecs_t, live_t, ids_t, cells
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def phase_mesh(torch, dev, run_path, allpairs, xc):
    """10. The multi-device core (``core.distributed`` over a
    ``launch.mesh.Mesh``) with four positions: on four cards where the
    machine has them, else all four on the one card, each on its own
    stream.  ``allpairs``: phase 2's x and result, on the host.  Each
    sub-phase's time by CUDA events, its launches and the peak memory."""
    from repro_torch.core import distributed as D
    from repro_torch.core.distances import quantize_rows
    from repro_torch.core.knn import knn_query
    from repro_torch.core.pq import build_ivfpq
    from repro_torch.data.synthetic import random_vectors
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.filters import QueryFilter
    from repro_torch.serving.index import RetrievalIndex

    ndev = torch.cuda.device_count()
    devices = [torch.device("cuda", p) for p in range(4)] if ndev >= 4 else [dev] * 4
    ring_mesh = make_mesh((4,), ("ring",), devices=devices)
    q_mesh = make_mesh((1, 4), ("data", "model"), devices=devices)
    t_phase = time.perf_counter()
    out = {"devices": [str(d) for d in devices], "launches": {}}

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return res, start.elapsed_time(end)

    def sub(label, fn):
        """``fn`` through ``run_path`` (its launches), timed by CUDA events,
        with the peak device memory of the run."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (res, counts), ms = timed(lambda: run_path(label, fn))
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res, {"ms": ms, "launches": {k: v for k, v in counts.items() if v},
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    # 10a. The ring at allpairs_160k, against phase 2's fused all-pairs.
    x_h, want_v_h, want_i_h = allpairs
    n, k = x_h.shape[0], want_i_h.shape[1]
    x = x_h.to(dev)
    want_v, want_i = want_v_h.to(dev), want_i_h.to(dev)
    dist = operand_distance(*ops._mxu_operands(x, x, "sqeuclidean")[:4], alpha=-2.0,
                            finalize="identity")
    ring = D.make_ring_allpairs(ring_mesh, k=k, impl="kernel")
    res, st = sub("mesh_ring_allpairs_160k", lambda: ring(x, n))
    for name in ("pairwise_distance", "stream_topk"):
        check(st["launches"].get(name, 0) > 0, f"10a: {name} never launched: {st}")
    runs = [st["ms"]] + [timed(lambda: ring(x, n))[1] for _ in range(2)]
    cmp = check_topk(res.distances, res.indices, want_v, want_i, n=n, rtol=1e-5, atol=2e-3,
                     dist=dist)
    out["ring"] = {**st, "runs_ms": runs, "median_ms": statistics.median(runs),
                   "vs_phase2": cmp, "col_chunk": D.COL_CHUNK}
    say("mesh_ring_allpairs_160k", out["ring"])
    ring16 = D.make_ring_allpairs(ring_mesh, k=k, impl="kernel", wire_dtype=torch.bfloat16)
    res16, st16 = sub("mesh_ring_allpairs_160k_bf16", lambda: ring16(x, n))
    out["ring_bf16"] = {**st16, "recall_at_100": recall_at(torch, res16.indices, want_i),
                        "max_abs_err_vs_phase2": float((res16.distances - want_v).abs().max())}
    say("mesh_ring_allpairs_160k_bf16", out["ring_bf16"])
    del res, res16

    # 10b. The paper's triangle: gsize by configs/base.py's rule, n padded.
    gsize = -(-(-(-n // 8)) // 128) * 128  # pad_to(ceil(n / 2P), 128), P = 4
    xp = D.pad_rows_to(x, gsize)
    tri = D.make_triangle_allpairs(ring_mesh, k=k, gsize=gsize, impl="kernel")
    res, st = sub("mesh_triangle_allpairs_160k", lambda: tri(xp, n))
    for name in ("pairwise_distance", "stream_topk"):
        check(st["launches"].get(name, 0) > 0, f"10b: {name} never launched: {st}")
    out["triangle"] = {**st, "gsize": gsize, "n_pad": xp.shape[0],
                       "vs_phase2": check_topk(res.distances, res.indices, want_v, want_i, n=n,
                                               rtol=1e-5, atol=2e-3, dist=dist)}
    say("mesh_triangle_allpairs_160k", out["triangle"])
    del res, x, xp, want_v, want_i, dist
    torch.cuda.empty_cache()

    # 10c. The sharded query at query_1m: queries replicated, rows over four.
    n4, m = QUERY_ROWS, MESH_QUERIES
    db = torch.from_numpy(random_vectors(n4, 256, seed=1)).to(dev)
    q = torch.from_numpy(random_vectors(m, 256, seed=2)).to(dev)
    single, single_ms = timed(lambda: knn_query(q, db, k))
    fn = D.make_query_sharded(q_mesh, query_axis="data", db_axis="model", k=k, impl="fused")
    res, st = sub("mesh_query_1m", lambda: fn(q, db, n4))
    check(st["launches"].get("fused_knn", 0) >= 4, f"10c: fused_knn launches: {st}")
    runs = [st["ms"]] + [timed(lambda: fn(q, db, n4))[1] for _ in range(2)]
    qdist = operand_distance(*ops._mxu_operands(q, db, "sqeuclidean")[:4], alpha=-2.0,
                             finalize="identity")
    out["query"] = {**st, "runs_ms": runs, "median_ms": statistics.median(runs),
                    "single_device_ms": single_ms, "queries": m, "rows": n4,
                    "vs_single_device": check_topk(res.distances, res.indices, single.distances,
                                                   single.indices, n=n4, rtol=1e-5, atol=2e-3,
                                                   dist=qdist)}
    say("mesh_query_1m", out["query"])
    db_q = quantize_rows(db, "int8")
    fn8 = D.make_query_sharded(q_mesh, query_axis="data", db_axis="model", k=k, impl="fused",
                               scan_dtype="int8", wire_dtype=torch.bfloat16)
    res8, st8 = sub("mesh_query_1m_int8", lambda: fn8(q, db, n4, None, db_q))
    for name in ("fused_knn", "rescore_topk"):
        check(st8["launches"].get(name, 0) > 0, f"10c int8: {name} never launched: {st8}")
    rec = recall_at(torch, res8.indices, single.indices)
    check(rec >= 0.9, f"10c int8 two-stage on the mesh: recall@{k} {rec} < 0.9")
    out["query_int8"] = {**st8, "recall_at_100": rec,
                         "k_scan": D.scan_width(n4 // 4, k, 4)}
    say("mesh_query_1m_int8", out["query_int8"])
    del db, q, single, res, res8, db_q, qdist
    torch.cuda.empty_cache()

    # 10d. The index on the mesh: flat at query_1m (neg_dot, k 10), churned.
    k4 = 10
    db_np = random_vectors(n4, 256, seed=1)
    tags = tenant_tags(n4, seed=8)
    idx = RetrievalIndex.build(np.arange(n4), db_np, distance="neg_dot", impl="fused",
                               device="cuda", mesh=q_mesh, tenants=tags)
    del db_np
    rng = np.random.default_rng(4)
    idx.delete(rng.choice(n4, n4 // 100, replace=False))
    idx.upsert(np.arange(n4, n4 + 8192), random_vectors(8192, 256, seed=3),
               tenants=tenant_tags(8192, seed=9))
    engine = QueryEngine(idx, EngineConfig(k=k4, min_batch=8, max_batch=1024))
    qs = [random_vectors(1024, 256, seed=300 + b) for b in range(21)]

    def serve():
        for b in qs:  # the first batch is tagged cold
            engine.search(b)
        return engine.meter

    meter, st = sub("mesh_index_flat", serve)
    for name in ("fused_knn", "merge_partials"):
        check(st["launches"].get(name, 0) > 0, f"10d flat: {name} never launched: {st}")
    vecs, ids = idx._live_rows()
    vt = torch.from_numpy(vecs).to(dev)
    ids_t = torch.from_numpy(ids).to(dev).long()
    qt = torch.from_numpy(qs[0][:64]).to(dev)
    bv, bi = brute_topk(torch, qt, vt, 16)
    pos = torch.full((int(ids_t.max()) + 1,), -1, dtype=torch.long, device=dev)
    pos[ids_t] = torch.arange(len(ids_t), device=dev)
    got = idx.search(qs[0][:64], k4)
    flat_cmp = check_topk(got.distances, got.ids.long(), bv[:, :k4], ids_t[bi[:, :k4].long()],
                          n=len(pos), rtol=1e-5, atol=1e-3,
                          dist=lambda r, e: -(qt[r] * vt[pos[e]]).sum(1))
    qten = np.random.default_rng(10).integers(0, N_TENANTS, 1024).astype(np.int32)
    fgot, fst = sub("mesh_index_flat_tenant", lambda: idx.search(qs[1], k4,
                                                                 filter=QueryFilter(tenant=qten)))
    tag_of = np.full(int(ids.max()) + 1, -1, np.int64)
    tag_of[ids] = idx._live_tenants()
    gi = fgot.ids.cpu().numpy()
    check(bool(((tag_of[gi.clip(0)] == qten[:, None]) | (gi < 0)).all()),
          "10d: the mesh index served an id of another tenant")
    out["index_flat"] = {**st, **meter.summary(), "p90_ms": meter.latency_ms(90),
                         "vs_brute_force": flat_cmp,
                         "live": len(idx), "tenant_batch": {
                             **fst, "empty_slots": int((fgot.ids < 0).sum())}}
    say("mesh_index_flat", out["index_flat"])
    del idx, engine, vt, ids_t, qt, pos, got, fgot
    torch.cuda.empty_cache()

    # IVF fp32 (4096 cells, 1,024 a shard) and IVF-PQ (pq_m 32) on phase 6's rows.
    xm, cq = xc[:QUERY_ROWS], xc[QUERY_ROWS : QUERY_ROWS + 1024]
    ivf_idx = RetrievalIndex.build(np.arange(QUERY_ROWS), xm, distance="neg_dot", impl="fused",
                                   device="cuda", ivf_cells=IVF_CELLS, nprobe=8, mesh=q_mesh)
    t0 = time.perf_counter()
    ivf_idx._device_state()
    torch.cuda.synchronize()
    ivf_build_s = time.perf_counter() - t0
    cells = ivf_idx._dev["main_ivf"]
    check(cells.ncells == IVF_CELLS, f"10d: {cells.ncells} cells")
    vt = ivf_idx._dev["main_vecs"]
    truth = true_ids(torch, torch.from_numpy(cq).to(dev), vt, k4)
    ivf_engine = QueryEngine(ivf_idx, EngineConfig(k=k4, min_batch=8, max_batch=1024))

    def serve_ivf():
        for _ in range(11):
            got = ivf_engine.search(cq)
        return got

    got, st = sub("mesh_index_ivf", serve_ivf)
    for name in ("ivf_scan", "rescore_topk"):
        check(st["launches"].get(name, 0) > 0, f"10d ivf: {name} never launched: {st}")
    rec = recall_at(torch, got.ids, truth)
    check(rec >= 0.9, f"10d ivf nprobe 8 on the mesh: recall@10 {rec} < 0.9")
    ivf_idx.nprobe = IVF_CELLS
    qt = torch.from_numpy(cq[:256]).to(dev)
    full = ivf_idx.search(cq[:256], k4)
    bv, bi = brute_topk(torch, qt, vt, 16)
    full_cmp = check_topk(full.distances, full.ids.long(), bv[:, :k4], bi[:, :k4], n=QUERY_ROWS,
                          rtol=1e-5, atol=1e-3, dist=neg_dot_distance(qt, vt))
    out["index_ivf"] = {**st, **ivf_engine.meter.summary(), "recall_at_10": rec,
                        "build_s": ivf_build_s, "cell_cap": cells.cell_cap,
                        "full_probe_vs_brute_force": full_cmp}
    say("mesh_index_ivf", out["index_ivf"])
    t0 = time.perf_counter()
    pq = build_ivfpq(vt, cells, PQ_M, nbits=PQ_NBITS, distance="neg_dot",
                     generator=torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    pq_build_s = time.perf_counter() - t0
    pq_idx = RetrievalIndex.from_arrays(
        xm, np.arange(QUERY_ROWS), np.ones(QUERY_ROWS, bool), np.zeros((0, 256), np.float32),
        np.zeros(0, np.int32), np.zeros(0, bool), 0, distance="neg_dot", impl="fused",
        device="cuda", ivf=cells, pq=pq, overfetch=8, nprobe=8, mesh=q_mesh)
    del ivf_idx, ivf_engine
    pq_engine = QueryEngine(pq_idx, EngineConfig(k=k4, min_batch=8, max_batch=1024))

    def serve_pq():
        for _ in range(11):
            got = pq_engine.search(cq)
        return got

    got, st = sub("mesh_index_ivfpq", serve_pq)
    for name in ("pq_scan", "rescore_topk"):
        check(st["launches"].get(name, 0) > 0, f"10d ivfpq: {name} never launched: {st}")
    # The index's IVF-PQ merge ships bf16 values, as the reference's does
    # (src/repro/serving/index.py:937): at neg_dot values near 250 a bf16
    # step is 1-2 while neighbours lie 0.01-0.5 apart, so the wire ties them
    # and the merge keeps positions, not the nearest.  Its contract is
    # near-optimality: an id counts if it is a true top-10 id or its exact
    # distance is within one bf16 rounding of the exact 10th.  The scorer
    # itself, on an fp32 wire over the same shards, is held to the recall
    # floor id for id.
    qt = torch.from_numpy(cq).to(dev)
    kth = -torch.topk(qt @ vt.T, k4, dim=1).values[:, -1:]
    exact_d = -(qt[:, None, :] * vt[got.ids.long().clamp(min=0)]).sum(2)
    near = (got.ids >= 0) & (exact_d <= kth + kth.abs() * 2.0 ** -8 + 1e-3)
    hit = (got.ids.long()[:, :, None] == truth.long()[:, None, :]).any(2)
    rec, rec_wire = recall_at(torch, got.ids, truth), float((hit | near).float().mean())
    check(rec_wire >= 0.85, f"10d ivf-pq overfetch 8 on the mesh: recall@10 with the bf16 "
                            f"wire's ties {rec_wire} < 0.85 (id for id {rec})")
    fp32_wire = D.make_ivfpq_query_sharded(
        q_mesh, query_axis="data", db_axis="model", k=16, nprobe=8, cell_cap=cells.cell_cap,
        distance="neg_dot", overfetch=8)
    live_p = pq_idx._dev["main_ivf_live"]
    res32 = fp32_wire(qt, cells.centroids, *pq, cells.packed, cells.row_of_slot, live_p)
    rec32 = recall_at(torch, res32.indices[:, :k4], truth)
    check(rec32 >= 0.85, f"10d ivf-pq overfetch 8, fp32 wire: recall@10 {rec32} < 0.85")
    out["index_ivfpq"] = {**st, **pq_engine.meter.summary(), "recall_at_10": rec,
                          "recall_at_10_wire_ties": rec_wire, "recall_at_10_fp32_wire": rec32,
                          "pq_build_s": pq_build_s}
    say("mesh_index_ivfpq", out["index_ivfpq"])
    out["fleet_state"] = (cells, pq)  # phase 11 cuts these cells and codes into shards
    del pq_idx, pq_engine, cells, pq, vt, truth, got, full
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say("mesh_phase", {"seconds": out["phase_s"], "devices": out["devices"],
                       "launches": out["launches"]})
    return out



def phase_fleet(torch, dev, run_path, cells, pq, xc, compare):
    """11. The shard fleet (``serving.shards``, ``transport``, ``supervisor``)
    at query_1m on one card: phase 10's IVF-PQ cells and codes (4,096 cells,
    ``pq_m`` 32, nprobe 8, overfetch 8, neg_dot, k 10) in an index, cut into
    4 shard images of 1,024 cells under ``build/phase11`` with a fleet
    manifest of 2 replicas.  11a: the in-process fleet (R = 1): recall@10
    against brute force, full coverage, and bit for bit the (1, 4)-mesh
    scorer over the same cells, codes and live slots; 25 warm batches
    through ``QueryEngine``.  11b: 4 x 2 worker processes, each its own
    CUDA context on the card: spawn and HELLO seconds, the card's memory,
    bit for bit the in-process fleet on the fp32 and the bf16 wire, the
    frames' bytes beside ``rpc_bytes_per_batch``, 25 warm batches.  11c: a
    SIGKILL mid-batch and one replica of every shard killed between batches
    (results bit for bit healthy), the respawn into probation and back to
    healthy, both replicas of one shard dead under ``"partial"`` (coverage
    < 1, the flat sort of the surviving shards' runs) and ``"refuse"``
    (``ShardUnavailableError``), and a drain that leaves no worker process.
    Every position shares the one card: no time here is a scaling figure."""
    import shutil

    from repro_torch.accounting import ServingMeter, rpc_bytes_per_batch, shard_bytes_per_query
    from repro_torch.core import distributed as D
    from repro_torch.core.ivf import packed_live
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving import transport as TR
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.faults import FaultPolicy, FaultyWorker
    from repro_torch.serving.health import HealthState
    from repro_torch.serving.index import RetrievalIndex
    from repro_torch.serving.shards import ShardRouter, ShardUnavailableError, load_fleet
    from repro_torch.serving.snapshot import save_shards
    from repro_torch.serving.supervisor import SupervisorConfig

    k, n_shards, replicas = 10, 4, 2
    t_phase = time.perf_counter()
    out = {"launches": {}, "compare": compare}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res, {name: c for name, c in counts.items() if c}

    def same(a, b, what):
        check(torch.equal(a.ids.to(dev), b.ids.to(dev))
              and torch.equal(a.distances.to(dev), b.distances.to(dev)),
              f"11: {what}: results differ")

    xm, qs = xc[:QUERY_ROWS], xc[QUERY_ROWS:]
    batches = [qs[b * 1024 : (b + 1) * 1024] for b in range(len(qs) // 1024)]
    qfix = torch.from_numpy(batches[0]).to(dev)
    index = RetrievalIndex.from_arrays(
        xm, np.arange(QUERY_ROWS), np.ones(QUERY_ROWS, bool), np.zeros((0, 256), np.float32),
        np.zeros(0, np.int32), np.zeros(0, bool), 0, distance="neg_dot", impl="fused",
        device=dev, ivf=cells, pq=pq, overfetch=8, nprobe=8)
    vt, live, main_ids = index._device_state()["main"]
    truth = main_ids[true_ids(torch, qfix, vt, k)]
    root = os.path.join(HERE, "build", "phase11")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    image_bytes = cells.packed.numel() * 4 + pq[1].codes.numel() + cells.packed.shape[0] * 9
    say("fleet_disk", {"path": root, "total_bytes": disk.total, "free_bytes": disk.free,
                       "images_bytes_estimate": image_bytes})
    check(disk.free > 2 * image_bytes,
          f"phase 11: {disk.free} bytes free, the shard images need {2 * image_bytes}")
    t0 = time.perf_counter()
    save_shards(index, os.path.join(root, "fleet"), n_shards, replicas=replicas)
    save_s = time.perf_counter() - t0
    fleet_root = os.path.join(root, "fleet")
    files = {os.path.relpath(os.path.join(dp, f), fleet_root):
             os.path.getsize(os.path.join(dp, f))
             for dp, _, fs in os.walk(fleet_root) for f in fs}
    out["save"] = {"seconds": save_s, "bytes": sum(files.values()), "files": files}
    say("fleet_save", out["save"])

    # 11a. The in-process fleet, one replica a shard.
    t0 = time.perf_counter()
    inproc = load_fleet(fleet_root, replicas=1, device=dev, meter=ServingMeter())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    base, st = counted("fleet_inproc_batch", lambda: inproc.search(qfix, k))
    for name in ("fused_knn", "pq_scan", "rescore_topk"):
        check(st.get(name, 0) > 0, f"11a: {name} never launched: {st}")
    rec = recall_at(torch, base.ids, truth)
    check(rec >= 0.85, f"11a: the in-process fleet's recall@10 {rec} < 0.85")
    check(bool(np.all(base.coverage == 1.0)), "11a: coverage below 1 on a healthy fleet")
    check(all(s in ("ok", "skipped") for _, s in base.shard_status),
          f"11a: shard status {base.shard_status}")
    mesh = make_mesh((1, 4), ("data", "model"), devices=[dev] * 4)
    scorer = D.make_ivfpq_query_sharded(mesh, query_axis="data", db_axis="model", k=k,
                                        nprobe=8, cell_cap=cells.cell_cap, distance="neg_dot",
                                        overfetch=8)
    res = scorer(qfix, cells.centroids, *pq, cells.packed, cells.row_of_slot,
                 packed_live(cells, live))
    ids = torch.where(res.indices >= 0, main_ids[res.indices.clamp(min=0).long()], -1)
    check(torch.equal(base.ids, ids) and torch.equal(base.distances, res.distances),
          "11a: the in-process fleet differs from the (1, 4)-mesh scorer")
    cell_cap, ncells = cells.cell_cap, cells.ncells
    del mesh, scorer, res, ids, cells, pq
    engine = QueryEngine(inproc, EngineConfig(k=k, min_batch=8, max_batch=1024))

    def window(eng):
        for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
            eng.search(batches[b % len(batches)])
        return eng.meter

    meter, st = counted("fleet_inproc_steady", lambda: window(engine))
    # Each dispatch's seconds, by the router's failover wrapper (host clock).
    dispatch = {key: w["mean_ms"] for key, w in inproc.meter.shard_summary()["workers"].items()}
    out["inproc"] = {"load_s": load_s, "recall_at_10": rec, "launches": st,
                     "dispatch_mean_ms": dispatch,
                     "equals_mesh_scorer": True, **meter.summary(),
                     "p90_ms": meter.latency_ms(90), "cell_cap": cell_cap,
                     "shard_bytes_model": shard_bytes_per_query(
                         QUERY_ROWS, 256, n_shards, ncells=ncells, nprobe=8, pq_m=PQ_M,
                         k=k, overfetch=8, wire_bytes_per_value=4)}
    say("fleet_inproc", out["inproc"])
    del index, vt, live, engine
    torch.cuda.empty_cache()

    # 11b. The process fleet: 4 shards x 2 replicas, each a worker process.
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    t0 = time.perf_counter()
    router = load_fleet(fleet_root, workers="proc", device=dev, meter=ServingMeter(),
                        supervisor_cfg=SupervisorConfig(heartbeat_s=600.0))
    spawn_s = time.perf_counter() - t0
    sup = router.supervisor
    pids = {w.key: w.pid for w in sup.workers}  # every worker process, respawns added below
    try:
        free1, _ = torch.cuda.mem_get_info()
        got, st = counted("fleet_proc_batch", lambda: router.search(qfix, k))
        same(got, base, "the proc fleet against the in-process fleet (fp32 wire)")
        want16 = ShardRouter(inproc.workers, wire_dtype="bfloat16").search(qfix, k)
        for w in sup.workers:
            w.wire_dtype = "bfloat16"
        got16 = ShardRouter(sup.workers, wire_dtype="bfloat16").search(qfix, k)
        for w in sup.workers:
            w.wire_dtype = None
        same(got16, want16, "the proc fleet against the in-process fleet (bf16 wire)")
        req = len(TR.pack_frame(TR.F_QUERY, {"seq": 1, "k": k}, {"q": batches[0]}))
        rep = {wire: len(TR.pack_frame(TR.F_RESULT, {"seq": 1}, TR.encode_result(
            base.distances.new_zeros((1024, 16)), base.ids.new_zeros((1024, 16)),
            wire_dtype=wire))) for wire in (None, "bfloat16")}
        dispatched = sum(s == "ok" for _, s in got.shard_status)
        engine = QueryEngine(router, EngineConfig(k=k, min_batch=8, max_batch=1024))
        meter, st_w = counted("fleet_proc_steady", lambda: window(engine))
        out["proc"] = {
            "workers": len(sup.workers), "spawn_s": spawn_s,
            "dispatch_mean_ms": {key: w["mean_ms"] for key, w in
                                 router.meter.shard_summary()["workers"].items()},
            "hello_s": {w.key: w.spawn_s for w in sup.workers},
            "card_used_gb_before": (total - free0) / 1e9,
            "card_used_gb_after_spawn": (total - free1) / 1e9,
            "workers_card_gb": (free0 - free1) / 1e9, "launches_parent": {**st, **st_w},
            "frames_per_batch": {"dispatched": dispatched, "query_bytes": req,
                                 "result_bytes_fp32": rep[None],
                                 "result_bytes_bf16": rep["bfloat16"],
                                 "batch_bytes_fp32": dispatched * (req + rep[None])},
            "rpc_bytes_per_batch": rpc_bytes_per_batch(1024, 256, k=k,
                                                       shards_dispatched=dispatched),
            **meter.summary(), "p90_ms": meter.latency_ms(90),
            "equals_inproc_fp32": True, "equals_inproc_bf16": True}
        say("fleet_proc", out["proc"])

        # 11c. Faults on real processes.  A SIGKILL mid-batch: replica 0 of
        # shard 0 dies inside its call, and the router fails over.
        r0 = {w.spec.shard_id: w for w in sup.workers if w.spec.replica == 0}
        mid = ShardRouter([FaultyWorker(w, FaultPolicy.kill_at(0)) if w is r0[0] else w
                           for w in sup.workers])
        same(mid.search(qfix, k), base, "a SIGKILL mid-batch")
        # Between batches: replica 0 of every other shard, SIGKILLed.
        for sid in range(1, n_shards):
            r0[sid].kill()
        after, st = counted("fleet_proc_one_replica_dead", lambda: ShardRouter(
            sup.workers).search(qfix, k))
        same(after, base, "one replica of every shard dead")
        check(not any(w.alive for w in r0.values()), "11c: a killed worker is alive")
        healer = ShardRouter(sup.workers)
        t0 = time.perf_counter()
        respawned = sup.poll(healer.health)
        respawn_s = time.perf_counter() - t0
        check(sorted(respawned) == sorted(w.key for w in r0.values()),
              f"11c: respawned {respawned}")
        check(all(healer.health.state(w.key) is HealthState.PROBATION for w in r0.values()),
              "11c: a respawned worker did not re-enter as probation")
        trial = ShardRouter(list(r0.values()))
        trial.health = healer.health
        same(trial.search(qfix, k), base, "the respawned replicas")
        check(all(healer.health.state(w.key) is HealthState.HEALTHY for w in r0.values()),
              "11c: a respawned worker did not return to healthy")
        out["faults"] = {"respawn_s": respawn_s,
                         "respawn_hello_s": {w.key: w.spawn_s for w in r0.values()},
                         "new_pids": all(w.pid != pids[w.key] for w in r0.values())}
        pids.update({f"{w.key}-respawned": w.pid for w in r0.values()})
        # Both replicas of shard 1 dead.
        for w in sup.workers:
            if w.spec.shard_id == 1:
                w.kill()
        part = ShardRouter(sup.workers, degraded="partial").search(qfix, k)
        check(dict(part.shard_status)[1] == "failed", f"11c: status {part.shard_status}")
        check(float(part.coverage.min()) < 1.0, "11c: full coverage with a shard dead")
        alive = [inproc.workers[g[0]].topk(qfix, k) for g in inproc.groups
                 if inproc.workers[g[0]].spec.shard_id != 1]
        vals = torch.cat([r.distances for r in alive], 1)
        order = torch.sort(vals, dim=1, stable=True).indices[:, :k]
        check(torch.equal(part.distances, vals.gather(1, order))
              and torch.equal(part.ids, torch.cat([r.indices for r in alive], 1).gather(1, order)),
              "11c: partial result is not the flat sort of the surviving shards' runs")
        try:
            ShardRouter(sup.workers, degraded="refuse").search(qfix, k)
            check(False, "11c: refuse served with a shard dead")
        except ShardUnavailableError as e:
            lo, hi = inproc.workers[inproc.groups[1][0]].spec[2:4]
            check(e.shard_ids == (1,) and e.cells and all(lo <= c < hi for c in e.cells),
                  f"11c: ShardUnavailableError carries {e.shard_ids} / {e.cells}")
        out["faults"].update({"partial_coverage_min": float(part.coverage.min()),
                              "partial_coverage_mean": float(part.coverage.mean()),
                              "refuse_raised": True})
    finally:
        procs = [w._proc for w in sup.workers if w._proc is not None]
        t0 = time.perf_counter()
        sup.shutdown(drain=True)
        drain_s = time.perf_counter() - t0
    left = []
    for pid in set(pids.values()):
        try:
            os.kill(pid, 0)
            left.append(pid)
        except ProcessLookupError:
            pass
    check(not left, f"11c: worker processes left after shutdown: {left}")
    out["faults"].update({"drain_s": drain_s, "exit_codes": [p.returncode for p in procs],
                          "pids_checked": len(set(pids.values()))})
    say("fleet_faults", out["faults"])
    del inproc, router, base, got, got16, want16, part, alive, qfix, truth, main_ids
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    say("fleet_phase", {"seconds": out["phase_s"], "launches": out["launches"]})
    return out


def phase_service(torch, dev, run_path):
    """12. The two-tower retrieval service (``serving.service``) at the full
    width of ``configs/two_tower.py::full_config()`` on the card: 11.12 x
    10^9 parameters (44.5 GB of tables) drawn from a seed, the item corpus
    the arch's ``retrieval_cand`` cell (10^6 candidates), served with its
    ``serving_defaults()``.  12a: the state, and the towers on 1,024 item
    and 1,024 user rows against a CPU computation of the same rows (each
    table's last row among them), atol 1e-5; the largest table's tail drawn,
    not zeros or a copy.  12b: the flat service: the item sweep timed apart
    from ``build_corpus``; one user (the cell's batch), then batches of 1024
    users, half of them repeat users, each list equal to a brute force over
    the live corpus embeddings (ids tie-aware, scores within 1e-5), through
    an ingest of 8,192 items, a delete of 1% and a compact; a batch with each
    user's unfiltered top 5 excluded; a steady window of ``SERVICE_STEADY``
    batches; the params fingerprint, ``save_index`` and ``restore_index``
    into a fresh service (bit-identical results).  12c: IVF-PQ at phase 7's
    settings (``ivf_cells`` 4096, nprobe 8, ``pq_m`` 32, overfetch 8):
    no deleted id served, recall@10 at overfetch 8 and 4 reported; a
    full-probe fp32 IVF service equal to brute force.  A rehearsal on the
    CPU shrinks it through ``SERVICE_CONFIG``, ``SERVICE_ITEMS``,
    ``IVF_CELLS`` and ``SERVICE_STEADY``."""
    import shutil

    from repro_torch.configs.two_tower import full_config, serving_defaults
    from repro_torch.kernels.ref import check_topk
    from repro_torch.models import recsys as P
    from repro_torch.serving import ServiceConfig, TwoTowerRetrievalService
    from repro_torch.serving.service import params_crc32

    cfg = full_config() if SERVICE_CONFIG is None else SERVICE_CONFIG
    n_items, ivf_cells, steady = SERVICE_ITEMS, IVF_CELLS, SERVICE_STEADY
    k = serving_defaults()["k"]
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    free, total = torch.cuda.mem_get_info()
    say("service_memory_before", {"free_bytes": free, "total_bytes": total,
                                  "allocated_bytes": torch.cuda.memory_allocated()})
    torch.cuda.reset_peak_memory_stats()

    # 12a. The state and the towers.
    t0 = synced()
    params = P.init_two_tower(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
    init_s = synced() - t0
    tables = params["user_tables"] + params["item_tables"]
    state = {"init_s": init_s, "n_params": P.n_params(params),
             "bytes": 4 * P.n_params(params),
             "table_bytes": 4 * sum(t.numel() for t in tables),
             "largest_table_elements": max(t.numel() for t in tables)}
    say("service_state", state)

    g = np.random.default_rng(12)
    towers = {}
    for tower, fn in (("item", P.item_embedding), ("user", P.user_embedding)):
        tabs, mlp = params[f"{tower}_tables"], params[f"{tower}_mlp"]
        ids = np.stack([g.integers(0, t.shape[0], 1024) for t in tabs], axis=1)
        ids[0] = [t.shape[0] - 1 for t in tabs]  # each table's last row
        got = fn(params, torch.from_numpy(ids).to(dev)).cpu()
        # The CPU side reads each row through a view (its offset computed on
        # the host), never through the card's gather.
        x = torch.cat([torch.stack([t[int(r)] for r in ids[:, i]]).cpu()
                       for i, t in enumerate(tabs)], dim=1)
        x = P.apply_mlp([{key: v.cpu() for key, v in layer.items()} for layer in mlp], x)
        want = x / x.norm(dim=-1, keepdim=True).clamp_min(1e-9)
        err = float((got - want).abs().max())
        check(err <= 1e-5, f"12a: the {tower} tower on the card vs the CPU: {err}")
        towers[tower] = {"max_abs_err": err, "rows": 1024,
                         "last_rows": [int(t.shape[0] - 1) for t in tabs]}
    big = max(tables, key=lambda t: t.numel()).view(-1)
    tail = big[-(1 << 20):]
    tail_std, tail_mean = float(tail.std()), float(tail.mean())
    check(abs(tail_std - cfg.feat_dim ** -0.5) < 0.01 * cfg.feat_dim ** -0.5
          and abs(tail_mean) < 1e-3, f"12a: the largest table's tail: std {tail_std}")
    if big.numel() > (1 << 31) + (1 << 20):
        check(not torch.equal(tail, big[-(1 << 20) - (1 << 31) : -(1 << 31)]),
              "12a: the largest table's tail repeats the block 2^31 elements before it")
    towers["largest_table_tail"] = {"std": tail_std, "mean": tail_mean,
                                    "elements": big.numel()}
    del big, tail
    say("service_towers", towers)

    item_lim, user_lim = min(cfg.i_sizes()), min(cfg.u_sizes())
    rng = np.random.default_rng(0)  # launch/serve.py's draws of the corpus fields
    fields = rng.integers(0, item_lim, size=(n_items, cfg.n_item_fields)).astype(np.int32)
    pool = rng.integers(0, user_lim, size=(4096, cfg.n_user_fields)).astype(np.int32)
    batch_no = [0]

    def users(m=1024, repeat=0.5):
        """m users, a share ``repeat`` of them drawn from the pool of 4,096
        repeat visitors, the rest new (keys past the pool)."""
        n_rep = int(m * repeat)
        b = batch_no[0]
        batch_no[0] += 1
        keys = np.concatenate([rng.integers(0, 4096, size=n_rep),
                               4096 + b * m + np.arange(m - n_rep)])
        f = np.concatenate([pool[keys[:n_rep]],
                            rng.integers(0, user_lim, size=(m - n_rep, cfg.n_user_fields))])
        return keys, f.astype(np.int32)

    def brute(svc, q, excluded=None, K=16):
        """Top-K of -q.v over the service's live rows, by external id, and
        the distance of any (row, external id)."""
        vecs, ids = svc._live_index()._live_rows()
        vt = torch.from_numpy(vecs).to(dev)
        it = torch.from_numpy(ids).to(dev).long()
        pos = torch.full((int(it.max()) + 1,), -1, dtype=torch.long, device=dev)
        pos[it] = torch.arange(len(it), device=dev)
        bv, bi = [], []
        for r in range(0, len(q), 256):
            d = -(q[r : r + 256] @ vt.T)
            if excluded is not None:
                for j, ex in enumerate(excluded[r : r + 256]):
                    p = pos[torch.as_tensor(ex, device=dev).long()]
                    d[j, p[p >= 0]] = float("inf")
            v, i = torch.topk(d, K, dim=1, largest=False)
            bv.append(v)
            bi.append(it[i])

        def dist(rows, ext):
            p = pos[ext]
            check(bool((p >= 0).all()), "a served id is not live")
            return -(q[rows] * vt[p]).sum(1)

        return torch.cat(bv), torch.cat(bi), dist, len(pos)

    def gate(step, svc, keys, f, exclude=None):
        ids, scores = svc.recommend(keys, f, exclude_ids=exclude)
        q = P.user_embedding(params, torch.from_numpy(f).to(dev))
        bv, bi, dist, n = brute(svc, q, exclude)
        got_v = -torch.from_numpy(scores).to(dev)
        got_i = torch.from_numpy(ids).to(dev).long()
        cmp = check_topk(got_v, got_i, bv[:, :k], bi[:, :k], n=n, rtol=1e-5, atol=1e-5,
                         dist=dist)
        say(f"service_check_{step}", {**cmp, "users": len(keys),
                                      "live": len(svc._live_index())})
        return ids

    # 12b. The flat service.
    def flat():
        res = {}
        svc = TwoTowerRetrievalService(params, cfg, ServiceConfig(**serving_defaults()),
                                       device=dev)
        t0 = synced()
        sweep = svc._embed("item", fields)
        res["item_sweep_s"] = synced() - t0
        del sweep
        t0 = synced()
        corpus = svc.build_corpus(np.arange(n_items), fields)
        res["build_corpus_s"] = synced() - t0
        res["index_build_s"] = res["build_corpus_s"] - res["item_sweep_s"]
        check(corpus.shape == (n_items, cfg.tower_mlp[-1]) and corpus.device.type == dev.type,
              "12b: corpus embeddings' shape or place")
        del corpus
        one = []
        for j in range(21):  # the retrieval_cand cell: one user a call
            keys, f = users(1, 0.0)
            t0 = time.perf_counter()
            if j == 0:
                gate("one_user", svc, keys, f)
            else:
                svc.recommend(keys, f)
            one.append((time.perf_counter() - t0) * 1e3)
        res["one_user_first_ms"] = one[0]
        res["one_user_ms_p50"] = statistics.median(one[1:])
        gate("batch_1024_initial", svc, *users())
        gate("batch_1024_repeat", svc, *users())
        new = rng.integers(0, item_lim, size=(8192, cfg.n_item_fields)).astype(np.int32)
        t0 = synced()
        svc.ingest_items(np.arange(n_items, n_items + 8192), new)
        res["ingest_8192_s"] = synced() - t0
        gate("ingest", svc, *users())
        dead = np.random.default_rng(4).choice(n_items, n_items // 100, replace=False)
        t0 = time.perf_counter()
        check(svc.delete_items(dead) == len(dead), "12b: delete count")
        res["delete_1pct_s"] = time.perf_counter() - t0
        gate("delete", svc, *users())
        t0 = synced()
        svc.compact()
        res["compact_s"] = synced() - t0
        gate("compact", svc, *users())
        keys, f = users()
        top5, _ = svc.recommend(keys, f, k=5)
        ids = gate("exclude_top5", svc, keys, f, exclude=[row for row in top5])
        check(not any(set(row.tolist()) & set(ex.tolist()) for row, ex in zip(ids, top5)),
              "12b: an excluded id was served")
        # The steady window: warm batches of 1024, half of them repeat users.
        svc.e2e_meter.reset()
        svc.meter.reset()
        h0, m0 = svc.user_cache.hits, svc.user_cache.misses
        for _ in range(steady + 1):
            svc.recommend(*users())
        hits, misses = svc.user_cache.hits - h0, svc.user_cache.misses - m0
        e2e, eng = svc.e2e_meter, svc.meter
        embed_ms = []  # the user side alone: cache lookups, the tower on the misses
        for _ in range(10):
            keys, f = users()
            t0 = synced()
            svc.embed_users(keys, f)
            embed_ms.append((synced() - t0) * 1e3)
        res["steady"] = {"batches": e2e.n_batches, "e2e_p50_ms": e2e.latency_ms(50),
                         "embed_users_ms_p50": statistics.median(embed_ms),
                         "e2e_p90_ms": e2e.latency_ms(90), "e2e_max_ms": e2e.latency_ms(100),
                         "scan_p50_ms": eng.latency_ms(50), "scan_p90_ms": eng.latency_ms(90),
                         "cache_hit_rate": hits / max(hits + misses, 1),
                         "cold_batches": e2e.summary()["compile_batches"]}
        # Persistence: the fingerprint alone, then a save and a restore into a
        # fresh service, each of which takes one fingerprint.
        root = os.path.join(HERE, "build", "phase12")
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        t0 = time.perf_counter()
        fp = params_crc32(params)
        res["fingerprint_s"] = time.perf_counter() - t0
        keys, f = users()
        want = svc.recommend(keys, f)
        t0 = synced()
        snap = svc.save_index(os.path.join(root, "flat"))
        res["save_index_s"] = synced() - t0
        res["image_bytes"] = sum(os.path.getsize(os.path.join(dp, name))
                                 for dp, _, names in os.walk(snap) for name in names)
        svc2 = TwoTowerRetrievalService(params, cfg, ServiceConfig(**serving_defaults()),
                                       device=dev)
        t0 = synced()
        svc2.restore_index(snap)
        res["restore_index_s"] = synced() - t0
        got = svc2.recommend(keys, f)
        check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
              "12b: the restored service's results differ")
        res["fingerprint"] = fp
        res["stats"] = {key: v for key, v in svc.stats().items() if key != "engine"}
        del svc, svc2
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
        return res

    out["flat"] = counted("service_flat", flat)
    say("service_flat", out["flat"])

    # 12c. IVF-PQ at phase 7's settings on the same towers and corpus.
    def ivfpq():
        res = {}
        sc = ServiceConfig(**{**serving_defaults(), "ivf_cells": ivf_cells, "nprobe": 8,
                              "pq_m": PQ_M, "overfetch": 8})
        svc = TwoTowerRetrievalService(params, cfg, sc, device=dev)
        t0 = synced()
        svc.build_corpus(np.arange(n_items), fields)
        res["build_corpus_s"] = synced() - t0
        keys, f = users()
        t0 = synced()
        svc.recommend(keys, f)  # trains the cells and the codebooks
        res["first_search_s"] = synced() - t0
        ivf = svc.index._dev["main_ivf"]
        counts = ivf.counts.cpu().numpy()
        res["cells"] = {"ncells": int(ivf.ncells), "cell_cap": int(ivf.cell_cap),
                        "max": int(counts.max()), "mean": float(counts.mean()),
                        "empty": int((counts == 0).sum()),
                        "packed_bytes": ivf.packed.numel() * 4}
        q = P.user_embedding(params, torch.from_numpy(f).to(dev))
        _, truth, _, _ = brute(svc, q, K=k)
        recall = {}
        for of in (8, 4):
            svc.index.overfetch = of
            ids, _ = svc.recommend(keys, f)
            recall[f"overfetch_{of}"] = recall_at(torch, torch.from_numpy(ids).to(dev), truth)
        svc.index.overfetch = 8
        res["recall_at_10"] = {**recall, "reference_floor_clustered": 0.85}
        dead = np.random.default_rng(5).choice(n_items, n_items // 100, replace=False)
        svc.delete_items(dead)
        svc.ingest_items(np.arange(n_items, n_items + 8192),
                         rng.integers(0, item_lim, size=(8192, cfg.n_item_fields)).astype(
                             np.int32))
        svc.e2e_meter.reset()
        svc.meter.reset()
        served = []
        for _ in range(21):
            ids, _ = svc.recommend(*users())
            served.append(ids)
        served = np.concatenate(served)
        check(not np.isin(served, dead).any(), "12c: a deleted id was served")
        check(bool((served >= 0).all()), "12c: a list came back short")
        res["after_churn"] = {"batches": svc.e2e_meter.n_batches,
                              "e2e_p50_ms": svc.e2e_meter.latency_ms(50),
                              "scan_p50_ms": svc.meter.latency_ms(50),
                              "deleted": len(dead), "ingested": 8192}
        del svc, q
        torch.cuda.empty_cache()
        # The exactness hatch: an fp32 IVF service probing every cell.
        sc = ServiceConfig(**{**serving_defaults(), "ivf_cells": ivf_cells,
                              "nprobe": ivf_cells})
        svc = TwoTowerRetrievalService(params, cfg, sc, device=dev)
        svc.build_corpus(np.arange(n_items), fields)
        t0 = synced()
        svc.recommend(*users())  # trains the cells
        res["full_probe_first_search_s"] = synced() - t0
        gate("ivf_full_probe", svc, *users())
        del svc
        torch.cuda.empty_cache()
        return res

    out["ivfpq"] = counted("service_ivfpq", ivfpq)
    say("service_ivfpq", out["ivfpq"])
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    del params, tables
    torch.cuda.empty_cache()
    say("service_phase", {"seconds": out["phase_s"], "peak_bytes": out["peak_bytes"],
                          "launches": out["launches"]})
    return out


def table_digest(torch, t) -> int:
    """A position-weighted sum of ``t``'s 32-bit words (mod 2^64), computed
    on its device in blocks of 2^24 words: equal for byte-equal tensors."""
    words = t.detach().reshape(-1).view(torch.int32)
    n = 1 << 24
    w = torch.arange(1, n + 1, device=t.device, dtype=torch.int64)
    sums = torch.stack([(c.long() * w[: len(c)]).sum() for c in words.split(n)]).cpu().tolist()
    acc = 0
    for s in sums:
        acc = (acc * 1000003 + s) % (1 << 64)
    return acc


# Phase 13's largest table of each arch (a leaf of its params) and the batch
# column(s) that index it.
LARGEST_TABLE = {
    "two-tower-retrieval": (("user_tables", 0), lambda b: b["user"][:, 0]),
    "dlrm-rm2": (("tables", 0), lambda b: b["sparse"][:, 0]),
    "xdeepfm": (("tables", 0), lambda b: b["sparse"][:, 0]),
    "bst": (("items", None), lambda b: np.concatenate([b["hist"].ravel(), b["target"]])),
}


HOLD_AFTER = (1, 4)  # 17a: steps after which 13b's DLRM is kept (the first with lr > 0; the last)


def dlrm_watch(cfg) -> dict:
    """For each step of ``HOLD_AFTER``: per table of the three largest, 2,048
    drawn ids among those the batches up to it touched, and the largest 16."""
    from repro_torch.data.synthetic import recsys_batch

    rows = TRAIN_ROWS or 65536
    sizes = cfg.sizes()
    big = sorted(range(len(sizes)), key=lambda i: -sizes[i])[:3]
    seen = [recsys_batch("dlrm-rm2", rows, cfg, step=i)["sparse"]
            for i in range(max(HOLD_AFTER) + 1)]
    g = np.random.default_rng(17)
    out = {}
    for step in HOLD_AFTER:
        out[step] = {}
        for i in big:
            ids = np.unique(np.concatenate([b[:, i] for b in seen[: step + 1]]))
            out[step][i] = np.unique(np.concatenate([
                g.choice(ids, min(2048, len(ids)), replace=False), ids[-16:]]))
    return out


def dlrm_sample(torch, params, watch: dict) -> dict:
    """The dense leaves and the watched rows of ``params`` (whole tensors or
    ``Sharded`` leaves), on the host."""
    from repro_torch.distributed.sharding import Sharded

    def host(t):  # a copy: the state is updated in place after this
        return t.whole().cpu() if isinstance(t, Sharded) else t.detach().cpu().clone()

    rows = {}
    for i, ids in watch.items():
        t = params["tables"][i]
        rows[i] = (sharded_table_rows(torch, t, ids) if isinstance(t, Sharded) else
                   t.index_select(0, torch.from_numpy(ids).to(t.device)).cpu().numpy())
    return {"dense": {f"{k}.{j}.{n}": host(v).numpy() for k in ("bot", "top")
                      for j, layer in enumerate(params[k]) for n, v in layer.items()},
            "rows": rows}


def phase_train(torch, dev, run_path):
    """13. The recommender's trainer (``distributed.steps``, ``train.optim``)
    at the full width of each recsys arch's ``full_config()`` on the card,
    through ``RecsysArch.build(rules, "train_batch")``: 65,536 rows a step
    (``configs/base.py:350``), ``StepConfig(**TRAIN_STEP)`` with
    ``TRAIN_MICRO`` micro-batches; each step timed as its two halves
    (``step.grads``: forward and backward; ``step.update``: the clip and the
    optimizer), the rows it touched, the peak device memory.

    13a: the two-tower model (44.5 GB of tables drawn from seed 0), 10 steps
    at 8 micro-batches of 8,192 rows (each its own in-batch softmax).
    Gates: every loss finite and the last below the first; every sampled
    touched row of every table (the hottest ids, the largest ids, others
    spread between) equal, after each step, to row-wise Adagrad recomputed
    on the host from that step's coalesced gradient and clip (rtol 1e-6,
    atol 1e-7); a sample of the largest user table (rows past element 2^31
    among them) that no batch touched byte-equal to the start; then the
    trained towers serve: ``TwoTowerRetrievalService`` over 10^6 items, one
    batch of 1,024 users equal to a brute force over the trained item
    embeddings, and ``make_retrieval_step`` at ``retrieval_cand`` (1 user x
    10^6 candidates, k 100) equal to brute force; then 14a
    (``phase_loop_checkpoint``): the first 3 steps again from a fresh draw
    of seed 0 through a ``TrainLoop`` and a full-width checkpoint, resumed
    to step 5 and held leaf by leaf against this run's state there.  13b: ``dlrm-rm2``, ``xdeepfm`` and ``bst``, 5 steps each,
    losses finite and a sample of untouched rows of the largest table byte-
    equal (DLRM's past element 2^31), then ``serve_p99`` (512 rows) through
    ``make_recsys_serve_step``.  13c: each arch at ``smoke_config()``, 5
    steps on the card and on the CPU from one start: losses and params
    within rtol 1e-4 and atol 1e-5.  A rehearsal on the CPU shrinks it by
    replacing the archs' ``full_config`` and through ``TRAIN_ROWS`` and
    ``SERVICE_ITEMS``."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.two_tower import serving_defaults
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels.ref import check_topk
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import recsys as P
    from repro_torch.models.nn import split_params, tree_leaves, tree_map
    from repro_torch.serving import ServiceConfig, TwoTowerRetrievalService
    from repro_torch.train import optim as O

    import gc

    rules = make_rules(make_host_mesh(devices=[dev]))
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def leaf(tree, path):
        node = tree[path[0]]
        return node if path[1] is None else node[path[1]]

    def state_from_spec(spec, values, where):
        """A train state of ``values``: its optimizer state the zeros of the
        built spec's (meta) shapes."""
        def zeros(t):
            return torch.zeros(t.shape, dtype=t.dtype, device=where)

        return ST.TrainState(values, O.OptState(0, tree_map(zeros, spec.opt.m),
                                                tree_map(zeros, spec.opt.v)))

    def fresh_state(aid):
        """(step, state, cfg, rows a step): the cell's step and a state drawn
        on the card from seed 0."""
        arch = REG.get(aid)
        sc = ST.StepConfig(**TRAIN_STEP, micro_batches=TRAIN_MICRO[aid])
        step, (spec, specs) = arch.build(rules, "train_batch", step_config=sc)
        cfg = arch.full_config()
        values, _ = split_params(arch.init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))
        rows = TRAIN_ROWS or next(iter(specs.values())).shape[0]
        return step, state_from_spec(spec, values, dev), cfg, rows

    def sample_rows(t, g):
        """Rows of ``t`` to watch: drawn ones, the last 256 and, where the
        table passes 2^31 elements, the 16 rows around that element."""
        R, D = t.shape
        parts = [g.integers(0, R, 4096), np.arange(max(R - 256, 0), R)]
        edge = (1 << 31) // D
        if edge < R:
            parts.append(np.arange(edge - 8, min(edge + 8, R)))
        return np.unique(np.concatenate(parts))

    def train(aid, n_steps, hook=None):
        torch.cuda.reset_peak_memory_stats()
        t0 = synced()
        step, state, cfg, rows = fresh_state(aid)
        init_s = synced() - t0
        path, col = LARGEST_TABLE[aid]
        big = leaf(state.params, path)
        watch = sample_rows(big, np.random.default_rng(13))
        watch_t = torch.from_numpy(watch).to(dev)
        start = big.index_select(0, watch_t).cpu()
        rec = {"init_s": init_s, "rows_a_step": rows, "micro_batches": TRAIN_MICRO[aid],
               "losses": [], "grads_ms": [], "update_ms": [], "rows_touched": []}
        touched = []
        for i in range(n_steps):
            batch = recsys_batch(aid, rows, cfg, step=i)
            touched.append(np.unique(col(batch)))
            t0 = synced()
            (_, metrics), grads = step.grads(state, batch)
            rec["grads_ms"].append((synced() - t0) * 1e3)
            kept = hook("before", i, state, grads, metrics) if hook else None
            t0 = synced()
            state, metrics = step.update(state, grads, metrics)
            rec["update_ms"].append((synced() - t0) * 1e3)
            if hook:
                hook("after", i, state, grads, metrics, kept)
            rec["losses"].append(float(metrics["loss"]))
            rec["rows_touched"].append(sum(len(g.ids) for g in tree_leaves(grads)
                                           if isinstance(g, O.RowGrad)))
            del grads
        step_ms = [a + b for a, b in zip(rec["grads_ms"], rec["update_ms"])]
        rec.update(step_ms_first=step_ms[0], step_ms_median=statistics.median(step_ms),
                   grads_ms_median=statistics.median(rec["grads_ms"]),
                   update_ms_median=statistics.median(rec["update_ms"]),
                   peak_bytes=torch.cuda.max_memory_allocated())
        check(all(np.isfinite(rec["losses"])), f"13: {aid} losses {rec['losses']}")
        untouched = ~np.isin(watch, np.unique(np.concatenate(touched)))
        now = big.index_select(0, watch_t).cpu()
        check(bool(untouched.any()) and torch.equal(now[untouched], start[untouched]),
              f"13: untouched rows of {aid}'s largest table moved")
        past = watch * big.shape[1] >= (1 << 31)
        rec["untouched_checked"] = {"rows": int(untouched.sum()),
                                    "past_2_31": int((untouched & past).sum()),
                                    "table_rows": int(big.shape[0])}
        return step, state, cfg, rec

    # 13a. The two-tower model.
    def two_tower():
        aid = "two-tower-retrieval"
        clip, eps = ST.StepConfig().grad_clip, 1e-8
        errs = {"acc": 0.0, "p": 0.0, "rows": 0}
        keep = {}

        def hook(when, i, state, grads, metrics, kept=None):
            tables = [(name, j) for name in ("user_tables", "item_tables")
                      for j in range(len(state.params[name]))]
            if when == "before":
                kept = {}
                for name, j in tables:
                    rg = grads[name][j]
                    n = len(rg.ids)
                    pos = torch.from_numpy(np.unique(np.concatenate([
                        np.arange(min(3, n)), np.arange(max(n - 8, 0), n),
                        np.linspace(0, n - 1, 21).astype(np.int64)]))).to(dev)
                    ids = rg.ids[pos]
                    kept[name, j] = (ids, state.params[name][j].index_select(0, ids).cpu(),
                                     state.opt.m[name][j].index_select(0, ids).cpu(),
                                     rg.rows[pos].cpu())
                return kept
            scale = min(np.float32(1), np.float32(clip) / max(np.float32(float(metrics["grad_norm"])),
                                                                np.float32(1e-9)))
            lr = np.float32(metrics["lr"])
            for (name, j), (ids, p0, a0, g) in kept.items():
                g = g.numpy() * np.float32(scale)
                acc = a0.numpy() + (g * g).mean(-1, keepdims=True)
                want = p0.numpy() - lr * (g / np.sqrt(acc + np.float32(eps)))
                got_acc = state.opt.m[name][j].index_select(0, ids).cpu().numpy()
                got = state.params[name][j].index_select(0, ids).cpu().numpy()
                np.testing.assert_allclose(got_acc, acc, rtol=1e-6, atol=0)
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
                errs["acc"] = max(errs["acc"], float(np.abs(got_acc / acc - 1).max()))
                errs["p"] = max(errs["p"], float(np.abs(got - want).max()))
                errs["rows"] += len(ids)
            if i == LOOP_RESUME_TO - 1:  # what 14a's resumed loop must reproduce
                keep["digests"] = state_digests(torch, state)
            return None

        step, state, cfg, rec = train(aid, TRAIN_STEPS[aid], hook)
        check(rec["losses"][-1] < rec["losses"][0], f"13a: the loss did not fall {rec['losses']}")
        rec["formula_check"] = {"rows": errs["rows"], "max_rel_err_acc": errs["acc"],
                                "max_abs_err_param": errs["p"]}
        say("train_two_tower", rec)

        # Serve the trained towers.
        n_items = SERVICE_ITEMS
        k = serving_defaults()["k"]
        rng = np.random.default_rng(0)
        fields = rng.integers(0, min(cfg.i_sizes()),
                              size=(n_items, cfg.n_item_fields)).astype(np.int32)
        users = rng.integers(0, min(cfg.u_sizes()),
                             size=(1024, cfg.n_user_fields)).astype(np.int32)

        def serve():
            torch.cuda.reset_peak_memory_stats()
            res = {}
            svc = TwoTowerRetrievalService(state.params, cfg, ServiceConfig(**serving_defaults()),
                                           device=dev)
            t0 = synced()
            corpus = svc.build_corpus(np.arange(n_items), fields)
            res["build_corpus_s"] = synced() - t0
            t0 = synced()
            ids, scores = svc.recommend(np.arange(1024), users)
            res["batch_1024_ms"] = (synced() - t0) * 1e3
            q = P.user_embedding(state.params, torch.from_numpy(users).to(dev))

            def brute(qq, kk):
                bv, bi = [], []
                for r in range(0, len(qq), 256):
                    v, i = torch.topk(-(qq[r : r + 256] @ corpus.T), kk, dim=1, largest=False)
                    bv.append(v)
                    bi.append(i)
                return torch.cat(bv), torch.cat(bi)

            def dist(qq):
                return lambda rows, ext: -(qq[rows] * corpus[ext]).sum(1)

            bv, bi = brute(q, k)
            res["service_vs_brute"] = check_topk(
                -torch.from_numpy(scores).to(dev), torch.from_numpy(ids).to(dev).long(), bv, bi,
                n=n_items, rtol=1e-5, atol=1e-5, dist=dist(q))
            fn, _ = REG.get(aid).build(rules, "retrieval_cand")
            t0 = synced()
            s1, i1 = fn(state.params, users[:1], corpus)
            res["retrieval_step_ms"] = (synced() - t0) * 1e3
            check(s1.shape == (1, min(100, n_items)), f"13a: retrieval step shape {s1.shape}")
            bv, bi = brute(q[:1], s1.shape[1])
            res["retrieval_step_vs_brute"] = check_topk(-s1, i1.long(), bv, bi, n=n_items,
                                                        rtol=1e-5, atol=1e-5, dist=dist(q[:1]))
            del svc, corpus
            res["peak_bytes"] = torch.cuda.max_memory_allocated()
            return res

        # Within this path's count: a nested run_path would zero and read the
        # counters again, and this path would then count those launches twice.
        serving = serve()
        say("train_two_tower_serve", serving)
        del state
        gc.collect()
        torch.cuda.empty_cache()

        # 14a. The repeat as a TrainLoop: 3 steps and a final sync save of the
        # full-width state, then a fresh draw resumed from it to step 5.
        loop = phase_loop_checkpoint(torch, dev, lambda: fresh_state(aid), aid, keep.pop("digests"))
        say("loop_two_tower_checkpoint", loop)
        gc.collect()
        torch.cuda.empty_cache()
        return {"train": rec, "serve": serving, "loop_checkpoint": loop}

    out["two_tower"] = counted("train_two_tower", two_tower)

    # 13b. The three ranking models.
    for aid in ("dlrm-rm2", "xdeepfm", "bst"):
        def ranking(aid=aid):
            hook = None
            if aid == "dlrm-rm2":  # what 17a's sharded run must reproduce
                watch = dlrm_watch(REG.get(aid).full_config())
                kept = {}

                def hook(when, i, state, grads, metrics, _=None):
                    if when == "after" and i in watch:
                        kept[i] = dlrm_sample(torch, state.params, watch[i])

            _, state, cfg, rec = train(aid, TRAIN_STEPS[aid], hook)
            if aid == "dlrm-rm2":
                out["dlrm_hold"] = {"losses": list(rec["losses"]), "watch": watch,
                                    "after": kept, "step_ms_median": rec["step_ms_median"]}
            fn, _ = REG.get(aid).build(rules, "serve_p99")
            batch = recsys_batch(aid, 512, cfg, step=99)
            batch.pop("labels")
            ms = []
            for _ in range(11):
                t0 = synced()
                prob = fn(state.params, batch)
                ms.append((synced() - t0) * 1e3)
            check(prob.shape == (512,) and bool(((prob >= 0) & (prob <= 1)).all()),
                  f"13b: {aid} serve_p99 output")
            rec["serve_p99_ms_first"] = ms[0]
            rec["serve_p99_ms_median"] = statistics.median(ms[1:])
            del state
            gc.collect()
            torch.cuda.empty_cache()
            return rec

        out[aid] = counted(f"train_{aid}", ranking)
        say(f"train_{aid}", out[aid])

    # 13c. The card against the CPU at smoke_config().
    cpu = torch.device("cpu")
    cpu_rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[cpu]))

    def card_vs_cpu():
        res = {}
        for aid in ("two-tower-retrieval", "dlrm-rm2", "xdeepfm", "bst"):
            arch = REG.get(aid)
            cfg = arch.smoke_config()
            sc = ST.StepConfig(**TRAIN_STEP)
            values, _ = split_params(arch.init_params(
                cfg, generator=torch.Generator().manual_seed(0), device=cpu))
            runs = {}
            for where, r in ((cpu, cpu_rules), (dev, rules)):
                step, (spec, _) = arch.build(r, "train_batch", smoke=True, step_config=sc)
                state = state_from_spec(spec, tree_map(lambda t: t.to(where, copy=True), values),
                                        where)
                losses = []
                for i in range(5):
                    state, m = step(state, recsys_batch(aid, 64, cfg, step=i))
                    losses.append(float(m["loss"]))
                runs[where.type] = (losses, [t.cpu() for t in P.param_leaves(state.params)])
            (lc, pc), (lg, pg) = runs["cpu"], runs[dev.type]
            np.testing.assert_allclose(lg, lc, rtol=1e-4, atol=1e-5)
            for a, b in zip(pg, pc):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
            res[aid] = {"max_abs_loss_err": float(np.abs(np.subtract(lg, lc)).max()),
                        "max_abs_param_err": max(float((a - b).abs().max())
                                                 for a, b in zip(pg, pc)),
                        "losses_card": lg}
        return res

    out["card_vs_cpu"] = counted("train_card_vs_cpu", card_vs_cpu)
    say("train_card_vs_cpu", out["card_vs_cpu"])
    out["phase_s"] = time.perf_counter() - t_phase
    say("train_phase", {"seconds": out["phase_s"], "launches": out["launches"]})
    return out


SHARD_MESH = (2, 2)  # 17: the ("data", "model") mesh, its positions cycling over the cards
SHARD_STEPS = 5  # 17a-b: 13b's DLRM steps; 13c's smoke steps
SHARD_ITEMS = 1_000_000  # 17c: the two-tower retrieval_cand cell (configs/base.py:354-356)
SHARD_TOL = dict(rtol=1e-4, atol=1e-5)  # 13c's
SGDM_TABLE_ROWS = 1 << 20  # 17a.sgdm: DLRM-RM2's tables cut to this many rows


def bytes_equal(torch, a, b, chunk=1 << 28) -> bool:
    """``a`` and ``b`` hold the same bytes, compared in chunks of words (no
    temporary as large as a table)."""
    wa, wb = a.reshape(-1), b.reshape(-1)
    if a.element_size() == 4:
        wa, wb = wa.view(torch.int32), wb.view(torch.int32)
    else:
        wa, wb = wa.view(torch.uint8), wb.view(torch.uint8)
    return wa.shape == wb.shape and all(
        torch.equal(wa[i : i + chunk], wb[i : i + chunk]) for i in range(0, len(wa), chunk))


def replicas_equal(torch, tree) -> bool:
    """Every replica of every ``Sharded`` block of ``tree`` byte-equal."""
    from repro_torch.distributed.sharding import Sharded
    from repro_torch.models.nn import tree_leaves

    return all(bytes_equal(torch, s.parts[g[0]], s.parts[q])
               for s in tree_leaves(tree) if isinstance(s, Sharded)
               for g in s.replica_groups() for q in g[1:])


def sharded_table_rows(torch, sh, ids: np.ndarray) -> np.ndarray:
    """Rows ``ids`` (global numbering) of a table placed as ``sh``, each read
    from its block's first replica, on the host."""
    s, mesh = sh.sharding, sh.mesh
    axes, R = s.dim_axes(0), sh.parts[0].shape[0]
    holders = mesh.groups(axes)[0] if axes else [0]
    out = np.empty((len(ids), sh.shape[1]), np.float32)
    for b, p in enumerate(holders):
        sel = np.nonzero(ids // R == b)[0] if axes else np.arange(len(ids))
        if len(sel):
            local = torch.from_numpy(ids[sel] - b * R if axes else ids[sel])
            out[sel] = sh.parts[p].index_select(0, local.to(sh.parts[p].device)).cpu().numpy()
    return out


def phase_sharded(torch, dev, run_path, hold):
    """17. The recommender's steps sharded over a (2, 2) mesh of the card
    (module docstring).  ``hold`` is 13b's DLRM on the host: its losses,
    ``dlrm_watch``'s ids and its ``dlrm_sample`` after each step of
    ``HOLD_AFTER``.  A CPU rehearsal shrinks it through ``TRAIN_ROWS``,
    ``SHARD_ITEMS`` and the archs' ``full_config``."""
    import gc

    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import spmd
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.sharding import make_rules, shard_tree, unshard_tree
    from repro_torch.kernels.ref import check_topk
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import recsys as P
    from repro_torch.models.nn import split_params, tree_map

    t_phase = time.perf_counter()
    n_cards = max(torch.cuda.device_count(), 1)
    devices = [dev if dev.type == "cpu" else torch.device("cuda", i % n_cards)
               for i in range(4)]
    rules = make_rules(make_mesh(SHARD_MESH, ("data", "model"), devices=devices))
    mesh = rules.mesh
    out = {"launches": {}, "mesh": {"shape": list(SHARD_MESH),
                                    "devices": [str(d) for d in devices]}}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def train_step(aid, cfg, where_rules, micro):
        arch = REG.get(aid)
        loss, baxes = ST.recsys_loss(aid, cfg)
        sc = ST.StepConfig(**TRAIN_STEP, micro_batches=micro)
        step, _, st_shard, opt = ST.make_train_step(loss, arch.abstract_params(cfg), where_rules,
                                                    baxes, sc)
        return step, st_shard, opt

    # 17a. DLRM-RM2 at full width.
    def sharded_dlrm(micro, check_lookups):
        """13b's 5 steps on the mesh at ``micro`` micro-batches: (losses, step
        ms, replicas equal, the held samples after ``HOLD_AFTER``'s steps,
        the draw and cut seconds, the bytes after the cut, the peak)."""
        aid = "dlrm-rm2"
        arch = REG.get(aid)
        cfg = arch.full_config()
        rows = TRAIN_ROWS or 65536
        step, st_shard, opt = train_step(aid, cfg, rules, micro)
        torch.cuda.reset_peak_memory_stats()
        t0 = synced()
        values, _ = split_params(arch.init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))
        draw_s = synced() - t0
        batch0 = recsys_batch(aid, rows, cfg, step=0)
        ids0 = torch.from_numpy(batch0["sparse"]).to(dev).long()
        whole_rows = ([t[ids0[:, i]] for i, t in enumerate(values["tables"])]
                      if check_lookups else None)
        state = ST.init_state(opt, values)
        del values
        t0 = synced()
        state = shard_tree(state, st_shard)
        shard_s = synced() - t0
        after_cut = torch.cuda.memory_allocated()
        if check_lookups:
            misses = 0
            with torch.no_grad(), spmd.body(mesh):
                for i, sh in enumerate(state.params["tables"]):
                    got = P.embedding_lookup(spmd.Local(sh.parts, sh.sharding), ids0[:, i])
                    misses += sum(not bytes_equal(torch, g, whole_rows[i]) for g in got.parts)
            check(misses == 0, f"17a: {misses} looked-up blocks differ from the whole lookup")
            del whole_rows, got
        losses, ms, equal, kept = [], [], True, {}
        for i in range(SHARD_STEPS):
            batch = batch0 if i == 0 else recsys_batch(aid, rows, cfg, step=i)
            t0 = synced()
            state, m = step(state, batch)
            ms.append((synced() - t0) * 1e3)
            losses.append(float(m["loss"]))
            equal = equal and replicas_equal(torch, (state.params, state.opt.m, state.opt.v))
            if i in hold["watch"]:
                kept[i] = dlrm_sample(torch, state.params, hold["watch"][i])
        peak = torch.cuda.max_memory_allocated()
        del state, m
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ms, equal, kept, draw_s, shard_s, after_cut, peak

    def err(a, b) -> dict:
        """Max |a - b| over the held samples, and the largest ratio of
        |a - b| to the tolerance (atol + rtol |b|): at most 1 where held."""
        out_ = {"abs": 0.0, "tol_ratio": 0.0}
        pairs = [(a["dense"][k], b["dense"][k]) for k in b["dense"]] + \
            [(a["rows"][i], b["rows"][i]) for i in b["rows"]]
        for x, y in pairs:
            d = np.abs(x - y)
            out_["abs"] = max(out_["abs"], float(d.max()))
            out_["tol_ratio"] = max(out_["tol_ratio"], float(
                (d / (SHARD_TOL["atol"] + SHARD_TOL["rtol"] * np.abs(y))).max()))
        return out_

    def dlrm():
        first, last = HOLD_AFTER
        losses, ms, equal, kept, draw_s, shard_s, after_cut, peak = sharded_dlrm(
            TRAIN_MICRO["dlrm-rm2"], True)
        check(equal, "17a: the replicas of a block differ")
        np.testing.assert_allclose(losses, hold["losses"], **SHARD_TOL)
        vs_whole = {i: err(kept[i], hold["after"][i]) for i in HOLD_AFTER}
        check(vs_whole[first]["tol_ratio"] <= 1.0,
              f"17a: the params after step {first} leave the tolerance: {vs_whole[first]}")
        # The floor of step 5: the same run at 2 micro-batches (the same
        # gradients, summed in another order) against this one.
        _, _, equal2, kept2, _, _, _, _ = sharded_dlrm(2, False)
        check(equal2, "17a: the replicas of a block differ at 2 micro-batches")
        return {"draw_s": draw_s, "shard_s": shard_s, "bytes_after_cut": after_cut,
                "losses": losses, "losses_13b": hold["losses"],
                "max_abs_loss_err": float(np.abs(np.subtract(losses, hold["losses"])).max()),
                "step_ms": ms, "step_ms_first": ms[0],
                "step_ms_median": statistics.median(ms[1:]) if len(ms) > 1 else ms[0],
                "step_ms_13b_median": hold["step_ms_median"], "peak_bytes": peak,
                "params_vs_13b": {f"after_step_{i + 1}": vs_whole[i] for i in HOLD_AFTER},
                "params_micro2_vs_micro1": {f"after_step_{i + 1}": err(kept2[i], kept[i])
                                            for i in HOLD_AFTER},
                "held_rows": sum(len(v) for v in hold["watch"][last].values()),
                "replicas_byte_equal": True, "first_lookups_bit_equal": True}

    out["dlrm"] = counted("sharded_dlrm", dlrm)
    say("sharded_dlrm", out["dlrm"])

    # 17a.sgdm: the same steps with momentum SGD, sharded against whole.
    def dlrm_sgdm():
        """13b's 5 steps of a DLRM-RM2 whose tables are cut to
        ``SGDM_TABLE_ROWS`` rows (so that the whole and the sharded state
        with their momentum fit in turn), ``StepConfig(optimizer="sgdm")``,
        whole on the card and on the (2, 2) mesh: the gap after each step of
        ``HOLD_AFTER``.  SGD with momentum carries a last-bit difference in
        a gradient forward at last-bit size, where AdamW and row-wise
        Adagrad can turn it into a step of about the learning rate: a gap
        near 1e-5 is summation order, a gap near 17a's 4e-4 a fault."""
        import dataclasses

        aid = "dlrm-rm2"
        arch = REG.get(aid)
        full = arch.full_config()
        cfg = dataclasses.replace(full, table_sizes=tuple(min(n, SGDM_TABLE_ROWS)
                                                          for n in full.sizes()))
        rows = TRAIN_ROWS or 65536
        watch = dlrm_watch(cfg)
        one = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
        runs = {}
        for sharded in (False, True):
            loss, baxes = ST.recsys_loss(aid, cfg)
            sc = ST.StepConfig(**TRAIN_STEP, optimizer="sgdm")
            step, _, st_shard, opt = ST.make_train_step(loss, arch.abstract_params(cfg),
                                                        rules if sharded else one, baxes, sc)
            values, _ = split_params(arch.init_params(
                cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))
            state = ST.init_state(opt, values)
            del values
            if sharded:
                state = shard_tree(state, st_shard)
            losses, kept, ms = [], {}, []
            for i in range(SHARD_STEPS):
                batch = recsys_batch(aid, rows, cfg, step=i)
                t0 = synced()
                state, m = step(state, batch)
                ms.append((synced() - t0) * 1e3)
                losses.append(float(m["loss"]))
                if i in watch:
                    kept[i] = dlrm_sample(torch, state.params, watch[i])
            runs[sharded] = (losses, kept, ms)
            del state, m
            gc.collect()
            torch.cuda.empty_cache()
        np.testing.assert_allclose(runs[True][0], runs[False][0], **SHARD_TOL)
        gap = {f"after_step_{i + 1}": err(runs[True][1][i], runs[False][1][i])
               for i in HOLD_AFTER}
        check(gap[f"after_step_{HOLD_AFTER[0] + 1}"]["tol_ratio"] <= 1.0,
              f"17a sgdm: the params after step {HOLD_AFTER[0] + 1} leave the tolerance: {gap}")
        return {"table_rows": list(cfg.sizes()), "losses_sharded": runs[True][0],
                "losses_whole": runs[False][0], "step_ms_sharded": runs[True][2],
                "step_ms_whole": runs[False][2], "params_sharded_vs_whole": gap,
                "held_rows": sum(len(v) for v in watch[HOLD_AFTER[1]].values())}

    out["dlrm_sgdm"] = counted("sharded_dlrm_sgdm", dlrm_sgdm)
    say("sharded_dlrm_sgdm", out["dlrm_sgdm"])

    # 17b. The four archs at smoke size on the card's mesh and four CPU positions.
    cpu = torch.device("cpu")
    cpu_rules = make_rules(make_mesh(SHARD_MESH, ("data", "model"), devices=[cpu] * 4))
    trained = {}

    def smoke():
        res = {}
        for aid in ("dlrm-rm2", "xdeepfm", "bst", "two-tower-retrieval"):
            arch = REG.get(aid)
            cfg = arch.smoke_config()
            values, _ = split_params(arch.init_params(
                cfg, generator=torch.Generator().manual_seed(0), device=cpu))
            runs = {}
            for where, r in ((cpu, cpu_rules), (dev, rules)):
                step, st_shard, opt = train_step(aid, cfg, r, 2 if aid == "two-tower-retrieval"
                                                 else 1)
                state = shard_tree(ST.init_state(
                    opt, tree_map(lambda t: t.to(where, copy=True), values)), st_shard)
                losses, equal = [], True
                for i in range(SHARD_STEPS):
                    state, m = step(state, recsys_batch(aid, 64, cfg, step=i))
                    losses.append(float(m["loss"]))
                    equal = equal and replicas_equal(torch, (state.params, state.opt.m,
                                                             state.opt.v))
                check(equal, f"17b: {aid}'s replicas differ on {where}")
                serve = None
                if aid != "two-tower-retrieval":
                    fn, _, _ = ST.make_recsys_serve_step(aid, cfg, r, arch.abstract_params(cfg))
                    batch = recsys_batch(aid, 64, cfg, step=99)
                    batch.pop("labels")
                    serve = fn(state.params, batch).cpu()
                runs[where.type] = (losses, [t.cpu() for t in
                                             P.param_leaves(unshard_tree(state.params))], serve)
                if where == dev:
                    trained[aid] = (state, cfg)
            (lc, pc, sc_), (lg, pg, sg) = runs["cpu"], runs[dev.type]
            np.testing.assert_allclose(lg, lc, **SHARD_TOL)
            for a, b in zip(pg, pc):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **SHARD_TOL)
            if sg is not None:
                np.testing.assert_allclose(sg.numpy(), sc_.numpy(), **SHARD_TOL)
            res[aid] = {"max_abs_loss_err": float(np.abs(np.subtract(lg, lc)).max()),
                        "max_abs_param_err": max(float((a - b).abs().max())
                                                 for a, b in zip(pg, pc)),
                        "max_abs_serve_err": None if sg is None else
                        float((sg - sc_).abs().max()), "losses_card": lg}
        return res

    out["smoke"] = counted("sharded_smoke", smoke)
    say("sharded_smoke", out["smoke"])

    # 17c. Retrieval over the trained two-tower model's shards.
    def retrieval():
        aid = "two-tower-retrieval"
        state, cfg = trained.pop(aid)
        trained.clear()
        values = unshard_tree(state.params)
        rng = np.random.default_rng(0)
        fields = rng.integers(0, min(cfg.i_sizes()),
                              size=(SHARD_ITEMS, cfg.n_item_fields)).astype(np.int32)
        users = rng.integers(0, min(cfg.u_sizes()), size=(1, cfg.n_user_fields)).astype(np.int32)
        with torch.no_grad():
            db = torch.cat([P.item_embedding(values, fields[r : r + 65536])
                            for r in range(0, SHARD_ITEMS, 65536)])
            q = P.user_embedding(values, users)
        fn, _, _ = ST.make_retrieval_step(cfg, rules, REG.get(aid).abstract_params(cfg),
                                          k=min(100, SHARD_ITEMS))
        ms = []
        for _ in range(3):
            t0 = synced()
            s1, i1 = fn(state.params, users, db)
            ms.append((synced() - t0) * 1e3)
        bv, bi = torch.topk(-(q @ db.T), s1.shape[1], dim=1, largest=False)
        held = check_topk(-s1, i1.long(), bv, bi, n=SHARD_ITEMS, rtol=1e-5, atol=1e-5,
                          dist=lambda rows, ext: -(q[rows] * db[ext]).sum(1))
        check(bool(torch.equal(torch.sort(i1.long(), 1).values, torch.sort(bi, 1).values)),
              "17c: the retrieved ids differ from the brute force's")
        return {"items": SHARD_ITEMS, "k": int(s1.shape[1]), "ms_first": ms[0],
                "ms_median": statistics.median(ms[1:]), "vs_brute": held, "ids_equal": True}

    out["retrieval"] = counted("sharded_retrieval", retrieval)
    say("sharded_retrieval", out["retrieval"])
    out["phase_s"] = time.perf_counter() - t_phase
    say("sharded_phase", {"seconds": out["phase_s"], "launches": out["launches"]})
    return out


LOOP_STEPS, LOOP_RESUME_TO = 3, 5  # 14a: the first loop's steps, the resumed loop's end
ASYNC_STEPS, ASYNC_EVERY, ASYNC_KEEP = 6, 2, 2  # 14b: BST at full width, async saves
LAUNCHER_STEPS, LAUNCHER_EVERY = 200, 10  # 14b: launch/train.py --arch bst (smoke_config)
NEQUIP_STEPS = 40  # 14c: the reference test's run (tests/test_models_gnn.py:90-112)
NEQUIP_STEP = dict(peak_lr=5e-3, warmup_steps=5, total_steps=60)
RELAX_ITERS, RELAX_EVERY, RELAX_STEP = 20, 5, 0.02  # 14d: examples/potential_md.py's loop
RELAX_SPACING = 20  # 14d: molecules this many cutoffs apart along x


def state_digests(torch, state) -> list:
    """Each leaf of a train state in checkpoint order: a tensor's
    ``table_digest``, an int itself."""
    from repro_torch.train.checkpoint import flatten

    return [table_digest(torch, t) if isinstance(t, torch.Tensor) else t for t in flatten(state)]


def meta_like(torch, state):
    """``state``'s structure with each tensor a meta tensor of its shape."""
    from repro_torch.train.checkpoint import flatten, unflatten

    return unflatten(state, [torch.empty(t.shape, dtype=t.dtype, device="meta")
                             if isinstance(t, torch.Tensor) else t for t in flatten(state)])


def phase_loop_checkpoint(torch, dev, draw, aid, want):
    """14a. The loop and a full-width checkpoint (``train.loop.TrainLoop``,
    ``train.checkpoint``), on 13a's two-tower model: ``draw()`` gives (step,
    state drawn from seed 0, cfg, rows a step).  A ``TrainLoop`` runs
    ``LOOP_STEPS`` steps and its final sync save streams the state (44.5 GB
    of tables, the row accumulators, the towers and their moments) from the
    card into ``build/phase14a`` (the free disk checked first: too little
    fails with the numbers); the state is freed, seed 0 drawn afresh, and a
    second ``TrainLoop`` (``final_save=False``: the disk holds one such
    checkpoint) auto-resumes into the fresh draw's tensors in place and runs
    to step ``LOOP_RESUME_TO``.  Every leaf (each table's digest, the
    accumulators, the towers and their moments, the step) must equal 13a's
    first run at that step (``want``).  The save's and restore's seconds and
    GB/s, the fsync's seconds and the peak memory are printed; the directory
    is removed at the end."""
    import gc
    import shutil

    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig

    root = os.path.join(HERE, "build", "phase14a")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    try:
        torch.cuda.reset_peak_memory_stats()
        step, state, cfg, rows = draw()
        need = sum(t.numel() * t.element_size() for t in flatten(state)
                   if isinstance(t, torch.Tensor))
        free = shutil.disk_usage(root).free
        out["disk"] = {"free_gb": free / 1e9, "checkpoint_gb": need / 1e9}
        check(free > need + (2 << 30), f"14a: {free / 1e9:.2f} GB free under build/; the "
              f"checkpoint needs {need / 1e9:.2f} GB and 2 GiB of room")

        def batch_fn(i):
            return recsys_batch(aid, rows, cfg, step=i)

        common = dict(checkpoint_dir=root, checkpoint_every=1 << 30, keep_checkpoints=1,
                      log_every=1)
        first = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=LOOP_STEPS, **common))
        t0 = time.perf_counter()
        state, end = first.run(state)
        out["first_run_s"] = time.perf_counter() - t0
        check(end == LOOP_STEPS, f"14a: the first loop ended at {end}")
        st = first.ckpt.last_stats
        out["save"] = {**st, "gb": st["bytes"] / 1e9, "gb_per_s": st["bytes"] / st["seconds"] / 1e9}
        out["losses"] = [h["loss"] for h in first.history]
        del state, first
        gc.collect()
        torch.cuda.empty_cache()

        step, like, cfg, rows = draw()  # seed 0 afresh: the restore overwrites it in place
        ptrs = [t.data_ptr() for t in flatten(like) if isinstance(t, torch.Tensor)]
        second = TrainLoop(step, batch_fn, TrainLoopConfig(total_steps=LOOP_RESUME_TO,
                                                           final_save=False, **common))
        t0 = time.perf_counter()
        state, end = second.run(like)
        out["second_run_s"] = time.perf_counter() - t0
        rs = second.restore_stats
        out["restore"] = {**rs, "gb": rs["bytes"] / 1e9, "gb_per_s": rs["bytes"] / rs["seconds"] / 1e9}
        out["losses"] += [h["loss"] for h in second.history]
        check(end == LOOP_RESUME_TO and len(second.history) == LOOP_RESUME_TO - LOOP_STEPS,
              f"14a: the resumed loop ran {len(second.history)} steps to {end}")
        check([t.data_ptr() for t in flatten(state) if isinstance(t, torch.Tensor)] == ptrs,
              "14a: the restore did not fill the drawn tensors in place")
        got = state_digests(torch, state)
        check(got == want, "14a: the resumed state at step "
              f"{LOOP_RESUME_TO} differs from 13a's first run in leaves "
              f"{[j for j, (a, b) in enumerate(zip(got, want)) if a != b][:8]}")
        out["leaves_equal"] = len(got)
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        del state, like, second
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def coalesce_ab(torch, dev, rounds=4):
    """``train.optim.coalesce_rows`` (one stable sort of the ids) against the
    ``torch.unique`` + ``argsort`` form it replaced, on one step's lookups of
    the two-tower model's largest table at ``train_batch`` (65,536 ids of
    ``recsys_batch``, rows of its 256 columns): the two results equal bit
    for bit, each timed by CUDA events (median of 20 calls) in turns one,
    two, two, one."""
    from repro_torch.configs import registry as REG
    from repro_torch.core.segments import segment_sums
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.train.optim import RowGrad, coalesce_rows

    cfg = REG.get("two-tower-retrieval").full_config()
    rows_n = TRAIN_ROWS or 65536
    ids = torch.from_numpy(recsys_batch("two-tower-retrieval", rows_n, cfg, step=0)["user"][:, 0]
                           .astype(np.int64)).to(dev)
    rows = torch.randn((rows_n, cfg.embed_dim), generator=torch.Generator(dev).manual_seed(5),
                       device=dev)

    def two_sorts():
        uniq, inv = torch.unique(ids, return_inverse=True)
        order = torch.argsort(inv, stable=True)
        return RowGrad(uniq, segment_sums(rows[order], torch.bincount(inv, minlength=len(uniq))))

    a, b = coalesce_rows(ids, rows), two_sorts()
    check(torch.equal(a.ids, b.ids) and torch.equal(a.rows, b.rows),
          "coalesce: the one-sort and two-sort forms differ")
    ms = {"one_sort": [], "unique_argsort": []}
    for r in range(rounds):
        for name in (("one_sort", "unique_argsort") if r % 2 == 0
                     else ("unique_argsort", "one_sort")):
            fn = (lambda: coalesce_rows(ids, rows)) if name == "one_sort" else two_sorts
            ms[name].append(time_ms(torch, fn, reps=20, warmup=2))
    return {"lookups": rows_n, "unique_ids": len(a.ids), "row_cols": cfg.embed_dim,
            **{f"{k}_ms": statistics.median(v) for k, v in ms.items()}, "runs_ms": ms}


def edges_agree(pos, got_src, want_src, k, cutoff, tol=1e-4):
    """Hold a radius graph's sources ([n * k], slot j of row i the j-th
    neighbour of node i, a self-loop for none) against a brute force's:
    each row's set of neighbours equal, except ids at near-ties (a differing
    id's squared distance within ``tol`` relative of the row's k-th or of the
    cutoff's); returns the count of such ties."""
    n = len(pos)
    got, want = got_src.reshape(n, k), want_src.reshape(n, k)
    rows = np.nonzero((np.sort(got, 1) != np.sort(want, 1)).any(1))[0]
    ties = 0
    for i in rows:
        a, b = set(got[i].tolist()) - {i}, set(want[i].tolist()) - {i}
        if a == b:
            continue
        d2 = ((pos - pos[i]) ** 2).sum(1)
        d2[i] = np.inf
        bounds = (np.sort(d2)[k - 1], cutoff * cutoff)
        for j in a ^ b:
            check(min(abs(d2[j] - e) for e in bounds) <= tol * max(1.0, d2[j]),
                  f"14d: node {i}'s neighbour {j} (d^2 {d2[j]}) is no near-tie")
            ties += 1
    return ties


def phase_loop(torch, dev, run_path):
    """14. The training loop, the launcher and the NequIP potential.

    14b: BST at ``full_config()`` (0.89 GB of tables), ``ASYNC_STEPS`` steps
    of 65,536 rows through a ``TrainLoop`` with async saves every
    ``ASYNC_EVERY`` steps, ``ASYNC_KEEP`` kept: each kept step's restored
    bytes equal that step's digests, taken before the next in-place step.
    Then ``python -m repro_torch.launch.train --arch bst`` (``smoke_config``,
    the card) run whole beside a second run SIGKILLed after its first
    checkpoint and then rerun: the resumed losses in ``--metrics`` bit-equal
    to the whole run's at the same steps.
    14c: NequIP at ``full_config()`` on the ``molecule`` cell
    (``molecule_batch(128, 30, 64, n_species=64)``: 3,840 atoms, 8,192
    edges), ``NEQUIP_STEPS`` steps with ``NEQUIP_STEP``: the last loss below
    the first (the ratio printed beside the reference test's 0.7); 3 steps
    again from the same start byte-equal in every parameter; 3 steps on the
    CPU from that start within rtol 1e-4 and atol 1e-5.
    14d: ``examples/potential_md.py``'s relaxation at full width with 14c's
    trained params: the 128 molecules packed into one system,
    ``RELAX_SPACING`` cutoffs apart along x; ``RELAX_ITERS`` steepest-descent
    steps, the neighbour list rebuilt by ``radius_graph`` on the card every
    ``RELAX_EVERY`` (3,840 atoms, 12 neighbours, the fused kernel over each
    group at d 4), each rebuild's edges equal to a float64 brute force on
    the card except at near-ties (counted), the first rebuild's kernel
    launches each held against ``fused_knn_plain``.
    Then ``coalesce_ab``: the ``coalesce_rows`` A/B."""
    import shutil
    import signal

    from repro_torch.configs import registry as REG
    from repro_torch.data.graphs import molecule_batch, radius_graph
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.distributed import steps as ST
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import gnn as G
    from repro_torch.models.nn import split_params, tree_leaves, tree_map
    from repro_torch.train import optim as O
    from repro_torch.train.checkpoint import available_steps, latest_step, restore
    from repro_torch.train.loop import TrainLoop, TrainLoopConfig

    rules = make_rules(make_host_mesh(devices=[dev]))
    cpu = torch.device("cpu")
    cpu_rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[cpu]))
    root = os.path.join(HERE, "build", "phase14")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    # 14b. Async saves at full width.
    def async_saves():
        aid = "bst"
        arch = REG.get(aid)
        step, (spec, _) = arch.build(rules, "train_batch", step_config=ST.StepConfig(
            **TRAIN_STEP, micro_batches=TRAIN_MICRO[aid]))
        cfg = arch.full_config()
        values, _ = split_params(arch.init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))
        zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev)  # noqa: E731
        state = ST.TrainState(values, O.OptState(0, tree_map(zeros, spec.opt.m),
                                                 tree_map(zeros, spec.opt.v)))
        rows = TRAIN_ROWS or 65536
        digests = {}

        def watched(state, batch):
            return step(state, batch)

        def grads(state, batch):  # before the in-place step: the state a save took
            s = state.opt.step
            if s and s % ASYNC_EVERY == 0:
                digests[s] = state_digests(torch, state)
            return step.grads(state, batch)

        watched.grads, watched.update = grads, step.update
        ck = os.path.join(root, "async")
        loop = TrainLoop(watched, lambda i: recsys_batch(aid, rows, cfg, step=i), TrainLoopConfig(
            total_steps=ASYNC_STEPS, checkpoint_dir=ck, checkpoint_every=ASYNC_EVERY,
            keep_checkpoints=ASYNC_KEEP, log_every=1))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, end = loop.run(state)
        run_s = time.perf_counter() - t0
        digests[end] = state_digests(torch, state)
        kept = available_steps(ck)
        want_kept = list(range(ASYNC_STEPS, 0, -ASYNC_EVERY))[:ASYNC_KEEP][::-1]
        check(kept == want_kept, f"14b: kept steps {kept}, not {want_kept}")
        like = meta_like(torch, state)
        for s in kept:
            got, _, _ = restore(ck, like, step=s, device=dev)
            check(state_digests(torch, got) == digests[s],
                  f"14b: the checkpoint of step {s} differs from the state it saved")
            del got
        return {"steps": end, "kept": kept, "checked_steps": sorted(digests), "run_s": run_s,
                "step_dt_s": [h["dt_s"] for h in loop.history],
                "losses": [h["loss"] for h in loop.history],
                "last_save": loop.ckpt.last_stats, "peak_bytes": torch.cuda.max_memory_allocated()}

    out["async"] = counted("loop_async_bst", async_saves)
    say("loop_async_bst", out["async"])

    # 14b. The launcher, SIGKILLed after its first checkpoint and resumed.
    def launcher():
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "bst",
                "--steps", str(LAUNCHER_STEPS), "--checkpoint-every", str(LAUNCHER_EVERY),
                "--lr", "5e-3", "--device", dev.type]
        path = lambda name: os.path.join(root, name)  # noqa: E731
        t0 = time.perf_counter()
        whole = subprocess.Popen(base + ["--metrics", path("whole.jsonl")], env=env,
                                 stdout=subprocess.DEVNULL)
        cut = subprocess.Popen(base + ["--checkpoint-dir", path("ck"), "--metrics",
                                       path("cut.jsonl")], env=env, stdout=subprocess.DEVNULL)
        again = None
        try:
            while latest_step(path("ck")) is None and cut.poll() is None:
                time.sleep(0.005)
            cut.send_signal(signal.SIGKILL)
            check(cut.wait() == -signal.SIGKILL, "14b: the launcher ended before its checkpoint")
            first = latest_step(path("ck"))
            again = subprocess.Popen(base + ["--checkpoint-dir", path("ck"), "--metrics",
                                             path("again.jsonl")], env=env,
                                     stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            check(whole.wait(timeout=600) == 0, "14b: the whole launcher run failed")
            _, err = again.communicate(timeout=600)
            check(again.returncode == 0, f"14b: the resumed launcher failed: {err[-2000:]}")
        finally:
            for p in (whole, cut, again):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()

        def losses(name):
            return {r["step"]: r["loss"] for r in map(json.loads, open(path(name)))
                    if "loss" in r}

        want, got = losses("whole.jsonl"), losses("again.jsonl")
        check(got and min(got) > first and all(got[s] == want[s] for s in got),
              f"14b: the resumed losses differ from the whole run's: {got} {want}")
        check(latest_step(path("ck")) == LAUNCHER_STEPS, "14b: the resumed run's last save")
        return {"killed_after_step": first, "resumed_steps_compared": len(got),
                "seconds": time.perf_counter() - t0}

    out["launcher"] = counted("loop_launcher_kill_resume", launcher)
    say("loop_launcher_kill_resume", out["launcher"])

    # 14c. NequIP at full width on the molecule cell.
    arch = REG.get("nequip")
    cfg = arch.full_config()
    cell = {c.name: c for c in arch.shapes}["molecule"]
    n_mol = cell.params["batch"]
    mb = molecule_batch(n_mol, cell.params["n_nodes"] // n_mol,
                        cell.params["n_edges"] // n_mol, n_species=cfg.n_species, seed=0)
    check(len(mb["positions"]) == cell.params["n_nodes"]
          and len(mb["edges"][0]) == cell.params["n_edges"], "14c: the molecule cell's shape")
    start, _ = split_params(arch.init_params(cfg, cell, generator=torch.Generator(dev).manual_seed(0),
                                             device=dev))
    start = tree_map(lambda t: t.cpu(), start)
    loss, baxes = ST.gnn_potential_loss(cfg, n_graphs=n_mol)

    def on(where):
        return {k: (tuple(torch.from_numpy(x).to(where) for x in v) if isinstance(v, tuple)
                    else torch.from_numpy(v).to(where))
                for k, v in mb.items() if k != "n_graphs"}

    def train(where, r, n_steps, keep_at=None):
        step, _, _, opt = ST.make_train_step(loss, arch.abstract_params(cfg, cell), r, baxes,
                                             ST.StepConfig(**NEQUIP_STEP))
        state = ST.init_state(opt, tree_map(lambda t: t.to(where, copy=True), start))
        batch = on(where)
        losses, ms, kept = [], [], None
        for i in range(n_steps):
            t0 = synced() if where.type == "cuda" else time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            ms.append(((synced() if where.type == "cuda" else time.perf_counter()) - t0) * 1e3)
            if i + 1 == keep_at:
                kept = [t.clone() for t in tree_leaves(state.params)]
        return state, losses, ms, kept

    def nequip():
        torch.cuda.reset_peak_memory_stats()
        state, losses, ms, first3 = train(dev, rules, NEQUIP_STEPS, keep_at=3)
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"14c: the loss did not fall: {losses[0]} -> {losses[-1]}")
        peak = torch.cuda.max_memory_allocated()
        _, again, _, again3 = train(dev, rules, 3, keep_at=3)
        check(again == losses[:3] and all(torch.equal(a, b) for a, b in zip(again3, first3)),
              "14c: 3 steps again from the same start differ on the card")
        _, on_cpu, cpu_ms, cpu3 = train(cpu, cpu_rules, 3, keep_at=3)
        np.testing.assert_allclose(losses[:3], on_cpu, rtol=1e-4, atol=1e-5)
        errs = []
        for a, b in zip(first3, cpu3):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
            errs.append(float((a.cpu() - b).abs().max()))
        return state.params, {
            "atoms": len(mb["positions"]), "edges": len(mb["edges"][0]), "molecules": n_mol,
            "n_params": sum(t.numel() for t in tree_leaves(start)), "losses": losses,
            "last_over_first": losses[-1] / losses[0], "reference_test_asks": 0.7,
            "step_ms_first": ms[0], "step_ms_median": statistics.median(ms[1:]),
            "cpu_step_ms_median": statistics.median(cpu_ms), "repeat_byte_equal_leaves": len(first3),
            "cpu_max_abs_param_err": max(errs),
            "cpu_max_abs_loss_err": float(np.abs(np.subtract(losses[:3], on_cpu)).max()),
            "peak_bytes": peak}

    trained, out["nequip"] = counted("nequip_train", nequip)
    say("nequip_train", out["nequip"])

    # 14d. The relaxation at full width, the neighbour list on the card.
    offset = (mb["node_graph"].astype(np.float32) * np.float32(RELAX_SPACING * cfg.cutoff))
    pos0 = mb["positions"] + np.stack([offset, 0 * offset, 0 * offset], 1)
    species = torch.from_numpy(mb["node_input"]).to(dev)
    K_NB = 12

    def relax():
        pos = torch.from_numpy(pos0).to(dev)
        res = {"rebuild_ms": [], "ties": [], "energy": [], "max_abs_force": []}
        records = []
        orig = FK.fused_knn_partials

        def recorded(*a, **kw):
            got = orig(*a, **kw)
            records.append((a, kw, got))
            return got

        edges = None
        for it in range(RELAX_ITERS):
            if it % RELAX_EVERY == 0:
                if it == 0:
                    FK.fused_knn_partials = recorded
                try:
                    t0 = synced()
                    edges = radius_graph(pos, cutoff=cfg.cutoff, max_neighbors=K_NB)
                    res["rebuild_ms"].append((synced() - t0) * 1e3)
                finally:
                    FK.fused_knn_partials = orig
                p64 = pos.double()
                d2 = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
                d2.fill_diagonal_(float("inf"))
                bv, bi = torch.topk(d2, K_NB, dim=1, largest=False)
                n = len(p64)
                want = torch.where(bv <= cfg.cutoff ** 2, bi,
                                   torch.arange(n, device=dev)[:, None]).reshape(-1)
                del d2, bv, bi
                res["ties"].append(edges_agree(p64.cpu().numpy(), edges[0].long().cpu().numpy(),
                                               want.cpu().numpy(), K_NB, cfg.cutoff))
                res.setdefault("live_edges", []).append(
                    int((edges[0] != edges[1]).sum()))
            e, f = G.energy_and_forces(trained, pos, species, edges, cfg)
            res["energy"].append(float(e))
            res["max_abs_force"].append(float(f.abs().max()))
            pos = pos + RELAX_STEP * f
        check(bool(torch.isfinite(pos).all()) and all(np.isfinite(res["energy"])),
              "14d: the relaxation went non-finite")
        return res, records

    (out["relax"], records) = counted("nequip_relax", relax)
    check(out["launches"].get("fused_knn", 0) > 0, "14d: radius_graph launched no fused_knn")

    # The first rebuild's launches against the plain version, and their time.
    check(all(v.shape[0] == 1 for _, _, (v, _) in records),
          "14d: a group's call split its database axis (the hold below takes one set)")
    errs, ties, calls = [], 0, []
    bound = {"ops": 0.0, "bytes": 0.0}
    for a, kw, (v, i) in records:
        fx, gy, hx, hy, k = a
        plain_v, plain_i = FK.fused_knn_plain(fx, gy, hx, hy, k, alpha=kw["alpha"],
                                              finalize=kw["distance_finalize"],
                                              n_real=kw["n_real"],
                                              exclude_self=kw.get("exclude_self", False))
        c = check_topk(v[0], i[0], plain_v, plain_i, n=gy.shape[0], rtol=1e-5, atol=1e-4,
                       dist=operand_distance(fx, gy, hx, hy, alpha=kw["alpha"],
                                             finalize=kw["distance_finalize"]))
        errs.append(c["max_abs_err"])
        ties += c["swapped"] + c["cut_ties"]
        calls.append((a, kw))
        (m_, d_), n_, K_ = fx.shape, gy.shape[0], v.shape[-1]
        bound["ops"] += 2.0 * m_ * n_ * d_
        bound["bytes"] += (m_ + n_) * d_ * 4 + (m_ + n_) * 4 + m_ * K_ * 8
    k_ms = time_ms(torch, lambda: [FK.fused_knn_partials(*a, **kw) for a, kw in calls])
    p_ms = time_ms(torch, lambda: [FK.fused_knn_plain(
        *a, alpha=kw["alpha"], finalize=kw["distance_finalize"], n_real=kw["n_real"],
        exclude_self=kw.get("exclude_self", False)) for a, kw in calls])
    out["relax"]["fused_knn_hold"] = {
        "calls": len(records), "max_abs_err": max(errs), "near_ties": ties, "ms": k_ms,
        "plain_ms": p_ms, **mm_bound(bound["ops"], bound["bytes"]), "library_ms": None,
        "shape": f"{len(records)} groups, {records[0][0][0].shape[0]} x "
                 f"{records[0][0][1].shape[0]} each, d {records[0][0][0].shape[1]} (3 padded), "
                 f"K {records[0][2][0].shape[-1]}"}
    del records, calls
    say("nequip_relax", out["relax"])

    out["coalesce"] = coalesce_ab(torch, dev)
    say("coalesce_rows_ab", out["coalesce"])
    shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    say("loop_phase", {"seconds": out["phase_s"], "launches": out["launches"]})
    return out


LM_PROMPT = 4096  # 15a: two prompts of this many tokens (the train_4k cell's seq_len)
LM_DECODE = 8  # 15a-b: greedy decode steps
LM_HOLD = (512, 8, 768)  # 15a.3: prompt, decode steps, forward length (2 x 768: 3 routing groups)
LM_LAYER_ROWS = 256  # 15a.4: tokens a row of layer 0's input, two rows
LM_SWA_PROMPT = 6144  # 15b: one prompt past h2o-danube-3-4b's window of 4096
LM_TRAIN = dict(peak_lr=1e-3, warmup_steps=1, total_steps=20)  # 15c's 3 steps
LM_FLOOR_STEPS = 4  # 15a-b: steps of the noise floor's decode
# The holds of phase 15 on decoded logits, each step's error relative to its
# largest |logit| (bf16 logits: an ulp is 2^-8 of a value): (the most any
# step may be off, the most the median step may be).  The sequence-parallel
# decode sums the same terms in another order, and prefill + decode against
# ``forward`` runs other shapes, so other summation orders.  At full width
# the random model is chaotic in bf16: any such order moves the logits by
# 2-5% of the largest (on an H100 80GB HBM3 at 700 W), and a token whose
# router scores sit at a tie takes another expert.  So the exact check of
# each path is made before the bf16 rounding (``LM_MERGE_TOL``: the merged
# accumulators of the sequence-parallel attention against one
# ``flash_mlo`` over the whole cache, in fp32), and the logits are held to
# the noise floor, which each run also measures (the plain decode with the
# whole cache as one chunk against chunks of ``kv_chunk``).  A wrong slot,
# position or mask is off at every step, by far more.
LM_TOL = (0.15, 0.08)
LM_MERGE_TOL = 1e-5


class RouterLaunches:
    """While active, record every call of ``stream_topk``'s wrapper (its
    input, K and result): the MoE router's launches, held against the plain
    version afterwards."""

    def __init__(self):
        from repro_torch.kernels import stream_topk as ST

        self.mod, self.records = ST, []

    def __enter__(self):
        self.orig = self.mod.stream_topk

        def wrap(x, k, **kw):
            got = self.orig(x, k, **kw)
            self.records.append((x, k, got))
            return got

        self.mod.stream_topk = wrap
        return self

    def __exit__(self, *exc):
        self.mod.stream_topk = self.orig

    def hold(self, torch):
        """Each record's ids and values equal to ``stream_topk_plain``'s; the
        records are dropped once held.  Returns how many were held."""
        for x, k, (v, i) in self.records:
            pv, pi = self.mod.stream_topk_plain(x, k)
            check(torch.equal(i, pi) and torch.equal(v, pv),
                  f"router stream_topk {tuple(x.shape)} k {k}: kernel and plain differ")
        n, self.records = len(self.records), []
        return n


def phase_lm(torch, dev, run_path):
    """15. The language models (``models.attention``, ``models.moe``,
    ``models.transformer``, the LM steps of ``distributed.steps``,
    ``launch.train --preset lm100m``).

    15a: qwen3-moe-30b-a3b at ``full_config()`` (48 layers, d_model 2048,
    32 heads over 4 KV heads, QK-norm, 128 experts top-8, vocab 151,936),
    drawn from seed 0 on the card (30.5e9 parameters, 61.1 GB).  (1) 2
    prompts of ``LM_PROMPT`` tokens (``lm_batch(2, 4096, vocab, seed=0)``)
    prefilled twice into one cache (the first run's router launches
    recorded), then ``LM_DECODE`` greedy decode steps, each fed the argmax
    of the step before (the first step's router launches recorded).  (2) The
    same steps, fed the same tokens, through ``make_lm_decode_step(
    seq_parallel=True)`` on a (1, 4) mesh of the card, from a clone of the
    prefilled cache: first its attention of layer 0 in fp32 against one
    ``flash_mlo`` over the whole cache (``LM_MERGE_TOL``), then the logits
    held against the plain decode's by ``LM_TOL`` (each step's error over
    its largest |logit|: the worst step, the median step), beside the
    noise floor (the plain decode with the whole cache as one chunk,
    ``LM_FLOOR_STEPS`` steps), the greedy tokens compared and any that
    differ reported.  (3) At ``capacity_factor`` E / K = 16 (a group's capacity is
    the group: no token drops in either mode): a prefill of 2 x 512 tokens
    and 8 decode steps against ``forward`` over 2 x 768 tokens at the
    decoded positions, by ``LM_TOL``.  (4) Layer 0's drawn weights
    copied to the host: ``layer_forward`` on the same 2 x 256 bf16 hidden
    states on the card and on the CPU, allclose (rtol 2^-6, atol 2^-6 of
    the largest |y|) on every token whose kept experts are the same on
    both; the tokens that keep other experts (a router tie broken apart by
    the last bits, or a capacity overflow it moved) reported, at most 2 in
    100.  (5) Every recorded router launch held against
    ``stream_topk_plain`` on the same scores: ids and values equal.
    (6) Prefill ms and tokens/s, decode ms a step (first, median) plain and
    sequence-parallel, beside the bound: every weight's bytes over 3.35
    TB/s (the GShard dispatch touches every expert each step); the peak
    memory; the router's ``stream_topk`` at the prefill's [8192, 128], k 8,
    beside ``torch.topk`` and its plain version.
    15b: h2o-danube-3-4b at ``full_config()`` (7.92 GB), one prompt of
    ``LM_SWA_PROMPT`` tokens (the ring of 4,096 keeps the last 4,096,
    rolled), ``LM_DECODE`` greedy steps held against ``forward`` over the
    whole sequence at the decoded positions, and the sequence-parallel
    decode on the (1, 4) mesh against the plain one, as in 15a; the same
    times, bound and peak.
    15c: each of the five LMs at ``smoke_config()`` drawn once on the CPU:
    a prefill of 2 x 16 tokens, 8 decode steps and 3 train steps
    (``lm_loss``, ``make_train_step``, ``LM_TRAIN``) on the card and on the
    CPU: logits within 1e-4 (dense) or 5e-3 (the MoE's bf16 expert path),
    losses within rtol 1e-4, params within 2e-5 (dense) or 6 lr with 99 in
    100 of each leaf within lr / 16 (the MoE, as the CPU tests hold it);
    then ``launch.train --preset lm100m --steps 20 --batch 4 --seq-len 128
    --device cuda`` in process: losses finite, the last below the first.
    Phase 15 must launch ``stream_topk`` (the MoE router of 15a and 15c).
    A rehearsal on the CPU shrinks it by replacing the archs'
    ``full_config`` and the ``LM_*`` sizes."""
    import dataclasses
    import gc

    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import stream_topk as ST
    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import split_params, tree_leaves, tree_map

    cpu = torch.device("cpu")
    rules = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
    sp_rules = make_rules(make_mesh((1, 4), ("data", "model"), devices=[dev] * 4))
    t_phase = time.perf_counter()
    out = {"launches": {}}

    def counted(label, fn):
        res, counts = run_path(label, fn)
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
        return res

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    def tokens(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def weights(cfg):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = synced()
        values = split_params(Tr.init_params(
            cfg, generator=torch.Generator(dev).manual_seed(0), device=dev))[0]
        draw_s = synced() - t0
        leaves = tree_leaves(values)
        qk_norms = 2 * cfg.head_dim * cfg.n_layers if cfg.use_qk_norm else 0  # not in n_params
        check(sum(t.numel() for t in leaves) == cfg.n_params + qk_norms,
              f"drawn {sum(t.numel() for t in leaves)} parameters, n_params {cfg.n_params}")
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        return values, {"draw_s": draw_s, "n_params": cfg.n_params, "param_bytes": nbytes,
                        "decode_bound_ms": nbytes / PEAK_HBM * 1e3}

    def decode(step, values, cache, first, n, feed=None, record=None):
        """``n`` decode steps from ``first`` [B]: greedy, or fed ``feed[i]``
        at step i; returns (the logits of each step on the host, the tokens
        fed, each step's ms)."""
        logits, fed, ms = [], [], []
        tok = first
        for i in range(n):
            tok = feed[i] if feed is not None else tok
            fed.append(tok)
            t0 = synced()
            if record is not None and i == 0:
                with record:
                    lg, cache = step(values, cache, tok)
            else:
                lg, cache = step(values, cache, tok)
            ms.append((synced() - t0) * 1e3)
            logits.append(lg.float().cpu())
            tok = lg.argmax(-1).to(torch.int32)
        return logits, fed, ms

    held = _lm_held

    def serving(values, cfg, prompt, label, record=None):
        """Prefill (twice) and ``LM_DECODE`` greedy steps, then the same
        steps sequence-parallel from a clone of the prefilled cache."""
        B, S = prompt.shape
        abstract = Tr.abstract_params(cfg)
        cache = Tr.init_cache(cfg, B, S + LM_DECODE, device=dev)
        prefill = STP.make_lm_prefill_step(cfg, rules, abstract)[1](prompt, cache)
        res = {"prompt": [B, S], "cache_bytes": 2 * cache.k.numel() * cache.k.element_size(),
               "cache_slots": cache.k.shape[2]}
        ms = []
        for rep in range(2):
            t0 = synced()
            if rep == 0 and record is not None:
                with record:
                    lg, cache = prefill(values, prompt, cache)
            else:
                lg, cache = prefill(values, prompt, cache)
            ms.append((synced() - t0) * 1e3)
        check(bool(torch.isfinite(lg.float()).all()) and lg.shape == (B, cfg.vocab),
              f"{label}: prefill logits")
        prefill_logits = lg.float().cpu()
        check(cache.pos.tolist() == [S] * B, f"{label}: the cache's positions")
        res.update(prefill_ms=ms, prefill_tokens_per_s=B * S / (ms[1] / 1e3))
        sp_cache, floor_cache = cache.clone(), cache.clone()
        first = lg.argmax(-1).to(torch.int32)
        sp_step = STP.make_lm_decode_step(cfg, sp_rules, abstract, seq_parallel=True)[1](
            sp_cache, first)
        # The sequence-parallel attention of layer 0, in fp32, against one
        # flash_mlo over the whole prefilled cache.
        with torch.no_grad():
            lp = Tr.layer_params(values["layers"], 0)
            h = Tr._rms(Tr._embed_tokens(values, first[:, None], cfg), lp["ln1"], cfg.norm_eps)
            q = Tr._qkv(lp, h, cfg, cache.pos[:, None])[0].float()
            want = A.decode_attention_layer(q, cache.k[0], cache.v[0], cache.pos,
                                            window=cfg.sliding_window, kv_chunk=cfg.kv_chunk,
                                            logits_soft_cap=cfg.logits_soft_cap)
            got = sp_step.attn_fn(q, cache.k[0], cache.v[0], cache.pos)
        merge_err = float((got - want).abs().max()) / float(want.abs().max())
        check(merge_err <= LM_MERGE_TOL, f"{label}: the sequence-parallel attention of layer 0 "
              f"off one flash_mlo by {merge_err} of its largest value")
        res["sp_attention_fp32_rel_err"] = merge_err
        step = STP.make_lm_decode_step(cfg, rules, abstract)[1](cache, first)
        plain, fed, ms = decode(step, values, cache, first, LM_DECODE, record=record)
        check(all(bool(torch.isfinite(x).all()) for x in plain), f"{label}: decode logits")
        res.update(decode_ms_first=ms[0], decode_ms_median=statistics.median(ms[1:]),
                   decode_ms=ms)
        # The noise floor: the plain decode with the whole cache as one chunk.
        one = dataclasses.replace(cfg, kv_chunk=floor_cache.k.shape[2])
        floor_step = STP.make_lm_decode_step(one, rules, abstract)[1](floor_cache, first)
        floor, _, _ = decode(floor_step, values, floor_cache, first, LM_FLOOR_STEPS, feed=fed)
        errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(floor, plain)]
        res["noise_floor_one_chunk"] = {"max": max(errs), "median": statistics.median(errs),
                                        "per_step": errs}
        del floor_cache
        sp, _, sp_ms = decode(sp_step, values, sp_cache, first, LM_DECODE, feed=fed)
        differ = [(i, b) for i in range(LM_DECODE) for b in range(B)
                  if int(sp[i][b].argmax()) != int(plain[i][b].argmax())]
        res.update(sp_decode_ms_first=sp_ms[0], sp_decode_ms_median=statistics.median(sp_ms[1:]),
                   sp_vs_plain=held(sp, plain, f"{label}: the sequence-parallel decode"),
                   sp_greedy_tokens_differ=differ)
        seq = torch.cat([prompt] + [t[:, None] for t in fed], dim=1)  # the tokens fed, in order
        return res, seq, plain, {"prefill": prefill_logits, "decode": plain, "fed": fed}

    # 15a. qwen3-moe-30b-a3b at full width.
    cfg = REG.get("qwen3-moe-30b-a3b").full_config()
    values, qa = weights(cfg)
    say("lm_qwen3_weights", qa)
    record = RouterLaunches()
    prompt = tokens(lm_batch(2, LM_PROMPT, cfg.vocab, seed=0)["tokens"])
    (res, _, _, whole_15a) = counted("lm_qwen3_serving", lambda: serving(
        values, cfg, prompt, "15a", record=record))
    qa.update(res)
    say("lm_qwen3_serving", res)
    check(len(record.records) == 2 * cfg.n_layers,
          f"15a: {len(record.records)} router launches recorded, not 2 x {cfg.n_layers}")
    x_router = next(x for x, _, _ in record.records if x.shape[0] > 2)
    qa["router_launches_held"] = record.hold(torch)
    router = {"shape": f"{x_router.shape[0]} x {x_router.shape[1]}, k {cfg.moe.top_k} "
                       f"(the router at the prefill: -probs of {x_router.shape[0]} tokens)"}
    router["ms"] = time_ms(torch, lambda: ST.stream_topk(x_router, cfg.moe.top_k), reps=20)
    router["graph_ms"] = graph_ms(torch, lambda: ST.stream_topk(x_router, cfg.moe.top_k))
    router["plain_ms"] = time_ms(torch, lambda: ST.stream_topk_plain(x_router, cfg.moe.top_k),
                                 reps=20)
    router["library_ms"] = time_ms(torch, lambda: torch.topk(x_router, cfg.moe.top_k, dim=1,
                                                             largest=False), reps=20)
    router["library_graph_ms"] = graph_ms(torch, lambda: torch.topk(
        x_router, cfg.moe.top_k, dim=1, largest=False))
    m_r, n_r = x_router.shape
    router["bound_ms"], router["bound_by"] = bound_ms(1.0 * m_r * n_r,
                                                      m_r * n_r * 4 + m_r * cfg.moe.top_k * 8)
    kv, ki = ST.stream_topk(x_router, cfg.moe.top_k)
    pv, pi = ST.stream_topk_plain(x_router, cfg.moe.top_k)
    check(torch.equal(ki, pi), "the router's stream_topk: ids differ from the plain version")
    router["max_abs_err"] = float((kv - pv).abs().max())
    out["router"] = router
    del record, x_router, kv, ki, pv, pi
    say("lm_router_stream_topk", router)

    # 15a.3: prefill + decode against forward.  At capacity factor E / K
    # (16) a routing group's capacity is the group, so no token drops in
    # either mode; at the reference test's 8 (where its smoke config's
    # capacity is the group) the full config's is half the group, and the
    # random router sends most tokens to a few experts (a rehearsal dropped
    # 10-25% of the choices).
    cap = cfg.moe.n_experts / cfg.moe.top_k
    cfg_all = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    n_pre, n_dec, n_fwd = LM_HOLD

    def hold_forward():
        seq = tokens(lm_batch(2, n_fwd, cfg.vocab, seed=1)["tokens"])
        cache = Tr.init_cache(cfg_all, 2, n_pre + n_dec, device=dev)
        Tr.prefill(values, seq[:, :n_pre], cfg_all, cache)
        got = []
        for t in range(n_pre, n_pre + n_dec):
            got.append(Tr.decode_step(values, cache, seq[:, t], cfg_all)[0].float().cpu())
        with torch.no_grad():
            full, _ = Tr.forward(values, seq, cfg_all)
        want = [full[:, t].float().cpu() for t in range(n_pre, n_pre + n_dec)]
        return {"capacity_factor": cap, **held(got, want, "15a: prefill + decode against forward")}

    qa["decode_vs_forward"] = counted("lm_qwen3_vs_forward", hold_forward)
    say("lm_qwen3_vs_forward", qa["decode_vs_forward"])

    # 15a.4: layer 0 at full width on the card and on the CPU.  A token
    # whose router scores sit at a tie that the two devices' last bits
    # break apart takes another expert on one of them, and so can change
    # which later choice overflows an expert's capacity (token order, then
    # choice order): a token whose kept experts differ is reported, not
    # held; every other token is held.
    def hold_layer():
        lp = Tr.layer_params(values["layers"], 0)
        lp_host = tree_map(lambda t: t.to(cpu), lp)
        g = np.random.default_rng(2)
        x = torch.from_numpy(g.standard_normal((2, LM_LAYER_ROWS, cfg.d_model), np.float32))
        x = x.to(torch.bfloat16)
        pos = torch.arange(LM_LAYER_ROWS, dtype=torch.int32)[None].expand(2, -1)
        with torch.no_grad(), RouterLaunches() as on_dev:
            got = Tr.layer_forward(lp, x.to(dev), pos.to(dev), cfg)[0].float().cpu()
        with torch.no_grad(), RouterLaunches() as on_cpu:
            t0 = time.perf_counter()
            want = Tr.layer_forward(lp_host, x, pos, cfg)[0].float()
            cpu_s = time.perf_counter() - t0
        C = M.capacity(cfg.moe, 2 * LM_LAYER_ROWS)  # one routing group of the 512 tokens
        kept = []
        for r in (on_dev, on_cpu):
            ids = r.records[0][2][1].cpu().long()[None]  # [1, tokens, 8], in choice order
            _, keep = M.expert_slots(ids, cfg.moe.n_experts, C)
            kept.append(torch.where(keep, ids, -1)[0].sort(-1).values)
        same = (kept[0] == kept[1]).all(-1).reshape(2, LM_LAYER_ROWS)
        scale = float(want.abs().max())
        diff = (got - want).abs()
        err = float(diff[same].max())
        check(bool((diff[same] <= 2 ** -6 * (want[same].abs() + scale)).all()),
              f"15a: layer 0 on the card off the CPU's by {err} (largest |y| {scale})")
        flips = int((~same).sum())
        check(flips <= 0.02 * same.numel(), f"15a: {flips} of {same.numel()} tokens kept "
              "other experts on the card than on the CPU")
        return {"max_abs_err": err, "largest_abs_y": scale, "cpu_s": cpu_s,
                "tokens_keeping_other_experts": flips,
                "their_max_abs_err": float(diff[~same].max()) if flips else None,
                "host_copy_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(lp))}

    qa["layer0_vs_cpu"] = counted("lm_qwen3_layer0", hold_layer)
    qa["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["qwen3"] = qa
    say("lm_qwen3", qa)

    # 18a. The same model on a (1, 4) mesh of the card: 15a's params cut in
    # place, its prompts, its tokens fed, held against its logits.
    out18 = {"launches": {}}

    def counted18(label, fn):
        res_, counts = run_path(label, fn)
        for name, count in counts.items():
            out18["launches"][name] = out18["launches"].get(name, 0) + count
        return res_

    out18["qwen3"] = counted18("sharded_lm_qwen3", lambda: sharded_lm_qwen3(
        torch, dev, values, cfg, prompt, whole_15a,
        {k: qa[k] for k in ("prefill_tokens_per_s", "decode_ms_first", "decode_ms_median",
                            "sp_decode_ms_first", "sp_decode_ms_median", "decode_bound_ms",
                            "noise_floor_one_chunk", "peak_bytes")}))
    say("sharded_lm_qwen3", out18["qwen3"])
    del whole_15a
    del values
    gc.collect()
    torch.cuda.empty_cache()

    # 15b. h2o-danube-3-4b at full width: decode past the window.
    cfg = REG.get("h2o-danube-3-4b").full_config()
    values, hb = weights(cfg)
    prompt = tokens(lm_batch(1, LM_SWA_PROMPT, cfg.vocab, seed=0)["tokens"])
    res, seq, plain, _ = counted("lm_h2o_serving", lambda: serving(values, cfg, prompt, "15b"))
    hb.update(res)
    say("lm_h2o_serving", res)
    check(hb["cache_slots"] == min(cfg.sliding_window, LM_SWA_PROMPT + LM_DECODE),
          "15b: the ring's capacity")

    def hold_forward_swa():
        with torch.no_grad():
            full, _ = Tr.forward(values, seq, cfg)
        want = [full[:, S].float().cpu() for S in range(LM_SWA_PROMPT, seq.shape[1])]
        return held(plain, want, "15b: the decode past the window against forward")

    hb["decode_vs_forward"] = counted("lm_h2o_vs_forward", hold_forward_swa)
    hb["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["h2o"] = hb
    say("lm_h2o", hb)

    # 18b. The same model on a (2, 2) mesh of the card: FSDP over "data".
    out18["h2o"] = counted18("sharded_lm_h2o", lambda: sharded_lm_h2o(torch, dev, values, cfg))
    say("sharded_lm_h2o", out18["h2o"])
    del values, seq, plain
    gc.collect()
    torch.cuda.empty_cache()

    # 15c. The five LMs at smoke_config(): the card against the CPU; the launcher.
    def smoke(aid):
        arch = REG.get(aid)
        scfg = arch.smoke_config()
        start = split_params(arch.init_params(scfg, generator=torch.Generator().manual_seed(0),
                                              device="cpu"))[0]
        toks = lm_batch(2, 24, scfg.vocab, seed=4)["tokens"]
        batches = [lm_batch(4, 32, scfg.vocab, seed=5, step=i) for i in range(3)]

        def run(d):
            v = tree_map(lambda t: t.to(d, copy=True), start)
            cache = Tr.init_cache(scfg, 2, 24, device=d)
            t = torch.from_numpy(toks).to(d)
            lg = [Tr.prefill(v, t[:, :16], scfg, cache)[0].float().cpu()]
            for i in range(16, 24):
                lg.append(Tr.decode_step(v, cache, t[:, i], scfg)[0].float().cpu())
            r = make_rules(make_mesh((1, 1), ("data", "model"), devices=[d]))
            loss, baxes = STP.lm_loss(scfg)
            step, _, _, opt = STP.make_train_step(loss, arch.abstract_params(scfg), r, baxes,
                                                  STP.StepConfig(**LM_TRAIN))
            state = STP.init_state(opt, v)
            losses = []
            for b in batches:
                state, m = step(state, {k: torch.from_numpy(x.copy()).to(d) for k, x in b.items()})
                losses.append(float(m["loss"]))
            return lg, losses, [x.float().cpu() for x in tree_leaves(state.params)]

        want, got = run(cpu), run(dev)
        moe = scfg.moe is not None
        lerr = max(float((a - b).abs().max()) for a, b in zip(got[0], want[0]))
        check(lerr <= (5e-3 if moe else 1e-4), f"15c {aid}: logits off the CPU's by {lerr}")
        check(np.allclose(got[1], want[1], rtol=1e-4, atol=0), f"15c {aid}: losses {got[1]} "
              f"against the CPU's {want[1]}")
        perr, lr = 0.0, LM_TRAIN["peak_lr"]
        for a, b in zip(got[2], want[2]):
            d = (a - b).abs()
            perr = max(perr, float(d.max()))
            if moe:
                check(float(d.max()) <= 6 * lr and float(d.flatten().quantile(0.99)) < lr / 16,
                      f"15c {aid}: params off the CPU's by {float(d.max())}")
            else:
                check(bool((d <= 2e-5 + 1e-5 * b.abs()).all()),
                      f"15c {aid}: params off the CPU's by {float(d.max())}")
        return {"max_abs_logit_err": lerr, "losses": got[1], "cpu_losses": want[1],
                "max_abs_param_err": perr}

    out["smoke"] = {aid: counted(f"lm_smoke_{aid}", lambda aid=aid: smoke(aid))
                    for aid in ("h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b",
                                "qwen3-moe-30b-a3b")}
    say("lm_smoke", out["smoke"])

    def launcher():
        path = os.path.join(HERE, "build", "phase15_lm100m.jsonl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            os.remove(path)
        t0 = time.perf_counter()
        rc = LT.main(["--preset", "lm100m", "--steps", "20", "--batch", "4", "--seq-len", "128",
                      "--device", str(dev.type), "--metrics", path])
        wall = time.perf_counter() - t0
        losses = [r["loss"] for r in map(json.loads, open(path)) if "loss" in r]
        os.remove(path)
        check(rc == 0 and losses and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"15c: the lm100m launcher's losses {losses}")
        return {"seconds": wall, "first_loss": losses[0], "last_loss": losses[-1],
                "logged": len(losses)}

    out["launcher"] = counted("lm_launcher", launcher)
    say("lm_launcher", out["launcher"])
    check(out["launches"].get("stream_topk", 0) > 0,
          f"phase 15 never launched stream_topk: {out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    say("lm_phase", {"seconds": out["phase_s"], "launches": out["launches"]})
    out["phase18"] = out18
    return out


# ---------------------------------------------------------------------------
# 16. The dry run's shape paths against the kernels, the dry run against the
# card, and the int8 error-feedback all-reduce on a mesh of the card.
# ---------------------------------------------------------------------------

DRY_TOWER_MICRO = 8  # 16b: phase 13's two-tower micro-batches
COMPRESS_MESH = 4  # 16c: positions of the (4,) mesh on the card
COMPRESS_REPS = 10  # 16c: timed calls
COMPRESS_GATE = 0.05  # 16c: the reference's gate (tests/test_distributed_knn.py:149)


def shape_cases(torch, dev):
    """name -> (wrapper call, its operands on ``dev``): each kernel of the
    ``kernels`` line at a shape the script launches (phase 4's serving
    batch and its merge, the symmetric path's 512-row tile, phase 3b's
    Hellinger block, the router at 15a's prefill, phase 5's rescore, phases
    6-7's 1024 queries in union tiles of 256 over ``IVF_CELLS`` cells of 512
    slots, nprobe 8).
    The probe lists are drawn (distinct ascending cells, each whole): only
    the shapes matter here."""
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import ivf_scan as IVS
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import pairwise_distance as PD
    from repro_torch.kernels import pq_scan as PQS
    from repro_torch.kernels import rescore as RS
    from repro_torch.kernels import stream_topk as ST

    g = torch.Generator(dev).manual_seed(16)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    n, d, m = QUERY_ROWS, 256, 1024
    ncells, cap, tile_m = IVF_CELLS, 512, 256
    S = ncells * cap
    nt, W = m // tile_m, min(tile_m * 8, ncells)
    # Union lists as the index builds them: distinct cells in ascending order.
    probes = torch.stack([torch.sort(torch.randperm(ncells, generator=g, device=dev)[:W]).values
                          for _ in range(nt)]).int()
    extent = torch.full((ncells,), cap, dtype=torch.int32, device=dev)
    part = torch.sort(r(16, m, 16), dim=-1).values
    return {
        "fused_knn": (lambda a: FK.fused_knn(*a, 10, distance_finalize="identity", alpha=-1.0,
                                             n_real=n),
                      (r(m, d), r(n, d), r(m, 1), r(1, n))),
        "merge_partials": (lambda a: MP.merge_partials(*a),
                           (part, torch.randint(0, n, part.shape, generator=g, device=dev,
                                                dtype=torch.int32))),
        "pairwise_distance": (lambda a: PD.pairwise_distance(*a, alpha=-2.0,
                                                             finalize="identity"),
                              (r(512, d), r(512, d), r(512, 1), r(1, 512))),
        "pairwise_cumulative": (lambda a: PD.pairwise_distance_cumulative(
            *a, accumulate="hellinger", finalize="half_sqrt"),
            (r(1024, d).abs(), r(16384, d).abs())),
        "stream_topk": (lambda a: ST.stream_topk(*a, 8), (r(8192, 128),)),
        "rescore_topk": (lambda a: RS.rescore_topk(*a, 10, alpha=-2.0, finalize="identity"),
                         (r(m, d), r(m, 64, d), r(m, 1), r(m, 64))),
        "ivf_scan_table": (lambda a: IVS.build_table(*a, cap, 8), (probes, extent)),
        "ivf_scan": (lambda a: IVS.ivf_scan(a[0], *a[1:5], 64, cell_cap=cap, tile_m=tile_m,
                                            cell_extent=a[5], distance_finalize="identity",
                                            alpha=-2.0),
                     (probes, r(m, d), r(S, d), r(m, 1), r(1, S), extent)),
        "pq_scan": (lambda a: PQS.pq_scan(a[0], *a[1:5], 128, cell_cap=cap, ncodes=256,
                                          tile_m=tile_m, cell_extent=a[5],
                                          distance_finalize="identity"),
                    (probes, r(m, PQ_M * 256),
                     torch.randint(0, 256, (S, PQ_M), generator=g, device=dev,
                                   dtype=torch.uint8), r(m, 1), r(1, S), extent)),
    }


def phase_dryrun(torch, dev, measured):
    """16. ``launch/dryrun.py``, ``launch/hlo_stats.py`` and
    ``train/compression.py`` on the card's machine.

    16a (a gate): each wrapper of the ``kernels`` line at a shape the
    script launches (``shape_cases``), on the card and on meta tensors:
    the meta outputs' shapes and dtypes are the card's, and the meta call
    launches nothing.  16b (printed, not a gate): the dry run's counters
    (``dryrun.trace_step``) over qwen3-moe-30b-a3b's prefill of 2 x
    ``LM_PROMPT`` tokens into 15a's cache, and over the two-tower train step
    at ``train_batch`` and ``DRY_TOWER_MICRO`` micro-batches, on one meta
    position, beside ``measured``: 15a's and 13a's peaks and times.  16c (a
    gate): ``compressed_psum_tree`` on a (``COMPRESS_MESH``,) mesh of the
    card over DLRM-RM2's ``full_config()`` dense leaves (every leaf but the
    tables), drawn per position from seeds 0-3 on the host: every leaf
    within ``COMPRESS_GATE`` of the fp32 sum, sums and residuals equal to
    the CPU's on the same draws; the median ms a call of
    ``COMPRESS_REPS`` and the wire bytes beside an fp32 ring's."""
    from repro_torch.configs import registry as REG
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import _backend as B
    from repro_torch.launch import hlo_stats
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.launch.mesh import Mesh, make_mesh
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import split_params, tree_leaves
    from repro_torch.train.compression import compressed_psum_tree

    t_phase = time.perf_counter()
    out = {}

    # 16a. The shape paths against the kernels.
    shapes = {}
    for name, (call, args) in shape_cases(torch, dev).items():
        got = call(args)
        torch.cuda.synchronize()
        want = [(list(t.shape), str(t.dtype)) for t in (got if isinstance(got, tuple) else (got,))]
        del got
        with B.shape_calls() as calls:
            meta = call(tuple(torch.empty_like(t, device="meta") for t in args))
        have = [(list(t.shape), str(t.dtype)) for t in (meta if isinstance(meta, tuple) else (meta,))]
        check(have == want, f"16a: {name} on meta gives {have}, on the card {want}")
        check([c[0] for c in calls] == [name], f"16a: {name}'s meta call recorded {calls}")
        shapes[name] = {"card": want, "meta": have, "flops": calls[0][1], "bytes": calls[0][2]}
        del args
    out["shape_paths"] = shapes
    say("dryrun_shape_paths", shapes)
    torch.cuda.empty_cache()

    # 16b. The dry run's counters over two steps the script ran on the card.
    one = Mesh((1, 1), ("data", "model"), [torch.device("meta")], streams=False)
    rules = make_rules(one)
    arch = REG.get("qwen3-moe-30b-a3b")
    cfg = arch.full_config()
    abstract = arch.abstract_params(cfg)
    values, _ = split_params(abstract)
    tokens = torch.empty((2, LM_PROMPT), dtype=torch.int32, device="meta")
    cache = Tr.init_cache(cfg, 2, LM_PROMPT + LM_DECODE, device="meta")
    step = STP.make_lm_prefill_step(cfg, rules, abstract)[1](tokens, cache)
    traced = {"qwen3_prefill": trace_step(step, (values, tokens, cache), rules, None)}
    tower = REG.get("two-tower-retrieval")
    sc = STP.StepConfig(**TRAIN_STEP, micro_batches=DRY_TOWER_MICRO)
    fn, args = tower.build(rules, "train_batch", step_config=sc)
    traced["two_tower_train"] = trace_step(fn, args, rules, None)
    del values, cache, args
    for key, card in (("qwen3_prefill", measured["qwen3_prefill"]),
                      ("two_tower_train", measured["two_tower_train"])):
        rec = traced[key]
        row = {k: rec[k] for k in ("trace_s", "flops", "bytes_accessed", "transcendentals",
                                   "peak_memory_in_bytes_unsharded", "kernel_calls")}
        row["ops"] = sum(rec["op_counts"].values())
        row["card"] = card
        if card.get("ms"):
            row["card_tflop_s"] = rec["flops"] / (card["ms"] / 1e3) / 1e12
        out[key] = row
        say(f"dryrun_{key}", row)

    # 16c. The int8 error-feedback all-reduce on a mesh of the card.
    dlrm = REG.get("dlrm-rm2")
    d_abs = dlrm.abstract_params(dlrm.full_config())
    d_vals, _ = split_params(d_abs)
    dense = [v for v, tab in zip(tree_leaves(d_vals), tree_leaves(STP.table_mask(d_abs)))
             if not tab]
    P = COMPRESS_MESH
    draws = []
    for p in range(P):
        g = torch.Generator().manual_seed(p)
        draws.append([torch.randn(tuple(v.shape), generator=g) for v in dense])
    zeros = [[torch.zeros(tuple(v.shape)) for v in dense] for _ in range(P)]
    cpu_mesh = make_mesh((P,), ("dp",), devices=[torch.device("cpu")] * P)
    want_s, want_e = compressed_psum_tree(cpu_mesh, list(range(P)), draws, zeros)
    card_mesh = make_mesh((P,), ("dp",), devices=[dev] * P)
    g_dev = [[t.to(dev) for t in gp] for gp in draws]
    e_dev = [[t.to(dev) for t in ep] for ep in zeros]
    with hlo_stats.recording() as events:
        got_s, got_e = compressed_psum_tree(card_mesh, list(range(P)), g_dev, e_dev)
    torch.cuda.synchronize()
    worst = 0.0
    for j, v in enumerate(dense):
        true = sum(draws[p][j].double() for p in range(P))
        scale = float(true.abs().max())
        for p in range(P):
            s, e = got_s[p][j].cpu(), got_e[p][j].cpu()
            check(torch.equal(s, want_s[p][j]) and torch.equal(e, want_e[p][j]),
                  f"16c: leaf {j} {tuple(v.shape)} at position {p}: the card's sum or "
                  "residual differs from the CPU's")
            worst = max(worst, float((s.double() - true).abs().max()) / (scale + 1e-9))
    check(worst < COMPRESS_GATE, f"16c: a leaf is {worst} off the fp32 sum, past {COMPRESS_GATE}")
    times = []
    for _ in range(COMPRESS_REPS + 1):
        t0 = time.perf_counter()
        compressed_psum_tree(card_mesh, list(range(P)), g_dev, e_dev)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    st = hlo_stats.collect_stats(events, P)
    n_el = sum(v.numel() for v in dense)
    out["compression"] = {
        "leaves": len(dense), "elements": n_el, "positions": P,
        "max_rel_err_vs_fp32_sum": worst, "equal_to_cpu": True,
        "ms_first": times[0], "ms_median": statistics.median(times[1:]),
        "collective_counts": st.counts,
        "wire_bytes_per_device": st.wire_bytes_per_device,
        "fp32_ring_wire_bytes_per_device": 2 * (P - 1) / P * n_el * 4}
    say("dryrun_compression", out["compression"])
    out["phase_s"] = time.perf_counter() - t_phase
    say("dryrun_phase", {"seconds": out["phase_s"]})
    return out


# ---------------------------------------------------------------------------
# 18. The language models' prefill and decode sharded over a (data, model)
# mesh of the card (18a-b run inside phase 15, on its drawn params).
# ---------------------------------------------------------------------------

SHARDED_LM_STEPS = 8  # 18a, 18c: decode steps of each sharded decode
SHARDED_H2O_STEPS = 4  # 18b: decode steps of the whole and each sharded decode
SHARDED_LM_SMOKE = (4, 16)  # 18c: prompts, prompt tokens
SHARDED_LM_REL = 1e-4  # 18c: of the largest |logit|, the dense archs
SHARDED_LM_MOE_ATOL = 5e-3  # 18c: the MoE's bf16 expert path (15c's bound)


def _synced(torch):
    torch.cuda.synchronize()
    return time.perf_counter()


def _lm_held(got, want, what):
    """Each step's max |got - want| over its largest |want|, held to LM_TOL."""
    errs = [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got, want)]
    check(max(errs) <= LM_TOL[0] and statistics.median(errs) <= LM_TOL[1],
          f"{what}: steps off by {errs} of their largest |logit|, past {LM_TOL}")
    return {"max": max(errs), "median": statistics.median(errs), "per_step": errs}


def _position_bytes(torch, values, n: int) -> dict:
    """Each position's bytes of the ``Sharded`` params, and the bytes of the
    leaves that are not cut ``n`` ways (a norm, the router)."""
    from repro_torch.models.nn import tree_leaves

    leaves = tree_leaves(values)
    per = [sum(x.parts[p].numel() * x.parts[p].element_size() for x in leaves)
           for p in range(n)]
    whole = sum(math.prod(x.shape) * x.parts[0].element_size() for x in leaves)
    small = sum(math.prod(x.shape) * x.parts[0].element_size() for x in leaves
                if math.prod(x.shape) != n * x.parts[0].numel())
    return {"per_position": per, "whole": whole, "not_cut": small,
            "bound": (whole - small) / n + small}


def _sharded_serve_run(torch, dev, cfg, rules, values, prompt, fed, sp, record=None,
                       prefills=1):
    """A cache cut over ``rules``' mesh (``cache_shardings``), ``prefills``
    prefills of ``prompt`` into it (the last timed), then one decode step a
    token of ``fed``: the logits on the host, the ms, every cache part the
    same storage after every step, and the router launches held."""
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import cache_shardings, shard_tree
    from repro_torch.models import transformer as Tr

    B, S = prompt.shape
    abstract = Tr.abstract_params(cfg)
    cache = Tr.init_cache(cfg, B, S + LM_DECODE, device=dev)
    cache = shard_tree(cache, cache_shardings(rules, cache, sp))
    prefill = STP.make_lm_prefill_step(cfg, rules, abstract)[1](prompt, cache)
    held = 0
    for _ in range(prefills):
        t0 = _synced(torch)
        if record is not None:
            with record:
                lg, cache = prefill(values, prompt, cache)
            held += record.hold(torch)
        else:
            lg, cache = prefill(values, prompt, cache)
        pre_ms = (_synced(torch) - t0) * 1e3
    check(cache.pos.whole().tolist() == [S] * B, "the sharded cache's positions")
    out = {"prefill": lg.float().cpu(), "prefill_ms": pre_ms,
           "prefill_tokens_per_s": B * S / (pre_ms / 1e3), "cache_spec": str(cache.k.sharding.spec),
           "cache_part_shape": list(cache.k.parts[0].shape)}
    step = STP.make_lm_decode_step(cfg, rules, abstract, seq_parallel=sp)[1](cache, fed[0])
    ptrs = [t.untyped_storage().data_ptr() for x in cache for t in x.parts]
    logits, ms, resident = [], [], True
    for tok in fed:
        t0 = _synced(torch)
        if record is not None:
            with record:
                lg, cache = step(values, cache, tok)
        else:
            lg, cache = step(values, cache, tok)
        ms.append((_synced(torch) - t0) * 1e3)
        logits.append(lg.float().cpu())
        resident &= [t.untyped_storage().data_ptr() for x in cache for t in x.parts] == ptrs
    if record is not None:
        held += record.hold(torch)
    check(resident, "a decode step moved a part of the sharded cache")
    check(all(bool(torch.isfinite(x).all()) for x in logits), "sharded decode logits")
    out.update(decode=logits, decode_ms=ms, decode_ms_first=ms[0],
               decode_ms_median=statistics.median(ms[1:]), router_launches_held=held,
               cache_parts_resident=resident)
    return out


def sharded_lm_qwen3(torch, dev, values, cfg, prompt, whole, figures_15a):
    """18a. qwen3-moe-30b-a3b at ``full_config()`` on a (1, 4) mesh of the
    card.  ``values`` are 15a's drawn params, cut here in place one leaf at
    a time (``shard_tree``: each whole leaf dropped once its four parts
    exist; 61.1 GB whole and cut never both on the card); ``whole`` holds
    15a's logits and fed tokens on the host.  Each position must hold a
    quarter of the cut leaves (the experts, the heads, the vocabulary) plus
    the leaves that are not cut (the norms, the router): no whole expert
    stack, no whole embedding.  15a's 2 prompts of ``LM_PROMPT`` tokens are
    prefilled twice into a cache cut over the KV heads (the second timed),
    then ``SHARDED_LM_STEPS`` decode steps take 15a's fed tokens; the
    prefill's and each step's logits are held against 15a's by ``LM_TOL``.
    Then the sequence-parallel decode from a prefill into a cache cut over
    its slots, held the same way.  Every router launch at every position is
    held against ``stream_topk_plain`` on the same scores.  Every cache
    part stays the same storage from step to step."""
    import gc

    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as Tr

    t_phase = time.perf_counter()
    rules = make_rules(make_mesh((1, 4), ("data", "model"), devices=[dev] * 4))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = _synced(torch)
    shard_tree(values, STP.param_shardings(rules, Tr.abstract_params(cfg))[0])
    out = {"mesh": [1, 4], "cut_s": _synced(torch) - t0,
           "cut_peak_bytes": torch.cuda.max_memory_allocated()}
    # The whole leaves' memory, cached for the caller's stream, back to the
    # card: the positions allocate on their own streams.
    gc.collect()
    torch.cuda.empty_cache()
    nb = _position_bytes(torch, values, 4)
    out["param_bytes"] = nb
    check(max(nb["per_position"]) <= nb["bound"] and nb["not_cut"] <= 0.01 * nb["whole"],
          f"18a: a position holds more than a quarter of the cut leaves: {nb}")
    E, V = cfg.moe.n_experts, cfg.vocab
    moe = values["layers"]["moe"]
    check(all(moe[n].parts[p].shape[1] == E // 4 for n in ("wi_gate", "wi_up", "wo")
              for p in range(4)), "18a: a position holds a whole expert stack")
    check(all(values["embed"].parts[p].shape[0] == V // 4
              and values["unembed"].parts[p].shape[1] == V // 4 for p in range(4)),
          "18a: a position holds a whole embedding")
    say("sharded_lm_qwen3_cut", out)
    record = RouterLaunches()
    fed = whole["fed"][:SHARDED_LM_STEPS]
    for sp in (False, True):
        tag = "sp" if sp else "plain"
        torch.cuda.reset_peak_memory_stats()
        run = _sharded_serve_run(torch, dev, cfg, rules, values, prompt, fed, sp, record,
                                 prefills=1 if sp else 2)
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        run["prefill_vs_15a"] = _lm_held([run.pop("prefill")], [whole["prefill"]],
                                         f"18a {tag}: the prefill against 15a's")
        run["decode_vs_15a"] = _lm_held(run.pop("decode"), whole["decode"][:len(fed)],
                                        f"18a {tag}: the decode against 15a's")
        out[tag] = run
    want = 4 * cfg.n_layers * (3 + 2 * len(fed))
    held = out["plain"]["router_launches_held"] + out["sp"]["router_launches_held"]
    check(held == want, f"18a: {held} router launches held, not {want}")
    out["router_launches_held"] = held
    out["whole_15a"] = figures_15a
    out["seconds"] = time.perf_counter() - t_phase
    return out


def sharded_lm_h2o(torch, dev, values, cfg):
    """18b. h2o-danube-3-4b at ``full_config()`` (15b's drawn params) on a
    (2, 2) mesh of the card: the first language model with "data" > 1, its
    ``fsdp`` dimensions cut over "data" and gathered a layer at a time.  2
    prompts of ``LM_SWA_PROMPT`` tokens (the batch splits over "data", the
    ring of 4,096 wraps): the whole step on the card (prefill, then
    greedy steps), then the sharded prefill and the
    same steps fed the same tokens, plain and sequence-parallel, held
    against it by ``LM_TOL`` (``SHARDED_H2O_STEPS`` steps: four positions
    decode this model at about a second a step on the one card).  The whole
    params stay for phase 15's use, so both copies sit on the card (7.92
    GB each)."""
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import make_rules, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import tree_map

    t_phase = time.perf_counter()
    abstract = Tr.abstract_params(cfg)
    prompt = torch.from_numpy(np.ascontiguousarray(
        lm_batch(2, LM_SWA_PROMPT, cfg.vocab, seed=0)["tokens"])).to(dev)
    B, S = prompt.shape
    one = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
    cache = Tr.init_cache(cfg, B, S + LM_DECODE, device=dev)
    t0 = _synced(torch)
    lg, cache = STP.make_lm_prefill_step(cfg, one, abstract)[1](prompt, cache)(values, prompt,
                                                                               cache)
    whole = {"prefill_ms": (_synced(torch) - t0) * 1e3}
    want_prefill = lg.float().cpu()
    step = STP.make_lm_decode_step(cfg, one, abstract)[1](cache, lg.argmax(-1))
    tok, fed, logits, ms = lg.argmax(-1).to(torch.int32), [], [], []
    for _ in range(SHARDED_H2O_STEPS):
        fed.append(tok)
        t0 = _synced(torch)
        lg, cache = step(values, cache, tok)
        ms.append((_synced(torch) - t0) * 1e3)
        logits.append(lg.float().cpu())
        tok = lg.argmax(-1).to(torch.int32)
    whole.update(decode_ms_first=ms[0], decode_ms_median=statistics.median(ms[1:]),
                 cache_slots=cache.k.shape[2])
    check(whole["cache_slots"] < S, "18b: the ring does not wrap")
    del cache
    rules = make_rules(make_mesh((2, 2), ("data", "model"), devices=[dev] * 4))
    sharded = shard_tree(tree_map(lambda t: t, values),
                         STP.param_shardings(rules, abstract)[0])
    out = {"mesh": [2, 2], "prompt": [B, S], "whole": whole,
           "param_bytes": _position_bytes(torch, sharded, 4)}
    nb = out["param_bytes"]
    check(max(nb["per_position"]) <= nb["bound"] and nb["not_cut"] <= 0.01 * nb["whole"],
          f"18b: a position holds more than a quarter of the cut leaves: {nb}")
    for sp in (False, True):
        tag = "sp" if sp else "plain"
        torch.cuda.reset_peak_memory_stats()
        run = _sharded_serve_run(torch, dev, cfg, rules, sharded, prompt, fed, sp)
        run["peak_bytes"] = torch.cuda.max_memory_allocated()
        run["prefill_vs_whole"] = _lm_held([run.pop("prefill")], [want_prefill],
                                           f"18b {tag}: the prefill against the whole step's")
        run["decode_vs_whole"] = _lm_held(run.pop("decode"), logits,
                                          f"18b {tag}: the decode against the whole step's")
        out[tag] = run
    del sharded
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_sharded_lm_smoke(torch, dev, run_path):
    """18c. The five language models at ``smoke_config()`` (fp32; the MoE's
    expert path bf16) on a (2, 2) mesh of the card: drawn on the CPU from
    seed 0, ``SHARDED_LM_SMOKE`` prompts prefilled and ``SHARDED_LM_STEPS``
    decode steps, sharded (plain and sequence-parallel) against the whole
    step on the card, each step within ``SHARDED_LM_REL`` of its largest
    |logit| (the MoE archs within ``SHARDED_LM_MOE_ATOL``, 15c's bound for
    that bf16 path)."""
    from repro_torch.configs import registry as REG
    from repro_torch.distributed import steps as STP
    from repro_torch.distributed.sharding import cache_shardings, make_rules, shard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as Tr
    from repro_torch.models.nn import split_params, tree_map

    t_phase = time.perf_counter()
    one = make_rules(make_mesh((1, 1), ("data", "model"), devices=[dev]))
    rules = make_rules(make_mesh((2, 2), ("data", "model"), devices=[dev] * 4))
    B, S = SHARDED_LM_SMOKE
    out = {"launches": {}}

    def serve(cfg, values, toks, r, sharded, sp):
        abstract = Tr.abstract_params(cfg)
        v = tree_map(lambda t: t.to(dev, copy=True), values)
        cache = Tr.init_cache(cfg, B, S + SHARDED_LM_STEPS, device=dev)
        if sharded:
            v = shard_tree(v, STP.param_shardings(r, abstract)[0])
            cache = shard_tree(cache, cache_shardings(r, cache, sp))
        t = toks.to(dev)
        lg, cache = STP.make_lm_prefill_step(cfg, r, abstract)[1](t[:, :S], cache)(
            v, t[:, :S], cache)
        got = [lg.float().cpu()]
        step = STP.make_lm_decode_step(cfg, r, abstract, seq_parallel=sp)[1](cache, t[:, S])
        for i in range(S, S + SHARDED_LM_STEPS):
            lg, cache = step(v, cache, t[:, i])
            got.append(lg.float().cpu())
        return got

    def one_arch(aid):
        arch = REG.get(aid)
        cfg = arch.smoke_config()
        values = split_params(arch.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                               device="cpu"))[0]
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, cfg.vocab, (B, S + SHARDED_LM_STEPS)).astype(np.int32))
        want = serve(cfg, values, toks, one, False, False)
        scale = max(float(w.abs().max()) for w in want)
        atol = SHARDED_LM_MOE_ATOL if cfg.moe is not None else SHARDED_LM_REL * scale
        res = {"largest_abs_logit": scale, "atol": atol}
        for sp in (False, True):
            got = serve(cfg, values, toks, rules, True, sp)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(err <= atol, f"18c {aid} {'sp' if sp else 'plain'}: sharded logits off the "
                  f"whole step's by {err}, past {atol}")
            res["max_abs_err_sp" if sp else "max_abs_err"] = err
        return res

    for aid in ("qwen3-moe-30b-a3b", "mixtral-8x22b", "h2o-danube-3-4b", "gemma-2b", "yi-6b"):
        res, counts = run_path(f"sharded_lm_smoke_{aid}", lambda aid=aid: one_arch(aid))
        out[aid] = res
        for name, count in counts.items():
            out["launches"][name] = out["launches"].get(name, 0) + count
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core.knn import knn_allpairs
    from repro_torch.data.synthetic import clustered_vectors, random_vectors
    from repro_torch.kernels import _backend as B
    from repro_torch.kernels import fused_knn as FK
    from repro_torch.kernels import ivf_scan as IVS
    from repro_torch.kernels import merge_partials as MP
    from repro_torch.kernels import ops
    from repro_torch.kernels import pairwise_distance as PD
    from repro_torch.kernels import pq_scan as PQS
    from repro_torch.kernels import rescore as RS
    from repro_torch.kernels import scan as SC
    from repro_torch.kernels import stream_topk as ST
    from repro_torch.kernels.ref import check_topk, operand_distance
    from repro_torch.serving.engine import EngineConfig, QueryEngine
    from repro_torch.serving.index import RetrievalIndex
    from repro_torch.core.topk import next_pow2 as T_next_pow2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The language models' bf16 products accumulate in fp32 (phase 15).
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("card", {"nvidia_smi": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    # Each kernel's launch count: (wrapper module, counter).
    counters = {"fused_knn": (FK, "LAUNCHES"), "merge_partials": (MP, "LAUNCHES"),
                "pairwise_distance": (PD, "LAUNCHES"), "stream_topk": (ST, "LAUNCHES"),
                "rescore_topk": (RS, "LAUNCHES"), "ivf_scan": (IVS, "LAUNCHES"),
                "pq_scan": (PQS, "LAUNCHES"), "pairwise_cumulative": (PD, "CUMULATIVE_LAUNCHES"),
                "fused_knn_masked": (FK, "MASKED_LAUNCHES"), "fused_knn_wide": (FK, "WIDE_LAUNCHES"),
                "merge_partials_wide": (MP, "WIDE_LAUNCHES"),
                "stream_topk_wide": (ST, "WIDE_LAUNCHES"),
                "rescore_topk_wide": (RS, "WIDE_LAUNCHES"),
                "ivf_scan_wide": (IVS, "WIDE_LAUNCHES"), "pq_scan_wide": (PQS, "WIDE_LAUNCHES"),
                "ivf_scan_table": (IVS, "TABLE_LAUNCHES")}
    launches = {name: 0 for name in counters}

    def run_path(label, fn):
        """Drive one main path with the counts zeroed just before and read just after."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
        for name in counts:
            launches[name] += counts[name]
        say(f"path_{label}", {"launches": counts, "wall_s": time.perf_counter() - t0})
        return out, counts

    # 1. Build.
    build_s = B.build()
    regs = {}
    for name in B.KERNEL_SOURCES:
        log = B.library_path(name).with_suffix(".log")
        # ptxas's report: each entry function with its target, then its registers
        regs[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in log.read_text().splitlines()
                      if "registers" in ln or "Compiling entry function" in ln]
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
    fused_bound = mm_bound(2.0 * n * n * d, 2 * n * d * 4 + 2 * n * 4 + n * K * 8)
    say("allpairs_160k", {"median_ms": statistics.median(fused_times), "runs_ms": fused_times,
                          "plain_ms": fused_plain_ms, "vs_plain": fused_cmp, "bm": bm,
                          "splits": splits,
                          "ctas_per_sm": SC.kernel_shape("fused_knn", dev, bm, K)[0],
                          "ctas": ctas, **fused_bound})

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
    pd_bound = mm_bound(2.0 * m2 * n * d, (m2 + n) * d * 4 + (m2 + n) * 4 + m2 * n * 4)
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
    # The kernel's shape: the stage ring, CTAs an SM, shared memory, splits.
    st_shape = {f"k{kk}": {**ST.kernel_shape(dev, T_next_pow2(kk)),
                           "splits": ST.plan(rows, n, T_next_pow2(kk), dev)[0]}
                for kk, rows in ((k, m2), (4096, 1024))}
    say("stream_topk_shape", st_shape)
    # Phase 2 of the paper at the card's cap, k = 4096, on rows 0..1023.
    with WideLaunches(torch) as rec:
        _, counts = run_path("two_phase_1024x160k_k4096",
                             lambda: ops.stream_topk(dm[:1024], 4096))
    check(counts["stream_topk_wide"] == 1, f"launches {counts}")
    st_wide = hold_wide(torch, rec.records)["stream_topk"][0]
    del dm, rec

    n3 = 16_384  # 528 tiles of 512: the per-tile path's depth, cut for the script's time
    x3 = x[:n3]
    sym, counts = run_path("allpairs_16k_kernel_symmetric",
                           lambda: knn_allpairs(x3, k, impl="kernel", symmetric=True))
    check(counts["pairwise_distance"] > 0, f"launches {counts}")
    ref3 = knn_allpairs(x3, k, impl="fused")
    say("symmetric_kernel_vs_fused_16k", check_topk(
        sym.distances, sym.indices, ref3.distances, ref3.indices, n=n3, rtol=1e-5, atol=2e-3,
        dist=dist))
    del sym, ref3

    # 3b. The paper's two phases with the per-coordinate kernel.
    cum = phase_cumulative(torch, dev, run_path, x, res)
    allpairs_host = (x.cpu(), res.distances.cpu(), res.indices.cpu())  # phase 10's reference
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
        # A steady window after the churn: 25 full batches on one engine of
        # its own, so the percentiles rest on more than a handful of samples.
        steady = QueryEngine(index, EngineConfig(k=k4, min_batch=8, max_batch=1024))
        for b in range(STEADY_BATCHES + 1):  # the first batch is tagged cold
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
    # The library yardstick: torch.topk over the [m, S * K] concatenation.
    cat_v = part_v.permute(1, 0, 2).reshape(part_v.shape[1], -1).contiguous()
    mg_lib_ms = time_ms(torch, lambda: torch.topk(cat_v, part_v.shape[2], dim=1, largest=False))
    mg_graph = {"graph_ms": graph_ms(torch, lambda: MP.merge_partials(part_v, part_i)),
                "library_graph_ms": graph_ms(torch, lambda: torch.topk(
                    cat_v, part_v.shape[2], dim=1, largest=False))}
    del cat_v
    # The fused kernel and its merge at the card's cap, K = 4096: the first
    # 64 queries of the batch (one row tile, the database axis split 132 ways).
    with WideLaunches(torch) as rec:
        FK.fused_knn(sf[0][:64].contiguous(), sf[1], sf[2][:64].contiguous(), sf[3], 4096, **kw)
    cap_k = hold_wide(torch, rec.records)
    check(len(cap_k.get("merge_partials", [])) == 1, "the K = 4096 call was not split")
    del rec
    say("serving_batch_1024", {"kernel_ms": serve_ms, "partials_ms": partials_ms,
                               "merge_ms": mg_ms, "plain_ms": serve_plain_ms,
                               "merge_plain_ms": mg_plain_ms, "vs_plain": serve_cmp,
                               "bm": bm4, "splits": splits4, "ctas": -(-1024 // bm4) * splits4,
                               "ctas_per_sm": SC.kernel_shape("fused_knn", dev, bm4, 16)[0],
                               **mm_bound(2.0 * 1024 * nn * d,
                                          (1024 + nn) * d * 4 + 1024 * 16 * 8),
                               "merge_bound_ms": mg_bound, "merge_library_ms": mg_lib_ms,
                               "merge_graph": mg_graph})

    del index, engine, steady, vecs_t, qb, sf, outs, part_v, part_i, mv, mi, mpv, mpi
    torch.cuda.empty_cache()

    # 8. Filtered and multi-tenant serving on phase 4's rows.
    flt = phase_filtered(torch, dev, run_path, db)
    del db

    # 5. Two-stage quantized serving; 6. IVF and 7. IVF-PQ serving, on one
    # clustered dataset, the last 8,192 rows the queries.
    ts, int8_index, int8_queries = phase_two_stage(torch, dev, run_path)
    xc = clustered_vectors(QUERY_ROWS + 8192, d, n_clusters=4096, seed=0)
    ivf = phase_ivf(torch, dev, run_path, xc)
    pq, pq_index = phase_ivfpq(torch, dev, run_path, xc)

    # 9. Snapshots and the crash-safe lifecycle on phase 7's and phase 5's indexes.
    held = {"ivfpq": pq_index, "int8": int8_index}
    del pq_index, int8_index
    phase_persistence(torch, dev, run_path, held, pq["build"], xc[QUERY_ROWS:], int8_queries)
    torch.cuda.empty_cache()

    # 10. The multi-device core on four positions: ring, triangle, the
    # sharded query and the index on the mesh.
    mesh = phase_mesh(torch, dev, run_path, allpairs_host, xc)
    mesh_launches = mesh["launches"]
    del allpairs_host
    for name in ("pairwise_distance", "stream_topk", "fused_knn", "rescore_topk", "ivf_scan",
                 "pq_scan"):
        check(mesh_launches.get(name, 0) > 0, f"phase 10 never launched {name}: {mesh_launches}")

    # 11. The shard fleet at query_1m: in process, then eight worker
    # processes, then their faults, on phase 10's cells and codes.
    fleet_launches = phase_fleet(torch, dev, run_path, *mesh.pop("fleet_state"), xc, {
        "phase7_one_card_p50_ms": pq["steady"]["p50_ms"],
        "phase10d_mesh_p50_ms": mesh["index_ivfpq"]["p50_ms"]})["launches"]
    del xc, mesh
    for name in ("fused_knn", "pq_scan", "rescore_topk"):
        check(fleet_launches.get(name, 0) > 0, f"phase 11 never launched {name}: {fleet_launches}")

    # 12. The two-tower retrieval service at full width, on what the earlier
    # phases freed.
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    service_launches = phase_service(torch, dev, run_path)["launches"]
    for name in ("fused_knn", "merge_partials", "pq_scan", "rescore_topk"):
        check(service_launches.get(name, 0) > 0,
              f"phase 12 never launched {name}: {service_launches}")

    # 13. The recommender's trainer at full width, then retrieval with the
    # trained towers, on what phase 12 freed.
    gc.collect()
    torch.cuda.empty_cache()
    train = phase_train(torch, dev, run_path)
    train_launches = train["launches"]
    for name in ("fused_knn", "merge_partials"):
        check(train_launches.get(name, 0) > 0, f"phase 13 never launched {name}: {train_launches}")

    # 14. The loop, async saves and the launcher, NequIP and its relaxation,
    # the neighbour lists built by the fused kernel.
    gc.collect()
    torch.cuda.empty_cache()
    loop = phase_loop(torch, dev, run_path)
    loop_launches = loop["launches"]

    # 15. The language models: qwen3-moe-30b-a3b and h2o-danube-3-4b at full
    # width, the five at smoke size, the LM launcher; the MoE router on
    # stream_topk.
    gc.collect()
    torch.cuda.empty_cache()
    lm = phase_lm(torch, dev, run_path)
    lm_launches = lm["launches"]

    # 16. The dry run: the kernels' shape paths against the kernels, two
    # traced steps beside what 15a and 13a measured, and the int8
    # error-feedback all-reduce on a mesh of the card.
    gc.collect()
    torch.cuda.empty_cache()
    tt = train["two_tower"]["train"]
    phase_dryrun(torch, dev, {
        "qwen3_prefill": {"ms": lm["qwen3"]["prefill_ms"][1],
                          "peak_bytes_15a": lm["qwen3"]["peak_bytes"]},
        "two_tower_train": {"ms": tt["step_ms_median"], "peak_bytes_13a": tt["peak_bytes"]}})

    # 17. The recommender sharded over a (2, 2) mesh of the card: DLRM-RM2 at
    # full width against 13b, the four at smoke size against four CPU
    # positions, retrieval over the trained towers' shards.
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase_sharded(torch, dev, run_path, train.pop("dlrm_hold"))
    sharded_launches = sharded["launches"]
    for name in ("fused_knn", "merge_partials"):
        check(sharded_launches.get(name, 0) > 0,
              f"phase 17 never launched {name}: {sharded_launches}")

    # 18. The language models' serve steps sharded over a mesh of the card:
    # 18a-b ran inside phase 15 on its drawn params; 18c, the five at smoke
    # size on a (2, 2) mesh against their whole steps.
    gc.collect()
    torch.cuda.empty_cache()
    lm18 = lm["phase18"]
    lm18["smoke"] = phase_sharded_lm_smoke(torch, dev, run_path)
    say("sharded_lm_smoke", lm18["smoke"])
    lm18_launches = dict(lm18["launches"])
    for name, count in lm18["smoke"]["launches"].items():
        lm18_launches[name] = lm18_launches.get(name, 0) + count
    check(lm18_launches.get("stream_topk", 0) > 0,
          f"phase 18 never launched stream_topk: {lm18_launches}")
    say("sharded_lm_phase", {"seconds": lm18["qwen3"]["seconds"] + lm18["h2o"]["seconds"]
                             + lm18["smoke"]["seconds"], "launches": lm18_launches})

    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    rs, iv = ts["int8"]["rescore"], ivf["float32"]["ivf_scan_batch_1024"]
    fused_variants = {
        sd: {"ms": ts[sd]["partials_ms"], "plain_ms": ts[sd].get("plain_ms"),
             **{key: ts[sd][key] for key in ("bound_ms", "bound_by", "bound_fp32_ms")},
             "max_abs_err": ts[sd]["vs_plain"]["max_abs_err"] if "vs_plain" in ts[sd] else None,
             "shape": f"partial sets, 1024 x {QUERY_ROWS} (gy {sd}), d 256, k {ts['k_scan']}"}
        for sd in ("float32", "bfloat16", "int8")}
    for label, v in [*ivf["fused_knn"].items(), ("pq_encode", pq["fused_knn_encode"]),
                     ("masked_partials", flt["masked_partials"]), ("wide_k512", flt["wide_k512"])]:
        fused_variants[label] = {key: v[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                         "bound_fp32_ms", "shape")}
        fused_variants[label]["max_abs_err"] = v["vs_plain"]["max_abs_err"]
        fused_variants[label]["library_ms"] = None
    fused_variants["masked_partials"].update(
        launches=launches["fused_knn_masked"], unmasked_ms=flt["masked_partials"]["unmasked_ms"],
        fused_call_unmasked_ms=flt["masked_partials"]["fused_call_unmasked_ms"])
    fused_variants["wide_k512"]["launches"] = launches["fused_knn_wide"]
    # Each selection kernel's wide launches (K > 256): those of the filtered
    # batches with 500 exclusions of phases 5-7, and each kernel at the
    # card's cap (K = 4096; ivf_scan and pq_scan take K up to cell_cap).
    wide = {}
    for label, rows in (("two_stage_filtered", ts["int8"]["filtered_exclude"]["wide"]),
                        ("ivf_filtered", ivf["float32"]["filtered_exclude"]["wide"]),
                        ("ivfpq_filtered", pq["filtered_exclude"]["wide"]),
                        ("cap", {**cap_k, "stream_topk": [st_wide],
                                 "rescore_topk": [ts["int8"]["rescore_k4096"]]})):
        for name, entries in rows.items():
            for e in entries:
                key = f"{label}_k{e['K']}"
                while key in wide.setdefault(name, {}):
                    key += "_"
                wide[name][key] = {k_: e[k_] for k_ in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "library_ms",
                    "shape")}
                wide[name][key]["launches"] = launches[f"{name}_wide"]
    fused_variants.update(wide["fused_knn"])
    fused_variants["radius_graph_d4"] = {**loop["relax"]["fused_knn_hold"],
                                         "launches": loop_launches.get("fused_knn", 0)}
    kernels = [
        {"name": "fused_knn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_knn.cu",
         "replaces": "src/repro/kernels/fused_knn.py:129", "launches": launches["fused_knn"],
         "max_abs_err": fused_err, "ms": statistics.median(fused_times),
         "plain_ms": fused_plain_ms, **fused_bound, "library_ms": None, "product": PRODUCT, "shape": "allpairs 160000 x 160000, d 256, k 100",
         "variants": fused_variants},
        {"name": "merge_partials", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/merge_partials.cu",
         "replaces": "src/repro/kernels/fused_knn.py:129", "launches": launches["merge_partials"],
         "max_abs_err": mg_err, "ms": mg_ms, "plain_ms": mg_plain_ms, "bound_ms": mg_bound,
         "bound_by": mg_by, "library_ms": mg_lib_ms, **mg_graph,
         "shape": f"{splits4} splits x 1024 x 16 (serving batch, k 10)",
         "variants": {"k512": {**flt["merge_k512"], "launches": launches["merge_partials_wide"]},
                      **wide["merge_partials"]}},
        {"name": "pairwise_distance", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_distance.cu",
         "replaces": "src/repro/kernels/pairwise_distance.py:85",
         "launches": launches["pairwise_distance"], "max_abs_err": pd_err, "ms": pd_ms,
         "plain_ms": pd_plain_ms, **pd_bound, "library_ms": pd_lib_ms, "product": PRODUCT, "shape": "8192 x 160000, d 256"},
        {"name": "stream_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/stream_topk.cu",
         "replaces": "src/repro/kernels/stream_topk.py:88", "launches": launches["stream_topk"],
         "max_abs_err": st_err, "ms": st_ms, "plain_ms": st_plain_ms, "bound_ms": st_bound,
         "bound_by": st_by, "library_ms": st_lib_ms, "shape": "8192 x 160000, k 100",
         "kernel_shape": st_shape, "variants": {**wide["stream_topk"], "k100_1024_rows": {
             key: cum["sqeuclidean"]["stream_topk"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                 "shape")},
             "moe_router": {**lm["router"], "launches": lm_launches.get("stream_topk", 0)},
             "moe_router_per_position": {
                 "launches": lm18_launches.get("stream_topk", 0),
                 "held_against_plain": lm18["qwen3"]["router_launches_held"],
                 "shape": "18a: qwen3-moe-30b-a3b's router on each of 4 positions of a (1, 4) "
                          "mesh, [8192, 128] a position at the prefill (the batch whole on "
                          "each) and [2, 128] at a decode step, k 8"}}},
        {"name": "rescore_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rescore.cu",
         "replaces": "src/repro/kernels/rescore.py:65", "launches": launches["rescore_topk"],
         "max_abs_err": rs["vs_plain"]["max_abs_err"], "ms": rs["ms"],
         "plain_ms": rs["plain_ms"], "bound_ms": rs["bound_ms"][0], "bound_by": rs["bound_ms"][1],
         "library_ms": None, "shape": f"candidates {rs['shape']} (int8 two-stage, k 10)",
         "variants": wide["rescore_topk"]},
        {"name": "ivf_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ivf_scan.cu",
         "replaces": "src/repro/kernels/ivf_scan.py:130", "launches": launches["ivf_scan"],
         "max_abs_err": iv["vs_plain"]["max_abs_err"], "ms": iv["ms"],
         "plain_ms": iv["plain_ms"], **{key: iv[key] for key in (
             "bound_ms", "bound_by", "bound_fp32_ms")}, "library_ms": None,
         "product": PRODUCT,
         "shape": f"1024 queries, tile_m {iv['tile_m']}, nprobe 8 of 4096 cells, fp32, "
                  f"k {iv['k_scan']}",
         "variants": {**{f"{sd}_batch_{m}": {key: ivf[sd][f"ivf_scan_batch_{m}"][key]
                                             for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                         "bound_fp32_ms", "product")}
                         for sd in ("float32", "int8") for m in (1024, 8)},
                      **wide["ivf_scan"]}},
        {"name": "ivf_scan_table", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ivf_scan.cu",
         "replaces": "src/repro/kernels/ivf_scan.py:130", "launches": launches["ivf_scan_table"],
         **{key: iv["table"][key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "shape")},
         "variants": {f"{sd}_batch_{m}": ivf[sd][f"ivf_scan_batch_{m}"]["table"]
                      for sd in ("float32", "int8") for m in (1024, 8)}},
        {"name": "pq_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pq_scan.cu",
         "replaces": "src/repro/kernels/pq_scan.py:138", "launches": launches["pq_scan"],
         "max_abs_err": pq["pq_scan_batch_1024"]["vs_plain"]["max_abs_err"],
         "ms": pq["pq_scan_batch_1024"]["ms"], "plain_ms": pq["pq_scan_batch_1024"]["plain_ms"],
         "bound_ms": pq["pq_scan_batch_1024"]["bound_ms"],
         "bound_by": pq["pq_scan_batch_1024"]["bound_by"], "library_ms": None,
         "shape": f"1024 queries, tile_m 256, nprobe 8 of 4096 cells, pq_m {PQ_M}, "
                  f"nbits {PQ_NBITS}, k {pq['pq_scan_batch_1024']['k_scan']}",
         "lookup_floor_ms": pq["pq_scan_batch_1024"]["lookup_floor_ms"],
         "kernel_shape": {key: pq["pq_scan_batch_1024"][key] for key in (
             "mode", "qb", "chunk", "code_ring_units", "splits", "ctas_per_sm", "smem_bytes")},
         "variants": {"batch_8": {key: pq["pq_scan_batch_8"][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "lookup_floor_ms")},
             "pq_m256_batch_64": {key: pq["pq_scan_pq_m256_batch_64"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "lookup_floor_ms", "max_abs_err",
                 "mode", "chunk", "ctas_per_sm", "smem_bytes", "shape")},
             **wide["pq_scan"]}},
        {"name": "pairwise_cumulative", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_cumulative.cu",
         "replaces": "src/repro/kernels/pairwise_distance.py:134",
         "launches": launches["pairwise_cumulative"],
         "max_abs_err": cum["sqeuclidean"]["max_abs_err"], "ms": cum["sqeuclidean"]["ms"],
         "plain_ms": cum["sqeuclidean"]["plain_ms"], "bound_ms": cum["sqeuclidean"]["bound_ms"],
         "bound_by": cum["sqeuclidean"]["bound_by"],
         "library_ms": cum["sqeuclidean"]["library_ms"],
         "shape": f"sqeuclidean {cum['sqeuclidean']['shape']} (library: torch.cdist ** 2)",
         "variants": {name: {key: cum[name][key] for key in (
             "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "shape")}
             for name in ("hellinger", "kl")}},
    ]
    for entry in kernels:
        entry["launches_phase10"] = mesh_launches.get(entry["name"], 0)
        entry["launches_phase11"] = fleet_launches.get(entry["name"], 0)
        entry["launches_phase12"] = service_launches.get(entry["name"], 0)
        entry["launches_phase13"] = train_launches.get(entry["name"], 0)
        entry["launches_phase14"] = loop_launches.get(entry["name"], 0)
        entry["launches_phase15"] = lm_launches.get(entry["name"], 0)
        entry["launches_phase17"] = sharded_launches.get(entry["name"], 0)
        entry["launches_phase18"] = lm18_launches.get(entry["name"], 0)
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
