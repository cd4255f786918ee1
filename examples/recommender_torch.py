"""The paper's motivating application end to end, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/recommender_torch.py             # on the card
    PYTHONPATH=src python examples/recommender_torch.py --device cpu

The port of ``examples/recommender.py``, step for step:

  1. train a two-tower retrieval model on synthetic click logs (in-batch
     sampled softmax) through ``distributed.steps.make_train_step``;
  2. embed an item corpus and pack it into a serving ``RetrievalIndex``
     (``serving.TwoTowerRetrievalService``);
  3. build item-to-item recommendations with the all-pairs kNN engine (the
     paper's core problem: "finding the nearest vectors to each vector");
  4. serve user -> item retrieval through the batched query engine, then
     ingest fresh items, delete stale ones, compact, and re-serve;
  5. re-recommend with per-user seen-item exclusion lists.

On the card the scans run the port's CUDA kernels (``fused_knn`` and its
merge); with ``--device cpu`` their plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry as REG
from repro_torch.core.knn import knn_allpairs
from repro_torch.data.synthetic import recsys_batch
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.kernels._backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serving import ServiceConfig, TwoTowerRetrievalService

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
dev = resolve_device(ap.parse_args().device)  # asking for CUDA without a card raises

rules = make_rules(make_host_mesh(devices=[dev]))
arch = REG.get("two-tower-retrieval")
cfg = arch.smoke_config()

# -- 1. train ---------------------------------------------------------------
params = arch.init_params(cfg, generator=torch.Generator(dev).manual_seed(0), device=dev)
loss, baxes = ST.recsys_loss("two-tower-retrieval", cfg)
_, jitted, _, opt = ST.make_train_step(
    loss, arch.abstract_params(cfg), rules, baxes,
    ST.StepConfig(peak_lr=5e-3, warmup_steps=10, total_steps=200))
state = ST.init_state(opt, params)
fn = jitted(recsys_batch("two-tower-retrieval", 128, cfg))
t0 = time.time()
for step in range(120):
    state, m = fn(state, recsys_batch("two-tower-retrieval", 128, cfg, step=step))
    if step % 40 == 0:
        print(f"step {step:4d} loss {float(m['loss']):.3f} "
              f"in-batch-acc {float(m['in_batch_acc']):.2f}")
print(f"trained 120 steps in {time.time() - t0:.1f}s, final loss {float(m['loss']):.3f}")

# -- 2. embed the corpus into a serving index --------------------------------
rng = np.random.default_rng(7)
svc = TwoTowerRetrievalService(state.params, cfg, ServiceConfig(k=5, embed_batch=1024),
                               device=dev)
corpus = rng.integers(0, min(cfg.i_sizes()), (4096, cfg.n_item_fields)).astype(np.int32)
corpus_emb = svc.build_corpus(np.arange(len(corpus)), corpus)
print(f"corpus indexed: {len(svc.index)} items x {svc.index.dim} dims")

# -- 3. item-to-item: the paper's all-pairs problem --------------------------
t0 = time.time()
i2i = knn_allpairs(corpus_emb, k=10, distance="neg_cosine")
print(f"item-to-item kNN for {corpus_emb.shape[0]} items in {time.time() - t0:.2f}s; "
      f"item 0's neighbors: {i2i.indices[0].tolist()}")

# -- 4. user->item retrieval through the engine ------------------------------
user_keys = np.arange(16)
users = rng.integers(0, min(cfg.u_sizes()), (16, cfg.n_user_fields)).astype(np.int32)
ids, scores = svc.recommend(user_keys, users)
print("user 0 recommendations:", ids[0], "scores:", scores[0].round(3))

# Online lifecycle: fresh items land in the delta segment, stale ones are
# tombstoned, compact() re-packs; results stay exact throughout.
fresh = rng.integers(0, min(cfg.i_sizes()), (256, cfg.n_item_fields)).astype(np.int32)
svc.ingest_items(np.arange(len(corpus), len(corpus) + 256), fresh)
svc.delete_items(np.arange(128))
ids2, _ = svc.recommend(user_keys, users)
svc.compact()
ids3, _ = svc.recommend(user_keys, users)
assert np.array_equal(ids2, ids3), "compaction must not change results"
for _ in range(3):  # steady-state batches
    svc.recommend(user_keys, users)
st = svc.stats()
print(f"after churn: {st['index_rows']} items, serving p50 "
      f"{st['serving']['p50_ms']:.1f} ms, cache hit-rate {st['cache']['hit_rate']:.2f}")

# -- 5. seen-item exclusion: never recommend what the user already saw -------
# Each user's history (here: their previous recommendations) becomes a
# ragged exclusion list; the index widens its fetch by the list width so the
# page stays exactly the next-best k items.
seen = [ids3[u].tolist()[: 2 + u % 3] for u in range(len(user_keys))]
ids4, _ = svc.recommend(user_keys, users, exclude_ids=seen)
for u in range(len(user_keys)):
    assert not set(ids4[u]) & set(seen[u]), "excluded item resurfaced"
print(f"seen-item exclusion: user 0 saw {seen[0]}, now gets {ids4[0].tolist()}")
print("done.")
