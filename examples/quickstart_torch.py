"""Quickstart of the PyTorch/CUDA port: the paper's k-nearest-vector problem.

    PYTHONPATH=src python examples/quickstart_torch.py             # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The port of ``examples/quickstart.py``.  On the card every call below runs
the port's CUDA kernels; with ``--device cpu`` their plain versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.core.knn import knn_allpairs, knn_query
from repro_torch.data.synthetic import clustered_vectors, random_vectors
from repro_torch.kernels._backend import resolve_device

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
dev = resolve_device(ap.parse_args().device)  # asking for CUDA without a card raises

# 1. The paper's exact workload (scaled down): random vectors, d=256, k=100.
x = torch.from_numpy(random_vectors(n=2000, d=256, seed=0)).to(dev)
result = knn_allpairs(x, k=100)
print("all-pairs kNN:", tuple(result.distances.shape), tuple(result.indices.shape))
print("  nearest to vector 0:", result.indices[0, :5].tolist(),
      "at distance", result.distances[0, :5].cpu().numpy().round(2))

# 2. Any cumulatively-computable distance (paper Sect. 3): KL divergence.
p = np.abs(random_vectors(500, 64, 1)) + 0.01
p = torch.from_numpy(p / p.sum(axis=1, keepdims=True)).to(dev)
res_kl = knn_allpairs(p, k=10, distance="kl")
print("KL-divergence kNN:", tuple(res_kl.distances.shape))

# 3. Query-vs-database (the recommender serving case):
db = torch.from_numpy(clustered_vectors(5000, 128, seed=2)).to(dev)
q = torch.from_numpy(clustered_vectors(64, 128, seed=3)).to(dev)
res_q = knn_query(q, db, k=20, distance="sqeuclidean")
print("query kNN:", tuple(res_q.indices.shape))

# 4. Exact-vs-brute check: the engine is EXACT; the paper's point is that
#    "strict computation in practical time is possible" (no ANN needed).
brute = np.argsort(((q[0] - db) ** 2).sum(1).cpu().numpy(), kind="stable")[:20]
match = np.array_equal(np.sort(res_q.indices[0].cpu().numpy()), np.sort(brute))
print("exact top-20 matches brute force:", match)
assert match

# 5. The one-pass kernel (distance and selection fused) against the plain
#    per-tile route on the same inputs.
res_f = knn_query(q[:32], db[:2048], k=16, impl="fused")
res_t = knn_query(q[:32], db[:2048], k=16, impl="torch")
err = float((res_f.distances - res_t.distances).abs().max())
print(f"fused == torch path: max |delta| = {err:.2e}")
print("done.")
