"""PyTorch/CUDA port of the exact kNN system, beside the JAX package ``repro``.

The same subpackage layout as ``repro`` (``core``, ``kernels``, ``serving``,
``data``), so each port file sits beside the reference file of the same
name.  Imports ``torch`` and numpy only.  Kernels are hand-written CUDA for
Hopper (``kernels/csrc``), built on first use.
"""
from repro_torch.core.knn import KNNResult, knn_allpairs, knn_query
from repro_torch.serving.engine import EngineConfig, QueryEngine
from repro_torch.serving.index import RetrievalIndex, SearchResult

__all__ = ["EngineConfig", "KNNResult", "QueryEngine", "RetrievalIndex",
           "SearchResult", "knn_allpairs", "knn_query"]
