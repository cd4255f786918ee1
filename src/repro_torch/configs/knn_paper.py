"""knn-paper: the paper's own workload as a selectable config.

Port of ``repro/configs/knn_paper.py``: k-nearest-vector, d=256, k=100
(paper Sect. 7 Table 1), plus a beyond-paper 2M-vector cell and the
query-sharded serving cell.
"""
from repro_torch.configs.base import KNNArch

ARCH = KNNArch("knn-paper")
