"""nequip [gnn]: O(3)-equivariant interatomic potential.

Port of ``repro/configs/nequip.py``, field for field: n_layers 5, d_hidden
32, l_max 2, n_rbf 8, cutoff 5, n_species 64, radial_hidden 64
[arXiv:2101.03164; paper].  The molecule cell's neighbour list is built by
the paper's kNN solver (``data.graphs.radius_graph``).
"""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn import GNNConfig


def full_config() -> GNNConfig:
    return GNNConfig(n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0, n_species=64,
                     radial_hidden=64)


def smoke_config() -> GNNConfig:
    return GNNConfig(n_layers=2, d_hidden=8, l_max=2, n_rbf=4, cutoff=5.0, n_species=8,
                     radial_hidden=16)


ARCH = GNNArch("nequip", full_config, smoke_config)
