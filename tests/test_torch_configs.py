"""The port's registry, and every (arch x shape) cell traced on the meta device.

Port of ``tests/test_configs.py``: the same registry checks, input specs
and full configs.  In place of the reference's smoke lowering, every
non-skip cell runs the dry run's trace (``launch.dryrun.run_cell``) at
smoke size on a 2 x 2 mesh of meta positions: the step runs through, every
kernel wrapper on its shape path, nothing allocated; the kNN cells and
the recommender's (whose steps run sharded over the mesh) record their
collectives.  Three cells run at full width on the production mesh, as
``python -m repro_torch.launch.dryrun`` runs every cell.
"""
import math

import pytest
import torch

from repro_torch.configs import registry as REG
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh

ALL_CELLS = [(a, s) for a, s, kind, _ in REG.all_cells(include_knn=True) if kind != "skip"]
SKIPPED = [(a, s, r) for a, s, kind, r in REG.all_cells() if kind == "skip"]
KEYS = ("arch", "shape", "mesh", "devices", "unrolled", "status", "argument_size_in_bytes",
        "output_size_in_bytes", "flops", "bytes_accessed", "transcendentals",
        "collective_counts", "collective_result_bytes", "collective_wire_bytes_per_device",
        "peak_memory_in_bytes_unsharded", "trace_s", "kernel_calls", "op_counts")


def test_registry_contains_all_assigned():
    assert sorted(REG.ASSIGNED) == sorted([
        "h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b",
        "qwen3-moe-30b-a3b", "nequip", "xdeepfm", "dlrm-rm2", "bst",
        "two-tower-retrieval",
    ])


def test_cell_count_is_40():
    """10 archs x 4 shapes; skips are still declared cells."""
    assert len(REG.all_cells()) == 40
    assert len(SKIPPED) == 3  # yi-6b, gemma-2b, qwen3 long_500k
    assert len(ALL_CELLS) == 40  # 37 assigned + the paper's 3


def test_skips_documented():
    for a, s, r in SKIPPED:
        assert s == "long_500k"
        assert "attention" in r


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        REG.get("nonexistent")


@pytest.mark.parametrize("arch_id", REG.ASSIGNED)
def test_full_input_specs_match_assignment(arch_id):
    """Spot-check the full-scale shapes against the assignment sheet."""
    arch = REG.get(arch_id)
    if arch.family == "lm":
        specs = arch.input_specs("train_4k")
        assert specs["tokens"].shape == (256, 4096)
        specs = arch.input_specs("prefill_32k")
        assert specs["tokens"].shape == (32, 32768)
        specs = arch.input_specs("decode_32k")
        assert specs["tokens"].shape == (128,)
        cfg = arch.full_config()
        C = specs["cache"].k.shape[2]
        if cfg.sliding_window:
            assert C == min(32768, cfg.sliding_window)
        else:
            assert C == 32768
        assert specs["cache"].k.device.type == "meta"
    elif arch.family == "gnn":
        cells = {c.name: c for c in arch.shapes}
        assert cells["full_graph_sm"].params["n_nodes"] == 2708
        assert cells["ogb_products"].params["n_nodes"] == 2449029
        assert cells["molecule"].params["batch"] == 128
        # padded edges stay within 512 of the assigned count
        assert 0 <= cells["ogb_products"].params["n_edges"] - 61859140 < 512
    else:
        specs = arch.input_specs("train_batch")
        lead = next(iter(specs.values())).shape[0]
        assert lead == 65536
        cells = {c.name: c for c in arch.shapes}
        assert tuple(cells) == RECSYS_SHAPES
        if arch_id == "two-tower-retrieval":
            assert cells["retrieval_cand"].params["n_candidates"] == 1_000_000
        else:
            assert cells["retrieval_cand"].params["batch"] == 1_000_000


def test_lm_full_configs_match_assignment():
    cfgs = {a: REG.get(a).full_config() for a in
            ("h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b",
             "qwen3-moe-30b-a3b")}
    c = cfgs["h2o-danube-3-4b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == \
        (24, 3840, 32, 8, 10240, 32000)
    c = cfgs["yi-6b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == \
        (32, 4096, 32, 4, 11008, 64000)
    c = cfgs["gemma-2b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_ff, c.vocab) == \
        (18, 2048, 8, 1, 16384, 256000)
    assert c.head_dim == 256
    c = cfgs["mixtral-8x22b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.vocab) == \
        (56, 6144, 48, 8, 32768)
    assert (c.moe.n_experts, c.moe.top_k, c.moe.d_ff) == (8, 2, 16384)
    c = cfgs["qwen3-moe-30b-a3b"]
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.vocab) == \
        (48, 2048, 32, 4, 151936)
    assert (c.moe.n_experts, c.moe.top_k, c.moe.d_ff) == (128, 8, 768)


def test_gnn_full_config_matches_assignment():
    c = REG.get("nequip").full_config()
    assert (c.n_layers, c.d_hidden, c.l_max, c.n_rbf, c.cutoff) == (5, 32, 2, 8, 5.0)


def test_recsys_full_configs_match_assignment():
    c = REG.get("xdeepfm").full_config()
    assert (c.n_sparse, c.embed_dim, c.cin_layers, c.mlp) == \
        (39, 10, (200, 200, 200), (400, 400))
    c = REG.get("dlrm-rm2").full_config()
    assert (c.n_dense, c.n_sparse, c.embed_dim) == (13, 26, 64)
    assert c.bot_mlp == (512, 256, 64) and c.top_mlp == (512, 512, 256, 1)
    c = REG.get("bst").full_config()
    assert (c.embed_dim, c.seq_len, c.n_blocks, c.n_heads) == (32, 20, 1, 8)
    assert c.mlp == (1024, 512, 256)
    c = REG.get("two-tower-retrieval").full_config()
    assert c.embed_dim == 256 and c.tower_mlp == (1024, 512, 256)


MESH22 = Mesh((2, 2), ("data", "model"), [torch.device("meta")] * 4, streams=False)
# The kernel each family's cells reach on their shape path.
KERNELS = {"mixtral-8x22b": {"stream_topk"}, "qwen3-moe-30b-a3b": {"stream_topk"},
           "knn-paper/query_1m": {"fused_knn"},
           "knn-paper/allpairs_160k": {"pairwise_distance", "stream_topk"},
           "knn-paper/allpairs_2m": {"pairwise_distance", "stream_topk"},
           "two-tower-retrieval/retrieval_cand": {"fused_knn"}}


@pytest.mark.parametrize("arch_id,shape", ALL_CELLS)
def test_cell_traces_smoke(arch_id, shape):
    rec = DR.run_cell(arch_id, shape, False, smoke=True, mesh=MESH22)
    assert rec["status"] == "ok" and rec["devices"] == 4
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert 0 < rec["argument_size_in_bytes"] <= rec["peak_memory_in_bytes_unsharded"]
    want = KERNELS.get(f"{arch_id}/{shape}", KERNELS.get(arch_id, set()))
    assert set(rec["kernel_calls"]) == want
    # the kNN cells, the recommender's and the language models' serve cells
    # (sharded steps) move data between positions
    moves = _sharded(arch_id, shape)
    assert bool(rec["collective_counts"]) == moves
    assert ("collectives" in rec) != moves


def _sharded(arch_id, shape) -> bool:
    """The cells whose steps run over the mesh: the kNN solvers, the
    recommender's steps, the language models' prefill and decode."""
    arch = REG.get(arch_id)
    kind = {c.name: c.kind for c in arch.shapes}[shape]
    return arch.family in ("knn", "recsys") or (arch.family == "lm"
                                                and kind in ("prefill", "decode"))


@pytest.mark.parametrize("arch_id,shape,reason", SKIPPED)
def test_skipped_cells_refuse_to_build(arch_id, shape, reason):
    arch = REG.get(arch_id)
    with pytest.raises(KeyError, match="skipped"):
        arch.build(make_rules(MESH22), shape, smoke=True)
    rec = DR.run_cell(arch_id, shape, False)
    assert rec == {"arch": arch_id, "shape": shape, "mesh": "single", "status": "skip",
                   "reason": reason}


@pytest.mark.parametrize("arch_id,shape", [("qwen3-moe-30b-a3b", "decode_32k"),
                                           ("dlrm-rm2", "train_batch"), ("nequip", "molecule")])
def test_cell_at_full_width_on_the_production_mesh(arch_id, shape):
    rec = DR.run_cell(arch_id, shape, False)
    assert set(KEYS) <= set(rec) and rec["status"] == "ok"
    assert rec["devices"] == 256 and rec["mesh"] == "single" and rec["unrolled"] is False
    assert math.isfinite(rec["flops"]) and rec["flops"] > 0
    assert rec["output_size_in_bytes"] > 0 and rec["transcendentals"] > 0
    if _sharded(arch_id, shape):  # the sharded step: collectives, a per-device peak
        assert rec["collective_counts"] and "collectives" not in rec
        assert rec["argument_size_in_bytes"] < rec["peak_memory_in_bytes"]
    else:
        assert rec["collective_counts"] == {} and rec["collectives"].startswith("not modelled")
    assert rec["argument_size_in_bytes"] < rec["peak_memory_in_bytes_unsharded"]
