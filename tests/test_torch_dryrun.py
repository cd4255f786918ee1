"""The dry run (``repro_torch.launch.dryrun``) and the kernels' shape paths.

* The CLI in a subprocess, as a user runs it: two ``ok`` records with the
  reference's shared keys, an unknown shape recorded as ``fail`` with exit
  1, ``--unroll`` changing nothing but the flag.
* Every kernel wrapper on meta tensors: its CPU outputs' shapes and dtypes,
  neither its plain version nor a launch run, one shape call recorded with
  the FLOPs of ``PERF.md``'s bound column, the card's refusals kept.
* The counts against sums written out here: ``knn-paper/query_1m`` and
  ``dlrm-rm2/serve_p99`` at smoke size (the latter sharded over 2 x 2
  positions).
* ``run_cell`` initialises no CUDA and leaves the environment as it was.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _backend as B
from repro_torch.kernels import fused_knn as FK
from repro_torch.kernels import ivf_scan as IVS
from repro_torch.kernels import merge_partials as MP
from repro_torch.kernels import pairwise_distance as PD
from repro_torch.kernels import pq_scan as PQS
from repro_torch.kernels import rescore as RS
from repro_torch.kernels import stream_topk as ST
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh

REPO = Path(__file__).resolve().parents[1]
SHARED = ("arch", "shape", "mesh", "devices", "unrolled", "status", "argument_size_in_bytes",
          "output_size_in_bytes", "flops", "bytes_accessed", "transcendentals",
          "collective_counts", "collective_result_bytes", "collective_wire_bytes_per_device")
MESH22 = Mesh((2, 2), ("data", "model"), [torch.device("meta")] * 4, streams=False)


def _cli(*args, out):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """Three runs of the CLI into one file: the cell on both meshes, the
    same cell with --unroll into a second file, an unknown shape."""
    d = tmp_path_factory.mktemp("dryrun")
    runs = {
        "both": _cli("--arch", "dlrm-rm2", "--shape", "serve_p99", "--mesh", "both",
                     out=d / "out.json"),
        "unroll": _cli("--arch", "dlrm-rm2", "--shape", "serve_p99", "--unroll",
                       out=d / "unroll.json"),
        "bad": _cli("--arch", "dlrm-rm2", "--shape", "no_such_shape", out=d / "out.json"),
    }
    return runs, json.loads((d / "out.json").read_text()), json.loads(
        (d / "unroll.json").read_text())


def test_cli_records_both_meshes(cli):
    runs, data, _ = cli
    assert runs["both"].returncode == 0, runs["both"].stderr[-2000:]
    for mesh, n in (("single", 256), ("multi", 512)):
        rec = data[f"dlrm-rm2|serve_p99|{mesh}"]
        assert set(SHARED) <= set(rec)
        assert rec["status"] == "ok" and rec["devices"] == n and rec["unrolled"] is False
        assert f"[dryrun] dlrm-rm2/serve_p99/{mesh}" in runs["both"].stdout
    assert "0 failures" in runs["both"].stdout
    # The batch rows split over the data-parallel axes, the tables' rows over "model".
    single, multi = data["dlrm-rm2|serve_p99|single"], data["dlrm-rm2|serve_p99|multi"]
    assert multi["argument_size_in_bytes"] < single["argument_size_in_bytes"]
    assert multi["flops"] == single["flops"]


def test_cli_records_an_unknown_shape_as_a_failure(cli):
    runs, data, _ = cli
    assert runs["bad"].returncode == 1
    rec = data["dlrm-rm2|no_such_shape|single"]
    assert rec["status"] == "fail" and rec["error"].startswith("KeyError") and rec["trace"]
    assert "FAIL" in runs["bad"].stdout and "1 failures" in runs["bad"].stdout
    assert data["dlrm-rm2|serve_p99|single"]["status"] == "ok"  # merged, not replaced


def test_cli_unroll_changes_only_the_flag(cli):
    runs, data, unrolled = cli
    assert runs["unroll"].returncode == 0
    a, b = data["dlrm-rm2|serve_p99|single"], unrolled["dlrm-rm2|serve_p99|single"]
    assert b["unrolled"] is True
    skip = {"unrolled", "trace_s"}
    assert {k: v for k, v in a.items() if k not in skip} == \
        {k: v for k, v in b.items() if k not in skip}


@pytest.mark.parametrize("arch_id,shape", [("gemma-2b", "train_4k"),
                                           ("knn-paper", "allpairs_160k")])
def test_unroll_counts_every_trip_either_way(arch_id, shape):
    """The layer scan and the ring are Python loops: equal counts."""
    a = DR.run_cell(arch_id, shape, False, smoke=True, mesh=MESH22)
    b = DR.run_cell(arch_id, shape, False, smoke=True, mesh=MESH22, unroll=True)
    assert (a["unrolled"], b["unrolled"]) == (False, True)
    for key in ("flops", "bytes_accessed", "op_counts", "kernel_calls", "collective_counts",
                "collective_result_bytes", "peak_memory_in_bytes_unsharded"):
        assert a[key] == b[key], key


def test_run_cell_initialises_no_cuda_and_leaves_the_environment():
    env = dict(os.environ)
    DR.run_cell("knn-paper", "query_1m", False, smoke=True, mesh=MESH22)
    assert not torch.cuda.is_initialized()
    assert dict(os.environ) == env
    code = ("import os, torch\nenv = dict(os.environ)\n"
            "from repro_torch.launch import dryrun\n"
            "dryrun.run_cell('dlrm-rm2', 'serve_p99', False)\n"
            "print(torch.cuda.is_initialized(), dict(os.environ) == env)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(REPO / "src")), timeout=300)
    assert proc.stdout.split() == ["False", "True"], proc.stderr[-2000:]


def test_flops_of_query_1m_are_the_fused_products():
    """64 queries over 1024 rows, d 32, on 2 x 2 positions: each position
    scans its quarter, and the whole is 2 m n d."""
    rec = DR.run_cell("knn-paper", "query_1m", False, smoke=True, mesh=MESH22)
    assert rec["flops"] == 2 * 64 * 1024 * 32
    assert rec["kernel_calls"] == {"fused_knn": 4}
    assert rec["collective_counts"] == {"collective-permute": 2}


def test_flops_of_dlrm_serve_are_its_products():
    """The smoke DLRM on 32 rows, sharded over 2 x 2 positions: each
    position scores its 16 rows of the batch ("data"); the bottom MLP
    13-32-16 (the hidden layer's columns split over "model", the last layer
    whole), the dot interaction of 27 features of 16 (one bmm a position),
    the top MLP 367-32-16-1 (367 = 27 * 26 / 2 pairs + 16; both hidden
    layers split).  Whatever is whole is recomputed on each "model"
    position."""
    B_, F_, D_ = 32, 27, 16
    b = B_ // 2
    bottom = 2 * b * (13 * 16 + 32 * 16)
    interaction = 2 * b * F_ * F_ * D_
    top = 2 * b * (367 * 16 + 32 * 8 + 16 * 1)
    rec = DR.run_cell("dlrm-rm2", "serve_p99", False, smoke=True, mesh=MESH22)
    assert rec["flops"] == 4 * (bottom + interaction + top)
    assert rec["op_counts"]["aten.bmm"] == 4 and rec["kernel_calls"] == {}
    assert rec["transcendentals"] == 2 * B_  # each position's rows' sigmoid


# ---------------------------------------------------------------------------
# The kernel wrappers on meta tensors.
# ---------------------------------------------------------------------------


def _on(x, dev):
    """``x`` (a tensor, or a tuple or dict of them) on ``dev``; on meta, empty
    tensors of its shapes and dtypes."""
    if isinstance(x, torch.Tensor):
        if torch.device(dev).type == "meta":
            return torch.empty_like(x, device="meta")
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    return x


def wrapper_cases():
    """name -> (call(args), args on the CPU, FLOPs of one launch): every
    kernel wrapper at a small shape.  The IVF probes name distinct cells,
    each scanned whole, so the tile table's width is its bound on the CPU
    too."""
    g = torch.Generator().manual_seed(0)
    m, n, d, k, S_, m8 = 24, 200, 16, 5, 4, 4

    def r(*shape):
        return torch.randn(*shape, generator=g)

    K = 8
    part = torch.sort(r(S_, m8, K), dim=-1).values
    ncells, cap, tile_m, W = 6, 32, 8, 3
    probes = torch.stack([torch.randperm(ncells, generator=g)[:W] for _ in range(3)]).int()
    extent = torch.full((ncells,), cap, dtype=torch.int32)
    S = ncells * cap
    pq_m, ncodes = 4, 16
    ivf = dict(probes=probes, fx=r(m, d), gy=r(S, d), hx=r(m, 1), hy=r(1, S), extent=extent)
    pq = dict(probes=probes, luts=r(m, pq_m * ncodes),
              codes=torch.randint(0, ncodes, (S, pq_m), generator=g, dtype=torch.uint8),
              hx=r(m, 1), hy=r(1, S), extent=extent)
    return {
        "fused_knn": (lambda a: FK.fused_knn(a["fx"], a["gy"], a["hx"], a["hy"], k,
                                             distance_finalize="identity", alpha=-2.0,
                                             n_real=n),
                      dict(fx=r(m, d), gy=r(n, d), hx=r(m, 1), hy=r(1, n)), 2.0 * m * n * d),
        "merge_partials": (lambda a: MP.merge_partials(a["v"], a["i"]),
                           dict(v=part, i=torch.randint(0, 99, part.shape, generator=g,
                                                        dtype=torch.int32)), 0.0),
        "pairwise_distance": (lambda a: PD.pairwise_distance(a["fx"], a["gy"], a["hx"], a["hy"],
                                                             alpha=-2.0, finalize="identity"),
                              dict(fx=r(m, d), gy=r(n, d), hx=r(m, 1), hy=r(1, n)),
                              2.0 * m * n * d),
        "pairwise_cumulative": (lambda a: PD.pairwise_distance_cumulative(
            a["x"], a["y"], accumulate="hellinger", finalize="half_sqrt"),
            dict(x=r(m, d).abs(), y=r(n, d).abs()), 4.0 * m * n * d),
        "stream_topk": (lambda a: ST.stream_topk(a["x"], k), dict(x=r(m, n)), 1.0 * m * n),
        "rescore_topk": (lambda a: RS.rescore_topk(a["fx"], a["cand"], a["hx"], a["hy"], k,
                                                   alpha=-2.0, finalize="identity"),
                         dict(fx=r(m, d), cand=r(m, 12, d), hx=r(m, 1), hy=r(m, 12)),
                         2.0 * m * 12 * d),
        "ivf_scan_table": (lambda a: IVS.build_table(a["probes"], a["extent"], cap, 2),
                           dict(probes=probes, extent=extent), 0.0),
        "ivf_scan": (lambda a: IVS.ivf_scan(a["probes"], a["fx"], a["gy"], a["hx"], a["hy"], k,
                                            cell_cap=cap, tile_m=tile_m,
                                            cell_extent=a["extent"], distance_finalize="identity",
                                            alpha=-2.0),
                     ivf, 2.0 * m * W * cap * d),
        "pq_scan": (lambda a: PQS.pq_scan(a["probes"], a["luts"], a["codes"], a["hx"], a["hy"],
                                          k, cell_cap=cap, ncodes=ncodes, tile_m=tile_m,
                                          cell_extent=a["extent"], distance_finalize="identity"),
                    pq, 1.0 * m * W * cap * pq_m),
    }


def _layout(out):
    return [(tuple(t.shape), t.dtype) for t in out] if isinstance(out, tuple) else \
        [(tuple(out.shape), out.dtype)]


PLAIN = [(FK, "fused_knn_plain"), (MP, "merge_partials_plain"), (PD, "pairwise_distance_plain"),
         (PD, "pairwise_cumulative_plain"), (ST, "stream_topk_plain"),
         (RS, "rescore_topk_plain"), (IVS, "tile_table"), (IVS, "ivf_scan_plain"),
         (PQS, "pq_scan_plain"), (B, "launch"), (B, "call")]


@pytest.mark.parametrize("name", list(wrapper_cases()))
def test_wrapper_meta_outputs_match_the_cpu(name, monkeypatch):
    call, args, flops = wrapper_cases()[name]
    want = _layout(call(args))
    meta_args = _on(args, "meta")

    def refuse(*a, **kw):
        raise AssertionError("ran on meta tensors")

    for mod, attr in PLAIN:
        monkeypatch.setattr(mod, attr, refuse)
    with B.shape_calls() as calls:
        got = call(meta_args)
    assert _layout(got) == want
    assert all(t.device.type == "meta" for t in (got if isinstance(got, tuple) else (got,)))
    assert [c[:2] for c in calls] == [(name, flops)]
    assert calls[0][2] > 0


@pytest.mark.parametrize("name", ["fused_knn", "stream_topk", "merge_partials", "rescore_topk",
                                  "ivf_scan", "pq_scan"])
def test_meta_refuses_past_the_cards_k(name):
    call, args, _ = wrapper_cases()[name]
    import repro_torch.kernels.stream_topk as st_mod

    a = _on(args, "meta")
    if name == "merge_partials":
        a = dict(v=torch.empty((2, 3, 8192), device="meta"),
                 i=torch.empty((2, 3, 8192), dtype=torch.int32, device="meta"))
        with pytest.raises(ValueError, match=str(st_mod.MAX_SELECT_K)):
            call(a)
        return
    wide = {"fused_knn": lambda a: FK.fused_knn(a["fx"], a["gy"], a["hx"], a["hy"], 5000,
                                                distance_finalize="identity", alpha=-2.0,
                                                n_real=200),
            "stream_topk": lambda a: ST.stream_topk(a["x"], 5000),
            "rescore_topk": lambda a: RS.rescore_topk(a["fx"], a["cand"], a["hx"], a["hy"], 5000,
                                                      alpha=-2.0, finalize="identity"),
            "ivf_scan": lambda a: IVS.ivf_scan(a["probes"], a["fx"], a["gy"], a["hx"], a["hy"],
                                               5000, cell_cap=32, tile_m=8,
                                               cell_extent=a["extent"],
                                               distance_finalize="identity", alpha=-2.0),
            "pq_scan": lambda a: PQS.pq_scan(a["probes"], a["luts"], a["codes"], a["hx"],
                                             a["hy"], 5000, cell_cap=32, ncodes=16, tile_m=8,
                                             cell_extent=a["extent"],
                                             distance_finalize="identity")}[name]
    with pytest.raises(ValueError, match=str(st_mod.MAX_SELECT_K)):
        wide(a)


def test_mixed_meta_and_cpu_operands_raise():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="several devices"):
        B.on_meta(x, torch.empty(4, 8, device="meta"))
    assert not B.on_meta(x) and B.on_meta(torch.empty(1, device="meta"))
