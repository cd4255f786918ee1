"""Collective accounting: the port's ``launch.hlo_stats`` against the JAX
package's.

The reference reads collective ops from compiled HLO text; the port counts
the collective events its mesh programs note.  The same five synthetic
collectives go to both (HLO lines to the reference, events to the port)
and must give equal counts, result bytes and wire bytes.  Then the ring
all-pairs on 8 positions: the port's events on a mesh of meta positions
against the schedule's own count, written out here, and against the
reference's compiled HLO under ``accounting.set_unroll(True)`` on 8 forced
host devices (one subprocess for the file).
"""
import json

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.launch import hlo_stats as RH
from repro_torch.core import distributed as D
from repro_torch.launch import hlo_stats as H
from repro_torch.launch.mesh import Mesh

SHAPES = [  # (HLO type string, (dtype, shape) of the port)
    ("f32[16,128]", ("f32", (16, 128))),
    ("bf16[2,4]{1,0}", (torch.bfloat16, (2, 4))),
    ("s32[8]", (torch.int32, (8,))),
    ("u8[100]", (torch.uint8, (100,))),
    ("token[]", ("token", ())),
]


@pytest.mark.parametrize("hlo,port", SHAPES, ids=[s for s, _ in SHAPES])
def test_shape_bytes(hlo, port):
    assert H._shape_bytes(*port) == RH._shape_bytes(hlo)


def test_collect_stats_synthetic_matches_the_reference():
    hlo = """
  %ag = f32[64,128]{1,0} all-gather(f32[4,128] %x), replica_groups=[16,16], dimensions={0}
  %ar.1 = bf16[1024]{0} all-reduce(bf16[1024] %y), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = f32[256]{0} collective-permute(f32[256] %z), source_target_pairs={{0,1}}
  %ags = (f32[32], f32[32]) all-gather-start(f32[2] %a, f32[2] %b), replica_groups=[4,16]
  %agd = f32[32] all-gather-done((f32[32]) %ags)
"""
    events = [
        H.Collective("all-gather", (("f32", (64, 128)),), 16),
        H.Collective("all-reduce", ((torch.bfloat16, (1024,)),), 4),
        H.Collective("collective-permute", (("f32", (256,)),)),
        H.Collective("all-gather", (("f32", (32,)), ("f32", (32,))), 16),
    ]
    want, got = RH.collect_stats(hlo, 256), H.collect_stats(events, 256)
    assert got.counts == want.counts == {"all-gather": 2, "all-reduce": 1,
                                         "collective-permute": 1}
    assert got.result_bytes == want.result_bytes
    assert got.wire_bytes_per_device == pytest.approx(want.wire_bytes_per_device, rel=1e-12)
    assert got.total_result_bytes() == want.total_result_bytes()


def test_one_device_share_of_grouped_events():
    """Events over groups of positions count on the positions that took
    part; an event without positions on every device; the busiest
    device's share is the result."""
    a = torch.empty(8, device="meta")
    with H.recording() as events:
        H.note("collective-permute", [a], [0, 1])
        H.note("collective-permute", [a], [2, 3])
        H.note("collective-permute", [a], [0, 2])
    events.append(H.Collective("all-reduce", (("f32", (2,)),), 4))
    st = H.collect_stats(events, 4)
    assert st.counts == {"collective-permute": 2, "all-reduce": 1}
    assert st.result_bytes == {"collective-permute": 64, "all-reduce": 8}
    assert st.wire_bytes_per_device == 64 + 2 * 3 / 4 * 8
    H.note("all-gather", [a], [0])  # no recording open: dropped
    assert len(events) == 4


REFERENCE = """
import json
import jax, jax.numpy as jnp
from repro import accounting
from repro.core import distributed as D
from repro.launch.hlo_stats import collect_stats
accounting.set_unroll(True)
mesh = jax.make_mesh((8,), ("ring",), axis_types=(jax.sharding.AxisType.Auto,))
out = {}
for wire in ("f32", "bf16"):
    for n in (1024, 1000):
        fn = D.make_ring_allpairs(mesh, k=9, wire_dtype=None if wire == "f32" else jnp.bfloat16)
        hlo = jax.jit(lambda x: fn(x, n)).lower(jnp.zeros((1024, 32), jnp.float32)).compile()
        st = collect_stats(hlo.as_text(), 8)
        out[f"{wire}/{n}"] = [st.counts, st.result_bytes, st.wire_bytes_per_device]
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def R():
    """The reference ring's collective stats, from one subprocess run."""
    out = run_with_devices(REFERENCE)
    return json.loads(out.split("JSON", 1)[1])


def _port_ring(wire, n):
    mesh = Mesh((8,), ("ring",), [torch.device("meta")] * 8, streams=False)
    fn = D.make_ring_allpairs(mesh, k=9, wire_dtype=None if wire == "f32" else torch.bfloat16)
    with H.recording() as events:
        fn(torch.empty((1024, 32), device="meta"), n)
    return H.collect_stats(events, 8)


def _schedule(wire):
    """P = 8, symmetric: P / 2 = 4 hops, each carrying the visiting block
    [128, 32], its heap's values [128, 16] and ids [128, 16]; then one
    rotation of the values and one of the ids homes the heaps: 14 permutes."""
    n_loc, d, K = 128, 32, 16
    wb = 4 if wire == "f32" else 2
    block, vals, ids = n_loc * d * wb, n_loc * K * wb, n_loc * K * 4
    return 4 * (block + vals + ids) + vals + ids


# XLA on the CPU moves the bf16 wire's final ``astype(float32)`` ahead of
# the permute that homes the heaps' values, so that one [128, 16] permute
# carries fp32 in the reference's compiled program (a deliberate
# difference, ``ROADMAP.md`` section 3): the port ships what the schedule
# says, bf16.
HOMING_UPCAST = {"f32": 0, "bf16": 128 * 16 * 2}


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ring_collectives_match_the_schedule_and_the_reference(R, wire):
    """n = 1024 = 8 x 128: XLA keeps the schedule's 14 permutes as 14
    ``collective-permute``s, none merged or split."""
    st = _port_ring(wire, 1024)
    assert st.counts == {"collective-permute": 14}
    assert st.result_bytes == {"collective-permute": _schedule(wire)}
    assert st.wire_bytes_per_device == _schedule(wire)
    counts, rbytes, wire_b = R[f"{wire}/1024"]
    want = _schedule(wire) + HOMING_UPCAST[wire]
    assert counts == st.counts
    assert rbytes == {"collective-permute": want} and wire_b == want


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_ring_collectives_past_a_ragged_n(R, wire):
    """n = 1000 on 8 x 128 padded rows: the port's schedule is unchanged,
    and XLA adds two permutes of [21, 16] (fp32 values, int32 ids) that
    re-shard the result's first n rows (a deliberate difference,
    ``ROADMAP.md`` section 3): the port hands its results back whole."""
    st = _port_ring(wire, 1000)
    assert st.counts == {"collective-permute": 14}
    assert st.result_bytes == {"collective-permute": _schedule(wire)}
    counts, rbytes, wire_b = R[f"{wire}/1000"]
    want = _schedule(wire) + HOMING_UPCAST[wire] + 2 * 21 * 16 * 4
    assert counts == {"collective-permute": 16}
    assert rbytes == {"collective-permute": want} and wire_b == want


def test_butterfly_is_log2_p_hops_of_two_permutes():
    mesh = Mesh((8,), ("x",), [torch.device("cpu")] * 8, streams=False)
    rng = np.random.default_rng(0)
    v = [torch.from_numpy(np.sort(rng.standard_normal((4, 8)).astype(np.float32), 1))
         for _ in range(8)]
    i = [torch.arange(32, dtype=torch.int32).reshape(4, 8) for _ in range(8)]
    with H.recording() as events:
        D.tree_merge_topk(mesh, list(range(8)), v, i)
    st = H.collect_stats(events, 8)
    assert st.counts == {"collective-permute": 6}
    assert st.result_bytes == {"collective-permute": 3 * (4 * 8 * 4 * 2)}
