"""The port's int8 error-feedback all-reduce (``repro_torch.train.compression``)
against the JAX package's.

The reference runs ONCE for the whole file: one module-scoped fixture runs
``repro.train.compression.compressed_psum_tree`` inside ``jax.shard_map``
in a subprocess with 8 forced host devices, on the arrays of
``tests/test_distributed_knn.py::test_compressed_psum_tree`` (seed 5; 257
and 132 elements a leaf, padded to a multiple of P), then a second round
with the first round's residuals fed back, and on meshes of 3 and 1
devices.  The port runs the same draws on meshes of CPU positions.

Tolerance: none.  Sums and residuals equal the reference's bit for bit,
on every position: the port computes as XLA compiles the reference (the
module docstring of ``train/compression.py``), and an int8 value that
rounded the other way would be off by a whole scale step, max / 127.
"""
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.launch import hlo_stats
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.compression import compressed_psum, compressed_psum_tree, init_error_state

REFERENCE = """
import functools, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.train.compression import compressed_psum_tree

out = {}
np.random.seed(5)
g = {"a": np.random.randn(8, 257).astype(np.float32),
     "b": np.random.randn(8, 4, 33).astype(np.float32)}
g2 = {"a": np.random.randn(8, 257).astype(np.float32),
      "b": np.random.randn(8, 4, 33).astype(np.float32)}
zeros = {k: np.zeros_like(v) for k, v in g.items()}

def run(devices, g, e):
    mesh = jax.sharding.Mesh(np.array(devices), ("dp",))
    spec = {"a": P("dp"), "b": P("dp")}
    @functools.partial(jax.shard_map, mesh=mesh, in_specs=(spec,) * 2, out_specs=(spec,) * 2,
                       check_vma=False)
    def body(gl, el):
        s, ne = compressed_psum_tree({k: v[0] for k, v in gl.items()},
                                     {k: v[0] for k, v in el.items()}, "dp")
        return ({k: v[None] for k, v in s.items()}, {k: v[None] for k, v in ne.items()})
    n = len(devices)
    s, ne = jax.jit(body)({k: jnp.asarray(v[:n]) for k, v in g.items()},
                          {k: jnp.asarray(v[:n]) for k, v in e.items()})
    return {k: np.asarray(v) for k, v in s.items()}, {k: np.asarray(v) for k, v in ne.items()}

cases = {"p8": (8, g, zeros), "p3": (3, g, zeros), "p1": (1, g, zeros)}
res = {}
for name, (n, gg, ee) in cases.items():
    res[name] = (gg, ee, *run(jax.devices()[:n], gg, ee))
res["p8_feedback"] = (g2, res["p8"][3], *run(jax.devices()[:8], g2, res["p8"][3]))
flat = {}
for name, (gg, ee, s, ne) in res.items():
    n = s["a"].shape[0]
    for k in ("a", "b"):
        flat[f"{name}.g.{k}"] = gg[k][:n]
        flat[f"{name}.e.{k}"] = ee[k][:n]
        flat[f"{name}.s.{k}"] = s[k]
        flat[f"{name}.ne.{k}"] = ne[k]
np.savez(sys.argv[1], **flat)
print("OK")
"""

CASES = ("p8", "p8_feedback", "p3", "p1")


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    """Every reference result of this file, from one subprocess run."""
    path = tmp_path_factory.mktemp("compression") / "reference.npz"
    run_with_devices(f"import sys\nsys.argv = ['', {str(path)!r}]\n" + REFERENCE)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _cpu_mesh(n):
    return make_mesh((n,), ("dp",), devices=[torch.device("cpu")] * n)


def _run(R, case):
    """The port on the case's inputs: (sum trees, residual trees), one a position."""
    n = R[f"{case}.g.a"].shape[0]
    grads = [{k: torch.from_numpy(R[f"{case}.g.{k}"][p].copy()) for k in ("a", "b")}
             for p in range(n)]
    errs = [{k: torch.from_numpy(R[f"{case}.e.{k}"][p].copy()) for k in ("a", "b")}
            for p in range(n)]
    return compressed_psum_tree(_cpu_mesh(n), list(range(n)), grads, errs)


@pytest.mark.parametrize("case", CASES)
def test_sums_and_residuals_equal_the_reference(R, case):
    sums, errs = _run(R, case)
    for k in ("a", "b"):
        for p in range(len(sums)):
            np.testing.assert_array_equal(sums[p][k].numpy(), R[f"{case}.s.{k}"][p])
            np.testing.assert_array_equal(errs[p][k].numpy(), R[f"{case}.ne.{k}"][p])


@pytest.mark.parametrize("case", CASES)
def test_within_the_reference_gate_of_the_fp32_sum(R, case):
    """The reference's own gate (``tests/test_distributed_knn.py:149``): every
    leaf within relative 0.05 of the fp32 sum, on every position."""
    sums, _ = _run(R, case)
    for k in ("a", "b"):
        true = R[f"{case}.g.{k}"].sum(0) + R[f"{case}.e.{k}"].sum(0)
        for s in sums:
            rel = np.abs(s[k].numpy() - true).max() / (np.abs(true).max() + 1e-9)
            assert rel < 0.05, (k, rel)


def test_residual_is_what_the_source_failed_to_send(R):
    """P = 1: the sum is the dequantized gradient, and sum + residual is the
    input exactly where no rounding of the subtraction intervenes."""
    sums, errs = _run(R, "p1")
    for k in ("a", "b"):
        g = torch.from_numpy(R[f"p1.g.{k}"][0])
        assert torch.allclose(sums[0][k] + errs[0][k], g, rtol=0, atol=1e-6)
        scale = g.abs().max() / 127
        assert float(errs[0][k].abs().max()) <= float(scale) / 2 * (1 + 1e-6)


def test_the_wire_carries_int8(R):
    """One scale all-reduce, 2(P-1) ring permutes (int8 chunk, fp32 scale),
    two all-gathers; the int8 ring moves about a quarter of an fp32 one."""
    n, P = 257, 8
    m = -(-n // P)
    mesh = _cpu_mesh(P)
    g = [torch.from_numpy(R["p8.g.a"][p].copy()) for p in range(P)]
    with hlo_stats.recording() as events:
        compressed_psum(mesh, list(range(P)), g, [torch.zeros(n)] * P)
    st = hlo_stats.collect_stats(events, P)
    assert st.counts == {"all-reduce": 1, "collective-permute": 2 * (P - 1), "all-gather": 2}
    assert st.result_bytes == {"all-reduce": 4, "collective-permute": (P - 1) * (m + 4),
                               "all-gather": P * m + P * 4}
    fp32_ring = 2 * (P - 1) / P * (P * m * 4)
    assert st.wire_bytes_per_device < 0.3 * fp32_ring


def test_init_error_state_is_zero_fp32():
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16), "b": [torch.ones(4)]}
    e = init_error_state(params)
    assert e["w"].dtype == torch.float32 and e["w"].shape == (3, 2)
    assert not e["w"].any() and not e["b"][0].any()
