"""The language models' prefill and decode sharded over a (data, model) mesh,
against the reference's sharded ``jax.jit`` serve steps, on the CPU.

The reference runs once, in the module fixture ``R``, on 8 forced host
devices (``conftest.run_with_devices``): ``make_host_mesh()`` is (4, 2)
there.  For each of the five LMs at ``smoke_config()`` (fp32; the MoE
expert path bf16) it prefills 4 prompts of 64 tokens through
``make_lm_prefill_step``'s ``shardings_for``, then runs 4 decode steps
through ``make_lm_decode_step``'s, plain and with ``seq_parallel=True``
(each from the prefilled cache), and keeps the logits, every param leaf's
and every cache leaf's ``addressable_shards`` shape, and the same steps
run whole (``prefill``, jitted ``decode_step``): the reference's own gap
between its sharded and whole steps.

The port runs the same steps on a (4, 2) mesh of 8 CPU positions from the
reference's init (``params_from_reference``, ``sharding.shard_tree``), its
caches cut by ``sharding.cache_shardings``.  Held:

* the dense archs' prefill logits within rtol 1e-5 / atol 1e-5 of the
  reference's sharded prefill;
* every step's logits (the prefill, then the decode, plain and
  sequence-parallel) against the port's whole step within rtol 1e-5 and
  atol 1e-5 plus the reference's own gap between its sharded and whole
  step (``_tol``), and against the reference's sharded step within that
  plus the gap between the two packages' whole steps.  The cache is bf16,
  so a last-bit difference in a key (a sum in another order) moves it by
  a bf16 ulp, and the MoE's bf16 expert path does the same to a token's
  output, in either package: the reference's sharded MoE steps leave its
  whole ones by up to 4.5e-3 here (of logits under 0.7), its sharded
  dense decodes by about 1e-5;
* each param leaf's and each cache leaf's part shape equal to the
  reference's shard shape;
* every replica of every cache block byte-equal to the others after every
  step;
* on a (1, 1) mesh, the sharded steps equal the whole steps bit for bit;
* each position's router launches equal ``stream_topk_plain`` on the same
  scores, one a position and layer of each step;
* the sequence-parallel decode's cache parts stay where they are: the same
  storages step after step, and no copy between positions reads one.

The LM serve cells of the dry run trace sharded at smoke size on a 2 x 2
meta mesh, with a per-device peak and collectives.
"""
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.configs import registry as REG
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import Sharded, cache_shardings, make_rules, shard_tree
from repro_torch.kernels import stream_topk as KST
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import attention as A
from repro_torch.models import transformer as Tr
from repro_torch.models.nn import split_params, tree_leaves
from repro_torch.train.checkpoint import unflatten

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x22b", "h2o-danube-3-4b", "gemma-2b", "yi-6b"]
B, P, N = 4, 64, 4  # prompts, prompt tokens, decode steps
TOL = dict(rtol=1e-5, atol=1e-5)

REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.configs import registry as RREG
from repro.distributed import steps as RST
from repro.distributed.sharding import make_rules
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as RT
from repro.models.nn import split_params

mesh = make_host_mesh()
assert dict(mesh.shape) == {"data": 4, "model": 2}, mesh.shape
rules = make_rules(mesh)
out = {}

def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))

def shard_shapes(prefix, tree):
    for i, x in enumerate(jax.tree.leaves(tree)):
        shapes = {tuple(s.data.shape) for s in x.addressable_shards}
        assert len(shapes) == 1, shapes
        out[f"{prefix}.{i}"] = np.asarray(shapes.pop(), np.int64)

toks = np.random.default_rng(3).integers(0, 512, (B, P + N)).astype(np.int32)
out["toks"] = toks
decode_whole = jax.jit(RT.decode_step, static_argnums=(3,))
for aid in ARCHS:
    cfg = RREG.get(aid).smoke_config()
    params = RT.init_params(jax.random.PRNGKey(0), cfg)
    values = split_params(params)[0]
    for i, x in enumerate(jax.tree.leaves(values)):
        out[f"{aid}.init.{i}"] = np.asarray(x)
    abstract = RT.abstract_params(cfg)
    prompt = jnp.asarray(toks[:, :P])
    cache = RT.init_cache(cfg, B, P + N)
    lg, cache = RT.prefill(values, prompt, cfg, cache)
    whole = [f32(lg)]
    for i in range(N):
        lg, cache = decode_whole(values, cache, jnp.asarray(toks[:, P + i]), cfg)
        whole.append(f32(lg))
    out[f"{aid}.whole"] = np.stack(whole)
    _, prefill_for, p_shard = RST.make_lm_prefill_step(cfg, rules, abstract)
    shard_shapes(f"{aid}.shapes.params", jax.device_put(values, p_shard))
    cache = RT.init_cache(cfg, B, P + N)
    lg, cache = prefill_for(prompt, cache)(values, prompt, cache)
    out[f"{aid}.prefill"] = f32(lg)
    shard_shapes(f"{aid}.shapes.cache", cache)
    kv = (None, "batch", "kv_seq", "kv_heads", None)  # the reference's cache_spec
    sp_cut = type(cache)(rules.sharding(kv, cache.k.shape), rules.sharding(kv, cache.v.shape),
                         rules.sharding(("batch",), cache.pos.shape))
    caches = {False: cache, True: jax.device_put(jax.tree.map(jnp.copy, cache), sp_cut)}
    for sp in (False, True):
        _, decode_for, _ = RST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=sp)
        c = caches[sp]
        fn = decode_for(c, jnp.asarray(toks[:, P]))
        logits = []
        for i in range(N):
            lg, c = fn(values, c, jnp.asarray(toks[:, P + i]))
            logits.append(f32(lg))
        tag = "sp" if sp else "plain"
        out[f"{aid}.decode_{tag}"] = np.stack(logits)
        shard_shapes(f"{aid}.shapes.cache_{tag}", c)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def R(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_lm") / "ref.npz"
    consts = f"ARCHS = {ARCHS!r}\nB, P, N = {B}, {P}, {N}\n"
    run_with_devices(f"import sys\nsys.argv = ['', {str(path)!r}]\n" + consts + REFERENCE)
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _leaves(R, prefix):
    out, i = [], 0
    while f"{prefix}.{i}" in R:
        out.append(R[f"{prefix}.{i}"])
        i += 1
    return out


def _mesh(shape):
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"), devices=[torch.device("cpu")] * n)


def _values(R, aid):
    """The reference's init as the port's value tree (on the CPU)."""
    cfg = REG.get(aid).smoke_config()
    like, _ = split_params(REG.get(aid).init_params(cfg, device="meta"))
    return unflatten(like, [torch.from_numpy(a.copy()) for a in _leaves(R, f"{aid}.init")])


def _replicas_equal(tree) -> bool:
    for s in tree_leaves(list(tree)):
        if not isinstance(s, Sharded):
            continue
        for group in s.replica_groups():
            first = s.parts[group[0]].reshape(-1).view(torch.uint8)
            if not all(torch.equal(first, s.parts[q].reshape(-1).view(torch.uint8))
                       for q in group[1:]):
                return False
    return True


class Launches:
    """Every call of ``stream_topk``'s wrapper while active: (x, k, result)."""

    def __init__(self, monkeypatch):
        self.records = []
        orig = KST.stream_topk

        def wrap(x, k, **kw):
            got = orig(x, k, **kw)
            self.records.append((x, k, got))
            return got

        monkeypatch.setattr(KST, "stream_topk", wrap)


def _serve(R, aid, shape, sharded=True, record=None):
    """The port's prefill and N decode steps, plain and sequence-parallel,
    from the reference's init: {"prefill", "decode_plain", "decode_sp"}
    logits, the caches, the params, and whether every replica was
    byte-equal after every step."""
    cfg = REG.get(aid).smoke_config()
    rules = make_rules(_mesh(shape))
    abstract = Tr.abstract_params(cfg)
    toks = torch.from_numpy(R["toks"])
    prefill_step, prefill_for, p_shard = ST.make_lm_prefill_step(cfg, rules, abstract)
    values = _values(R, aid)
    if sharded:
        values = shard_tree(values, p_shard)
    out = {"params": values, "equal": True, "caches": {}, "launches": []}
    for sp in (False, True):
        tag = "sp" if sp else "plain"
        cache = Tr.init_cache(cfg, B, P + N, device="cpu")
        if sharded:
            cache = shard_tree(cache, cache_shardings(rules, cache, sp))
        lg, cache = prefill_for(toks[:, :P], cache)(values, toks[:, :P], cache)
        out[f"prefill_{tag}"] = lg
        out["equal"] &= not sharded or _replicas_equal(cache)
        fn = ST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=sp)[1](cache, toks[:, P])
        logits = []
        for i in range(N):
            n0 = len(record.records) if record is not None else 0
            lg, cache = fn(values, cache, toks[:, P + i])
            logits.append(lg)
            out["equal"] &= not sharded or _replicas_equal(cache)
            if record is not None:
                out["launches"].append(len(record.records) - n0)
        out[f"decode_{tag}"] = torch.stack(logits)
        out["caches"][tag] = cache
    out["prefill"] = out["prefill_plain"]
    return out


@pytest.fixture(scope="module")
def PORT(R):
    """(the port's sharded serve steps of each arch on the (4, 2) mesh, its
    whole steps), run once."""
    cache = {}

    def get(aid):
        if aid not in cache:
            cache[aid] = _serve(R, aid, (4, 2)), _serve(R, aid, (1, 1), sharded=False)
        return cache[aid]

    return get


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _tol(*gaps):
    """rtol 1e-5, atol 1e-5 past the gaps given (module docstring)."""
    return dict(rtol=TOL["rtol"], atol=TOL["atol"] + sum(gaps))


@pytest.mark.parametrize("aid", ARCHS)
def test_sharded_prefill_matches_the_reference(R, PORT, aid):
    got, whole = PORT(aid)
    ref, ref_whole = R[f"{aid}.prefill"], R[f"{aid}.whole"][0]
    ref_gap, wholes_gap = _gap(ref, ref_whole), _gap(whole["prefill"].numpy(), ref_whole)
    # the sequence-parallel cache's prefill (every KV head, the slots cut) alike
    for key in ("prefill_plain", "prefill_sp"):
        np.testing.assert_allclose(got[key].numpy(), whole["prefill"].numpy(), **_tol(ref_gap))
        np.testing.assert_allclose(got[key].numpy(), ref, **_tol(ref_gap, wholes_gap))
        if REG.get(aid).smoke_config().moe is None:
            np.testing.assert_allclose(got[key].numpy(), ref, **TOL)


@pytest.mark.parametrize("tag", ["plain", "sp"])
@pytest.mark.parametrize("aid", ARCHS)
def test_sharded_decode_matches_the_reference(R, PORT, aid, tag):
    got, whole = PORT(aid)
    got, whole = got[f"decode_{tag}"].numpy(), whole[f"decode_{tag}"].numpy()
    assert got.shape == (N, B, REG.get(aid).smoke_config().vocab)
    ref, ref_whole = R[f"{aid}.decode_{tag}"], R[f"{aid}.whole"][1:]
    for i in range(N):
        ref_gap, wholes_gap = _gap(ref[i], ref_whole[i]), _gap(whole[i], ref_whole[i])
        np.testing.assert_allclose(got[i], whole[i], **_tol(ref_gap))
        np.testing.assert_allclose(got[i], ref[i], **_tol(ref_gap, wholes_gap))


@pytest.mark.parametrize("aid", ARCHS)
def test_part_shapes_match_the_reference(R, PORT, aid):
    got = PORT(aid)[0]
    shapes = [tuple(s.parts[0].shape) for s in tree_leaves(got["params"])]
    want = [tuple(int(x) for x in a) for a in _leaves(R, f"{aid}.shapes.params")]
    assert shapes == want
    for tag in ("plain", "sp"):
        cache = got["caches"][tag]
        assert all(isinstance(x, Sharded) for x in cache)
        shapes = [tuple(x.parts[0].shape) for x in cache]
        want = [tuple(int(x) for x in a) for a in _leaves(R, f"{aid}.shapes.cache_{tag}")]
        assert shapes == want, tag
    if aid == "gemma-2b":  # one KV head: whole on every position, the query heads cut
        assert got["caches"]["plain"].k.sharding.spec == (None, "data", None, None, None)
        assert got["params"]["layers"]["wq"].sharding.spec == (None, "data", "model", None)


@pytest.mark.parametrize("aid", ARCHS)
def test_cache_replicas_stay_byte_equal(PORT, aid):
    assert PORT(aid)[0]["equal"]


@pytest.mark.parametrize("aid", ARCHS)
def test_one_position_mesh_is_bit_equal_to_the_whole_step(R, aid):
    whole = _serve(R, aid, (1, 1), sharded=False)
    one = _serve(R, aid, (1, 1))
    assert isinstance(one["caches"]["plain"].k, Sharded)
    for key in ("prefill_plain", "prefill_sp", "decode_plain", "decode_sp"):
        assert torch.equal(one[key], whole[key]), key
    for tag in ("plain", "sp"):
        for a, b in zip(one["caches"][tag], whole["caches"][tag]):
            assert torch.equal(a.parts[0], b), tag


@pytest.mark.parametrize("aid", ["qwen3-moe-30b-a3b", "mixtral-8x22b"])
def test_each_position_routes_on_stream_topk(R, monkeypatch, aid):
    record = Launches(monkeypatch)
    cfg = REG.get(aid).smoke_config()
    got = _serve(R, aid, (4, 2), record=record)
    # one launch a position and a layer, each decode step
    assert got["launches"] == [8 * cfg.n_layers] * (2 * N)
    assert len(record.records) == 8 * cfg.n_layers * 2 * (N + 1)
    for x, k, (v, i) in record.records:
        pv, pi = KST.stream_topk_plain(x, k)
        assert torch.equal(i, pi) and torch.equal(v, pv)
    whole = _serve(R, aid, (1, 1), sharded=False)
    ref_gap = _gap(R[f"{aid}.prefill"], R[f"{aid}.whole"][0])
    np.testing.assert_allclose(got["prefill"].numpy(), whole["prefill"].numpy(), **_tol(ref_gap))


def test_sequence_parallel_cache_stays_resident(R, monkeypatch):
    """No decode step moves a cache part: each position's slots are the same
    storage from step to step, and nothing as large as a part is copied
    between positions."""
    aid = "yi-6b"
    cfg = REG.get(aid).smoke_config()
    rules = make_rules(_mesh((4, 2)))
    abstract = Tr.abstract_params(cfg)
    toks = torch.from_numpy(R["toks"])
    values = shard_tree(_values(R, aid), ST.make_lm_prefill_step(cfg, rules, abstract)[2])
    cache = Tr.init_cache(cfg, B, P + N, device="cpu")
    cache = shard_tree(cache, cache_shardings(rules, cache, seq_parallel=True))
    assert cache.k.sharding.spec == (None, "data", "model", None, None)
    ST.make_lm_prefill_step(cfg, rules, abstract)[0](values, toks[:, :P], cache)
    ptrs = [t.untyped_storage().data_ptr() for x in cache for t in x.parts]
    copied = []
    orig = Mesh.copy

    def copy(self, t, src, dst):
        copied.append(t.untyped_storage().data_ptr())
        return orig(self, t, src, dst)

    monkeypatch.setattr(Mesh, "copy", copy)
    fn = ST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=True)[1](cache, toks[:, P])
    before = [t.clone() for t in cache.k.parts[:2]]  # slots 0-33 and 34-67 of batch row 0
    for i in range(N):
        fn(values, cache, toks[:, P + i])
        assert [t.untyped_storage().data_ptr() for x in cache for t in x.parts] == ptrs
    assert copied and not set(copied) & set(ptrs)
    # positions 64-67 land in the second position's range, written in place there only
    assert torch.equal(cache.k.parts[0], before[0])
    assert not torch.equal(cache.k.parts[1], before[1])
    assert [int(x) for x in cache.pos.whole()] == [P + N] * B


def test_query_heads_must_cover_whole_groups():
    """A position's query heads that straddle two KV groups are refused."""
    mesh = _mesh((1, 4))
    from repro_torch.distributed import spmd

    with spmd.body(mesh):
        k = spmd.Local([torch.zeros(1, 2, 2, 4)] * 4)  # 2 KV heads, whole
        ok = A.kv_for_queries(k, 8, ("model",), ())  # 2 query heads a position, groups of 4
        assert [tuple(t.shape) for t in ok.parts] == [(1, 2, 1, 4)] * 4
        with pytest.raises(ValueError, match="whole groups"):  # 6 heads a position, groups of 4
            A.kv_for_queries(spmd.Local([torch.zeros(1, 2, 6, 4)] * 4), 24, ("model",), ())


MESH22 = Mesh((2, 2), ("data", "model"), [torch.device("meta")] * 4, streams=False)


@pytest.mark.parametrize("shape,variant", [("prefill_32k", None), ("decode_32k", None),
                                           ("decode_32k", "sp")])
@pytest.mark.parametrize("aid", ARCHS)
def test_lm_serve_cells_trace_sharded(aid, shape, variant):
    rec = DR.run_cell(aid, shape, False, smoke=True, mesh=MESH22, variant=variant)
    assert rec["status"] == "ok" and rec["devices"] == 4
    assert "collectives" not in rec and rec["collective_counts"]
    assert rec["collective_wire_bytes_per_device"] > 0
    assert 0 < rec["peak_memory_in_bytes"] < rec["peak_memory_in_bytes_unsharded"]
    moe = REG.get(aid).smoke_config().moe is not None
    assert set(rec["kernel_calls"]) == ({"stream_topk"} if moe else set())
