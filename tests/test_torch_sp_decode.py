"""Sequence-parallel (flash-decoding) decode of the port
(``distributed.steps.make_lm_decode_step(seq_parallel=True)``) against its
plain decode and against the JAX package's, on the CPU.

The port's copies of the two tests of ``tests/test_sp_decode.py``, on a
(2, 4) mesh of CPU positions (batch over "data", the cache's slots over
"model"), with the reference's bounds; beside them the reference's own
logits from the same params (its plain decode and forward, run once in the
module fixture ``R``), within rtol and atol 1e-4 (fp32 throughout; the
cache's bf16 rounds alike in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro.models.nn import split_params as ref_split
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer as Tr

TOL = dict(rtol=1e-4, atol=1e-4)
PREF, STEPS = 16, 6


def _cfgs(window):
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab=256, sliding_window=window)
    return RT.TransformerConfig(**kw, dtype=jnp.float32), Tr.TransformerConfig(
        **kw, dtype=torch.float32)


def _one_cfgs():
    kw = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=1, head_dim=8, d_ff=64,
              vocab=128, sliding_window=16)
    return RT.TransformerConfig(**kw, dtype=jnp.float32), Tr.TransformerConfig(
        **kw, dtype=torch.float32)


def _rules():
    mesh = make_mesh((2, 4), ("data", "model"), devices=[torch.device("cpu")] * 8)
    return make_rules(mesh)


@pytest.fixture(scope="module")
def R():
    """The reference's init and plain decode logits, per case."""
    out = {}
    decode = jax.jit(RT.decode_step, static_argnums=(3,))
    for window in (None, 8):
        rcfg, _ = _cfgs(window)
        params = RT.init_params(jax.random.PRNGKey(0), rcfg)
        toks = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int32)
        cache = RT.init_cache(rcfg, 4, 32)
        _, cache = RT.prefill(params, jnp.asarray(toks[:, :PREF]), rcfg, cache)
        logits = []
        for t in range(PREF, PREF + STEPS):
            lg, cache = decode(params, cache, jnp.asarray(toks[:, t]), rcfg)
            logits.append(np.asarray(lg))
        out[window] = {"init": jax.tree.map(np.asarray, ref_split(params)[0]), "toks": toks,
                       "logits": logits}
    rcfg, _ = _one_cfgs()
    params = RT.init_params(jax.random.PRNGKey(0), rcfg)
    toks = np.random.default_rng(2).integers(0, 128, (1, 32)).astype(np.int32)
    full, _ = RT.forward(params, jnp.asarray(toks[:, :17]), rcfg)
    out["one"] = {"init": jax.tree.map(np.asarray, ref_split(params)[0]), "toks": toks,
                  "full": np.asarray(full)}
    return out


@pytest.mark.parametrize("window", [None, 8])  # full attention + SWA ring cache
def test_sp_decode_matches_baseline_full_and_swa(R, window):
    _, cfg = _cfgs(window)
    rules = _rules()
    values = Tr.params_from_reference(R[window]["init"], device="cpu")
    abstract = Tr.abstract_params(cfg)
    toks = torch.from_numpy(R[window]["toks"])
    B, S = toks.shape
    cache = Tr.init_cache(cfg, B, S, device="cpu")
    _, cache = Tr.prefill(values, toks[:, :PREF], cfg, cache)

    _, mk_base, _ = ST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=False)
    _, mk_sp, _ = ST.make_lm_decode_step(cfg, rules, abstract, seq_parallel=True)
    fb = mk_base(cache, toks[:, 0])
    fs = mk_sp(cache, toks[:, 0])
    cb, cs = cache.clone(), cache.clone()  # each path writes its cache in place
    for i, t in enumerate(range(PREF, PREF + STEPS)):
        lb, cb = fb(values, cb, toks[:, t])
        ls, cs = fs(values, cs, toks[:, t])
        np.testing.assert_allclose(ls.numpy(), R[window]["logits"][i], **TOL)
        np.testing.assert_allclose(lb.numpy(), R[window]["logits"][i], **TOL)
    err = float((lb - ls).abs().max())
    assert err < 2e-3, (window, err)
    assert cb.pos.tolist() == cs.pos.tolist() == [PREF + STEPS] * B


def test_sp_decode_batch_one(R):
    """long_500k regime: batch 1 cannot split over "data"; every data
    position then holds the whole batch, and the first one's result is kept."""
    _, cfg = _one_cfgs()
    values = Tr.params_from_reference(R["one"]["init"], device="cpu")
    toks = torch.from_numpy(R["one"]["toks"])
    cache = Tr.init_cache(cfg, 1, 32, device="cpu")
    assert cache.k.shape[2] == 16  # the ring: 16 slots, 4 a "model" position
    _, cache = Tr.prefill(values, toks[:, :16], cfg, cache)
    _, mk_sp, _ = ST.make_lm_decode_step(cfg, _rules(), Tr.abstract_params(cfg),
                                         seq_parallel=True)
    fs = mk_sp(cache, toks[:, 0])
    ls, cache = fs(values, cache, toks[:, 16])
    full, _ = Tr.forward(values, toks[:, :17], cfg)
    err = float((ls - full[:, 16]).abs().max())
    assert err < 5e-2, err
    np.testing.assert_allclose(ls.numpy(), R["one"]["full"][:, 16], rtol=5e-2, atol=5e-2)


def test_sp_decode_refuses_a_cache_that_does_not_split():
    _, cfg = _one_cfgs()
    _, mk_sp, _ = ST.make_lm_decode_step(cfg, _rules(), Tr.abstract_params(cfg),
                                         seq_parallel=True)
    cache = Tr.init_cache(cfg, 2, 14, device="cpu")  # 14 slots over 4 positions
    with pytest.raises(ValueError, match="does not split"):
        mk_sp(cache, torch.zeros(2, dtype=torch.int32))
