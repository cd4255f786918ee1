"""The port's language models (``repro_torch.models.attention``, ``moe``,
``transformer``), their configs and ``lm_batch`` against the JAX package's,
on the CPU.

The reference runs once, in the module fixture ``R``: each of the five LMs
at ``smoke_config()`` from its own init (carried across with
``params_from_reference``, every leaf in its dtype): forward on a [4, 48]
batch, a prefill of 48 tokens into a cache for 54 (the SWA archs' ring of
32 then holds the last 32, rolled), and 6 decode steps (the ring wraps);
``loss_fn`` and 3 ``make_train_step`` steps of yi-6b and qwen3; and
gemma's smoke config in bf16 (tied embeddings, MQA, GeGLU, the bf16
``embed_scale``: the full configs' dtype path) through the same serving
path.  Held:

* the port's copies of the ten tests of ``tests/test_models_lm.py``, with
  the reference's bounds;
* ``apply_rope``, and ``gqa_attention``/``flash_mlo`` at chunks of 5, 16
  and 64, with and without a window, ``k_valid`` and a soft cap: rtol and
  atol 1e-5;
* ``apply_moe`` at each router norm, in fp32 and bf16: ids, gates, keep
  masks and ``drop_frac`` exact or within 1e-5, ``y`` within ``Y_TOL``
  (the expert path is bf16; a product whose fp32 sum lands on the other
  side of a bf16 rounding boundary moves an element of ``y`` by a bf16
  ulp), ``aux_loss`` within 1e-6;
* the serving path of each smoke config: fp32 dense logits within
  ``DENSE_TOL``, the MoE configs' within ``MOE_TOL`` (that bf16 expert
  path), the bf16 config's within ``BF16_TOL`` (every activation rounds to
  bf16, and a last-bit difference, such as RoPE's fp32 cos and sin, moves
  a few of them by an ulp); the bf16 caches within ``CACHE_TOL`` and
  ``BF16_CACHE_TOL``.  A bf16 MoE is left out there: a token whose router
  scores lie within such a last-bit difference can take another expert
  (its ids are held exactly on equal inputs by the MoE test above);
* ``chunked_softmax_xent`` within rtol 1e-5; ``loss_fn`` and 3 steps;
* ``n_params``/``n_active_params`` of each full config equal, the meta
  ``abstract_params`` equal to the reference's leaf for leaf (shape, dtype,
  logical axes), and ``lm_batch`` array for array.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as RREG
from repro.data.synthetic import lm_batch as ref_lm_batch
from repro.distributed import steps as RST
from repro.models import attention as RA
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.models.nn import split_params as ref_split
from repro_torch.configs import registry as REG
from repro_torch.data.synthetic import lm_batch, token_stream
from repro_torch.distributed import steps as ST
from repro_torch.distributed.sharding import make_rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as Tr
from repro_torch.models.nn import Param, is_param, split_params, tree_leaves

LM_ARCHS = ["h2o-danube-3-4b", "yi-6b", "gemma-2b", "mixtral-8x22b", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_TOL = dict(rtol=1e-4, atol=1e-4)  # fp32 throughout; the cache's bf16 rounds alike
MOE_TOL = dict(rtol=0, atol=5e-3)  # fp32 configs' logits (about 0.7 at most) over the bf16 experts
Y_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # the MoE's bf16 y: two bf16 ulps
BF16_TOL = dict(rtol=0, atol=2 ** -6)  # bf16 logits (under 1): four bf16 ulps
CACHE_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # fp32 configs' bf16 cache: two ulps
BF16_CACHE_TOL = dict(rtol=2 ** -6, atol=2 ** -5)  # a bf16 config's: four, of the row's scale
B, P, N_DEC = 4, 48, 6
STEP = dict(peak_lr=1e-3, warmup_steps=1, total_steps=20)
CPU = torch.device("cpu")


def _carry(values):
    """A reference value tree as numpy, bf16 leaves as their 16-bit words."""
    return jax.tree.map(lambda a: np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16
                        else np.asarray(a), values)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _rules():
    return make_rules(make_mesh((1, 1), ("data", "model"), devices=[CPU]))


def _bf16_configs():
    """(name, reference config, port config): a smoke config in bf16, the
    full configs' dtype path."""
    out = []
    for aid, name in (("gemma-2b", "gemma-bf16"),):
        rc = dataclasses.replace(RREG.get(aid).smoke_config(), dtype=jnp.bfloat16)
        pc = dataclasses.replace(REG.get(aid).smoke_config(), dtype=torch.bfloat16)
        out.append((name, rc, pc))
    return out


def _serve_ref(rparams, rcfg, toks):
    logits, _ = RT.forward(rparams, jnp.asarray(toks[:, :P]), rcfg)
    cache = RT.init_cache(rcfg, B, P + N_DEC)
    lp, cache = RT.prefill(rparams, jnp.asarray(toks[:, :P]), rcfg, cache)
    out = {"forward": _f32(logits), "prefill": _f32(lp), "cache_k": _f32(cache.k),
           "cache_v": _f32(cache.v), "decode": []}
    decode = jax.jit(RT.decode_step, static_argnums=(3,))
    for t in range(N_DEC):
        ld, cache = decode(rparams, cache, jnp.asarray(toks[:, P + t]), rcfg)
        out["decode"].append(_f32(ld))
    out["cache_k_end"] = _f32(cache.k)
    return out


@pytest.fixture(scope="module")
def R(rules):
    """The reference's init, serving path and train steps, per config."""
    toks = lm_batch(B, P + N_DEC, 512, seed=3)["tokens"]
    cases = [(aid, RREG.get(aid).smoke_config(), REG.get(aid).smoke_config())
             for aid in LM_ARCHS] + _bf16_configs()
    out = {"toks": toks}
    for name, rcfg, pcfg in cases:
        rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
        out[name] = {"init": _carry(ref_split(rparams)[0]), "pcfg": pcfg,
                     **_serve_ref(rparams, rcfg, toks)}
    for aid in ("yi-6b", "qwen3-moe-30b-a3b"):
        rcfg = RREG.get(aid).smoke_config()
        rparams = RT.init_params(jax.random.PRNGKey(0), rcfg)
        batches = [lm_batch(4, 32, rcfg.vocab, seed=1, step=i) for i in range(3)]
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        l0, m0 = RT.loss_fn(rparams, jb[0], rcfg)
        loss, baxes = RST.lm_loss(rcfg)
        _, jitted, _, opt = RST.make_train_step(loss, RT.abstract_params(rcfg), rules, baxes,
                                                RST.StepConfig(**STEP))
        state = RST.init_state(opt, rparams)
        fn = jitted(jb[0])
        losses = []
        for b in jb:
            state, m = fn(state, b)
            losses.append(float(m["loss"]))
        out[aid]["train"] = {"batches": batches, "loss0": float(l0),
                             "aux0": float(m0["aux_loss"]), "losses": losses,
                             "final": [np.asarray(x, np.float32)
                                       for x in jax.tree.leaves(state.params)]}
    return out


def _port_params(R, name):
    return Tr.params_from_reference(R[name]["init"], device="cpu")


# ---------------------------------------------------------------------------
# The port's copies of tests/test_models_lm.py.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_arch_smoke_forward_and_train(arch_id):
    """Reduced config: one forward + one train step, shapes + no NaNs."""
    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 32)))
    logits, aux = Tr.forward(params, toks, cfg)
    assert logits.shape == (2, 32, cfg.vocab)
    assert not bool(torch.isnan(logits).any())

    loss, baxes = ST.lm_loss(cfg)
    _, jitted, _, opt = ST.make_train_step(
        loss, arch.abstract_params(cfg), _rules(), baxes,
        ST.StepConfig(peak_lr=1e-2, warmup_steps=2, total_steps=20))
    state = ST.init_state(opt, params)
    batch = {"tokens": toks, "labels": toks}
    fn = jitted(batch)
    l0 = None
    for _ in range(5):
        state, m = fn(state, batch)
        if l0 is None:
            l0 = float(m["loss"])
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) < l0, f"loss did not decrease ({l0} -> {m['loss']})"


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_arch_decode_consistency(arch_id):
    """prefill + decode == full forward at the decoded position (MoE archs at
    a capacity factor at which nothing drops in either mode)."""
    arch = REG.get(arch_id)
    cfg = arch.smoke_config()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = arch.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    S, pref = 24, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, S)))
    cache = Tr.init_cache(cfg, 2, S, device="cpu")
    logits, cache = Tr.prefill(params, toks[:, :pref], cfg, cache)
    for t in range(pref, S - 1):
        logits, cache = Tr.decode_step(params, cache, toks[:, t], cfg)
    full, _ = Tr.forward(params, toks[:, : S - 1], cfg)
    err = float((logits - full[:, S - 2]).abs().max())
    assert err < 5e-2, err  # bf16 cache tolerance


def test_swa_ring_cache_matches_window():
    """Ring cache decode == full forward when the window covers history."""
    cfg = Tr.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                               d_ff=64, vocab=64, sliding_window=8, dtype=torch.float32)
    params = Tr.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 64, (1, 30)))
    cache = Tr.init_cache(cfg, 1, 30, device="cpu")
    assert cache.k.shape[2] == 8  # capacity == window
    lg, cache = Tr.prefill(params, toks[:, :20], cfg, cache)
    lg, cache = Tr.decode_step(params, cache, toks[:, 20], cfg)
    full, _ = Tr.forward(params, toks[:, :21], cfg)
    err = float((lg - full[:, 20]).abs().max())
    assert err < 5e-2, err


def test_rope_rotation_property():
    """Relative-position property: scores depend on (q_pos - k_pos) only."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 2, 32), np.float32))
    p0, p1 = torch.tensor([[3]]), torch.tensor([[10]])
    s0 = torch.einsum("bshd,bshd->", A.apply_rope(x, p0), A.apply_rope(x, p0))
    s1 = torch.einsum("bshd,bshd->", A.apply_rope(x, p1), A.apply_rope(x, p1))
    np.testing.assert_allclose(float(s0), float(s1), rtol=1e-5)


def _qkv(B_, S, Hq, Hkv, D, seed=0):
    g = np.random.default_rng(seed)
    return (g.standard_normal((B_, S, Hq, D), np.float32),
            g.standard_normal((B_, S, Hkv, D), np.float32),
            g.standard_normal((B_, S, Hkv, D), np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_attention_chunking_invariance():
    """Online-softmax chunked attention == unchunked."""
    B_, S = 2, 37
    q, k, v = _t(*_qkv(B_, S, 4, 2, 16))
    pos = torch.arange(S)[None].expand(B_, S)
    outs = [A.gqa_attention(q, k, v, q_pos=pos, k_pos=pos, kv_chunk=c) for c in (5, 16, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), atol=1e-5, rtol=1e-5)


def test_sliding_window_masks_past():
    B_, S = 1, 16
    q, k, v = _t(*_qkv(B_, S, 1, 1, 8))
    pos = torch.arange(S)[None].expand(B_, S)
    full = A.gqa_attention(q, k, v, q_pos=pos, k_pos=pos, window=None)
    win = A.gqa_attention(q, k, v, q_pos=pos, k_pos=pos, window=4)
    assert not np.allclose(full[:, -1].numpy(), win[:, -1].numpy())
    np.testing.assert_allclose(full[:, 3].numpy(), win[:, 3].numpy(), atol=1e-5)


def test_moe_routing_topk_and_capacity():
    cfg = M.MoEConfig(n_experts=8, top_k=2, d_ff=16, group_size=32, capacity_factor=1.0)
    params = M.init_moe(torch.Generator().manual_seed(0), 16, cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 16), np.float32))
    y, metrics = M.apply_moe(params, x, cfg)
    assert y.shape == x.shape
    assert not bool(torch.isnan(y).any())
    assert 0.0 <= float(metrics["drop_frac"]) < 0.8
    assert float(metrics["aux_loss"]) > 0


def test_moe_capacity_one_expert_all_tokens():
    """If the router collapses, capacity bounds dispatch (no blowup)."""
    cfg = M.MoEConfig(n_experts=4, top_k=1, d_ff=8, group_size=16, capacity_factor=1.0)
    params = M.init_moe(torch.Generator().manual_seed(0), 8, cfg, device="cpu")
    router = torch.zeros_like(params["router"].value)
    router[:, 0] = 100.0
    params["router"].value = router
    x = torch.from_numpy(np.abs(np.random.default_rng(1).standard_normal((1, 16, 8),
                                                                       np.float32)) + 0.1)
    y, metrics = M.apply_moe(params, x, cfg)
    # capacity = 16*1/4*1.0 = 4 of 16 tokens kept -> 75% dropped
    assert float(metrics["drop_frac"]) > 0.5


def test_chunked_xent_matches_full():
    cfg = Tr.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                               d_ff=64, vocab=128, dtype=torch.float32)
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((2, 33, 32), np.float32))
    w = torch.from_numpy(g.standard_normal((32, 128), np.float32) * 0.1)
    labels = torch.from_numpy(g.integers(0, 128, (2, 33)))
    total, count = Tr.chunked_softmax_xent(x, w, labels, None, cfg, chunk=8)
    logits = x @ w
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    np.testing.assert_allclose(float(total), float((logz - gold).sum()), rtol=1e-5)
    assert float(count) == 66.0


def test_param_count_properties():
    for aid in LM_ARCHS:
        cfg = REG.get(aid).full_config()
        assert cfg.n_active_params <= cfg.n_params
        if cfg.moe is not None:
            assert cfg.n_active_params < cfg.n_params
    yi = REG.get("yi-6b").full_config()
    assert 5.5e9 < yi.n_params < 7e9, yi.n_params
    mix = REG.get("mixtral-8x22b").full_config()
    assert 1.2e11 < mix.n_params < 1.5e11, mix.n_params


# ---------------------------------------------------------------------------
# Parity with the reference.
# ---------------------------------------------------------------------------


def test_rope_matches_the_reference():
    g = np.random.default_rng(4)
    x = g.standard_normal((2, 7, 3, 32), np.float32)
    pos = g.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = np.asarray(RA.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = A.apply_rope(*_t(x, pos), theta).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _f32(RA.apply_rope(xb, jnp.asarray(pos), 1e4))
    got = _np(A.apply_rope(torch.from_numpy(_f32(xb)).bfloat16(), torch.from_numpy(pos), 1e4))
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("chunk", [5, 16, 64])
@pytest.mark.parametrize("variant", ["causal", "window", "valid_softcap"])
def test_attention_matches_the_reference(chunk, variant):
    B_, S = 2, 37
    q, k, v = _qkv(B_, S, 4, 2, 16, seed=chunk)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B_, S)).copy()
    kw = {}
    if variant == "window":
        kw["window"] = 8
    if variant == "valid_softcap":
        valid = np.random.default_rng(5).random((B_, S)) < 0.7
        valid[:, 0] = True
        kw.update(logits_soft_cap=3.0)
        rkv, pkv = dict(k_valid=jnp.asarray(valid)), dict(k_valid=torch.from_numpy(valid))
    else:
        rkv = pkv = {}
    args_r = dict(q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos), kv_chunk=chunk, **kw)
    args_p = dict(q_pos=torch.from_numpy(pos), k_pos=torch.from_numpy(pos), kv_chunk=chunk,
                  **kw)
    want = np.asarray(RA.gqa_attention(q, k, v, **args_r, **rkv))
    got = A.gqa_attention(*_t(q, k, v), **args_p, **pkv).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    rm, rl, ro = RA.flash_mlo(q, k, v, **args_r, **rkv)
    pm, pl, po = A.flash_mlo(*_t(q, k, v), **args_p, **pkv)
    for g, w in ((pm, rm), (pl, rl), (po, ro)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_cache_writes_and_positions_match_the_reference():
    g = np.random.default_rng(6)
    ck = g.standard_normal((2, 8, 2, 4), np.float32)
    new = g.standard_normal((2, 3, 2, 4), np.float32)
    pos = np.array([6, 2], np.int32)
    rk, _ = RA.cache_update_layer(jnp.asarray(ck), jnp.asarray(ck), jnp.asarray(new),
                                  jnp.asarray(new), jnp.asarray(pos))
    pk, pv = _t(ck, ck)
    A.cache_update_layer(pk, pv, *_t(new, new), torch.from_numpy(pos))
    np.testing.assert_array_equal(pk.numpy(), np.asarray(rk))
    for p, off, length in (([0, 5], 0, 8), ([9, 30], 2, 4), ([8, 3], 4, 4)):
        rp, rv = RA.cache_positions_range(jnp.asarray(p, jnp.int32), 8, off, length)
        tp, tv = A.cache_positions_range(torch.tensor(p, dtype=torch.int32), 8, off, length)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(rp))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["topk_softmax", "softmax_topk"])
def test_moe_matches_the_reference(norm, dtype):
    kw = dict(n_experts=8, top_k=2, d_ff=32, group_size=64, router_norm=norm,
              capacity_factor=1.0)
    rcfg, pcfg = RM.MoEConfig(**kw), M.MoEConfig(**kw)
    rdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rparams = RM.init_moe(jax.random.PRNGKey(0), 64, rcfg, rdt)
    rv = ref_split(rparams)[0]
    pv = Tr.params_from_reference(_carry(rv), device="cpu")
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 64, 64), np.float32)).astype(rdt)
    xt = torch.from_numpy(_f32(x)).to(getattr(torch, dtype))
    ry, rm = RM.apply_moe(rparams, x, rcfg, act=jax.nn.silu)
    py, pm = M.apply_moe(pv, xt, pcfg, act=Tr.silu)
    assert py.dtype == xt.dtype
    # The router, alone: ids, gates and keep masks.
    logits = jnp.einsum("gsd,de->gse", x.reshape(2, 64, 64).astype(jnp.float32), rv["router"])
    rids, rgates = RM._router_probs(logits, rcfg)
    pids, pgates = M._router_probs(torch.from_numpy(np.asarray(logits)), pcfg)
    np.testing.assert_array_equal(pids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(pgates.numpy(), np.asarray(rgates), **TOL)
    np.testing.assert_allclose(float(pm["drop_frac"]), float(rm["drop_frac"]), atol=0)
    np.testing.assert_allclose(float(pm["aux_loss"]), float(rm["aux_loss"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(py), _f32(ry), **Y_TOL)


def test_moe_keep_masks_match_the_reference():
    """A collapsed router drops most tokens: the same ones in both packages."""
    kw = dict(n_experts=4, top_k=2, d_ff=8, group_size=16, capacity_factor=1.0)
    rcfg, pcfg = RM.MoEConfig(**kw), M.MoEConfig(**kw)
    rparams = RM.init_moe(jax.random.PRNGKey(1), 8, rcfg)
    rv = jax.tree.map(np.asarray, ref_split(rparams)[0])
    rv["router"] = rv["router"].copy()
    rv["router"][:, 0] += 3.0
    rparams["router"].value = jnp.asarray(rv["router"])
    pv = Tr.params_from_reference(rv, device="cpu")
    x = np.abs(np.random.default_rng(2).standard_normal((2, 16, 8), np.float32)) + 0.1
    ry, rm = RM.apply_moe(rparams, jnp.asarray(x), rcfg)
    py, pm = M.apply_moe(pv, torch.from_numpy(x), pcfg, act=Tr.silu)
    assert float(pm["drop_frac"]) == float(rm["drop_frac"]) > 0.2
    # Dropped tokens pass through as zeros of y: the zero rows coincide.
    np.testing.assert_array_equal(_np(py) == 0, np.asarray(ry) == 0)
    np.testing.assert_allclose(_np(py), np.asarray(ry), **Y_TOL)


@pytest.mark.parametrize("name", LM_ARCHS + ["gemma-bf16"])
def test_serving_path_matches_the_reference(R, name):
    """forward, a prefill longer than the SWA window, 6 decode steps."""
    r = R[name]
    cfg = r["pcfg"]
    if cfg.dtype == torch.bfloat16:
        tol, ctol = BF16_TOL, BF16_CACHE_TOL
    else:
        tol, ctol = (MOE_TOL if cfg.moe is not None else DENSE_TOL), CACHE_TOL
    params = _port_params(R, name)
    toks = torch.from_numpy(R["toks"])
    logits, _ = Tr.forward(params, toks[:, :P], cfg)
    np.testing.assert_allclose(_np(logits), r["forward"], **tol)
    cache = Tr.init_cache(cfg, B, P + N_DEC, device="cpu")
    assert cache.k.dtype == torch.bfloat16
    assert cache.k.shape[2] == (32 if cfg.sliding_window else P + N_DEC)
    lp, cache = Tr.prefill(params, toks[:, :P], cfg, cache)
    np.testing.assert_allclose(_np(lp), r["prefill"], **tol)
    np.testing.assert_allclose(_np(cache.k), r["cache_k"], **ctol)
    np.testing.assert_allclose(_np(cache.v), r["cache_v"], **ctol)
    for t in range(N_DEC):
        ld, cache = Tr.decode_step(params, cache, toks[:, P + t], cfg)
        np.testing.assert_allclose(_np(ld), r["decode"][t], **tol)
    assert cache.pos.tolist() == [P + N_DEC] * B
    np.testing.assert_allclose(_np(cache.k), r["cache_k_end"], **ctol)


def test_chunked_xent_matches_the_reference():
    rcfg = RT.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                                d_ff=64, vocab=128, dtype=jnp.float32, logits_soft_cap=30.0)
    pcfg = Tr.TransformerConfig(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
                                d_ff=64, vocab=128, dtype=torch.float32, logits_soft_cap=30.0)
    g = np.random.default_rng(7)
    x = g.standard_normal((2, 45, 32), np.float32)
    w = g.standard_normal((32, 128), np.float32)
    labels = g.integers(0, 128, (2, 45)).astype(np.int32)
    mask = (g.random((2, 45)) < 0.8).astype(np.float32)
    for lm, chunk in ((None, 8), (mask, 16), (mask, 512)):
        rt, rc = RT.chunked_softmax_xent(jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels),
                                         None if lm is None else jnp.asarray(lm), rcfg, chunk)
        pt, pc = Tr.chunked_softmax_xent(*_t(x, w, labels), None if lm is None else
                                         torch.from_numpy(lm), pcfg, chunk)
        np.testing.assert_allclose(float(pt), float(rt), rtol=1e-5)
        assert float(pc) == float(rc)


@pytest.mark.parametrize("arch_id", ["yi-6b", "qwen3-moe-30b-a3b"])
def test_loss_and_train_steps_match_the_reference(R, arch_id):
    r = R[arch_id]
    cfg = REG.get(arch_id).smoke_config()
    moe = cfg.moe is not None
    params = _port_params(R, arch_id)
    batches = [{k: torch.from_numpy(v.copy()) for k, v in b.items()}
               for b in r["train"]["batches"]]
    with torch.no_grad():
        l0, m0 = Tr.loss_fn(params, batches[0], cfg)
    np.testing.assert_allclose(float(l0), r["train"]["loss0"], rtol=1e-4 if moe else 1e-5)
    np.testing.assert_allclose(float(m0["aux_loss"]), r["train"]["aux0"], rtol=1e-5, atol=1e-7)
    loss, baxes = ST.lm_loss(cfg)
    _, jitted, _, opt = ST.make_train_step(loss, Tr.abstract_params(cfg), _rules(), baxes,
                                           ST.StepConfig(**STEP))
    state = ST.init_state(opt, params)
    fn = jitted(batches[0])
    losses = []
    for b in batches:
        state, m = fn(state, b)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, r["train"]["losses"], rtol=1e-4 if moe else 1e-5)
    # AdamW moves a param by about lr (1e-3) a step whatever its gradient's
    # size.  Through the bf16 expert path the gradients differ in their last
    # bits (about 2^-8 of their size), which moves an Adam step by about as
    # much of lr, and can flip the sign of a gradient near 0: such a param
    # may end up to 2 lr a step away.  So every param within 6 lr, and 99 in
    # 100 of each leaf within lr / 16; dense, every param within 2e-5.
    for got, want in zip([_np(x) for x in tree_leaves(state.params)], r["train"]["final"]):
        if not moe:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
            continue
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * STEP["peak_lr"] * 3)
        assert np.quantile(np.abs(got - want), 0.99) < STEP["peak_lr"] / 16


def test_configs_and_param_counts_match_the_reference():
    for aid in LM_ARCHS:
        for which in ("full_config", "smoke_config"):
            want, got = getattr(RREG.get(aid), which)(), getattr(REG.get(aid), which)()
            assert got.n_params == want.n_params
            assert got.n_active_params == want.n_active_params
            w, g = dataclasses.asdict(want), dataclasses.asdict(got)
            assert g.pop("dtype") == getattr(torch, jnp.dtype(w.pop("dtype")).name)
            assert g == w, aid
    moe = REG.get("qwen3-moe-30b-a3b").full_config().moe
    assert M.moe_flops_per_token(2048, moe) == RM.moe_flops_per_token(
        2048, RREG.get("qwen3-moe-30b-a3b").full_config().moe)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_abstract_params_match_the_reference(arch_id):
    cfg, rcfg = REG.get(arch_id).full_config(), RREG.get(arch_id).full_config()
    got = REG.get(arch_id).abstract_params(cfg)
    want = RREG.get(arch_id).abstract_params(rcfg)
    g_leaves = tree_leaves(got, is_leaf=is_param)
    w_leaves = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "axes"))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert isinstance(g, Param) and g.value.device.type == "meta"
        assert tuple(g.value.shape) == tuple(w.value.shape)
        assert g.value.dtype == getattr(torch, jnp.dtype(w.value.dtype).name)
        assert g.axes == tuple(w.axes)


@pytest.mark.parametrize("step", [0, 5])
def test_lm_batch_matches_the_reference(step):
    for vocab in (512, 151_936):
        want = ref_lm_batch(3, 33, vocab, seed=2, step=step)
        got = lm_batch(3, 33, vocab, seed=2, step=step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert np.array_equal(token_stream(2, 5, 64, 1, 2)["tokens"],
                          ref_lm_batch(2, 5, 64, 1, 2)["tokens"])


def test_params_from_reference_keeps_each_leaf_dtype():
    rcfg = dataclasses.replace(RREG.get("qwen3-moe-30b-a3b").smoke_config(), dtype=jnp.bfloat16)
    rv = ref_split(RT.init_params(jax.random.PRNGKey(2), rcfg))[0]
    pv = Tr.params_from_reference(_carry(rv), device="cpu")
    for g, w in zip(tree_leaves(pv), jax.tree.leaves(rv)):
        assert g.dtype == getattr(torch, jnp.dtype(w.dtype).name)
        np.testing.assert_array_equal(_np(g), _f32(w))  # bit for bit


def test_remat_changes_memory_never_values():
    cfg = dataclasses.replace(REG.get("qwen3-moe-30b-a3b").smoke_config(),
                              remat_policy="nothing_saveable")
    params = split_params(Tr.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                         device="cpu"))[0]
    batch = {k: torch.from_numpy(v.copy()) for k, v in lm_batch(2, 32, cfg.vocab).items()}
    grads = []
    for c in (cfg, dataclasses.replace(cfg, remat_policy="none")):
        live = Tr.tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = Tr.loss_fn(live, batch, c)
        grads.append([loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(live))))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
