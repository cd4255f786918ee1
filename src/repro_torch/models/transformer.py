"""Decoder-only transformer LM (dense + MoE), layers stacked on a leading
[L] axis.

Port of ``repro/models/transformer.py``.  Covers the five LM
architectures of the registry: llama-style GQA (yi), GQA+SWA
(h2o-danube3), MQA/GeGLU/huge-vocab (gemma), SWA+MoE 8e top-2 (mixtral
8x22b), GQA+QK-norm+MoE 128e top-8 (qwen3-30b-a3b).

  * Each weight is one tensor with a leading [L] axis, drawn whole on its
    device in its dtype (``init_params``); a layer is a view of it
    (``layer_params``).  The reference's ``lax.scan`` over layers is a
    loop here.
  * ``_maybe_remat``: with any policy but ``"none"``, the layer body runs
    under ``torch.utils.checkpoint`` when gradients are on (activations
    recomputed in the backward pass: memory, never values).
  * Attention is the chunked online softmax of ``models.attention``; the
    MoE is the GShard dispatch/combine of ``models.moe``, its router on
    the ``stream_topk`` kernel.
  * Serving: ``prefill`` and ``decode_step`` write the KV cache in place,
    layer by layer (the reference's pure steps stack a new cache, which at
    full width would double it); ``KVCache.clone`` copies one for a second
    decode path.  The cache is bf16 in every config; decode reads bf16
    keys and values and casts each chunk to fp32, as the reference's.
  * Sharded serving: in a body (``distributed.spmd``, the LM serve steps of
    ``distributed.steps``) each position holds its blocks of the params
    and of the cache, and the reference's ``constrain`` points are where
    data moves: the vocabulary-cut embedding is a masked local gather
    summed over its mesh axes (``_lookup``); ``wq``/``wk``/``wv`` make the
    position's heads; ``wo`` and ``wff_o`` contract split rows and sum
    (``_proj``); the logits' vocabulary blocks are gathered (``_unembed``);
    each layer's ``fsdp`` dimensions are gathered over the data axes
    before use (``spmd.gather_fsdp``).  Whole, each of these is the
    identity, so a (1, 1) mesh runs the whole step's ops.

Weights and activations take ``cfg.dtype``; the products are IEEE fp32 or
bf16 with fp32 accumulation (``models.nn.require_exact_products``).
``params_from_reference`` carries the reference's numpy values across,
each leaf in its own dtype (a bf16 leaf as its 16-bit words).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import spmd
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.nn import (
    Param,
    apply_rmsnorm,
    gelu_tanh,
    is_param,
    lecun_init,
    normal_init,
    require_exact_products,
    rounded_to,
    silu,
    tree_map,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int  # dense FFN hidden (ignored when moe is set)
    vocab: int
    act: str = "silu"  # silu (llama) | gelu (gemma GeGLU)
    moe: M.MoEConfig | None = None
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_qk_norm: bool = False
    tied_embeddings: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    logits_soft_cap: float | None = None
    dtype: Any = torch.bfloat16  # weight/activation dtype (master fp32 in optim)
    kv_chunk: int = 1024
    remat_policy: str = "nothing_saveable"  # none|dots|nothing_saveable

    @property
    def n_params(self) -> int:
        D, Hq, Hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        attn = D * (Hq + 2 * Hkv) * hd + Hq * hd * D
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * D * self.moe.d_ff + D * self.moe.n_experts
        else:
            ffn = 3 * D * self.d_ff
        per_layer = attn + ffn + 2 * D
        embed = self.vocab * D * (1 if self.tied_embeddings else 2)
        return self.n_layers * per_layer + embed + D

    @property
    def n_active_params(self) -> int:
        """Per-token active parameters (MoE counts only top_k experts)."""
        if self.moe is None:
            return self.n_params
        D = self.d_model
        dense = self.n_params - self.n_layers * self.moe.n_experts * 3 * D * self.moe.d_ff
        return dense + self.n_layers * self.moe.top_k * 3 * D * self.moe.d_ff


ACTS = {"silu": silu, "gelu": gelu_tanh}


# ---------------------------------------------------------------------------
# Init.
# ---------------------------------------------------------------------------


def init_layer(generator, cfg: TransformerConfig, *, device="cuda", layers: int | None = None):
    """One layer's ``Param`` tree; with ``layers``, every leaf carries a
    leading [layers] axis (the stacked layers), each slice drawn alike."""
    D, Hq, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, la = ((layers,), (None,)) if layers is not None else ((), ())

    def zeros(shape, axes):
        return Param(torch.zeros(lead + shape, dtype=torch.float32, device=device), la + axes)

    def w(shape, fan_in, axes):
        return Param(lecun_init(generator, lead + shape, fan_in, device=device, dtype=cfg.dtype),
                     la + axes)

    p = {
        "ln1": zeros((D,), ("fsdp",)),
        "ln2": zeros((D,), ("fsdp",)),
        "wq": w((D, Hq, hd), D, ("fsdp", "tensor", None)),
        "wk": w((D, Hkv, hd), D, ("fsdp", "kv_heads", None)),
        "wv": w((D, Hkv, hd), D, ("fsdp", "kv_heads", None)),
        "wo": w((Hq, hd, D), Hq * hd, ("tensor", None, "fsdp")),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = zeros((hd,), (None,))
        p["k_norm"] = zeros((hd,), (None,))
    if cfg.moe is not None:
        p["moe"] = M.init_moe(generator, D, cfg.moe, cfg.dtype, device=device, layers=layers)
    else:
        Fd = cfg.d_ff
        p["wi_gate"] = w((D, Fd), D, ("fsdp", "tensor"))
        p["wi_up"] = w((D, Fd), D, ("fsdp", "tensor"))
        p["wff_o"] = w((Fd, D), Fd, ("tensor", "fsdp"))
    return p


def init_params(cfg: TransformerConfig, *, generator: torch.Generator | None = None,
                device="cuda"):
    """The ``Param`` tree drawn on ``device`` in each leaf's dtype from
    ``generator`` (default: a fresh one seeded 0); ``device="meta"`` gives
    the shapes, nothing allocated.  torch cannot replay ``jax.random``, so
    the values are the reference's distributions, not its numbers
    (``params_from_reference`` carries those)."""
    dev = torch.device(device)
    if dev.type != "meta" and generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    p = {
        "embed": Param(normal_init(generator, (cfg.vocab, cfg.d_model), 0.02, device=dev,
                                   dtype=cfg.dtype), ("vocab", "fsdp")),
        "layers": init_layer(generator, cfg, device=dev, layers=cfg.n_layers),
        "final_norm": Param(torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
                            ("fsdp",)),
    }
    if not cfg.tied_embeddings:
        p["unembed"] = Param(normal_init(generator, (cfg.d_model, cfg.vocab), 0.02, device=dev,
                                         dtype=cfg.dtype), ("fsdp", "vocab"))
    return p


def abstract_params(cfg: TransformerConfig):
    """The ``Param`` tree on the meta device: shapes, dtypes and logical
    axes, no allocation (the reference's ``ShapeDtypeStruct`` tree)."""
    return init_params(cfg, device="meta")


def params_from_reference(values, *, device="cuda"):
    """A reference value tree (``split_params(init_params(...))[0]``, numpy
    leaves) as the port's values on ``device``, each leaf keeping its
    dtype.  A bf16 leaf crosses as its 16-bit words: the caller passes
    ``np.asarray(a).view(np.uint16)``, and its bits become ``torch.bfloat16``."""
    from repro_torch.kernels._backend import resolve_device

    dev = resolve_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype == np.uint16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return tree_map(one, values)


def _values(params):
    return tree_map(lambda p: p.value if is_param(p) else p, params, is_leaf=is_param)


def layer_params(layers, i: int):
    """Layer ``i``'s leaves: views of the stacked [L, ...] tensors (in a
    body, each position's, keeping their ``Sharding``: ``spmd.index_first``)."""
    return tree_map(lambda t: spmd.index_first(t, i), layers)


# ---------------------------------------------------------------------------
# Layer body (shared by train forward / prefill / decode).
# ---------------------------------------------------------------------------


def _rms(x, scale, eps):
    return apply_rmsnorm({"scale": scale}, x, eps=eps)


def _proj(x: Tensor, w: Tensor, n_in_dims: int = 1) -> Tensor:
    """x [..., *w.shape[:n_in_dims]] contracted with w: one product in x's
    dtype (the reference's einsum over the same axes).  In a body, where
    the contracted dimensions of ``w`` are split (``wo`` by heads,
    ``wff_o`` by rows), ``x`` is split alike and the partial products are
    summed over those mesh axes (``spmd.all_reduce``)."""
    axes = tuple(a for d in range(n_in_dims) for a in spmd.split_axes(w, d))
    y = _product(x, w.to(x.dtype), n_in_dims)
    return spmd.all_reduce(y, axes)


def _product(x: Tensor, w: Tensor, n_in_dims: int) -> Tensor:
    """The contraction of ``_proj``, ``w`` already in x's dtype."""
    require_exact_products(x)
    if w.dim() == 2 and n_in_dims == 1:
        return x @ w  # a transposed (tied) unembedding stays a view
    k = math.prod(w.shape[:n_in_dims])
    y = x.reshape(*x.shape[: x.dim() - n_in_dims], k) @ w.reshape(k, -1)
    return y.reshape(*x.shape[: x.dim() - n_in_dims], *w.shape[n_in_dims:])


def _qkv(lp, x, cfg: TransformerConfig, positions):
    q = _proj(x, lp["wq"])
    k = _proj(x, lp["wk"])
    v = _proj(x, lp["wv"])
    if cfg.use_qk_norm:
        q = apply_rmsnorm({"scale": lp["q_norm"]}, q, eps=cfg.norm_eps)
        k = apply_rmsnorm({"scale": lp["k_norm"]}, k, eps=cfg.norm_eps)
    q = A.apply_rope(q, positions, cfg.rope_theta)
    k = A.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads(lp):
    """(the mesh axes the query heads are split over, the KV heads'): ()
    each outside a body."""
    return spmd.split_axes(lp["wq"], 1), spmd.split_axes(lp["wk"], 1)


def _ffn(lp, h, cfg: TransformerConfig):
    """(y, aux) of the layer's FFN: the MoE or the dense gated MLP."""
    act = ACTS[cfg.act]
    if cfg.moe is not None:
        y, metrics = M.apply_moe(lp["moe"], h, cfg.moe, act=act)
        return y, metrics["aux_loss"]
    ff = act(_proj(h, lp["wi_gate"])) * _proj(h, lp["wi_up"])
    y = _proj(ff, lp["wff_o"])
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


def layer_forward(lp, x, positions, cfg: TransformerConfig):
    """Full-sequence layer (training / prefill).  Returns (y, aux_loss, k, v)."""
    lp = spmd.gather_fsdp(lp)
    q_axes, kv_axes = _heads(lp)
    h = _rms(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(lp, h, cfg, positions)
    attn = A.gqa_attention(q, A.kv_for_queries(k, cfg.n_heads, q_axes, kv_axes),
                           A.kv_for_queries(v, cfg.n_heads, q_axes, kv_axes),
                           q_pos=positions, k_pos=positions, window=cfg.sliding_window,
                           kv_chunk=cfg.kv_chunk, logits_soft_cap=cfg.logits_soft_cap)
    x = x + _proj(attn, lp["wo"], 2)
    h = _rms(x, lp["ln2"], cfg.norm_eps)
    y, aux = _ffn(lp, h, cfg)
    return x + y, aux, k, v


REMAT_POLICIES = ("none", "dots", "nothing_saveable", "everything_saveable")


def _maybe_remat(fn, cfg: TransformerConfig):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when the
    policy is not ``"none"`` and gradients are on.  The reference's
    policies differ in which products they keep; the port recomputes the
    whole layer for each, which changes memory, never values."""
    if cfg.remat_policy not in REMAT_POLICIES:
        raise KeyError(f"unknown remat policy {cfg.remat_policy!r}")
    if cfg.remat_policy == "none":
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)

    return run


# ---------------------------------------------------------------------------
# Training forward + loss.
# ---------------------------------------------------------------------------


def _embed_tokens(values, tokens, cfg: TransformerConfig):
    emb = values["embed"]
    tokens = _tensor(tokens).to(device=emb.device).long()
    x = _lookup(spmd.gather_fsdp(emb), tokens).to(cfg.dtype)
    if cfg.embed_scale:  # sqrt(d_model) in fp32, then in the model's dtype
        x = x * rounded_to(float(torch.sqrt(torch.tensor(float(cfg.d_model)))), cfg.dtype)
    return x


def _tensor(x):
    """``x`` as a tensor (a body's ``Local`` as it is: ``torch.as_tensor``
    does not dispatch on it)."""
    return x if isinstance(x, (torch.Tensor, spmd.Local)) else torch.as_tensor(x)


def _lookup(emb, tokens):
    """``emb[tokens]``.  In a body whose table is cut by rows (``"vocab"``),
    the reference's masked local gather: each position gathers the tokens
    in its block of rows, in its own numbering, zeroes the rest, and the
    blocks' rows are summed over the rows' mesh axes (``spmd.all_reduce``;
    one row plus zeros, bit-equal to the whole lookup), the pattern of
    ``models.recsys._sharded_lookup``."""
    axes = spmd.split_axes(emb, 0)
    if not axes:
        return emb[tokens]
    rows = emb.shape[0]
    mesh = spmd.current().mesh

    def one(p):
        idp = spmd.part(tokens, p) - mesh.index_along(p, axes) * rows
        idx = idp.clamp(0, rows - 1)
        return torch.where((idx == idp)[..., None], emb.parts[p][idx], 0.0)

    return spmd.all_reduce(spmd.per_position(one), axes)


def _unembed_weight(values, cfg: TransformerConfig):
    if cfg.tied_embeddings:
        return values["embed"].T
    return values["unembed"]


def _unembed(values, x, cfg: TransformerConfig):
    """Logits [..., V].  In a body each position computes the logits of its
    block of the vocabulary (``unembed``'s columns, or the tied ``embed``'s
    rows), gathered whole over the vocabulary's mesh axes."""
    tied = cfg.tied_embeddings
    w = spmd.gather_fsdp(values["embed"] if tied else values["unembed"])
    axes = spmd.split_axes(w, 0 if tied else 1)
    logits = _proj(x, w.T if tied else w)
    if cfg.logits_soft_cap is not None:
        logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
    return spmd.all_gather(logits, logits.dim() - 1, axes)


def _positions(B: int, S: int, device) -> Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def backbone(values, tokens, cfg: TransformerConfig):
    """tokens [B, S] -> (final hidden [B, S, D] post-norm, total_aux_loss)."""
    x = _embed_tokens(values, tokens, cfg)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)

    def body(x, lp):
        y, a, _, _ = layer_forward(lp, x, positions, cfg)
        return y, a

    body = _maybe_remat(body, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = body(x, layer_params(values["layers"], i))
        aux = aux + a
    return _rms(x, values["final_norm"], cfg.norm_eps), aux


def forward(params, tokens, cfg: TransformerConfig) -> tuple[Tensor, Tensor]:
    """tokens [B, S] -> (logits [B, S, V], total_aux_loss)."""
    values = _values(params)
    x, aux = backbone(values, tokens, cfg)
    return _unembed(values, x, cfg), aux


def chunked_softmax_xent(
    x: Tensor,  # [B, S, D] final hidden
    w: Tensor,  # [D, V] unembed
    labels,  # [B, S]
    loss_mask,
    cfg: TransformerConfig,
    chunk: int = 512,
) -> tuple[Tensor, Tensor]:
    """Sum of per-token NLL + token count, computed in sequence chunks.

    The [B, S, V] logits tensor is never made whole: each chunk's logits
    are produced, reduced to NLL, and (under gradients) recomputed in the
    backward pass.
    """
    B, S, D = x.shape
    labels = torch.as_tensor(labels, device=x.device).long()
    if loss_mask is None:
        loss_mask = torch.ones((B, S), dtype=torch.float32, device=x.device)
    loss_mask = torch.as_tensor(loss_mask, device=x.device).to(torch.float32)
    chunk = min(chunk, S)

    def chunk_nll(xi, li, mi):
        logits = _proj(xi, w)
        if cfg.logits_soft_cap is not None:
            logits = cfg.logits_soft_cap * torch.tanh(logits / cfg.logits_soft_cap)
        logits = logits.to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, li[..., None])[..., 0]
        return torch.sum((logz - gold) * mi)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        args = (x[:, s0 : s0 + chunk], labels[:, s0 : s0 + chunk], loss_mask[:, s0 : s0 + chunk])
        if torch.is_grad_enabled():
            total = total + checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            total = total + chunk_nll(*args)
    return total, loss_mask.sum()


def loss_fn(params, batch: dict, cfg: TransformerConfig) -> tuple[Tensor, dict]:
    """Next-token cross entropy (fp32 logsumexp, chunked), + MoE aux."""
    values = _values(params)
    x, aux = backbone(values, batch["tokens"], cfg)
    total, count = chunked_softmax_xent(x, _unembed_weight(values, cfg), batch["labels"],
                                        batch.get("loss_mask"), cfg)
    loss = total / torch.clamp_min(count, 1.0)
    return loss + aux, {"loss": loss, "aux_loss": aux, "denom": count}


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV cache.
# ---------------------------------------------------------------------------


def cache_capacity(cfg: TransformerConfig, seq_len: int) -> int:
    if cfg.sliding_window is not None:
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: TransformerConfig, batch: int, seq_len: int, *, device="cuda") -> A.KVCache:
    """A zero bf16 cache for ``batch`` sequences of up to ``seq_len``
    tokens (the window's capacity for SWA), on ``device``."""
    return A.init_cache(cfg.n_layers, batch, cache_capacity(cfg, seq_len), cfg.n_kv_heads,
                        cfg.head_dim, dtype=torch.bfloat16, device=device)


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig, cache: A.KVCache):
    """Run the prompt and fill ``cache`` in place; returns (last-token
    logits [B, V], cache)."""
    values = _values(params)
    x = _embed_tokens(values, tokens, cfg)
    B, S = x.shape[:2]
    positions = _positions(B, S, x.device)
    for i in range(cfg.n_layers):
        lp = layer_params(values["layers"], i)
        x, _, k, v = layer_forward(lp, x, positions, cfg)
        ck, cv = spmd.index_first(cache.k, i), spmd.index_first(cache.v, i)
        kv_axes, head_axes = spmd.split_axes(lp["wk"], 1), spmd.split_axes(ck, 2)
        if tuple(head_axes) != tuple(kv_axes):  # a cache that keeps every KV head
            k, v = spmd.all_gather(k, 2, kv_axes), spmd.all_gather(v, 2, kv_axes)
        A.cache_write_prompt(ck, cv, k, v)
    x = _rms(x[:, -1:], spmd.gather_fsdp(values["final_norm"]), cfg.norm_eps)
    logits = _unembed(values, x, cfg)[:, 0]
    cache.pos.fill_(S)
    return logits, cache


@torch.no_grad()
def decode_step(params, cache: A.KVCache, tokens, cfg: TransformerConfig, attn_fn=None):
    """One decode step, the cache written in place.  tokens: [B] int.
    Returns (logits [B, V], cache).

    ``attn_fn(q, ck, cv, pos)``: optional attention override: the
    sequence-parallel (flash-decoding) path installs one here
    (``distributed.steps.make_lm_decode_step(seq_parallel=True)``).
    """
    values = _values(params)
    pos = cache.pos.clone()  # [B] position being written
    x = _embed_tokens(values, _tensor(tokens)[:, None], cfg)
    positions = pos[:, None]
    body = spmd.current() is not None
    for i in range(cfg.n_layers):
        lp = spmd.gather_fsdp(layer_params(values["layers"], i))
        h = _rms(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, positions)
        if body:
            q_axes, kv_axes = _heads(lp)
            attn = A.decode_attention_body(
                q, k, v, spmd.index_first(cache.k, i), spmd.index_first(cache.v, i), pos,
                n_q=cfg.n_heads, q_axes=q_axes, kv_axes=kv_axes, window=cfg.sliding_window,
                kv_chunk=cfg.kv_chunk, logits_soft_cap=cfg.logits_soft_cap)
        else:
            ck, cv = A.cache_update_layer(cache.k[i], cache.v[i], k, v, pos)
            if attn_fn is not None:
                attn = attn_fn(q, ck, cv, pos)
            else:
                attn = A.decode_attention_layer(q, ck, cv, pos, window=cfg.sliding_window,
                                                kv_chunk=cfg.kv_chunk,
                                                logits_soft_cap=cfg.logits_soft_cap)
        x = x + _proj(attn, lp["wo"], 2)
        h = _rms(x, lp["ln2"], cfg.norm_eps)
        y, _ = _ffn(lp, h, cfg)
        x = x + y
    x = _rms(x, spmd.gather_fsdp(values["final_norm"]), cfg.norm_eps)
    logits = _unembed(values, x, cfg)[:, 0]
    cache.pos.add_(1)
    return logits, cache
