"""Attention substrate: RoPE, GQA/MQA, sliding windows, chunked softmax,
KV caches (full and ring buffer for SWA decode).

Port of ``repro/models/attention.py``, function for function.  The
reference computes attention outside any Pallas kernel (the paper's
technique does not apply to it), so plain PyTorch is the port here:

  * the [Sq, Sk] mask is never built whole: positions go in, the mask is
    built per key chunk inside the online softmax;
  * attention is chunked over keys with running (max, normalizer, output)
    accumulators, the flash formulation; ``flash_mlo`` returns them
    un-normalized, the form that two key sets merge in exactly
    (``mlo_merge``, the sequence-parallel decode of
    ``distributed.steps.make_lm_decode_step``), so it cannot be
    ``scaled_dot_product_attention``;
  * KV heads are repeated to the query head count per chunk only; the
    resident cache stays at Hkv heads.

The score math is fp32 (IEEE: ``models.nn.require_fp32_products`` refuses
TF32 on the card).  ``NEG_INF`` is finite, as the reference's, so a row
whose keys are all masked so far carries a finite max that the first live
key's ``alpha = exp(m_old - m_new) = 0`` wipes out.

The caches are written in place (``cache_update_layer``): a step of the
reference returns a new cache and donates the old one, which a PyTorch
caller cannot do without holding both.  ``KVCache.clone`` copies one.

In a body (``distributed.spmd``) a cache's parts are ``Local`` values
carrying their ``Sharding`` (``distributed.sharding.cache_shardings``),
written in place on their positions: ``cache_write_prompt`` and
``cache_update_slots`` where the slots are split, ``kv_for_queries`` where
the query heads are split and the KV heads are not (a position reads the
KV heads of its own groups), and ``decode_attention_body`` for one decode
step over a position's heads and slots, merged over the slots' positions
by ``mlo_merge``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed import spmd
from repro_torch.models.nn import require_exact_products

Tensor = torch.Tensor

NEG_INF = -1e30  # additive mask value (finite: keeps softmax NaN-free)


def _fp32(v: float) -> float:
    """``v`` rounded to fp32, as a Python number: a constant that multiplies
    a tensor without a tensor of its own (a host-to-device copy a call)."""
    return float(torch.tensor(v, dtype=torch.float32))


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, *, device=None) -> Tensor:
    """Inverse frequencies [head_dim // 2] (fp32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) by position-dependent angles.

    x: [B, S, H, D]; positions: [B, S] int.  Split-half convention (llama);
    the rotation is fp32, the result in x's dtype.
    """
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)  # [d/2]
    angles = positions[..., None].to(torch.float32) * inv  # [B, S, d/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Core attention: GQA with online-softmax chunking over keys.
# ---------------------------------------------------------------------------


def _chunk_mask(q_pos: Tensor, k_pos: Tensor, window, k_valid) -> Tensor:
    """Additive fp32 mask [B, Sq, c] for one key chunk (built lazily)."""
    dq = q_pos[:, :, None]  # [B, Sq, 1]
    dk = k_pos[:, None, :]  # [B, 1, c]
    ok = dk <= dq
    if window is not None:
        ok = ok & (dk > dq - window)
    if k_valid is not None:
        ok = ok & k_valid[:, None, :]
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def flash_mlo(
    q: Tensor,  # [B, Sq, Hq, D]
    k: Tensor,  # [B, Sk, Hkv, D]
    v: Tensor,  # [B, Sk, Hkv, D]
    *,
    q_pos: Tensor,  # [B, Sq] absolute positions
    k_pos: Tensor,  # [B, Sk]
    window: int | None = None,
    k_valid: Tensor | None = None,  # [B, Sk] live-slot mask (ring caches)
    kv_chunk: int = 1024,
    logits_soft_cap: float | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Un-normalized flash accumulators (max, normalizer, weighted output).

    Returns fp32 (m [B, Sq, Hq], l [B, Sq, Hq], o [B, Sq, Hq, D]): the
    mergeable form, two partial (m, l, o) over disjoint key sets combine
    exactly (``mlo_merge``).  ``gqa_attention`` is the normalize-at-the-end
    wrapper.
    """
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    G = Hq // Hkv
    qf = q.to(torch.float32) * _fp32(1.0 / math.sqrt(D))
    require_exact_products(qf)

    kv_chunk = min(kv_chunk, Sk)
    n_chunks = max(1, (Sk + kv_chunk - 1) // kv_chunk)
    pad = n_chunks * kv_chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
        live = k_valid if k_valid is not None else torch.ones((B, Sk), dtype=torch.bool,
                                                              device=k.device)
        k_valid = torch.nn.functional.pad(live, (0, pad), value=False)

    m_run = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=q.device)
    o_run = torch.zeros((B, Sq, Hq, D), dtype=torch.float32, device=q.device)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        # Per-chunk KV repeat: the resident cache stays at Hkv heads.
        k_r = k[:, sl].repeat_interleave(G, dim=2).to(torch.float32)  # [B, c, Hq, D]
        v_r = v[:, sl].repeat_interleave(G, dim=2).to(torch.float32)
        s = torch.einsum("bqhd,bchd->bqhc", qf, k_r)  # [B, Sq, Hq, c] fp32
        if logits_soft_cap is not None:
            s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
        mask = _chunk_mask(q_pos, k_pos[:, sl], window,
                           None if k_valid is None else k_valid[:, sl])  # [B, Sq, c]
        s = s + mask[:, :, None, :]
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        del s
        l_run = l_run * alpha + p.sum(dim=-1)
        o_run = o_run * alpha[..., None] + torch.einsum("bqhc,bchd->bqhd", p, v_r)
        m_run = m_new
    return m_run, l_run, o_run


def mlo_normalize(m: Tensor, l: Tensor, o: Tensor, dtype) -> Tensor:
    return (o / torch.clamp_min(l[..., None], 1e-30)).to(dtype)


def mlo_merge(parts: "list[tuple[Tensor, Tensor, Tensor]]"):
    """Exact merge of flash accumulators over disjoint key sets."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    l = sum(torch.exp(pm - m) * pl for pm, pl, _ in parts)
    o = sum(torch.exp(pm - m)[..., None] * po for pm, _, po in parts)
    return m, l, o


def gqa_attention(
    q: Tensor,  # [B, Sq, Hq, D]
    k: Tensor,  # [B, Sk, Hkv, D]
    v: Tensor,  # [B, Sk, Hkv, D]
    *,
    q_pos: Tensor,  # [B, Sq] absolute positions
    k_pos: Tensor,  # [B, Sk]
    window: int | None = None,
    k_valid: Tensor | None = None,  # [B, Sk] live-slot mask (ring caches)
    kv_chunk: int = 1024,
    logits_soft_cap: float | None = None,
) -> Tensor:
    """Grouped-query attention, chunked online softmax, lazy masking.

    Returns [B, Sq, Hq, D] in q.dtype.  Hq % Hkv == 0; score math fp32.
    """
    m, l, o = flash_mlo(q, k, v, q_pos=q_pos, k_pos=k_pos, window=window,
                        k_valid=k_valid, kv_chunk=kv_chunk,
                        logits_soft_cap=logits_soft_cap)
    return mlo_normalize(m, l, o, q.dtype)


# ---------------------------------------------------------------------------
# KV caches.
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Decode-time key/value cache.

    ``k``/``v``: [L, B, C, Hkv, D] where C = cache capacity (= seq_len for
    full attention, = min(seq_len, window) ring buffer for SWA).
    ``pos``: [B] int32, the number of tokens already written (next
    position).  ``prefill`` and ``decode_step`` write all three in place.
    """

    k: Tensor
    v: Tensor
    pos: Tensor

    def clone(self) -> "KVCache":
        return KVCache(self.k.clone(), self.v.clone(), self.pos.clone())


def init_cache(n_layers: int, batch: int, capacity: int, n_kv: int, head_dim: int,
               dtype=torch.bfloat16, *, device="cuda") -> KVCache:
    shape = (n_layers, batch, capacity, n_kv, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def cache_update_layer(
    cache_k: Tensor,  # [B, C, Hkv, D] one layer's cache (a view of the stack)
    cache_v: Tensor,
    k_new: Tensor,  # [B, S_new, Hkv, D] (RoPE already applied)
    v_new: Tensor,
    pos: Tensor,  # [B] int: write offset
) -> tuple[Tensor, Tensor]:
    """Write S_new tokens at ring positions (pos + i) % C, in place; returns
    the two (written) caches."""
    B, C, Hkv, D = cache_k.shape
    S_new = k_new.shape[1]
    if S_new == C:
        cache_k.copy_(k_new)
        cache_v.copy_(v_new)
        return cache_k, cache_v
    idx = (pos.long()[:, None] + torch.arange(S_new, device=pos.device)[None, :]) % C
    bidx = torch.arange(B, device=pos.device)[:, None].expand(B, S_new)
    cache_k[bidx, idx] = k_new.to(cache_k.dtype)
    cache_v[bidx, idx] = v_new.to(cache_v.dtype)
    return cache_k, cache_v


def cache_write_prompt(cache_k, cache_v, k: Tensor, v: Tensor) -> None:
    """Write a prompt's keys and values [B, S, Hkv, D] into one layer's cache
    [B, C, Hkv, D] in place: the last C positions, ring-aligned so that slot
    s holds absolute position p with p % C == s, the slots past a shorter
    prompt zeroed.  In a body whose cache has its slots split
    (``cache_shardings``: ``"kv_seq"``, or ``"seq"`` where the batch does
    not split), each position writes its own range of the ring."""
    S = k.shape[1]
    c_loc = cache_k.shape[1]
    axes = spmd.split_axes(cache_k, 1)
    C = c_loc * _size(axes)
    for cache, new in ((cache_k, k), (cache_v, v)):
        if S >= C:
            ring = torch.roll(new[:, S - C:], (S - C) % C, dims=1)
        else:
            ring = torch.nn.functional.pad(new, (0, 0, 0, 0, 0, C - S))
        cache.copy_(spmd.narrow_along(ring, 1, axes, c_loc))


def _size(axes) -> int:
    """How many positions the mesh axes ``axes`` span (1 for none)."""
    if not axes:
        return 1
    mesh = spmd.current().mesh
    return math.prod(mesh.shape[a] for a in axes)


def cache_update_slots(cache_k, cache_v, k_new, v_new, pos) -> None:
    """``cache_update_layer`` of one new token a row in a body whose cache
    has its slots split: each position writes ring slot pos % C where it
    lies in its own range, and leaves its slots as they are elsewhere (a
    read and a write of the same slot, no host sync)."""
    axes = spmd.split_axes(cache_k, 1)
    B, c_loc = cache_k.shape[:2]
    C = c_loc * _size(axes)
    mesh = spmd.current().mesh

    def one(p):
        ck, cv = cache_k.parts[p], cache_v.parts[p]
        local = spmd.part(pos, p).long() % C - mesh.index_along(p, axes) * c_loc
        ok = ((local >= 0) & (local < c_loc))[:, None, None]
        li = local.clamp(0, c_loc - 1)
        rows = torch.arange(B, device=ck.device)
        for cache, new in ((ck, spmd.part(k_new, p)), (cv, spmd.part(v_new, p))):
            cache[rows, li] = torch.where(ok, new[:, 0].to(cache.dtype), cache[rows, li])
        return ck

    spmd.per_position(one)


def kv_for_queries(k, n_q: int, q_axes, kv_axes):
    """Keys (or values) [B, S, Hkv, D] as a body's own query heads meet
    them: ``k`` itself where the query and KV heads are split alike (or
    both whole); where only the query heads are split (the KV heads do not
    divide: gemma's one), each position's slice of the whole KV heads that
    its query heads group over.  A query head j of H over G KV heads reads
    KV head j // (H / G), so a position's heads must cover whole groups or
    lie in one."""
    if tuple(q_axes) == tuple(kv_axes):
        return k
    if kv_axes:
        raise ValueError(f"KV heads split over {kv_axes}, query heads over {q_axes}")
    n_kv = k.shape[2]
    G = n_q // n_kv
    hq = n_q // _size(q_axes)
    if hq % G and G % hq:
        raise ValueError(f"{hq} query heads a position do not cover whole groups of {G} "
                         f"over {n_kv} KV heads")
    mesh = spmd.current().mesh
    width = max(1, hq // G)
    return spmd.per_position(lambda p: spmd.part(k, p).narrow(
        2, mesh.index_along(p, q_axes) * hq // G, width))


def decode_attention_body(q, k_new, v_new, cache_k, cache_v, pos, *, n_q: int, q_axes,
                          kv_axes, window, kv_chunk: int = 2048,
                          logits_soft_cap: float | None = None):
    """One decode step's cache write and attention inside a body: ``q``
    [B, 1, Hq, D] over the position's query heads (split over ``q_axes``),
    ``k_new``/``v_new`` over its KV heads (``kv_axes``), one layer's cache
    parts (``Local`` values carrying their ``Sharding``).

    The new keys take the cache's heads (gathered where the cache keeps
    every head: the sequence-parallel layout) and are written in place
    (``cache_update_layer``, or ``cache_update_slots`` where the slots are
    split).  Where the slots are whole this is ``decode_attention_layer``
    over the position's heads.  Where they are split, each position runs
    ``flash_mlo`` over its own slots (the queries of every head gathered
    when the slots are split along the query heads' axes), the (m, l, o)
    of the positions along the slots' axes are gathered and merged
    exactly (``mlo_merge``) on each of them, and the position keeps its
    own heads of the result."""
    slot_axes = spmd.split_axes(cache_k, 1)
    head_axes = spmd.split_axes(cache_k, 2)
    if tuple(head_axes) != tuple(kv_axes):
        if head_axes:
            raise ValueError(f"cache heads split over {head_axes}, KV heads over {kv_axes}")
        k_new = spmd.all_gather(k_new, 2, kv_axes)
        v_new = spmd.all_gather(v_new, 2, kv_axes)
    if not slot_axes:
        ck, cv = cache_update_layer(cache_k, cache_v, k_new, v_new, pos)
        return decode_attention_layer(q, kv_for_queries(ck, n_q, q_axes, head_axes),
                                      kv_for_queries(cv, n_q, q_axes, head_axes), pos,
                                      window=window, kv_chunk=kv_chunk,
                                      logits_soft_cap=logits_soft_cap)
    cache_update_slots(cache_k, cache_v, k_new, v_new, pos)
    hq = q.shape[2]
    gather_q = bool(set(slot_axes) & set(q_axes))
    if gather_q:
        q_c, kc, vc = spmd.all_gather(q, 2, q_axes), cache_k, cache_v
    else:
        kc = kv_for_queries(cache_k, n_q, q_axes, head_axes)
        vc = kv_for_queries(cache_v, n_q, q_axes, head_axes)
        q_c = q
    c_loc = cache_k.shape[1]
    C = c_loc * _size(slot_axes)
    mesh = spmd.current().mesh
    k_pos, k_valid = spmd.per_position(lambda p: cache_positions_range(
        spmd.part(pos, p) + 1, C, mesh.index_along(p, slot_axes) * c_loc, c_loc))
    m, l, o = flash_mlo(q_c, kc, vc, q_pos=pos[:, None], k_pos=k_pos, window=window,
                        k_valid=k_valid, kv_chunk=min(kv_chunk, c_loc),
                        logits_soft_cap=logits_soft_cap)
    n = _size(slot_axes)
    ms, ls, os_ = (spmd.all_gather(t[None], 0, slot_axes) for t in (m, l, o))
    out = mlo_normalize(*mlo_merge([(ms[i], ls[i], os_[i]) for i in range(n)]), q.dtype)
    return spmd.narrow_along(out, 2, q_axes, hq) if gather_q else out


def cache_positions_range(pos: Tensor, capacity: int, offset: int, length: int):
    """Absolute position + validity for ring slots [offset, offset + length)
    of a cache with GLOBAL capacity ``capacity`` (sequence-parallel decode:
    each shard passes its own offset).  Slot s was last written at
    t = pos-1 - ((pos-1-s) mod C); valid iff 0 <= t."""
    s = offset + torch.arange(length, device=pos.device)[None, :]
    p = pos.long()[:, None]
    last = p - 1 - torch.remainder(p - 1 - s, capacity)
    valid = (last >= 0) & (p > 0)
    return last.to(torch.int32), valid


def cache_positions(pos: Tensor, capacity: int) -> tuple[Tensor, Tensor]:
    """Absolute position + validity of every ring slot."""
    return cache_positions_range(pos, capacity, 0, capacity)


def decode_attention_layer(
    q: Tensor,  # [B, 1, Hq, D] (RoPE applied at absolute position pos)
    cache_k: Tensor,  # [B, C, Hkv, D]  (new token already written)
    cache_v: Tensor,
    pos: Tensor,  # [B] position of the NEW token
    *,
    window: int | None,
    kv_chunk: int = 2048,
    logits_soft_cap: float | None = None,
) -> Tensor:
    """One-token attention against a (possibly ring) cache."""
    C = cache_k.shape[1]
    k_pos, k_valid = cache_positions(pos + 1, C)  # +1: new token written
    return gqa_attention(q, cache_k, cache_v, q_pos=pos[:, None], k_pos=k_pos, window=window,
                         k_valid=k_valid, kv_chunk=kv_chunk, logits_soft_cap=logits_soft_cap)

