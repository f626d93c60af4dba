"""Attention: GQA/MQA, RoPE, qk-norm and sliding windows — prefill and decode.

Counterpart of ``repro/models/attention.py``: :func:`init_attention`,
:func:`qkv`, :func:`attention_block` (prefill, and decode against a cache),
:func:`decode_attend`, :class:`KVCache` and :func:`update_cache`.  The
prefill's attention is the flash-attention wrapper (B7): the hand-written
kernel on a CUDA tensor, its plain version on a CPU tensor, in the model's
[B, S, H, hd] layout with the KV head indexed, not repeated.

Decode is plain PyTorch on either device, as the reference's is plain XLA
(no Pallas kernel): one query token against a preallocated cache, q grouped
by KV head (``_group``, no repeat), scores and softmax in float32, the
probabilities cast to v's dtype before P·V.  :func:`update_cache` writes
the new token into the cache in place and returns it, the PyTorch
counterpart of the reference's ``donate_argnums=(1,)``: a caller must not
reuse the cache it passed in, as it now holds the new token.

What the port leaves out, and why:

* ``attend_full``, ``attend_chunked`` and ``attend_auto``: the reference's
  three mask-consistent attention routes collapse into the one wrapper (in
  the port the attention always streams through B7; ``chunked_attn`` has no
  meaning).  ``attend_chunked_skip`` and ``attend_auto``'s shard_map route
  are mesh-only, and the sharding hints (``hints.hint``,
  ``hints.active_mesh``) have no meaning without a mesh: they wait for
  ROADMAP queue A item 12.

Shapes: x [B, S, d]; q [B, S, H, hd]; k, v [B, S, Hkv, hd]; caches
[B, S_max, Hkv, hd].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common

Params = dict[str, Any]

_NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Params = {
        "wq": common.dense_init(gen, (d, h * hd), dtype, lead=lead),
        "wk": common.dense_init(gen, (d, hkv * hd), dtype, lead=lead),
        "wv": common.dense_init(gen, (d, hkv * hd), dtype, lead=lead),
        "wo": common.dense_init(gen, (h * hd, d), dtype, lead=lead),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=gen.device)
    if cfg.qk_norm:
        p["q_norm"] = common.init_rmsnorm(hd, dtype, lead=lead, device=gen.device)
        p["k_norm"] = common.init_rmsnorm(hd, dtype, lead=lead, device=gen.device)
    return p


def qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Project + rope.  Returns q [B,S,H,hd], k/v [B,S,Hkv,hd]."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = common.rmsnorm(p["q_norm"], q)
        k = common.rmsnorm(p["k_norm"], k)
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B,S,H,hd] -> [B,S,Hkv,G,hd] with G = H//Hkv query heads per KV head."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, hkv, h // hkv, hd)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos, *,
                  window: int | None = None) -> torch.Tensor:
    """One-step decode.  q [B,1,H,hd]; caches [B,S,Hkv,hd]; ``pos`` (an int
    or a 0-d integer tensor on the cache's device) is the current token's
    position: cache slots > pos are masked out, and with ``window`` those
    <= pos - window too."""
    b, _, h, hd = q.shape
    hkv = k_cache.shape[2]
    qg = _group(q, hkv)[:, 0]  # [B,Hkv,G,hd]
    scale = hd**-0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    k_pos = torch.arange(k_cache.shape[1], device=k_cache.device)
    ok = k_pos <= pos
    if window is not None:
        ok &= k_pos > pos - window
    scores = torch.where(ok[None, None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache)
    return out.reshape(b, 1, h, v_cache.shape[-1])


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, S_max, Hkv, hd]
    v: torch.Tensor


def _slots(pos, s_new: int, s_max: int, device) -> torch.Tensor:
    """The cache slots of ``s_new`` tokens written from ``pos``, as the
    reference's ``dynamic_update_slice`` places them: a negative start
    counts from the end, then the start is clamped into [0, s_max - s_new]."""
    if isinstance(pos, torch.Tensor):
        start = pos.reshape(()).to(device=device, dtype=torch.long)
        start = torch.where(start < 0, start + s_max, start).clamp(0, s_max - s_new)
        return start + torch.arange(s_new, device=device)
    start = int(pos) + s_max if int(pos) < 0 else int(pos)
    start = min(max(start, 0), s_max - s_new)
    return torch.arange(start, start + s_new, device=device)


def update_cache(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor, pos) -> KVCache:
    """Write the new tokens' k/v [B, s, Hkv, hd] into the cache from slot
    ``pos`` on, in place, and return the cache: the tensors passed in now
    hold the new tokens (the reference returns a new cache and donates the
    old one)."""
    idx = _slots(pos, k_new.shape[1], cache.k.shape[1], cache.k.device)
    cache.k.index_copy_(1, idx, k_new)
    cache.v.index_copy_(1, idx, v_new)
    return cache


def _positions(cache_pos, device) -> torch.Tensor:
    """The decode token's position as an int32 [1] tensor (the reference's
    ``jnp.full((1,), cache_pos, jnp.int32)``)."""
    if isinstance(cache_pos, torch.Tensor):
        return cache_pos.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(cache_pos), dtype=torch.int32, device=device)


def attention_block(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    window: int | None = None,
    cache: KVCache | None = None,
    cache_pos=None,
    write_slot=None,
):
    """Full attention sub-block (projections, attention, output projection).

    Prefill: ``cache=None`` -> (out [B, S, d], (k, v)), causal attention
    through B7.  Decode: ``cache`` given, x [B, 1, d] -> (out, cache), the
    cache updated in place.  ``cache_pos`` is the ABSOLUTE token position
    (RoPE and the validity mask); ``write_slot`` is the cache slot to write
    (default ``cache_pos``; ring caches pass pos % window).  Ring caches
    must pass ``window=None``: the ring itself enforces the window.
    """
    b, s, _ = x.shape
    if cache is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        q, k, v = qkv(p, cfg, x, pos)
        out, _ = flash_attention(q, k, v, causal=True, window=window)
        return out.reshape(b, s, -1) @ p["wo"], (k, v)

    if cache_pos is None:
        raise ValueError("decode against a cache needs cache_pos")
    slot = write_slot if write_slot is not None else cache_pos
    q, k, v = qkv(p, cfg, x, _positions(cache_pos, x.device))
    cache = update_cache(cache, k, v, slot)
    out = decode_attend(q, cache.k, cache.v, cache_pos, window=window)
    return out.reshape(b, s, -1) @ p["wo"], cache
