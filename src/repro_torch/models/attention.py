"""Attention: GQA/MQA, RoPE, qk-norm and sliding windows — the prefill path.

Counterpart of ``repro/models/attention.py`` for training-shaped (prefill)
inputs: :func:`init_attention`, :func:`qkv` and :func:`attention_block`
without a cache.  Its attention is the flash-attention wrapper (B7): the
hand-written kernel on a CUDA tensor, its plain version on a CPU tensor, in
the model's [B, S, H, hd] layout with the KV head indexed, not repeated.

What the port leaves out, and why:

* ``attend_full``, ``attend_chunked`` and ``attend_auto``: the reference's
  three mask-consistent attention routes collapse into the one wrapper (in
  the port the attention always streams through B7; ``chunked_attn`` has no
  meaning).  ``attend_chunked_skip`` and ``attend_auto``'s shard_map route
  are mesh-only, and the sharding hints (``hints.hint``,
  ``hints.active_mesh``) have no meaning without a mesh: they wait for
  ROADMAP queue A item 12.
* ``decode_attend``, ``KVCache`` and ``update_cache`` wait for the decode
  slice.

Shapes: x [B, S, d]; q [B, S, H, hd]; k, v [B, S, Hkv, hd].
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common

Params = dict[str, Any]


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


def attention_block(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor | None = None,
    window: int | None = None,
):
    """Full attention sub-block (projections, causal attention, output
    projection) for prefill: returns (out [B, S, d], (k, v))."""
    b, s, _ = x.shape
    pos = positions if positions is not None else torch.arange(s, device=x.device)
    q, k, v = qkv(p, cfg, x, pos)
    out, _ = flash_attention(q, k, v, causal=True, window=window)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)
