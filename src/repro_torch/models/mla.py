"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): prefill and
the absorbed decode.

Counterpart of ``repro/models/mla.py``.  The KV state is a low-rank latent
``c_kv`` [B, S, kv_lora] plus one shared RoPE key ``k_pe`` [B, S, rope].

Prefill (``cache=None``) materialises per-head keys and values from the
latent and attends through B7 (``kernels/flash_attention``):
``q_full = [q_nope, q_pe]`` and ``k_full = [k_nope, k_pe broadcast over the
heads]``, q/k head size nope + rope (192 in deepseek-v2) against v's
``v_head_dim`` (128), causal, scale ``(nope + rope)^-½``, which is MLA's
own.  This is the reference's ``chunked=True`` route; its ``chunked=False``
route (two einsums and an [S, S] softmax) is the same function, so the port
keeps one.

Decode (``cache`` given) is the reference's absorbed form in latent space,
in plain PyTorch as the reference's is plain XLA: the query's nope part is
folded into ``w_uk``, scores and softmax in float32 over the latent cache,
the context unfolded through ``w_uv``.  The new token's latents go into the
cache in place, in the slot ``dynamic_update_slice`` would place them
(``attention.update_cache``'s rule), and the cache is returned.

Under a mesh (``hints.use_mesh``) with a ``model`` axis of extent ext > 1
the prefill takes this rank's slices (``launch/shardings.py``): ``w_q`` /
``w_uq``, ``w_uk`` and ``w_uv`` column-parallel, ``wo`` row-parallel.  The
latent projections (``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm``,
``w_kpe``) are whole on every rank, which computes them alike; they enter
the rank's split work through ``hints.copy``, so their gradients are
summed over ``model``.  When ext divides the heads, B7 runs on this rank's
H / ext heads (the reference's head hints) and ``wo`` is followed by a
``hints.psum``; otherwise each split weight is gathered whole
(``hints.replicate``) and every rank runs the block alike.  Decode keeps
its one-device path.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hints

Params = dict[str, Any]

_NEG_INF = -1e30


class MLACache(NamedTuple):
    c_kv: torch.Tensor  # [B, S, kv_lora]
    k_pe: torch.Tensor  # [B, S, rope_dim]


def init_mla(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    p: Params = {
        "w_dkv": common.dense_init(gen, (d, r), dtype, lead=lead),
        "kv_norm": common.init_rmsnorm(r, dtype, lead=lead, device=gen.device),
        "w_kpe": common.dense_init(gen, (d, rope), dtype, lead=lead),
        "w_uk": common.dense_init(gen, (r, h * nope), dtype, lead=lead),
        "w_uv": common.dense_init(gen, (r, h * vdim), dtype, lead=lead),
        "wo": common.dense_init(gen, (h * vdim, d), dtype, lead=lead),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = common.dense_init(gen, (d, cfg.q_lora_rank), dtype, lead=lead)
        p["q_norm"] = common.init_rmsnorm(cfg.q_lora_rank, dtype, lead=lead,
                                          device=gen.device)
        p["w_uq"] = common.dense_init(gen, (cfg.q_lora_rank, h * (nope + rope)), dtype,
                                      lead=lead)
    else:
        p["w_q"] = common.dense_init(gen, (d, h * (nope + rope)), dtype, lead=lead)
    return p


def _queries(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
             mesh=None):
    """(q_nope, q_pe) of the heads the query weight's columns hold; under
    ``mesh`` the input of the column-parallel product enters through
    ``hints.copy``."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        q_in, w = common.rmsnorm(p["q_norm"], x @ p["w_dq"]), p["w_uq"]
    else:
        q_in, w = x, p["w_q"]
    if mesh is not None:
        q_in = hints.copy(q_in, mesh)
    q = (q_in @ w).reshape(b, s, -1, nope + rope)
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    return q_nope, common.apply_rope(q_pe, positions, cfg.rope_theta)


def _latents(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    c_kv = common.rmsnorm(p["kv_norm"], x @ p["w_dkv"])                # [B,S,r]
    k_pe = x @ p["w_kpe"]                                              # [B,S,rope]
    k_pe = common.apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe


def mla_block(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    cache: MLACache | None = None,
    cache_pos=None,
    write_slot=None,
):
    """Prefill (``cache=None``): x [B, S, d] -> (out [B, S, d], (c_kv,
    k_pe)).  Decode: x [B, 1, d] at ABSOLUTE position ``cache_pos`` (an int
    or a 0-d integer tensor), the latents written to slot ``write_slot``
    (default ``cache_pos``; a ring passes pos % its length) -> (out, the
    cache updated in place)."""
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim

    if cache is None:
        mesh = hints.active_mesh()
        if hints.model_rank(mesh)[1] > 1:
            return _mla_mesh(p, cfg, x, mesh)
        positions = torch.arange(s, device=x.device)
        q_nope, q_pe = _queries(p, cfg, x, positions)
        c_kv, k_pe = _latents(p, cfg, x, positions)
        k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, nope)
        v = (c_kv @ p["w_uv"]).reshape(b, s, h, vdim)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, rope)], dim=-1)
        out, _ = flash_attention(q_full, k_full, v, causal=True)
        return out.reshape(b, s, h * vdim) @ p["wo"], (c_kv, k_pe)

    if hints.model_rank(hints.active_mesh())[1] > 1:
        raise NotImplementedError("decode under a mesh with a model axis: decode keeps its "
                                  "one-device path")
    if cache_pos is None:
        raise ValueError("decode against a cache needs cache_pos")
    slot = write_slot if write_slot is not None else cache_pos
    positions = attn_mod._positions(cache_pos, x.device)
    q_nope, q_pe = _queries(p, cfg, x, positions)                      # [B,1,h,*]
    c_new, kpe_new = _latents(p, cfg, x, positions)                    # [B,1,r], [B,1,rope]
    idx = attn_mod._slots(slot, 1, cache.c_kv.shape[1], cache.c_kv.device)
    cache.c_kv.index_copy_(1, idx, c_new.to(cache.c_kv.dtype))
    cache.k_pe.index_copy_(1, idx, kpe_new.to(cache.k_pe.dtype))
    c_kv, k_pe = cache

    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, p["w_uk"].reshape(r, h, nope))[:, 0]
    scores = (torch.einsum("bhr,bsr->bhs", q_abs, c_kv)
              + torch.einsum("bhd,bsd->bhs", q_pe[:, 0], k_pe)).float() * (nope + rope) ** -0.5
    k_idx = torch.arange(c_kv.shape[1], device=c_kv.device)
    scores = torch.where((k_idx <= cache_pos)[None, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    ctx = torch.einsum("bhs,bsr->bhr", probs, c_kv)                    # [B,h,r]
    out = torch.einsum("bhr,rhd->bhd", ctx, p["w_uv"].reshape(r, h, vdim))
    return out.reshape(b, 1, h * vdim) @ p["wo"], cache


def _mla_mesh(p: Params, cfg: ArchConfig, x: torch.Tensor, mesh):
    """The prefill on the model axis (module docstring): (out, (c_kv, k_pe))
    with the latents whole."""
    b, s, _ = x.shape
    h, nope, rope, vdim = (cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                           cfg.v_head_dim)
    _, ext = hints.model_rank(mesh)
    if h % ext:
        # the heads do not split: each split weight gathered whole, the
        # block run alike on every rank
        p = dict(p)
        widths = {"w_q": h * (nope + rope), "w_uq": h * (nope + rope), "w_uk": h * nope,
                  "w_uv": h * vdim}
        for k, full in widths.items():
            if k in p and p[k].shape[-1] != full:
                p[k] = hints.replicate(p[k], mesh, -1)
        if p["wo"].shape[-2] != h * vdim:
            p["wo"] = hints.replicate(p["wo"], mesh, -2)
        with hints.use_mesh(None):
            return mla_block(p, cfg, x)
    positions = torch.arange(s, device=x.device)
    q_nope, q_pe = _queries(p, cfg, x, positions, mesh)                # this rank's heads
    c_kv, k_pe = _latents(p, cfg, x, positions)                         # whole, alike
    c_in, kpe_in = hints.copy(c_kv, mesh), hints.copy(k_pe, mesh)
    hl = h // ext
    k_nope = (c_in @ p["w_uk"]).reshape(b, s, hl, nope)
    v = (c_in @ p["w_uv"]).reshape(b, s, hl, vdim)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat([k_nope, kpe_in[:, :, None, :].expand(b, s, hl, rope)], dim=-1)
    out, _ = flash_attention(q_full, k_full, v, causal=True)
    return hints.psum(out.reshape(b, s, hl * vdim) @ p["wo"], mesh), (c_kv, k_pe)
