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

Under a mesh (``hints.use_mesh``) with a ``model`` axis of extent ext > 1,
the prefill takes this rank's column-parallel slices of wq, wk, wv (and
bq, bk, bv) and row-parallel slice of wo (``launch/shardings.py``), and
:func:`attention_block` picks the reference's ``attend_auto`` route:

* head-parallel, when Hkv or the group size G = H / Hkv divides ext: B7
  runs on this rank's H / ext query heads.  Where Hkv divides, its KV heads
  are its own columns and no collective runs; where only G divides, the
  KV heads are gathered and each rank takes those its query heads read;
* sequence-parallel, when S divides by ext and S / ext >= 16: q, k and v
  are gathered along heads, this rank attends its query stripe of S / ext
  rows at ``q_offset = rank·S/ext`` against the full K/V (B7 with a query
  offset), the stripes are gathered, and the rank keeps the feature slice
  its row-parallel wo reads;
* otherwise replicated: the heads are gathered and every rank runs one
  full B7, keeping the feature slice its wo reads;
* where the model extent does not divide the projections' widths, the
  rules split none of them and every rank runs the block alike.

wo is followed by the sum over ``model``.  ``causal=False`` (whisper's
encoder) takes the same routes without the mask.  The collectives and
their gradients are ``models/hints.py``'s.  Decode keeps its one-device
path.

``DEFAULT_CAUSAL_SKIP`` keeps the reference's name (the default of its
``attend_auto(causal_skip=)``).  In the port ``attend_chunked_skip`` is B7
itself: both CUDA routes walk only
the key tiles that meet a block's causal / window band
(``flash_attention.cu``: from the tile of the band's first key to the
block's last query position; ``flash_fwd_sm90.cuh``: the same, and each
consumer warpgroup skips the tiles that miss its own 64 rows), so a fully
masked block is never loaded or computed, with or without the skip.  The
flag changes nothing and no second attention path exists.

What the port leaves out, and why: ``attend_full``, ``attend_chunked`` and
``attend_auto`` as functions: the reference's three mask-consistent
attention routes collapse into the one wrapper (the attention always
streams through B7; ``chunked_attn`` has no meaning), and ``attend_auto``'s
mesh routes are :func:`attention_block`'s.

Shapes: x [B, S, d]; q [B, S, H, hd]; k, v [B, S, Hkv, hd]; caches
[B, S_max, Hkv, hd].
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import common, hints

Params = dict[str, Any]

_NEG_INF = -1e30

# The reference's opt-in causal block skip; B7 always skips (module docstring).
DEFAULT_CAUSAL_SKIP = False


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


def _project(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """The q, k and v projections [B, S, features] (this rank's columns
    under a mesh)."""
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _heads(p: Params, cfg: ArchConfig, q, k, v, positions: torch.Tensor):
    """Reshape by the head counts the features hold (their widths over
    head_dim), then qk-norm and rope."""
    b, s, _ = q.shape
    hd = cfg.head_dim
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    if cfg.qk_norm:
        mesh = hints.active_mesh()
        # inside the model axis's split work the norms' gradients are partial
        qn, kn = ({"scale": hints.copy(p[n]["scale"], mesh)} if mesh is not None else p[n]
                  for n in ("q_norm", "k_norm"))
        q = common.rmsnorm(qn, q)
        k = common.rmsnorm(kn, k)
    if cfg.use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    """Project + rope.  Returns q [B,S,H,hd], k/v [B,S,Hkv,hd] (under a mesh:
    the heads of this rank's columns)."""
    return _heads(p, cfg, *_project(p, cfg, x), positions)


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
    causal: bool = True,
    cache: KVCache | None = None,
    cache_pos=None,
    write_slot=None,
):
    """Full attention sub-block (projections, attention, output projection).

    Prefill: ``cache=None`` -> (out [B, S, d], (k, v)), causal attention
    through B7 (``causal=False``: every query attends every key, the
    encoder's self-attention).  Decode: ``cache`` given, x [B, 1, d] -> (out, cache), the
    cache updated in place.  ``cache_pos`` is the ABSOLUTE token position
    (RoPE and the validity mask); ``write_slot`` is the cache slot to write
    (default ``cache_pos``; ring caches pass pos % window).  Ring caches
    must pass ``window=None``: the ring itself enforces the window.
    """
    b, s, _ = x.shape
    if cache is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)
        mesh = hints.active_mesh()
        rank, ext = hints.model_rank(mesh)
        if ext > 1 and p["wo"].shape[-2] != cfg.n_heads * cfg.head_dim:
            return _attention_mesh(p, cfg, x, pos, window, causal, mesh, rank, ext)
        # one device, or a model axis that splits none of the block's
        # weights: every rank runs it alike
        with hints.use_mesh(None):
            q, k, v = qkv(p, cfg, x, pos)
        out, _ = flash_attention(q, k, v, causal=causal, window=window)
        return out.reshape(b, s, -1) @ p["wo"], (k, v)

    if hints.model_rank(hints.active_mesh())[1] > 1:
        raise NotImplementedError("decode under a mesh with a model axis: decode keeps its "
                                  "one-device path")
    if cache_pos is None:
        raise ValueError("decode against a cache needs cache_pos")
    slot = write_slot if write_slot is not None else cache_pos
    q, k, v = qkv(p, cfg, x, _positions(cache_pos, x.device))
    cache = update_cache(cache, k, v, slot)
    out = decode_attend(q, cache.k, cache.v, cache_pos, window=window)
    return out.reshape(b, s, -1) @ p["wo"], cache


def _whole(mesh, w: torch.Tensor, full: int) -> tuple[torch.Tensor, bool]:
    """(``w``, whether it is this rank's column slice of ``full`` columns).
    A weight the rules leave whole enters the model axis's split work, so
    its gradient is summed over ``model`` (``hints.copy``)."""
    if w.shape[-1] != full:
        return w, True
    return hints.copy(w, mesh), False


def _attention_mesh(p: Params, cfg: ArchConfig, x, positions, window, causal: bool, mesh,
                    rank: int, ext: int):
    """The prefill attention block on the model axis: the route of the
    reference's ``attend_auto`` (module docstring).  Returns (out, (k, v))
    with k and v the heads this rank attended with."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // hkv
    x = hints.copy(x, mesh)
    proj = {}
    for name, full in (("q", h * hd), ("k", hkv * hd), ("v", hkv * hd)):
        w, split = _whole(mesh, p["w" + name], full)
        y = x @ w
        if cfg.qkv_bias:
            y = y + (p["b" + name] if split else hints.copy(p["b" + name], mesh))
        proj[name] = (y, split)

    def gathered(name):
        y, split = proj[name]
        return hints.all_gather(y, mesh, -1) if split else y

    if hkv % ext == 0 or g % ext == 0:
        # head-parallel: this rank's H / ext query heads
        hl = h // ext
        if hkv % ext == 0:
            k_in, v_in = proj["k"][0], proj["v"][0]
        else:
            k_in, v_in = gathered("k"), gathered("v")
        q, k, v = _heads(p, cfg, proj["q"][0], k_in, v_in, positions)
        if hkv % ext:
            k, v = _kv_for_heads(k, v, rank * hl, hl, g)
        out, _ = flash_attention(q, k, v, causal=causal, window=window)
        out = out.reshape(b, s, -1)
    else:
        q, k, v = _heads(p, cfg, gathered("q"), gathered("k"), gathered("v"), positions)
        if s % ext == 0 and s // ext >= 16:
            # sequence-parallel: this rank's stripe of queries against every key
            sl = s // ext
            stripe, _ = flash_attention(q[:, rank * sl:(rank + 1) * sl], k, v, causal=causal,
                                        window=window, q_offset=rank * sl)
            out = hints.all_gather(stripe.reshape(b, sl, -1), mesh, 1)
        else:
            out, _ = flash_attention(q, k, v, causal=causal, window=window)
            out = out.reshape(b, s, -1)
        # the feature slice this rank's row-parallel wo reads
        width = h * hd // ext
        out = out[..., rank * width:(rank + 1) * width]
    return hints.psum(out @ p["wo"], mesh), (k, v)


def _kv_for_heads(k, v, first: int, n: int, g: int):
    """The KV heads that query heads ``first .. first + n - 1`` read (each
    reads head j // g), laid out so the flash-attention wrapper's rule
    (query head i reads KV head i // (n / Hkv)) finds them: whole groups as
    they are, heads inside one group as that KV head, else one KV head per
    query head."""
    lo, hi = first // g, (first + n - 1) // g
    if (first % g == 0 and n % g == 0) or lo == hi:
        return k[:, :, lo:hi + 1], v[:, :, lo:hi + 1]
    idx = torch.arange(first, first + n, device=k.device) // g
    return k.index_select(2, idx), v.index_select(2, idx)
