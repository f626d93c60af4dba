"""Whisper-style encoder-decoder transformer (arXiv:2212.04356): init, the
encoder, the teacher-forced decoder, the training loss and decode.

Counterpart of ``repro/models/encdec.py`` (whisper-tiny).  As in the
reference, the mel-spectrogram and conv feature extractor is a stub: the
inputs are precomputed frame embeddings [B, T_enc, d] (what Whisper's two
conv layers would emit).  This module is the transformer backbone: a
bidirectional encoder over the frames, a causal decoder with
cross-attention, pre-LayerNorm, GELU MLPs, fixed sinusoidal positions in
the encoder and a learned ``dec_pos`` table in the decoder, biasless
projections, the decoder's embedding tied to its output.

* The encoder's self-attention is B7 with ``causal=False``
  (``kernels/flash_attention``), the reference's ``attend_full(causal=
  False)``; the decoder's is the causal B7 of ``attention.attention_block``.
  Under grad both go through the B8 backward.
* The cross-attention (:func:`_xattn`, :func:`xattn_kv`) is plain PyTorch,
  scores and softmax in float32, as the reference's is plain einsums
  outside any Pallas kernel (B7 takes equal query and key lengths only).
* Every layer is checkpointed (``torch.utils.checkpoint``) when grad mode
  is on, as the reference wraps each in ``jax.checkpoint``.
* Decode keeps the decoder's self-attention KV in an in-place
  ``attention.KVCache`` stacked [L, B, S, H, hd] and the cross K/V of the
  encoder output, computed once per request by :func:`init_cache`, in an
  :class:`EncDecCache`; :func:`decode_step` updates the cache in place and
  returns it (the reference donates it).

Under a mesh (``hints.use_mesh``) ``encode``, ``decode_train`` and
``lm_loss`` take this rank's slices of the parameters
(``launch/shardings.py``) and its rows of the frames and tokens.  Both
self-attentions take ``attention.attention_block``'s mesh routes (the
encoder's with ``causal=False``), the GELU MLPs ``common.mlp``'s (``b_up``
split with the columns, ``b_down`` added after the sum), and ``dec_pos``
is whole on every rank.  The cross-attention's ``wq``/``wk``/``wv`` are
column-parallel and ``wo`` row-parallel: where the heads divide the model
extent each rank attends its heads (the decoder states and the encoder
states entering through ``hints.copy``) and ``wo`` is followed by a
``hints.psum``; where they do not (whisper-tiny's 6 heads over 4 ranks),
each split weight is gathered whole (``hints.replicate``) and every rank
runs the cross-attention alike.  A layer leaf split over ``data`` (FSDP)
is gathered inside the rematerialised layer.  Decode keeps its one-device
path.

Frames in another dtype than the parameters meet them as JAX promotes
them: float32 frames against bf16 parameters run the encoder in float32 on
the exactly widened weights.  The decoder takes encoder states in the
parameters' dtype only; the reference's refuses wider ones too (its scan's
carry would change type), so a bf16 model is fed bf16 frames.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hints, transformer

Params = dict[str, Any]


def _init_xattn(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {
        "wq": common.dense_init(gen, (d, h * hd), dtype, lead=lead),
        "wk": common.dense_init(gen, (d, h * hd), dtype, lead=lead),
        "wv": common.dense_init(gen, (d, h * hd), dtype, lead=lead),
        "wo": common.dense_init(gen, (h * hd, d), dtype, lead=lead),
    }


def _widen(p: Params, x: torch.Tensor) -> tuple[Params, torch.Tensor]:
    """``p`` and ``x`` in their promoted type: what JAX computes when a
    sub-block's weights meet ``x`` (the identity where the types agree)."""
    def leaves(t):
        return [u for v in t.values() for u in (leaves(v) if isinstance(v, dict) else [v])]

    def cast(t, dt):
        return {k: cast(v, dt) if isinstance(v, dict) else v.to(dt) for k, v in t.items()}

    dt = x.dtype
    for leaf in leaves(p):
        dt = torch.promote_types(dt, leaf.dtype)
    return cast(p, dt), x.to(dt)


def _xattn(p: Params, cfg: ArchConfig, x: torch.Tensor, kv, mesh=None) -> torch.Tensor:
    """Cross attention: x [B, Sq, d] against precomputed (k, v) [B, Se, H, hd]
    (under ``mesh``: this rank's heads of ``p``'s columns, x entering
    through ``hints.copy`` and the output summed over ``model``)."""
    b, sq, _ = x.shape
    hd = cfg.head_dim
    if mesh is not None:
        x = hints.copy(x, mesh)
    q = (x @ p["wq"]).reshape(b, sq, -1, hd)
    k, v = kv
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() * hd**-0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v).reshape(b, sq, -1) @ p["wo"]
    return out if mesh is None else hints.psum(out, mesh)


def xattn_kv(p: Params, cfg: ArchConfig, enc_out: torch.Tensor, mesh=None):
    """The cross-attention's (k, v) [B, Se, H, hd] of the encoder states
    (under ``mesh``: the heads of ``p``'s columns, the states entering
    through ``hints.copy``)."""
    b, se, _ = enc_out.shape
    hd = cfg.head_dim
    if mesh is not None:
        enc_out = hints.copy(enc_out, mesh)
    return ((enc_out @ p["wk"]).reshape(b, se, -1, hd),
            (enc_out @ p["wv"]).reshape(b, se, -1, hd))


def _cross_layout(p: Params, cfg: ArchConfig):
    """(the cross-attention's weights, the mesh its heads split over or
    None): under a mesh whose model axis splits the weights, this rank's
    heads where the heads divide, else every split weight gathered whole
    (the block then runs alike on every rank)."""
    mesh = hints.active_mesh()
    _, ext = hints.model_rank(mesh)
    width = cfg.n_heads * cfg.head_dim
    if ext == 1 or p["wo"].shape[-2] == width:
        return p, None
    if cfg.n_heads % ext == 0:
        return p, mesh
    return {k: hints.replicate(v, mesh, -2 if k == "wo" else -1) for k, v in p.items()}, None


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device: ``enc_layers`` stacked on
    [n_encoder_layers], ``dec_layers`` on [n_layers], the learned decoder
    positions ``dec_pos`` [max_seq_len, d]."""
    d, dev = cfg.d_model, gen.device
    enc, dec = (cfg.n_encoder_layers,), (cfg.n_layers,)

    def norm(lead=()):
        return common.init_layernorm(d, dtype, lead=lead, device=dev)

    return {
        "embed": common.init_embedding(gen, cfg.vocab_size, d, dtype),
        "enc_layers": {
            "attn_norm": norm(enc),
            "attn": attn_mod.init_attention(gen, cfg, dtype, lead=enc),
            "mlp_norm": norm(enc),
            "mlp": common.init_mlp(gen, "gelu_mlp", d, cfg.d_ff, dtype, lead=enc),
        },
        "enc_norm": norm(),
        "dec_layers": {
            "self_norm": norm(dec),
            "self_attn": attn_mod.init_attention(gen, cfg, dtype, lead=dec),
            "cross_norm": norm(dec),
            "cross_attn": _init_xattn(gen, cfg, dtype, lead=dec),
            "mlp_norm": norm(dec),
            "mlp": common.init_mlp(gen, "gelu_mlp", d, cfg.d_ff, dtype, lead=dec),
        },
        "dec_norm": norm(),
        "dec_pos": common.embed_init(gen, (cfg.max_seq_len, d), dtype),
    }


def _enc_layer(layer: Params, h: torch.Tensor, cfg: ArchConfig, fsdp=None) -> torch.Tensor:
    if fsdp is not None:
        layer = hints.gather_data(layer, fsdp, hints.active_mesh(), slice(1, None), shift=1)
    p, x = _widen(layer["attn"], common.layernorm(layer["attn_norm"], h))
    h = h + attn_mod.attention_block(p, cfg, x, causal=False)[0]
    p, x = _widen(layer["mlp"], common.layernorm(layer["mlp_norm"], h))
    return h + common.mlp(p, "gelu_mlp", x, d_ff=cfg.d_ff)


def _dec_block(layer: Params, h: torch.Tensor, cfg: ArchConfig, kv, mesh=None,
               **cache) -> torch.Tensor:
    """One decoder layer against the cross (k, v) (``mesh``: the heads of
    the cross-attention split over it); ``cache`` is ``attention_block``'s
    decode arguments, none for teacher forcing."""
    a, _ = attn_mod.attention_block(layer["self_attn"], cfg,
                                    common.layernorm(layer["self_norm"], h), **cache)
    h = h + a
    h = h + _xattn(layer["cross_attn"], cfg, common.layernorm(layer["cross_norm"], h), kv, mesh)
    return h + common.mlp(layer["mlp"], "gelu_mlp", common.layernorm(layer["mlp_norm"], h),
                          d_ff=cfg.d_ff)


def _dec_layer(layer: Params, h: torch.Tensor, cfg: ArchConfig,
               enc_out: torch.Tensor, fsdp=None) -> torch.Tensor:
    if fsdp is not None:
        layer = hints.gather_data(layer, fsdp, hints.active_mesh(), slice(1, None), shift=1)
    cross, mesh = _cross_layout(layer["cross_attn"], cfg)
    layer = {**layer, "cross_attn": cross}
    return _dec_block(layer, h, cfg, xattn_kv(cross, cfg, enc_out, mesh), mesh)


def _layers(fn, params: Params, key: str, n: int, h: torch.Tensor, specs, *args) -> torch.Tensor:
    """``h`` through ``fn(layer, h, *args, fsdp)`` for each of the ``n``
    layers of ``params[key]`` (``specs``: the parameters' under a mesh)."""
    fsdp = None if specs is None else specs[key]
    stack = hints.gather_data(params[key], fsdp, hints.active_mesh(), slice(0, 1))
    for layer in common.unstack(stack, n):
        if torch.is_grad_enabled():
            h = hints.remat(fn, layer, h, *args, fsdp)
        else:
            h = fn(layer, h, *args, fsdp)
    return h


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [B, T_enc, d] (the conv stub's output) -> encoder states, in
    the promoted type of the frames and the parameters."""
    pos = common.sinusoidal_positions(frames.shape[1], cfg.d_model, device=frames.device)
    h = frames + pos.to(frames.dtype)
    h = _layers(_enc_layer, params, "enc_layers", cfg.n_encoder_layers, h,
                common.mesh_specs(cfg)[1], cfg)
    return common.layernorm(params["enc_norm"], h)


def decode_train(params: Params, cfg: ArchConfig, enc_out: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder hidden states [B, S, d] of ``tokens`` [B, S];
    ``enc_out`` in the parameters' dtype."""
    s = tokens.shape[1]
    h = common.embed(params["embed"], tokens, vocab=cfg.vocab_size) + params["dec_pos"][:s][None]
    if enc_out.dtype != h.dtype:
        raise TypeError(f"decode_train: encoder states in {enc_out.dtype} against "
                        f"{h.dtype} parameters; encode {h.dtype} frames")
    h = _layers(_dec_layer, params, "dec_layers", cfg.n_layers, h, common.mesh_specs(cfg)[1],
                cfg, enc_out)
    return common.layernorm(params["dec_norm"], h)


def lm_loss(params: Params, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S] given
    the frames, through the tied embedding."""
    h = decode_train(params, cfg, encode(params, cfg, frames), tokens)
    return transformer.next_token_xent(params, cfg, h, tokens, loss_chunk=512)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: attn_mod.KVCache   # [L, B, S_max, H, hd], written in place
    cross_kv: tuple             # (k, v) [L, B, T_enc, H, hd], fixed per request


def init_cache(params: Params, cfg: ArchConfig, enc_out: torch.Tensor, seq_len: int,
               dtype) -> EncDecCache:
    """A zero self-attention cache of ``seq_len`` slots in ``dtype`` and the
    cross K/V of ``enc_out`` [B, T_enc, d] (computed once per request, in
    the states' and weights' dtype), on the encoder states' device."""
    b, dev = enc_out.shape[0], enc_out.device
    shape = (cfg.n_layers, b, seq_len, cfg.n_kv_heads, cfg.head_dim)
    with torch.no_grad():
        kvs = [xattn_kv(layer["cross_attn"], cfg, enc_out)
               for layer in common.unstack(params["dec_layers"], cfg.n_layers)]
        cross = (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))
    return EncDecCache(
        self_kv=attn_mod.KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                                 v=torch.zeros(shape, dtype=dtype, device=dev)),
        cross_kv=cross)


def decode_step(params: Params, cfg: ArchConfig, cache: EncDecCache, token: torch.Tensor,
                pos) -> tuple[torch.Tensor, EncDecCache]:
    """One decoding step: ``token`` [B, 1] at position ``pos`` (an int or a
    0-d integer tensor) -> (logits [B, 1, V] from the tied embedding, the
    cache updated in place)."""
    table = params["dec_pos"]
    # dynamic_slice_in_dim's row: ``pos`` clamped into the table
    row = attn_mod._slots(pos, 1, table.shape[0], table.device)
    h = common.embed(params["embed"], token) + table.index_select(0, row)[None]
    xk, xv = cache.cross_kv
    for i, layer in enumerate(common.unstack(params["dec_layers"], cfg.n_layers)):
        h = _dec_block(layer, h, cfg, (xk[i], xv[i]), cache_pos=pos,
                       cache=attn_mod.KVCache(cache.self_kv.k[i], cache.self_kv.v[i]))
    h = common.layernorm(params["dec_norm"], h)
    return common.logits_from_hidden(h, params["embed"], None), cache
