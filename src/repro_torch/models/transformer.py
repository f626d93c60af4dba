"""Dense decoder-only transformer (llama lineage): init, forward, the
training loss and decode.

Counterpart of ``repro/models/transformer.py``'s ``init_params``,
``forward``, ``lm_loss``, ``init_cache`` and ``decode_step`` (qwen3-1.7b,
qwen2-1.5b, mistral-nemo-12b, granite-20b and, with a projected patch
prefix, the InternVL2 decoder of ``models/vlm.py``).  Layer parameters are
stacked on a leading [L] axis, as the reference stacks them; the
reference's ``lax.scan`` over that axis is a Python loop over layer views.

``remat`` is the reference's ``jax.checkpoint`` of every layer:
``torch.utils.checkpoint`` around each layer when grad mode is on, so the
backward keeps one [B, S, d] input per layer and recomputes the rest (the
attention forward, B7, runs again there).  Without grad it changes nothing.

Decode keeps a stacked [L, B, S, Hkv, hd] KV cache (a sliding-window model
allocates only ``min(seq_len, window)`` slots and writes ring slot
``pos % cache_len``); :func:`decode_step` updates it in place and returns
it (see ``attention.update_cache``).

What the port leaves out: ``chunked_attn`` (the attention always streams
through the B7/B8 kernels).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common

Params = dict[str, Any]


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device (layers stacked on [L])."""
    lead, d, dev = (cfg.n_layers,), cfg.d_model, gen.device
    params: Params = {
        "embed": common.init_embedding(gen, cfg.vocab_size, d, dtype),
        "layers": {
            "attn_norm": common.init_norm(cfg.norm, d, dtype, lead=lead, device=dev),
            "attn": attn_mod.init_attention(gen, cfg, dtype, lead=lead),
            "mlp_norm": common.init_norm(cfg.norm, d, dtype, lead=lead, device=dev),
            "mlp": common.init_mlp(gen, cfg.mlp, d, cfg.d_ff, dtype, lead=lead),
        },
        "final_norm": common.init_norm(cfg.norm, d, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (d, cfg.vocab_size), dtype)
    return params


def layer_fwd(layer: Params, cfg: ArchConfig, h: torch.Tensor, window) -> torch.Tensor:
    a, _ = attn_mod.attention_block(
        layer["attn"], cfg, common.apply_norm(cfg.norm, layer["attn_norm"], h),
        window=window,
    )
    h = h + a
    return h + common.mlp(layer["mlp"], cfg.mlp,
                          common.apply_norm(cfg.norm, layer["mlp_norm"], h))


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None, window: int | None = None,
            remat: bool = True) -> torch.Tensor:
    """Hidden states [B, P + S, d] for training or prefill; ``tokens`` [B, S]
    on the parameters' device.  ``prefix_embeds`` [B, P, d] (the VLM's
    projected patches), cast to the embeddings' dtype, go before the token
    embeddings, and positions run over prefix and text."""
    h = common.embed(params["embed"], tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    win = window if window is not None else cfg.sliding_window
    remat = remat and torch.is_grad_enabled()
    for layer in common.unstack(params["layers"], cfg.n_layers):
        if remat:
            # the layers draw no random numbers: no RNG state to replay
            h = checkpoint(layer_fwd, layer, cfg, h, win, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer_fwd(layer, cfg, h, win)
    return common.apply_norm(cfg.norm, params["final_norm"], h)


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S];
    ``prefix_embeds`` [B, P, d] go before the text and carry no loss."""
    h = forward(params, cfg, tokens, prefix_embeds=prefix_embeds)
    n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    h = h[:, n_prefix:]
    h_in, labels = h[:, :-1], tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    w = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    return common.chunked_softmax_xent(h_in, labels, mask, w,
                                       chunk=min(loss_chunk, h_in.shape[1]),
                                       transpose=cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, *,
               device=None) -> attn_mod.KVCache:
    """Stacked [L, B, S, Hkv, hd] KV cache of zeros on ``device`` (``None``:
    the card; the parameters' device is the one to pass); sliding-window
    models allocate only the window."""
    s = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len
    shape = (cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return attn_mod.KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                            v=torch.zeros(shape, dtype=dtype, device=dev))


def decode_step(params: Params, cfg: ArchConfig, cache: attn_mod.KVCache,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, attn_mod.KVCache]:
    """One decoding step: ``token`` [B, 1] at position ``pos`` (an int or a
    0-d integer tensor) -> (logits [B, 1, V], the cache updated in place)."""
    h = common.embed(params["embed"], token)
    cache_len = cache.k.shape[2]
    # With a ring (windowed) cache the write slot wraps around.
    slot = pos % cache_len if cfg.sliding_window else pos
    for i, layer in enumerate(common.unstack(params["layers"], cfg.n_layers)):
        a, _ = attn_mod.attention_block(
            layer["attn"], cfg, common.apply_norm(cfg.norm, layer["attn_norm"], h),
            cache=attn_mod.KVCache(cache.k[i], cache.v[i]), cache_pos=pos, write_slot=slot,
        )
        h = h + a
        h = h + common.mlp(layer["mlp"], cfg.mlp,
                           common.apply_norm(cfg.norm, layer["mlp_norm"], h))
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    w = None if cfg.tie_embeddings else params["lm_head"]
    return common.logits_from_hidden(h, params["embed"], w), cache
