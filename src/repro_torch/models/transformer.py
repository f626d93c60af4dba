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

Under a mesh (``hints.use_mesh``) ``forward`` and ``lm_loss`` take this
rank's slices of the parameters (``launch/shardings.py``) and this rank's
rows of the batch: the embedding, attention, MLP and loss run the
Megatron layout (``models/common.py``, ``models/attention.py``).  A layer
leaf whose spec names ``data`` (FSDP) is gathered over ``data`` inside the
rematerialised layer, so the gathered copy is freed after the layer and
gathered again in the backward; its gradient is the sum over ``data`` in
rank order, then this rank's slice (``hints.all_gather``'s backward).  A
leaf sharded over ``data`` on the layer axis itself is gathered once before
the loop; ``lm_head`` is gathered before the loss.

What the port leaves out: ``chunked_attn`` (the attention always streams
through the B7/B8 kernels).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hints

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


def layer_fwd(layer: Params, cfg: ArchConfig, h: torch.Tensor, window,
              fsdp: Params | None = None) -> torch.Tensor:
    """One layer; ``fsdp`` (the layer leaves' specs under a mesh) names the
    leaves to gather over ``data`` first."""
    if fsdp is not None:
        layer = hints.gather_data(layer, fsdp, hints.active_mesh(), slice(1, None), shift=1)
    a, _ = attn_mod.attention_block(
        layer["attn"], cfg, common.apply_norm(cfg.norm, layer["attn_norm"], h),
        window=window,
    )
    h = h + a
    return h + common.mlp(layer["mlp"], cfg.mlp,
                          common.apply_norm(cfg.norm, layer["mlp_norm"], h), d_ff=cfg.d_ff)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None, window: int | None = None,
            remat: bool = True) -> torch.Tensor:
    """Hidden states [B, P + S, d] for training or prefill; ``tokens`` [B, S]
    on the parameters' device.  ``prefix_embeds`` [B, P, d] (the VLM's
    projected patches), cast to the embeddings' dtype, go before the token
    embeddings, and positions run over prefix and text."""
    mesh, specs = common.mesh_specs(cfg)
    fsdp = None if specs is None else specs["layers"]
    h = common.embed(params["embed"], tokens, vocab=cfg.vocab_size)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    win = window if window is not None else cfg.sliding_window
    remat = remat and torch.is_grad_enabled()
    # a leaf split over data on the layer axis itself is gathered once, here
    stack = hints.gather_data(params["layers"], fsdp, mesh, slice(0, 1))
    for layer in common.unstack(stack, cfg.n_layers):
        if remat:
            h = hints.remat(layer_fwd, layer, cfg, h, win, fsdp)
        else:
            h = layer_fwd(layer, cfg, h, win, fsdp)
    return common.apply_norm(cfg.norm, params["final_norm"], h)


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            prefix_embeds: torch.Tensor | None = None,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S];
    ``prefix_embeds`` [B, P, d] go before the text and carry no loss."""
    h = forward(params, cfg, tokens, prefix_embeds=prefix_embeds)
    n_prefix = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    return next_token_xent(params, cfg, h[:, n_prefix:], tokens, loss_chunk)


def next_token_xent(params: Params, cfg: ArchConfig, h: torch.Tensor, tokens: torch.Tensor,
                    loss_chunk: int = 1024) -> torch.Tensor:
    """The mean cross-entropy of ``tokens[:, 1:]`` from hidden states ``h``
    [B, S, d] through the family's head (:func:`logits`'s): every family's
    loss."""
    h_in, labels = h[:, :-1], tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    return common.chunked_softmax_xent(h_in, labels, mask, _head(params, cfg),
                                       chunk=min(loss_chunk, h_in.shape[1]),
                                       transpose=cfg.tie_embeddings, vocab=cfg.vocab_size)


def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """The LM head's weight: the tied table [V, d], or ``lm_head`` [d, V]
    gathered over ``data`` where FSDP splits it."""
    if cfg.tie_embeddings:
        return params["embed"]["table"]
    mesh, specs = common.mesh_specs(cfg)
    return hints.gather_data(params["lm_head"], None if specs is None else specs["lm_head"],
                             mesh, slice(None))


def logits(params: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits [B, S, V] of hidden states (under a mesh, over the whole
    vocab on every rank), through the tied table or ``lm_head``: every
    family's head."""
    w = _head(params, cfg)
    return common.logits_from_hidden(h, {"table": w} if cfg.tie_embeddings else None,
                                     None if cfg.tie_embeddings else w, vocab=cfg.vocab_size)


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
