"""MoE language models: qwen2-moe (GQA attention) and deepseek-v2 (MLA).

Counterpart of ``repro/models/moe_lm.py``'s ``MoECaches``, ``init_params``,
``forward``, ``init_cache`` and ``decode_step``.  The skeleton of
``models/transformer.py``, with:

* the MoE FFN of ``models/moe.py``, its router aux loss summed over the
  layers (``forward`` returns it beside the hidden states);
* ``first_dense_layers`` whose FFN is a dense SwiGLU of width
  ``d_ff_dense`` (deepseek-v2's layer 0), stacked apart as
  ``dense_layers`` [L_dense, ...] before ``moe_layers`` [L - L_dense, ...];
* MLA attention (``models/mla.py``) and its latent cache when ``cfg.mla``.

Layer parameters are stacked on a leading axis, as the reference stacks
them; the reference's ``lax.scan`` over each stack is a Python loop over
``common.unstack``.  Prefill attention is B7 (GQA at equal head sizes, MLA
at (nope + rope, v_head_dim)); decode is plain PyTorch and updates the
caches in place (``attention.update_cache``'s rule), a sliding-window model
writing ring slot ``pos % cache_len``.

:func:`lm_loss` is the cross-entropy plus ``router_aux_coef`` times the
router's aux loss summed over the MoE layers; its backward goes through B8
(at MLA's (192, 128) for deepseek-v2).  Every layer is checkpointed
(``torch.utils.checkpoint``) when grad mode is on, as the reference wraps
each in ``jax.checkpoint`` (the routing is recomputed from the same inputs,
so it makes the same choices).

Under a mesh (``hints.use_mesh``) ``forward`` and ``lm_loss`` take this
rank's slices of the parameters (``launch/shardings.py``) and its rows of
the batch: the vocab-parallel embedding and loss of ``models/common.py``,
the attention's layout (``models/attention.py``, or ``models/mla.py``'s
heads), the expert layout of ``models/moe.py`` and the dense SwiGLU of the
first layers and the shared experts column- then row-parallel
(``common.mlp``).  A layer leaf the rules split over ``data`` (FSDP) is
gathered inside the rematerialised layer, as ``models/transformer.py``
does.

``forward``'s ``seq_shard`` keyword (the reference's default, ``None``,
reads ``$REPRO_SEQ_SHARD`` at each call) is a layout hint of the
reference's: the residual stream's sequence sharded over ``model`` between
blocks.  It moves no number, and the port takes the same route whatever
the keyword or the variable say.

What the port leaves out: ``chunked_attn`` (the attention always streams
through B7).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hints, mla, moe, transformer

Params = dict[str, Any]


class MoECaches(NamedTuple):
    """Decode caches for the dense-prefix layers and the MoE layers."""

    dense: Any   # KVCache | MLACache stacked [L_dense, ...], or None
    moe: Any     # KVCache | MLACache stacked [L_moe, ...]


def _init_layers(gen: torch.Generator, cfg: ArchConfig, dtype, n: int,
                 dense_ffn: bool) -> Params:
    lead, d, dev = (n,), cfg.d_model, gen.device
    attn = (mla.init_mla(gen, cfg, dtype, lead=lead) if cfg.mla
            else attn_mod.init_attention(gen, cfg, dtype, lead=lead))
    p: Params = {
        "attn_norm": common.init_norm(cfg.norm, d, dtype, lead=lead, device=dev),
        "attn": attn,
        "mlp_norm": common.init_norm(cfg.norm, d, dtype, lead=lead, device=dev),
    }
    if dense_ffn:
        p["mlp"] = common.init_mlp(gen, "swiglu", d, cfg.d_ff_dense or cfg.d_ff, dtype,
                                   lead=lead)
    else:
        p["moe"] = moe.init_moe_ffn(gen, cfg, dtype, lead=lead)
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device: ``moe_layers`` stacked on
    [L - first_dense_layers] and ``dense_layers`` on [first_dense_layers],
    each when there are any (a model cut to its dense layers has no MoE
    stack, whose empty leaves no gradient would reach), an untied
    ``lm_head`` unless the embeddings are tied."""
    n_dense = cfg.first_dense_layers
    params: Params = {
        "embed": common.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": common.init_norm(cfg.norm, cfg.d_model, dtype, device=gen.device),
    }
    if cfg.n_layers > n_dense:
        params["moe_layers"] = _init_layers(gen, cfg, dtype, cfg.n_layers - n_dense, False)
    if n_dense:
        params["dense_layers"] = _init_layers(gen, cfg, dtype, n_dense, True)
    if not cfg.tie_embeddings:
        params["lm_head"] = common.dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return params


def _attn(layer: Params, cfg: ArchConfig, h: torch.Tensor, **decode) -> tuple:
    x = common.apply_norm(cfg.norm, layer["attn_norm"], h)
    if cfg.mla:
        return mla.mla_block(layer["attn"], cfg, x, **decode)
    if decode:
        return attn_mod.attention_block(layer["attn"], cfg, x, **decode)
    return attn_mod.attention_block(layer["attn"], cfg, x, window=cfg.sliding_window)


def _ffn(layer: Params, cfg: ArchConfig, h: torch.Tensor):
    """(y, aux) of a dense-prefix layer's SwiGLU (aux None) or an MoE FFN."""
    x = common.apply_norm(cfg.norm, layer["mlp_norm"], h)
    if "mlp" in layer:
        return common.mlp(layer["mlp"], "swiglu", x, d_ff=cfg.d_ff_dense or cfg.d_ff), None
    return moe.moe_ffn(layer["moe"], cfg, x)


def _stacks(params: Params, cfg: ArchConfig, specs=None) -> list[tuple[str, list, Any]]:
    """The dense-prefix layers, then the MoE layers, as views per layer,
    each stack with its layer leaves' specs under a mesh (``specs``: the
    parameters'; a leaf split over ``data`` on the layer axis is gathered
    here, once)."""
    n_dense = cfg.first_dense_layers
    out = []
    for kind, key, n in (("dense", "dense_layers", n_dense),
                         ("moe", "moe_layers", cfg.n_layers - n_dense)):
        if key in params:
            fsdp = None if specs is None else specs[key]
            stack = hints.gather_data(params[key], fsdp, hints.active_mesh(), slice(0, 1))
            out.append((kind, common.unstack(stack, n), fsdp))
    return out


def _layer_fwd(layer: Params, cfg: ArchConfig, h: torch.Tensor, fsdp=None):
    if fsdp is not None:
        layer = hints.gather_data(layer, fsdp, hints.active_mesh(), slice(1, None), shift=1)
    h = h + _attn(layer, cfg, h)[0]
    y, aux = _ffn(layer, cfg, h)
    return h + y, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            seq_shard: bool | None = None):
    """(hidden [B, S, d], aux loss) for training or prefill; ``tokens``
    [B, S] on the parameters' device.  The aux loss is the float32 sum of
    the MoE layers'.  ``seq_shard`` changes nothing (module docstring)."""
    del seq_shard
    _, specs = common.mesh_specs(cfg)
    h = common.embed(params["embed"], tokens, vocab=cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, layers, fsdp in _stacks(params, cfg, specs):
        for layer in layers:
            if torch.is_grad_enabled():
                h, aux_l = hints.remat(_layer_fwd, layer, cfg, h, fsdp)
            else:
                h, aux_l = _layer_fwd(layer, cfg, h, fsdp)
            if aux_l is not None:
                aux = aux + aux_l
    return common.apply_norm(cfg.norm, params["final_norm"], h), aux


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` [B, S] plus ``router_aux_coef``
    times the aux loss (float32 scalar)."""
    h, aux = forward(params, cfg, tokens)
    xent = transformer.next_token_xent(params, cfg, h, tokens, loss_chunk)
    return xent + cfg.router_aux_coef * aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg: ArchConfig, n_layers: int, batch: int, seq: int, dtype, dev):
    s = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    if cfg.mla:
        return mla.MLACache(
            c_kv=torch.zeros((n_layers, batch, s, cfg.kv_lora_rank), dtype=dtype, device=dev),
            k_pe=torch.zeros((n_layers, batch, s, cfg.qk_rope_head_dim), dtype=dtype,
                             device=dev))
    shape = (n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim)
    return attn_mod.KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                            v=torch.zeros(shape, dtype=dtype, device=dev))


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, *,
               device=None) -> MoECaches:
    """Zero caches on ``device`` (``None``: the card): ``KVCache`` or
    ``MLACache`` stacks, ``dense=None`` without dense-prefix layers;
    sliding-window models allocate only the window."""
    dev = resolve_device(device)
    n_dense = cfg.first_dense_layers
    dense = (_init_layer_cache(cfg, n_dense, batch, seq_len, dtype, dev) if n_dense
             else None)
    return MoECaches(dense=dense, moe=_init_layer_cache(cfg, cfg.n_layers - n_dense, batch,
                                                        seq_len, dtype, dev))


def decode_step(params: Params, cfg: ArchConfig, caches: MoECaches, token: torch.Tensor,
                pos) -> tuple[torch.Tensor, MoECaches]:
    """One decoding step: ``token`` [B, 1] at position ``pos`` (an int or a
    0-d integer tensor) -> (logits [B, 1, V], the caches updated in place)."""
    h = common.embed(params["embed"], token)
    cache_len = caches.moe[0].shape[2]
    slot = pos % cache_len if cfg.sliding_window else pos
    for kind, layers, _ in _stacks(params, cfg):
        stack = getattr(caches, kind)
        for i, layer in enumerate(layers):
            layer_cache = type(stack)(*(t[i] for t in stack))
            h = h + _attn(layer, cfg, h, cache=layer_cache, cache_pos=pos, write_slot=slot)[0]
            h = h + _ffn(layer, cfg, h)[0]
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    w = None if cfg.tie_embeddings else params["lm_head"]
    return common.logits_from_hidden(h, params["embed"], w), caches
