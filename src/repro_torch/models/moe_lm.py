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

What the port leaves out: ``chunked_attn`` (the attention always streams
through B7), and the sequence-sharding hint ``seq_shard`` /
``$REPRO_SEQ_SHARD`` of the family's layout on a mesh, which waits (ROADMAP
queue A item 12; the dense family's layout is ported).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, mla, moe

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
        return common.mlp(layer["mlp"], "swiglu", x), None
    return moe.moe_ffn(layer["moe"], cfg, x)


def _stacks(params: Params, cfg: ArchConfig) -> list[tuple[str, list[Params]]]:
    """The dense-prefix layers, then the MoE layers, as views per layer."""
    n_dense = cfg.first_dense_layers
    out = []
    if "dense_layers" in params:
        out.append(("dense", common.unstack(params["dense_layers"], n_dense)))
    if "moe_layers" in params:
        out.append(("moe", common.unstack(params["moe_layers"], cfg.n_layers - n_dense)))
    return out


def _layer_fwd(layer: Params, cfg: ArchConfig, h: torch.Tensor):
    h = h + _attn(layer, cfg, h)[0]
    y, aux = _ffn(layer, cfg, h)
    return h + y, aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor):
    """(hidden [B, S, d], aux loss) for training or prefill; ``tokens``
    [B, S] on the parameters' device.  The aux loss is the float32 sum of
    the MoE layers'."""
    h = common.embed(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for _, layers in _stacks(params, cfg):
        for layer in layers:
            if torch.is_grad_enabled():
                # the layers draw no random numbers: no RNG state to replay
                h, aux_l = checkpoint(_layer_fwd, layer, cfg, h, use_reentrant=False,
                                      preserve_rng_state=False)
            else:
                h, aux_l = _layer_fwd(layer, cfg, h)
            if aux_l is not None:
                aux = aux + aux_l
    return common.apply_norm(cfg.norm, params["final_norm"], h), aux


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` [B, S] plus ``router_aux_coef``
    times the aux loss (float32 scalar)."""
    h, aux = forward(params, cfg, tokens)
    h_in, labels = h[:, :-1], tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    w = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    xent = common.chunked_softmax_xent(h_in, labels, mask, w,
                                       chunk=min(loss_chunk, h_in.shape[1]),
                                       transpose=cfg.tie_embeddings)
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
    for kind, layers in _stacks(params, cfg):
        stack = getattr(caches, kind)
        for i, layer in enumerate(layers):
            layer_cache = type(stack)(*(t[i] for t in stack))
            h = h + _attn(layer, cfg, h, cache=layer_cache, cache_pos=pos, write_slot=slot)[0]
            h = h + _ffn(layer, cfg, h)[0]
    h = common.apply_norm(cfg.norm, params["final_norm"], h)
    w = None if cfg.tie_embeddings else params["lm_head"]
    return common.logits_from_hidden(h, params["embed"], w), caches
