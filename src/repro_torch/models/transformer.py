"""Dense decoder-only transformer (llama lineage): init and prefill forward.

Counterpart of ``repro/models/transformer.py``'s ``init_params`` and
``forward`` (qwen3-1.7b, qwen2-1.5b, mistral-nemo-12b, granite-20b).  Layer
parameters are stacked on a leading [L] axis, as the reference stacks them;
the reference's ``lax.scan`` over that axis is a Python loop over layer views.

What the port leaves out: ``remat`` (``jax.checkpoint`` has no meaning for a
forward-only pass) and ``chunked_attn`` (the attention always streams
through the B7 kernel); ``prefix_embeds`` (the VLM, ROADMAP queue A item 14);
``lm_loss`` (the training slice), ``init_cache`` and ``decode_step`` (the
decode slice).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
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
            window: int | None = None) -> torch.Tensor:
    """Hidden states [B, S, d] for prefill; ``tokens`` [B, S] on the
    parameters' device."""
    h = common.embed(params["embed"], tokens)
    win = window if window is not None else cfg.sliding_window
    for i in range(cfg.n_layers):
        h = layer_fwd(common.layer(params["layers"], i), cfg, h, win)
    return common.apply_norm(cfg.norm, params["final_norm"], h)


def lm_head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """The output matrix [d, V]: the tied embedding's transpose or lm_head."""
    return params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]
