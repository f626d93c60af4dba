"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU recurrent
blocks and local attention in a (rec, rec, attn) pattern — init and prefill.

Counterpart of ``repro/models/rglru.py``'s ``_pattern``, ``_layout``,
``rg_lru``, ``init_rec_block``, ``init_attn_block``, ``_rec_fwd`` (the
training / prefill branch), ``_attn_fwd`` (window = ``local_window``),
``init_params`` and ``forward``.  Whole periods are stacked on a leading
[n_periods] axis, with the remainder layers (38 = 12·3 + 2) in ``tail``, as
the reference lays them out.

The recurrence of :func:`_rec_fwd` goes through the B9 wrapper
(``kernels.rglru_scan``): the hand-written kernel on a CUDA tensor, the
plain sequential scan on a CPU tensor.  :func:`rg_lru` keeps the reference's
signature and is that plain version (the reference evaluates the same
recurrence with ``lax.associative_scan``).  The local attention goes through
B7 with its window.

What the port leaves out: ``remat`` and ``chunked_attn`` (no forward-only
meaning; the attention always streams through B7), the sharding hint on the
width (mesh-only, ROADMAP queue A item 12), ``lm_loss`` (B9 has no
backward: ROADMAP queue A item 16), ``rg_lru_step``, ``RecState``, the
decode branch of ``_rec_fwd``, ``RGCache``, ``init_cache`` and
``decode_step`` (the decode slice).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import common

Params = dict[str, Any]


def _pattern(cfg: ArchConfig) -> tuple[str, ...]:
    return cfg.block_pattern or ("rec", "rec", "attn")


def _layout(cfg: ArchConfig) -> tuple[int, tuple[str, ...]]:
    pat = _pattern(cfg)
    n_periods, rem = divmod(cfg.n_layers, len(pat))
    return n_periods, pat[:rem]


def rg_lru(x, r, i, lam, h0=None):
    """x, r, i [B, S, W]; lam [W] -> (y [B, S, W], h_last [B, W]): the plain
    sequential recurrence."""
    return rglru_scan_ref(x, r, i, lam, h0)


def init_rec_block(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    d, dev = cfg.d_model, gen.device
    w = cfg.lru_width or d
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": common.init_rmsnorm(d, dtype, lead=lead, device=dev),
        "w_x": common.dense_init(gen, (d, w), dtype, lead=lead),
        "w_gate": common.dense_init(gen, (d, w), dtype, lead=lead),
        "conv_w": common.dense_init(gen, (cfg.conv_width, w), dtype, scale=0.5, lead=lead),
        "conv_b": torch.zeros((*lead, w), dtype=dtype, device=dev),
        "w_r": common.dense_init(gen, (w, w), dtype, lead=lead),
        "b_r": torch.zeros((*lead, w), **f32),
        "w_i": common.dense_init(gen, (w, w), dtype, lead=lead),
        "b_i": torch.zeros((*lead, w), **f32),
        "lam": torch.full((*lead, w), 4.0, **f32),  # sigmoid(4) ~ .98: slow decay
        "w_out": common.dense_init(gen, (w, d), dtype, lead=lead),
        "mlp_norm": common.init_rmsnorm(d, dtype, lead=lead, device=dev),
        "mlp": common.init_mlp(gen, cfg.mlp, d, cfg.d_ff, dtype, lead=lead),
    }


def init_attn_block(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    dev = gen.device
    return {
        "norm": common.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=dev),
        "attn": attn_mod.init_attention(gen, cfg, dtype, lead=lead),
        "mlp_norm": common.init_rmsnorm(cfg.d_model, dtype, lead=lead, device=dev),
        "mlp": common.init_mlp(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dtype, lead=lead),
    }


def _init_block(kind: str, gen, cfg, dtype, lead=()) -> Params:
    init = init_rec_block if kind == "rec" else init_attn_block
    return init(gen, cfg, dtype, lead=lead)


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device: ``periods`` stacked on
    [n_periods], ``tail`` a list of blocks."""
    n_periods, tail = _layout(cfg)
    return {
        "embed": common.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "periods": {f"b{i}": _init_block(kind, gen, cfg, dtype, (n_periods,))
                    for i, kind in enumerate(_pattern(cfg))},
        "final_norm": common.init_rmsnorm(cfg.d_model, dtype, device=gen.device),
        "tail": [_init_block(kind, gen, cfg, dtype) for kind in tail],
    }


def _rec_fwd(blk: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Recurrent block, prefill."""
    xin = common.rmsnorm(blk["norm"], h)
    x = xin @ blk["w_x"]
    gate = common.gelu(xin @ blk["w_gate"])
    width, s = blk["conv_w"].shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    x = sum(pad[:, i:i + s, :] * blk["conv_w"][i][None, None] for i in range(width)) \
        + blk["conv_b"]
    r = torch.sigmoid(x @ blk["w_r"] + blk["b_r"])
    i = torch.sigmoid(x @ blk["w_i"] + blk["b_i"])
    y, _ = rglru_scan(x, r, i, blk["lam"])  # widened to float32 in the kernel or on the host
    y = y.to(h.dtype) * gate
    out = h + y @ blk["w_out"]
    return out + common.mlp(blk["mlp"], cfg.mlp, common.rmsnorm(blk["mlp_norm"], out))


def _attn_fwd(blk: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """Local-attention block, prefill (window = ``cfg.local_window``)."""
    a, _ = attn_mod.attention_block(blk["attn"], cfg, common.rmsnorm(blk["norm"], h),
                                    window=cfg.local_window)
    h = h + a
    return h + common.mlp(blk["mlp"], cfg.mlp, common.rmsnorm(blk["mlp_norm"], h))


def _block_fwd(kind: str, blk: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return _rec_fwd(blk, cfg, h) if kind == "rec" else _attn_fwd(blk, cfg, h)


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, S, d] for prefill."""
    pat = _pattern(cfg)
    n_periods, tail = _layout(cfg)
    table = params["embed"]["table"]
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)).to(table.dtype)
    h = common.embed(params["embed"], tokens) * scale.to(table.device)
    for p in range(n_periods):
        period = common.layer(params["periods"], p)
        for i, kind in enumerate(pat):
            h = _block_fwd(kind, period[f"b{i}"], cfg, h)
    for blk, kind in zip(params["tail"], tail, strict=True):
        h = _block_fwd(kind, blk, cfg, h)
    return common.rmsnorm(params["final_norm"], h)
