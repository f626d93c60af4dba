"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU recurrent
blocks and local attention in a (rec, rec, attn) pattern — init, prefill and
decode.

Counterpart of ``repro/models/rglru.py``'s ``_pattern``, ``_layout``,
``rg_lru``, ``rg_lru_step``, ``init_rec_block``, ``init_attn_block``,
``RecState``, ``_rec_fwd`` and ``_attn_fwd`` (prefill and decode),
``init_params``, ``forward``, ``lm_loss``, ``RGCache``, ``init_cache`` and
``decode_step``.  Whole periods are stacked on a leading [n_periods] axis,
with the remainder layers (38 = 12·3 + 2) in ``tail``, as the reference
lays them out; so is the decode cache (a stacked state per period slot
``b{i}``, the tail's one by one).

The prefill recurrence of :func:`_rec_fwd` goes through the B9 wrapper
(``kernels.rglru_scan``): the hand-written kernel on a CUDA tensor, the
plain sequential scan on a CPU tensor.  :func:`rg_lru` keeps the reference's
signature and is that plain version (the reference evaluates the same
recurrence with ``lax.associative_scan``).  The local attention goes through
B7 with its window.  Under grad the scan goes through B9's autograd
Function (the hand-written backward kernel on the card, the plain backward
on the host) and the attention through B7/B8's, and :func:`forward`
checkpoints every period (``torch.utils.checkpoint``) as the reference
wraps its period body in ``jax.checkpoint``; the tail is not checkpointed,
as in the reference.  Decode is the reference's O(1) update in plain PyTorch
(:func:`rg_lru_step`, a ring KV cache of ``local_window`` slots written at
``pos % local_window``), every state updated in place by
:func:`decode_step`.

Under a mesh (``hints.use_mesh``) ``forward`` and ``lm_loss`` take this
rank's slices of the parameters (``launch/shardings.py``) and its rows of
the batch.  The reference's hint splits the RG-LRU width over ``model``:
``w_x`` and ``w_gate`` are column-parallel, so each rank holds its lanes of
x and of the gate, and slices the whole ``conv_w``, ``conv_b`` and
``lam`` to them (``hints.take_shard``).  ``w_r`` and ``w_i`` are
row-parallel on their [w, w] leaves: the gate pre-activations are a
``hints.psum`` of the rank's rows plus the whole ``b_r`` / ``b_i``, of
which it keeps its lanes for B9.
``w_out`` is row-parallel, followed by a ``hints.psum``; the MLPs are
``common.mlp``'s and the MQA blocks ``attention.attention_block``'s
layouts.  A leaf split over ``data`` (FSDP) is gathered inside the
rematerialised period (the tail's blocks before each block).  Decode
keeps its one-device path.

What the port leaves out: ``remat`` and ``chunked_attn`` as keywords (the
periods are checkpointed whenever grad is on; the attention always streams
through B7).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hints, transformer

Params = dict[str, Any]

_C = 8.0  # RG-LRU gate exponent constant (Griffin §2.4)


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


def rg_lru_step(x, r, i, lam, h_prev):
    """One-token update; all inputs [B, W] (lam [W])."""
    log_a = -_C * r * common.softplus(-lam)[None, :]
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return a * h_prev + mult * (i * x)


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


class RecState(NamedTuple):
    lru: torch.Tensor    # [B, W] (float32)
    conv: torch.Tensor   # [B, conv_width-1, W]


def _rec_fwd(blk: Params, cfg: ArchConfig, h: torch.Tensor, state: RecState | None = None):
    """Recurrent block: prefill (``state=None``) -> (out, None), or decode of
    one token -> (out, state updated in place)."""
    xin = common.rmsnorm(blk["norm"], h)
    mesh = hints.active_mesh()
    lanes = mesh is not None and state is None and blk["w_x"].shape[-1] != blk["lam"].shape[-1]
    if lanes:  # this rank's lanes of the width
        xin = hints.copy(xin, mesh)
        blk = {**blk, **{k: hints.take_shard(blk[k], mesh, -1)
                         for k in ("conv_w", "conv_b", "lam")}}
    x = xin @ blk["w_x"]
    gate = common.gelu(xin @ blk["w_gate"])
    if state is None:
        width, s = blk["conv_w"].shape[0], x.shape[1]
        pad = F.pad(x, (0, 0, width - 1, 0))
        x = sum(pad[:, i:i + s, :] * blk["conv_w"][i][None, None] for i in range(width)) \
            + blk["conv_b"]
        r = torch.sigmoid(_gate_pre(x, blk["w_r"], blk["b_r"], mesh if lanes else None))
        i = torch.sigmoid(_gate_pre(x, blk["w_i"], blk["b_i"], mesh if lanes else None))
        y, _ = rglru_scan(x, r, i, blk["lam"])  # widened to float32 in the kernel or on the host
        y = y.to(h.dtype) * gate
        out = y @ blk["w_out"]
        out = h + (hints.psum(out, mesh) if lanes else out)
    else:
        window = torch.cat([state.conv, x], dim=1)                     # [B,W,w]
        x1 = torch.einsum("bwc,wc->bc", window, blk["conv_w"]) + blk["conv_b"]
        r = torch.sigmoid(x1 @ blk["w_r"] + blk["b_r"])
        i = torch.sigmoid(x1 @ blk["w_i"] + blk["b_i"])
        h_new = rg_lru_step(x1.float(), r.float(), i.float(), blk["lam"], state.lru)
        y = (h_new.to(h.dtype) * gate[:, 0])[:, None]
        out = h + y @ blk["w_out"]
        state.lru.copy_(h_new)
        state.conv.copy_(window[:, 1:])
    out = out + common.mlp(blk["mlp"], cfg.mlp, common.rmsnorm(blk["mlp_norm"], out),
                           d_ff=cfg.d_ff)
    return out, state


def _gate_pre(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, mesh) -> torch.Tensor:
    """``x @ w + bias``; under ``mesh`` x holds this rank's lanes and ``w``
    its rows: the sum over ``model`` of the rows' products, plus the whole
    bias, then this rank's lanes."""
    if mesh is None:
        return x @ w + bias
    return hints.take_shard(hints.psum(x @ w, mesh) + bias, mesh, -1)


def _attn_fwd(blk: Params, cfg: ArchConfig, h: torch.Tensor, *,
              cache: attn_mod.KVCache | None = None, pos=None, slot=None):
    """Local-attention block: prefill (window = ``cfg.local_window``) ->
    (out, (k, v)), or decode against the ring ``cache`` -> (out, cache)."""
    a, new_cache = attn_mod.attention_block(
        blk["attn"], cfg, common.rmsnorm(blk["norm"], h),
        window=cfg.local_window if cache is None else None,
        cache=cache, cache_pos=pos, write_slot=slot,
    )
    h = h + a
    h = h + common.mlp(blk["mlp"], cfg.mlp, common.rmsnorm(blk["mlp_norm"], h), d_ff=cfg.d_ff)
    return h, new_cache


def _block_fwd(kind: str, blk: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    out, _ = _rec_fwd(blk, cfg, h) if kind == "rec" else _attn_fwd(blk, cfg, h)
    return out


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding scaled by sqrt(d_model), rounded to the table's dtype."""
    table = params["embed"]["table"]
    scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32)).to(table.dtype)
    return common.embed(params["embed"], tokens, vocab=cfg.vocab_size) * scale.to(table.device)


def _period_fwd(period: Params, cfg: ArchConfig, h: torch.Tensor,
                fsdp: Params | None = None) -> torch.Tensor:
    """One period; ``fsdp`` (its leaves' specs under a mesh) names the
    leaves to gather over ``data`` first."""
    if fsdp is not None:
        period = hints.gather_data(period, fsdp, hints.active_mesh(), slice(1, None), shift=1)
    for i, kind in enumerate(_pattern(cfg)):
        h = _block_fwd(kind, period[f"b{i}"], cfg, h)
    return h


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, S, d] for training or prefill; every period
    checkpointed when grad is on."""
    n_periods, tail = _layout(cfg)
    mesh, specs = common.mesh_specs(cfg)
    fsdp = None if specs is None else specs["periods"]
    h = _embed(params, cfg, tokens)
    remat = torch.is_grad_enabled()
    stack = hints.gather_data(params["periods"], fsdp, mesh, slice(0, 1))
    for period in common.unstack(stack, n_periods):
        if remat:
            h = hints.remat(_period_fwd, period, cfg, h, fsdp)
        else:
            h = _period_fwd(period, cfg, h, fsdp)
    tail_blocks = hints.gather_data(params["tail"], None if specs is None else specs["tail"],
                                    mesh, slice(None))
    for blk, kind in zip(tail_blocks, tail, strict=True):
        h = _block_fwd(kind, blk, cfg, h)
    return common.rmsnorm(params["final_norm"], h)


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S] on the
    parameters' device, the LM head tied to the embedding."""
    return transformer.next_token_xent(params, cfg, forward(params, cfg, tokens), tokens,
                                       loss_chunk)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

class RGCache(NamedTuple):
    period_rec: Any     # {bi: RecState stacked [n_periods, ...]} per rec slot
    period_attn: Any    # {bi: KVCache stacked [n_periods, ...]} per attn slot
    tail: tuple         # per tail block: RecState | KVCache


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, *, device=None) -> RGCache:
    """Zero state on ``device`` (``None``: the card; the parameters' device
    is the one to pass): per rec block an RG-LRU state (float32) and a conv
    tail, per attention block a ring KV cache of ``local_window`` slots."""
    del seq_len
    pat = _pattern(cfg)
    n_periods, tail = _layout(cfg)
    w = cfg.lru_width or cfg.d_model
    dev = resolve_device(device)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    def rec_state(lead=()):
        return RecState(lru=zeros((*lead, batch, w), torch.float32),
                        conv=zeros((*lead, batch, cfg.conv_width - 1, w), dtype))

    def kv_cache(lead=()):
        shape = (*lead, batch, cfg.local_window, cfg.n_kv_heads, cfg.head_dim)
        return attn_mod.KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype))

    return RGCache(
        period_rec={f"b{i}": rec_state((n_periods,)) for i, k in enumerate(pat) if k == "rec"},
        period_attn={f"b{i}": kv_cache((n_periods,)) for i, k in enumerate(pat) if k == "attn"},
        tail=tuple(rec_state() if k == "rec" else kv_cache() for k in tail),
    )


def decode_step(params: Params, cfg: ArchConfig, cache: RGCache, token: torch.Tensor,
                pos) -> tuple[torch.Tensor, RGCache]:
    """One decoding step: ``token`` [B, 1] at position ``pos`` (an int or a
    0-d integer tensor) -> (logits [B, 1, V], the cache updated in place)."""
    pat = _pattern(cfg)
    n_periods, tail = _layout(cfg)
    h = _embed(params, cfg, token)
    slot = pos % cfg.local_window
    for p in range(n_periods):
        period = common.layer(params["periods"], p)
        for i, kind in enumerate(pat):
            key = f"b{i}"
            if kind == "rec":
                st = cache.period_rec[key]
                h, _ = _rec_fwd(period[key], cfg, h, state=RecState(st.lru[p], st.conv[p]))
            else:
                kv = cache.period_attn[key]
                h, _ = _attn_fwd(period[key], cfg, h, cache=attn_mod.KVCache(kv.k[p], kv.v[p]),
                                 pos=pos, slot=slot)
    for blk, kind, st in zip(params["tail"], tail, cache.tail, strict=True):
        if kind == "rec":
            h, _ = _rec_fwd(blk, cfg, h, state=st)
        else:
            h, _ = _attn_fwd(blk, cfg, h, cache=st, pos=pos, slot=slot)
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(h, params["embed"], None), cache
