"""Mixture-of-Experts FFN with capacity-based (GShard-style) dispatch.

Counterpart of ``repro/models/moe.py``: qwen2-moe-a2.7b (shared + routed
top-4) and deepseek-v2-236b (2 shared + 160 routed top-6, with MLA from
``models/mla.py``).  Tokens are routed as the reference routes them, by a
capacity-bounded one-hot dispatch: a float32 router, softmax -> top-k ->
renormalise, queue positions by a ``cumsum`` of the one-hot choices in
token-major order, tokens past an expert's capacity dropped, then the
dispatch and combine tensors [B·G, gs, E, C] and four einsums (plain
matmuls, which the reference also leaves to XLA: no Pallas kernel).  A
gather/scatter dispatch is later speed work.

Ties.  ``jax.lax.top_k`` puts the lower expert index first among equal
probabilities; ``torch.topk`` promises no order for ties.  :func:`route`
takes the top k of a stable descending sort instead, which keeps the lower
index first, so equal inputs make the reference's choices, ties included.
(Probabilities that differ in their last bits between the two packages'
softmaxes may still order two nearly equal experts otherwise: the tests
compare dispatch masks bit for bit on random router inputs.)

Under a mesh (``hints.use_mesh``) with a ``model`` axis, :func:`moe_ffn`
takes this rank's slices of the expert stacks (``launch/shardings.py``):

* expert-parallel, when E divides the model extent (the rules split the
  expert axis): the float32 router is whole on every rank, so every rank
  routes alike and takes its experts' columns of dispatch and combine
  (``hints.take_shard``, whose backward gathers the combine's gradient
  whole); the expert einsums run on its E / ext experts, the input enters
  through ``hints.copy`` and the combine's sum over E is a ``hints.psum``;
* tensor-parallel inside each expert, when E does not divide but the
  expert width does (the rules split ``w_gate`` / ``w_up`` on their last
  dim and ``w_down`` on its rows): every expert on every rank, this rank's
  columns of each; the combine enters through ``hints.copy`` (its
  gradient is partial on each rank) and the output is summed;
* otherwise the experts are whole and every rank computes the FFN alike.

The aux loss comes from the routing every rank computes alike: it is
counted once, never summed over ``model``.  The shared experts are
``common.mlp`` at their full width, with its own layout.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, hints

Params = dict[str, Any]

GROUP_SIZE = 256  # tokens per capacity group: keeps the dispatch memory O(S)


def capacity(seq: int, top_k: int, n_experts: int, factor: float) -> int:
    return max(1, int(seq * top_k * factor / n_experts + 0.5))


def init_moe_ffn(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    """The float32 router [d, E], the experts' SwiGLU stacks [E, ...] and,
    with shared experts, one SwiGLU of width ``n_shared_experts * d_ff_expert``."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    p: Params = {
        "router": common.dense_init(gen, (d, e), torch.float32, scale=0.02, lead=lead),
        "experts": {
            "w_gate": common.dense_init(gen, (e, d, f), dtype, lead=lead),
            "w_up": common.dense_init(gen, (e, d, f), dtype, lead=lead),
            "w_down": common.dense_init(gen, (e, f, d), dtype, lead=lead),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = common.init_mlp(gen, "swiglu", d, cfg.n_shared_experts * f, dtype,
                                      lead=lead)
    return p


def route(logits: torch.Tensor, top_k: int, cap: int):
    """Token -> expert-slot assignment.

    logits [B, S, E] -> (dispatch [B, S, E, C] float32 0/1, combine [B, S, E,
    C] float32 weights, the Switch load-balance aux loss, a float32 scalar).
    Each sequence is one capacity group; tokens past an expert's capacity
    are dropped.
    """
    b, s, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :top_k], top_i[..., :top_k]                 # [B,S,K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(top_i, e).float()                                 # [B,S,K,E]
    flat = onehot.reshape(b, s * top_k, e)                               # token-major
    pos = torch.cumsum(flat, dim=1) - flat                               # queue position
    keep = (pos < cap) * flat                                            # [B,SK,E]
    # jax.nn.one_hot: a position past the capacity has no slot
    slot = (pos.long()[..., None] == torch.arange(cap, device=logits.device)).float()
    disp = (keep[..., None] * slot).reshape(b, s, top_k, e, cap)
    dispatch = disp.sum(dim=2)                                           # [B,S,E,C]
    combine = (disp * top_p[..., None, None]).sum(dim=2)

    frac_tokens = onehot.sum(dim=2).mean(dim=1)                          # [B,E]
    frac_probs = probs.mean(dim=1)                                       # [B,E]
    aux = e * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return dispatch, combine, aux


def moe_ffn(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """x [B, S, d] -> (y [B, S, d], aux loss).

    Tokens are grouped in blocks of ``GROUP_SIZE`` (the largest divisor of
    S up to it) for the capacity accounting, so the dispatch and combine
    tensors are [B·G, gs, E, C_g] with C_g = gs·top_k·cf / E: linear in S.
    """
    b, s, d = x.shape
    gs = s if s < GROUP_SIZE else GROUP_SIZE
    while s % gs:
        gs -= 1
    xg = x.reshape(b * (s // gs), gs, d)

    cap = capacity(gs, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    logits = xg.float() @ p["router"]
    dispatch, combine, aux = route(logits, cfg.top_k, cap)

    ex = p["experts"]
    mesh = hints.active_mesh()
    split_e = mesh is not None and ex["w_gate"].shape[-3] != cfg.n_experts
    split_f = (mesh is not None and not split_e
               and ex["w_down"].shape[-2] != cfg.d_ff_expert)
    x_exp = xg
    if split_e:      # this rank's experts
        x_exp = hints.copy(xg, mesh)
        dispatch = hints.take_shard(dispatch, mesh, 2)
        combine = hints.take_shard(combine, mesh, 2)
    elif split_f:    # this rank's columns of every expert
        x_exp = hints.copy(xg, mesh)
        combine = hints.copy(combine, mesh)

    xin = torch.einsum("bsec,bsd->becd", dispatch.to(x.dtype), x_exp)  # [BG,E,C,d]
    gate = F.silu(torch.einsum("becd,edf->becf", xin, ex["w_gate"]))
    up = torch.einsum("becd,edf->becf", xin, ex["w_up"])
    out = torch.einsum("becf,efd->becd", gate * up, ex["w_down"])      # [BG,E,C,d]
    y = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), out)
    if split_e or split_f:
        y = hints.psum(y, mesh)
    y = y.reshape(b, s, d)

    if "shared" in p:
        y = y + common.mlp(p["shared"], "swiglu", x,
                           d_ff=cfg.n_shared_experts * cfg.d_ff_expert)
    return y, aux
