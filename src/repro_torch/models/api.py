"""ModelBundle — one interface over the LM families the port serves.

Counterpart of ``repro/models/api.py`` for the families ported so far
(``dense``, ``ssm``, ``hybrid``).  Per family it wires up:

    init(seed, dtype=torch.float32, *, device=None) -> params
    forward(params, tokens)      -> hidden states [B, S, d]
    prefill(params, batch)       -> last-token logits [B, 1, V]

``seed`` is an int (a ``torch.Generator`` on ``device`` is seeded with it)
or a ``torch.Generator``, whose device the parameters then take.
``device=None`` means the CUDA card and raises without one (see
``repro_torch.device``); pass ``device="cpu"`` for the host.  ``tokens``
(and ``batch["tokens"]``) are [B, S] integers, numpy or torch; they move
to the parameters' device.  ``forward`` and ``prefill`` run under
``torch.inference_mode()``.  The reference's bundle has no ``forward``: its
callers reach the family module directly; the port's DAEF head takes the
bundle's.

``loss``, ``init_cache`` and ``decode`` raise ``NotImplementedError`` until
the training and decode slices; so does :func:`get_bundle` for the families
not ported yet (``vlm``, ``moe``, ``encdec``), naming the ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2, rglru, transformer

_MODULES = {"dense": transformer, "ssm": mamba2, "hybrid": rglru}
_NOT_YET = {
    "vlm": "the VLM (ROADMAP queue A item 14, other families)",
    "moe": "the MoE families (ROADMAP queue A item 14, other families)",
    "encdec": "the encoder-decoder (ROADMAP queue A item 14, other families)",
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., torch.Tensor]
    prefill: Callable[..., torch.Tensor]
    loss: Callable[..., torch.Tensor]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]


def _waits(what: str) -> Callable[..., Any]:
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP queue A item 14)")
    return fn


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"]["table"].device
    return torch.as_tensor(tokens, device=dev).long()


def _generator(seed, device=None) -> torch.Generator:
    """``seed`` itself if it is a generator, else a new one on ``device``
    (``None``: the card) seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def get_bundle(cfg: ArchConfig) -> ModelBundle:
    fam = cfg.family
    if fam in _NOT_YET:
        raise NotImplementedError(f"{_NOT_YET[fam]} is not ported yet")
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]

    def init(seed, dtype=torch.float32, *, device=None):
        with torch.no_grad():
            return mod.init_params(_generator(seed, device), cfg, dtype)

    @torch.inference_mode()
    def forward(params, tokens):
        return mod.forward(params, cfg, _tokens(params, tokens))

    @torch.inference_mode()
    def prefill(params, batch):
        h = mod.forward(params, cfg, _tokens(params, batch["tokens"]))
        w = transformer.lm_head(params, cfg) if fam == "dense" else params["embed"]["table"].T
        return h[:, -1:] @ w

    return ModelBundle(
        cfg=cfg, init=init, forward=forward, prefill=prefill,
        loss=_waits("lm_loss (the training slice, with the B8 backward)"),
        init_cache=_waits("init_cache (the decode slice)"),
        decode=_waits("decode (the decode slice)"),
    )
