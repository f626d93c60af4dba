"""ModelBundle — one interface over the LM families the port serves and trains.

Counterpart of ``repro/models/api.py`` for every family (``dense``, ``vlm``,
``moe``, ``ssm``, ``hybrid``, ``encdec``).  Per family it wires up:

    init(seed, dtype=torch.float32, *, device=None) -> params
    forward(params, tokens)      -> hidden states [B, S, d]
    prefill(params, batch)       -> last-token logits [B, 1, V]
    loss(params, batch)          -> scalar (training objective, float32)
    init_cache(batch_size, seq_len, dtype, *, device=None) -> decode cache
    decode(params, cache, token, pos) -> (logits [B, 1, V], cache)
    input_specs(shape, dtype)    -> {name: meta tensor} for an ``InputShape``

``seed`` is an int (a ``torch.Generator`` on ``device`` is seeded with it)
or a ``torch.Generator``, whose device the parameters then take.
``device=None`` means the CUDA card and raises without one (see
``repro_torch.device``); pass ``device="cpu"`` for the host.  ``tokens``
(and ``batch["tokens"]``) are [B, S] integers, numpy or torch; they move
to the parameters' device.  The ``vlm`` family's ``prefill`` and ``loss``
also read ``batch["patch_embeds"]`` [B, n_patches, d_frontend] (floats,
numpy or torch), projected into a prefix of the text; its ``forward(params,
tokens, patch_embeds=None)`` gives the hidden states of prefix and text, or
of the text alone.  The ``encdec`` family's read ``batch["frames"]`` [B,
T_enc, d_model], the encoder's inputs; its ``forward(params, tokens,
frames)`` gives the decoder's hidden states.  The ``moe`` family's
``forward`` gives the hidden states only (the reference's
``moe_lm.forward`` also returns the router's aux loss, which its loss
adds).  ``forward`` and ``prefill`` run under ``torch.inference_mode()``;
``loss`` runs in the caller's grad mode, with every layer rematerialised
when grad is on (its gradients go through the B7/B8 kernels on the card, and
the B9/B10 backward kernels for the recurrent families).
The reference's bundle has no ``forward``: its callers reach the family
module directly; the port's DAEF head takes the bundle's.  ``input_specs``
gives meta tensors, PyTorch's counterpart of the reference's
``jax.ShapeDtypeStruct``: shapes and dtypes, no storage.

``init_cache`` allocates a zero cache (a ``KVCache``, ``MoECaches``,
``Mamba2Cache`` or ``RGCache`` of tensors) on ``device``, ``None`` meaning
the card: pass the parameters' device.  The encoder-decoder's cache holds
the cross K/V of the encoder's output, which need the parameters: its
``init_cache`` raises, as the reference's does, and a caller builds the
cache with ``encdec.init_cache(params, cfg, enc_out, seq_len, dtype)``.
``decode`` runs one token [B, 1] at position ``pos`` (an int or a 0-d
integer tensor on the cache's device) under ``torch.inference_mode()`` and
updates the cache in place: the cache it returns is the one passed in, now
holding the token (the reference donates it), so a caller must not keep
the old one.  :func:`cache_specs` gives the cache's tree as meta tensors.

``loss`` trains every family; the ``ssm`` and ``hybrid`` families' gradients
go through the B10 and B9 backward kernels on the card.

Under a mesh (``hints.use_mesh``), every family's ``init`` returns this
rank's slices of the parameters (``launch/shardings.py``: the full
parameters are drawn, then sliced), and its ``forward``, ``prefill`` and
``loss`` take them with this rank's rows of the batch (the tokens, and
the patches or frames with them): the 2-D (data, model) layout of each
family's module (``models/transformer.py``, ``vlm.py``, ``moe.py`` /
``mla.py`` / ``moe_lm.py``, ``mamba2.py``, ``rglru.py``, ``encdec.py``).
``decode`` under a mesh with a ``model`` axis raises: decode keeps its
one-device path.  ``init(..., device="meta")`` gives the parameters'
shapes and dtypes as meta tensors, drawing nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import InputShape
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, encdec, hints, mamba2, moe_lm, rglru, transformer, vlm

_MODULES = {"dense": transformer, "vlm": vlm, "moe": moe_lm, "ssm": mamba2,
            "hybrid": rglru, "encdec": encdec}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init: Callable[..., Any]
    forward: Callable[..., torch.Tensor]
    prefill: Callable[..., torch.Tensor]
    loss: Callable[..., torch.Tensor]
    init_cache: Callable[..., Any]
    decode: Callable[..., Any]
    input_specs: Callable[..., dict[str, torch.Tensor]]


def _tokens(params, tokens) -> torch.Tensor:
    dev = params["embed"]["table"].device
    return torch.as_tensor(tokens, device=dev).long()


def _generator(seed, device=None) -> torch.Generator:
    """``seed`` itself if it is a generator, else a new one on ``device``
    (``None``: the card) seeded with it; on the meta device a shape-only
    stand-in."""
    if isinstance(seed, torch.Generator):
        return seed
    if device is not None and torch.device(device).type == "meta":
        return common.ShapeOnly()
    return torch.Generator(device=resolve_device(device)).manual_seed(int(seed))


def _floats(params, x) -> torch.Tensor:
    """The VLM's patch embeddings or the encoder's frames on the parameters'
    device, floats kept in their dtype (numpy's float64 as float32, the
    reference's default)."""
    x = torch.as_tensor(x, device=params["embed"]["table"].device)
    return x.float() if x.dtype == torch.float64 else x


def input_specs(shape: InputShape, dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The inputs of ``shape`` for the token-only families: int32 tokens
    [global_batch, seq_len], as meta tensors (``dtype`` is the reference's
    argument for the frontend inputs, which these families have none of)."""
    del dtype
    return {"tokens": torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32,
                                  device="meta")}


def _frontend_input_specs(name: str, dims: tuple[int, int]):
    def specs(shape: InputShape, dtype=torch.float32) -> dict[str, torch.Tensor]:
        """The tokens and, unless ``shape`` is a decode shape, the frontend's
        inputs [global_batch, *dims] in ``dtype``."""
        out = input_specs(shape)
        if shape.kind != "decode":
            out[name] = torch.empty((shape.global_batch, *dims), dtype=dtype, device="meta")
        return out
    return specs


def _encdec_cache_waits(*args, **kwargs):
    raise NotImplementedError(
        "the enc-dec cache needs params (the cross K/V of the encoder's output); use "
        "encdec.init_cache(params, cfg, enc_out, seq_len, dtype) directly")


def get_bundle(cfg: ArchConfig, *, chunked_attn: bool = True) -> ModelBundle:
    """The bundle of ``cfg``'s family.  ``chunked_attn`` is the reference's
    keyword and changes nothing here: the port's attention always streams
    through the flash-attention kernels (B7, B8)."""
    del chunked_attn
    fam = cfg.family
    if fam not in _MODULES:
        raise ValueError(f"unknown family {fam!r}")
    mod = _MODULES[fam]

    def init(seed, dtype=torch.float32, *, device=None):
        mesh = None if device is not None and torch.device(device).type == "meta" \
            else hints.active_mesh()
        with torch.no_grad():
            params = mod.init_params(_generator(seed, device), cfg, dtype)
            if mesh is not None:
                from repro_torch.launch import shardings

                params = shardings.shard_tree(params, shardings.lm_param_specs(cfg, mesh), mesh)
        return params

    if fam == "vlm":
        @torch.inference_mode()
        def forward(params, tokens, patch_embeds=None):
            patches = None if patch_embeds is None else _floats(params, patch_embeds)
            return vlm.forward(params, cfg, _tokens(params, tokens), patch_embeds=patches)
    elif fam == "encdec":
        @torch.inference_mode()
        def forward(params, tokens, frames):
            enc_out = encdec.encode(params, cfg, _floats(params, frames))
            return encdec.decode_train(params, cfg, enc_out, _tokens(params, tokens))
    elif fam == "moe":
        @torch.inference_mode()
        def forward(params, tokens):
            return moe_lm.forward(params, cfg, _tokens(params, tokens))[0]
    else:
        @torch.inference_mode()
        def forward(params, tokens):
            return mod.forward(params, cfg, _tokens(params, tokens))

    if fam == "encdec":
        init_cache = _encdec_cache_waits
    else:
        def init_cache(batch_size, seq_len, dtype, *, device=None):
            return mod.init_cache(cfg, batch_size, seq_len, dtype, device=device)

    @torch.inference_mode()
    def decode(params, cache, token, pos):
        if hints.model_rank(hints.active_mesh())[1] > 1:
            raise NotImplementedError("decode under a mesh with a model axis: decode keeps its "
                                      "one-device path")
        return mod.decode_step(params, cfg, cache, _tokens(params, token), pos)

    frontend = {"vlm": "patch_embeds", "encdec": "frames"}.get(fam)

    @torch.inference_mode()
    def prefill(params, batch):
        h = forward(params, batch["tokens"], *((batch[frontend],) if frontend else ()))
        return transformer.logits(params, cfg, h[:, -1:])

    def loss(params, batch):
        tokens = _tokens(params, batch["tokens"])
        if frontend:
            return mod.lm_loss(params, cfg, _floats(params, batch[frontend]), tokens)
        return mod.lm_loss(params, cfg, tokens)

    if fam == "vlm":
        specs = _frontend_input_specs("patch_embeds", (cfg.n_patches, cfg.d_frontend))
    elif fam == "encdec":
        specs = _frontend_input_specs("frames", (cfg.encoder_seq, cfg.d_model))
    else:
        specs = input_specs
    return ModelBundle(
        cfg=cfg, init=init, forward=forward, prefill=prefill, loss=loss,
        init_cache=init_cache, decode=decode, input_specs=specs,
    )


def cache_specs(bundle: ModelBundle, batch: int, seq_len: int, dtype) -> Any:
    """The decode cache's tree as meta tensors (shapes and dtypes, no
    storage): the counterpart of the reference's ``jax.eval_shape`` of
    ``bundle.init_cache``, and, for the encoder-decoder, of its
    ``EncDecCache`` of [L, B, seq_len, H, hd] self K/V and [L, B, T_enc, H,
    hd] cross K/V, all in ``dtype``."""
    cfg = bundle.cfg
    if cfg.family == "encdec":
        def meta(*shape):
            return torch.empty(shape, dtype=dtype, device="meta")

        shape = (cfg.n_layers, batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
        xshape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_heads, cfg.head_dim)
        return encdec.EncDecCache(self_kv=attn_mod.KVCache(k=meta(*shape), v=meta(*shape)),
                                  cross_kv=(meta(*xshape), meta(*xshape)))
    return bundle.init_cache(batch, seq_len, dtype, device="meta")
