"""InternVL2-style VLM (arXiv:2404.16821): a stub vision frontend, the MLP
projector and the dense decoder.

Counterpart of ``repro/models/vlm.py``.  The InternViT encoder is a stub, as
in the reference: the inputs are precomputed patch embeddings [B,
n_patches, d_frontend].  This module owns the projector (LayerNorm, a
2-layer MLP with the tanh GELU) and runs the dense decoder of
``models/transformer.py`` with the projected patches as a prefix
(``transformer.forward(prefix_embeds=...)``), so its attention is B7's.

Decode is the dense decode: the image tokens belong to the prefill, the KV
cache covers prefix and text.  :func:`lm_loss` is the dense loss over the
text, the projected patches a prefix that carries no loss; its gradients
reach the projector through the prefix.

Under a mesh (``hints.use_mesh``) the decoder is the dense layout of
``models/transformer.py`` and the patches are split with the tokens over
``data``.  The projector's ``w1`` [d_frontend, d] and ``w2`` [d, d] are
column-parallel (``launch/shardings.py``), its ``norm``, ``b1`` and ``b2``
whole: each rank computes ``gelu(x @ w1 + b1)`` on its columns (``b1``
sliced by ``hints.take_shard``), gathers them (``hints.all_gather``: the
ranks' products with ``w2`` differ), multiplies by its columns of ``w2``,
gathers the prefix whole (``hints.replicate``: every rank's decoder then
reads it alike) and adds ``b2``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common, hints, transformer

Params = dict[str, Any]


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """The decoder's parameters plus ``projector`` {norm, w1, b1, w2, b2}."""
    params = transformer.init_params(gen, cfg, dtype)
    d, df, dev = cfg.d_model, cfg.d_frontend, gen.device
    params["projector"] = {
        "norm": common.init_layernorm(df, dtype, device=dev),
        "w1": common.dense_init(gen, (df, d), dtype),
        "b1": torch.zeros((d,), dtype=dtype, device=dev),
        "w2": common.dense_init(gen, (d, d), dtype),
        "b2": torch.zeros((d,), dtype=dtype, device=dev),
    }
    return params


def project(params: Params, patch_embeds: torch.Tensor,
            cfg: ArchConfig | None = None) -> torch.Tensor:
    """Patch embeddings [B, P, d_frontend] -> prefix tokens [B, P, d_model],
    computed in the promoted type of the patches and the weights, as JAX
    promotes float32 patches against bf16 weights.  Under a mesh ``cfg``
    names the parameters' specs (module docstring)."""
    mesh, specs = common.mesh_specs(cfg) if cfg is not None else (None, None)
    p = hints.gather_data(params["projector"], None if specs is None else specs["projector"],
                          mesh, slice(None))
    x = common.layernorm(p["norm"], patch_embeds)
    dt = torch.promote_types(x.dtype, p["w1"].dtype)
    w1, b1, w2, b2 = (p[k].to(dt) for k in ("w1", "b1", "w2", "b2"))
    if mesh is None or w1.shape[-1] == b1.shape[-1]:
        x = common.gelu(x.to(dt) @ w1 + b1)
        return x @ w2 + b2
    x = common.gelu(hints.copy(x.to(dt), mesh) @ w1 + hints.take_shard(b1, mesh, -1))
    return hints.replicate(hints.all_gather(x, mesh, -1) @ w2, mesh, -1) + b2


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            patch_embeds: torch.Tensor | None = None, remat: bool = True) -> torch.Tensor:
    """Hidden states [B, P + S, d] of the projected patches and the tokens
    (without patches: [B, S, d], the decoder alone)."""
    prefix = None if patch_embeds is None else project(params, patch_embeds, cfg)
    return transformer.forward(params, cfg, tokens, prefix_embeds=prefix, remat=remat)


def lm_loss(params: Params, cfg: ArchConfig, patch_embeds: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S] after
    the projected ``patch_embeds`` [B, P, d_frontend]."""
    return transformer.lm_loss(params, cfg, tokens,
                               prefix_embeds=project(params, patch_embeds, cfg))


init_cache = transformer.init_cache
decode_step = transformer.decode_step
