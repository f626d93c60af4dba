"""Mamba-2 (SSD, State Space Duality, arXiv:2405.21060): init, prefill and
decode.

Counterpart of ``repro/models/mamba2.py``'s ``_dims``, ``init_layer`` /
``init_params``, ``_split_proj``, ``_causal_conv``, ``ssd_chunked``,
``layer_fwd``, ``forward``, ``lm_loss``, ``Mamba2Cache``, ``init_cache`` and
``decode_step``.  Layers are stacked on a leading [L] axis.

The SSD scan of :func:`layer_fwd` goes through the B10 wrapper
(``kernels.ssd_chunk``): the hand-written kernel on a CUDA tensor, the plain
chunked version on a CPU tensor, with B and C indexed per group (never
repeated per head).  :func:`ssd_chunked` keeps the reference's signature and
is that plain version.  Under grad the scan goes through B10's autograd
Function: its backward is the hand-written backward kernel on the card and
the plain backward on the host, and :func:`forward` checkpoints every layer
(``torch.utils.checkpoint``), as the reference wraps each in
``jax.checkpoint``; B10's forward then runs twice a layer.

Decode is the O(1) recurrent update of the reference, in plain PyTorch (the
reference's is plain XLA): a float32 [L, B, H, P, N] SSM state and a
[L, B, W-1, C] causal-conv tail in the model's dtype, both updated in place
by :func:`decode_step`.

Under a mesh (``hints.use_mesh``) ``forward`` and ``lm_loss`` take this
rank's slices of the parameters (``launch/shardings.py``) and its rows of
the batch.  ``in_proj`` and the conv leaves are whole on every rank, which
computes the projection and the conv alike; the reference's head hint
splits the SSD heads over ``model`` where they divide.  Each rank then
takes its heads of x, dt and z and its slices of ``dt_bias``, ``a_log``,
``d_skip`` and the gate norm's scale (``hints.take_shard``), runs B10 on
its heads with B and C (shared by the heads) entering through
``hints.copy``, forms the gated RMSNorm over the whole ``d_inner`` with its
mean square a sum over ``model`` (``hints.psum`` then ``hints.copy``: each
rank normalises its own channels with it), and multiplies by its rows of
the row-parallel ``out_proj``, followed by a ``hints.psum``.  Where the
heads do not divide but ``out_proj``'s rows do, the block runs alike on
every rank up to its channels of the gated output.  A layer leaf split over
``data`` (FSDP) is gathered inside the rematerialised layer.  Decode keeps
its one-device path.

What the port leaves out: ``remat`` as a keyword (the layers are
checkpointed whenever grad is on).

Shapes: tokens [B, S]; inner activations [B, S, H, P] (H heads, P head dim);
B/C projections [B, S, G, N] (G groups, N state dim).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain
from repro_torch.models import common, hints, transformer

Params = dict[str, Any]


class Mamba2Cache(NamedTuple):
    ssm: torch.Tensor    # [L, B, H, P, N] inter-token SSM state (float32)
    conv: torch.Tensor   # [L, B, W-1, conv_channels] causal-conv tail


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_ch = d_inner + 2 * cfg.n_groups * cfg.ssm_state
    return d_inner, n_heads, conv_ch


def a_log_init(n_heads: int) -> torch.Tensor:
    """log(linspace(1, 16, H)) in float32, from the float64 values rounded
    once (the reference's XLA-folded constant can differ by one ulp)."""
    return torch.from_numpy(np.log(np.linspace(1.0, 16.0, n_heads)).astype(np.float32))


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype, *, lead=()) -> Params:
    d, dev = cfg.d_model, gen.device
    d_inner, n_heads, conv_ch = _dims(cfg)
    g, n = cfg.n_groups, cfg.ssm_state
    d_proj = 2 * d_inner + 2 * g * n + n_heads  # in_proj emits [z | x | B | C | dt]
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "norm": common.init_rmsnorm(d, dtype, lead=lead, device=dev),
        "in_proj": common.dense_init(gen, (d, d_proj), dtype, lead=lead),
        "conv_w": common.dense_init(gen, (cfg.conv_width, conv_ch), dtype, scale=0.5,
                                    lead=lead),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "a_log": a_log_init(n_heads).to(dev).expand(*lead, n_heads).contiguous(),
        "dt_bias": torch.zeros((*lead, n_heads), **f32),
        "d_skip": torch.ones((*lead, n_heads), **f32),
        "gate_norm": common.init_rmsnorm(d_inner, dtype, lead=lead, device=dev),
        "out_proj": common.dense_init(gen, (d_inner, d), dtype, lead=lead),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32) -> Params:
    """Random parameters on ``gen``'s device (layers stacked on [L]); the LM
    head is tied to the embedding, as in the released models."""
    return {
        "embed": common.init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "layers": init_layer(gen, cfg, dtype, lead=(cfg.n_layers,)),
        "final_norm": common.init_rmsnorm(cfg.d_model, dtype, device=gen.device),
    }


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    d_inner, n_heads, _ = _dims(cfg)
    gn = cfg.n_groups * cfg.ssm_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, n_heads], dim=-1)


def _causal_conv(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv + SiLU.  x [B, S, C]; w [W, C]."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    return F.silu(out + bias)


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """The chunked SSD scan with the reference's signature (the plain route):
    x [B, S, H, P], dt [B, S, H] (softplus'd), a [H] (A = -a), b and c
    [B, S, G, N] -> (y [B, S, H, P], final state [B, H, P, N])."""
    return ssd_chunk_plain(x * dt[..., None], -a[None, None, :] * dt, b, c, chunk, h0)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, d_inner: int,
                mesh=None) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` over ``d_inner`` channels, of which the
    tensors hold this rank's under ``mesh``."""
    g = y * F.silu(z)
    if mesh is None:
        return common.rmsnorm({"scale": scale}, g)
    gf = g.float()
    var = hints.copy(hints.psum(gf.square().sum(-1, keepdim=True), mesh), mesh) / d_inner
    return (gf * torch.rsqrt(var + 1e-6) * scale.float()).to(g.dtype)


def layer_fwd(layer: Params, cfg: ArchConfig, h_in: torch.Tensor,
              fsdp: Params | None = None) -> torch.Tensor:
    """One mamba2 block (prefill); ``fsdp`` (the layer leaves' specs under a
    mesh) names the leaves to gather over ``data`` first."""
    mesh = hints.active_mesh()
    if fsdp is not None:
        layer = hints.gather_data(layer, fsdp, mesh, slice(1, None), shift=1)
    d_inner, n_heads, _ = _dims(cfg)
    gn = cfg.n_groups * cfg.ssm_state
    x_norm = common.rmsnorm(layer["norm"], h_in)
    z, x, b, c, dt = _split_proj(cfg, x_norm @ layer["in_proj"])
    xbc = _causal_conv(layer["conv_w"], layer["conv_b"], torch.cat([x, b, c], dim=-1))
    x, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    bsz, s, _ = x.shape
    x = x.reshape(bsz, s, n_heads, cfg.ssm_head_dim).float()
    b = b.reshape(bsz, s, cfg.n_groups, cfg.ssm_state).float().contiguous()
    c = c.reshape(bsz, s, cfg.n_groups, cfg.ssm_state).float().contiguous()
    dt = dt.float()
    heads = {k: layer[k] for k in ("dt_bias", "a_log", "d_skip")}
    scale = layer["gate_norm"]["scale"]
    _, ext = hints.model_rank(mesh)
    split_heads = ext > 1 and n_heads % ext == 0
    if split_heads:  # this rank's heads, B and C shared by them
        x, dt, z, scale = (hints.take_shard(t, mesh, dim) for t, dim in
                           ((x, 2), (dt, -1), (z, -1), (scale, -1)))
        heads = {k: hints.take_shard(v, mesh, -1) for k, v in heads.items()}
        b, c = hints.copy(b, mesh), hints.copy(c, mesh)
    dt = common.softplus(dt + heads["dt_bias"])
    a = torch.exp(heads["a_log"])

    y, _ = ssd_chunk(x * dt[..., None], -a[None, None, :] * dt, b, c,
                     chunk=min(cfg.ssm_chunk, s))
    y = y + heads["d_skip"][None, None, :, None] * x
    y = y.reshape(bsz, s, -1).to(h_in.dtype)
    y = _gated_norm(scale, y, z, d_inner, mesh if split_heads else None)
    if ext > 1 and not split_heads and layer["out_proj"].shape[-2] != d_inner:
        y = hints.take_shard(y, mesh, -1)  # the channels this rank's out_proj rows read
    out = y @ layer["out_proj"]
    if ext > 1 and layer["out_proj"].shape[-2] != d_inner:
        out = hints.psum(out, mesh)
    return h_in + out


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Hidden states [B, S, d] for training or prefill; every layer
    checkpointed when grad is on."""
    mesh, specs = common.mesh_specs(cfg)
    fsdp = None if specs is None else specs["layers"]
    h = common.embed(params["embed"], tokens, vocab=cfg.vocab_size)
    remat = torch.is_grad_enabled()
    stack = hints.gather_data(params["layers"], fsdp, mesh, slice(0, 1))
    for layer in common.unstack(stack, cfg.n_layers):
        if remat:
            h = hints.remat(layer_fwd, layer, cfg, h, fsdp)
        else:
            h = layer_fwd(layer, cfg, h, fsdp)
    return common.rmsnorm(params["final_norm"], h)


def lm_loss(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            loss_chunk: int = 1024) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar) of ``tokens`` [B, S] on the
    parameters' device, the LM head tied to the embedding."""
    return transformer.next_token_xent(params, cfg, forward(params, cfg, tokens), tokens,
                                       loss_chunk)


# ---------------------------------------------------------------------------
# Serving (recurrent decode, O(1) per token)
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, dtype, *,
               device=None) -> Mamba2Cache:
    """Zero state on ``device`` (``None``: the card; the parameters' device is
    the one to pass); its size does not depend on ``seq_len``."""
    del seq_len
    _, n_heads, conv_ch = _dims(cfg)
    dev = resolve_device(device)
    return Mamba2Cache(
        ssm=torch.zeros((cfg.n_layers, batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        dtype=torch.float32, device=dev),
        conv=torch.zeros((cfg.n_layers, batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                         device=dev),
    )


def decode_step(params: Params, cfg: ArchConfig, cache: Mamba2Cache, token: torch.Tensor,
                pos) -> tuple[torch.Tensor, Mamba2Cache]:
    """One decoding step: ``token`` [B, 1] -> (logits [B, 1, V], the cache
    updated in place).  ``pos`` is unused: the state carries the position."""
    del pos
    d_inner, n_heads, _ = _dims(cfg)
    gn, rep = cfg.n_groups * cfg.ssm_state, n_heads // cfg.n_groups
    h = common.embed(params["embed"], token)  # [B,1,d]
    for i in range(cfg.n_layers):
        layer = common.layer(params["layers"], i)
        x_norm = common.rmsnorm(layer["norm"], h)
        z, x, b, c, dt = _split_proj(cfg, x_norm @ layer["in_proj"])
        xbc = torch.cat([x, b, c], dim=-1)                        # [B,1,C]
        window = torch.cat([cache.conv[i], xbc[:, 0:1]], dim=1)   # [B,W,C]
        conv_out = F.silu(torch.einsum("bwc,wc->bc", window, layer["conv_w"])
                          + layer["conv_b"])
        cache.conv[i].copy_(window[:, 1:])
        x, b, c = torch.split(conv_out, [d_inner, gn, gn], dim=-1)
        bsz = x.shape[0]
        x = x.reshape(bsz, n_heads, cfg.ssm_head_dim).float()
        b = b.reshape(bsz, cfg.n_groups, cfg.ssm_state).float().repeat_interleave(rep, dim=1)
        c = c.reshape(bsz, cfg.n_groups, cfg.ssm_state).float().repeat_interleave(rep, dim=1)
        dt_v = common.softplus(dt[:, 0].float() + layer["dt_bias"])
        decay = torch.exp(-torch.exp(layer["a_log"])[None, :] * dt_v)  # [B,H]
        upd = x[..., :, None] * b[..., None, :] * dt_v[..., None, None]
        ssm = cache.ssm[i]
        ssm.copy_(ssm * decay[..., None, None] + upd)
        y = torch.einsum("bhn,bhpn->bhp", c, ssm)
        y = y + layer["d_skip"][None, :, None] * x
        y = y.reshape(bsz, 1, d_inner).to(h.dtype)
        y = common.rmsnorm(layer["gate_norm"], y * F.silu(z))
        h = h + y @ layer["out_proj"]
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(h, params["embed"], None), cache
