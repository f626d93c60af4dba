"""Shared model components: norms, MLPs, embeddings, RoPE, sinusoidal
positions, initialisers and the chunked cross-entropy.

Counterpart of ``repro/models/common.py``.  Modules are functional, as in
the reference: ``init_*`` returns a parameter dict of tensors, the apply
functions take (params, inputs).  Weights keep the reference's ``[in, out]``
orientation (``x @ w``).  Layers of a stack are drawn at once with a leading
``lead`` shape, which stands where the reference's ``jax.vmap(init_layer)``
puts its [L] axis.

The initialisers draw from an explicit ``torch.Generator``, on its device:
the same distributions as the reference (fan-in truncated normal within
±2σ, N(0, 0.02) embeddings), not the same bits (``jax.random`` and torch
generators differ).  The tests carry the reference's own parameters across
with ``interop.lm_params_from_numpy``.

``jax.nn.gelu`` defaults to the tanh approximation; so does every GELU here.

Under an active mesh with a ``model`` axis (``models/hints.py``) the apply
functions take this rank's slices of the parameters (``launch/shardings.py``)
and run the Megatron layout: :func:`embed` a vocab-parallel lookup,
:func:`mlp` column- then row-parallel with one sum over ``model``, and
:func:`chunked_softmax_xent` / :func:`logits_from_hidden` over a vocab
sharded on ``model``.  A leaf the rules leave whole (a dim that does not
divide) runs as on one device.  The initialisers draw on a generator's
device, or make meta tensors and draw nothing for a shape-only
``ShapeOnly`` generator (the counterpart of ``jax.eval_shape`` of an
init).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import hints

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------

class ShapeOnly:
    """Stands where a ``torch.Generator`` goes when only the parameters'
    shapes and dtypes are wanted: the initialisers make meta tensors."""

    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None, *,
               lead: tuple[int, ...] = ()) -> torch.Tensor:
    """Truncated-normal fan-in init (std ``shape[0] ** -0.5`` unless ``scale``
    is given, cut at ±2σ); ``lead + shape``.  float32 is drawn whole; another
    dtype one [*shape] slice at a time, each drawn in float32 and cast, so a
    stacked leaf never holds a float32 copy of itself (granite-20b's [52,
    6,144, 24,576] MLP stacks in bf16 would take 31.4 GB each, past one 80 GB
    card beside the leaves drawn before them)."""
    std = scale if scale is not None else shape[0] ** -0.5
    out = torch.empty((*lead, *shape), dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    if dtype == torch.float32:
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return out.mul_(std)
    for part in out.view(-1, *shape):
        part.copy_(dense_init(gen, shape, torch.float32, std))
    return out


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return t.mul_(0.02).to(dtype)


def _full(lead, shape, value, dtype, device) -> torch.Tensor:
    return torch.full((*lead, *shape), value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms (computed in float32, cast back)
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, *, lead=(), device=None) -> Params:
    return {"scale": _full(lead, (d,), 1.0, dtype, device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, dtype, *, lead=(), device=None) -> Params:
    return {"scale": _full(lead, (d,), 1.0, dtype, device),
            "bias": _full(lead, (d,), 0.0, dtype, device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)


def init_norm(kind: str, d: int, dtype, *, lead=(), device=None) -> Params:
    if kind == "rmsnorm":
        return init_rmsnorm(d, dtype, lead=lead, device=device)
    return init_layernorm(d, dtype, lead=lead, device=device)


def apply_norm(kind: str, p: Params, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, kind: str, d_model: int, d_ff: int, dtype, *,
             lead=()) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
        }
    return {  # gelu_mlp (whisper-style 2-matrix MLP with bias)
        "w_up": dense_init(gen, (d_model, d_ff), dtype, lead=lead),
        "b_up": _full(lead, (d_ff,), 0.0, dtype, gen.device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, lead=lead),
        "b_down": _full(lead, (d_model,), 0.0, dtype, gen.device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mesh_specs(cfg):
    """(the active mesh, the specs of ``cfg``'s parameters on it:
    ``shardings.lm_param_specs``), or (None, None) without a mesh."""
    mesh = hints.active_mesh()
    if mesh is None:
        return None, None
    from repro_torch.launch import shardings

    return mesh, shardings.lm_param_specs(cfg, mesh)


def _model_sharded(mesh, local: int, full: int) -> bool:
    """Whether a dim of ``full`` entries is split over the mesh's model axis
    (this rank holds ``local`` of them)."""
    return mesh is not None and local != full


def mlp(p: Params, kind: str, x: torch.Tensor, *, d_ff: int | None = None) -> torch.Tensor:
    """The MLP block.  Under a mesh whose ``model`` axis splits ``w_down``'s
    rows (``d_ff``, the full width, tells), the gate/up columns and
    ``b_up`` are this rank's and the output is summed over ``model``;
    ``b_down`` is added once, after the sum."""
    mesh = hints.active_mesh()
    if d_ff is not None and _model_sharded(mesh, p["w_down"].shape[-2], d_ff):
        x = hints.copy(x, mesh)
    else:
        mesh = None
    if kind == "swiglu":
        y = (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    elif kind == "geglu":
        y = (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    else:
        y = gelu(x @ p["w_up"] + p["b_up"]) @ p["w_down"]
    if mesh is not None:
        y = hints.psum(y, mesh)
    return y if kind in ("swiglu", "geglu") else y + p["b_down"]


# ---------------------------------------------------------------------------
# Rotary position embeddings (halves split, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (float32): ``1 / theta**e`` taken
    in float64 and rounded once, the constants XLA folds the reference's
    float32 expression into under ``jax.jit`` (its decode, prefill and train
    steps).  Power and quotient each rounded to float32 land one ulp away in
    up to 40 % of the entries (head size 128 at theta 1e6: 25 of 64), and at
    position 524,287 one ulp of a frequency moves its angle by up to 0.03
    rad.  The exponents ``e = i / head_dim`` are the reference's float32
    quotients, rounded once from float64 (on the card a float32 tensor over
    a scalar is a product with the scalar's reciprocal, an ulp off where
    ``head_dim`` is not a power of two)."""
    exponents = (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device)
                 / head_dim).float()
    return (1.0 / theta**exponents.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., seq, heads, head_dim]; positions broadcastable to [..., seq]."""
    inv = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * inv           # [..., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings [seq, d] (float32):
    ``[sin | cos]`` of position times ``10000^(-2i/d)``.  The power is taken
    in float64 and rounded once to float32, the correctly rounded float32
    power that XLA's is; torch's float32 ``pow`` is one ulp off at some
    exponents, which moves an angle at position 1,500 by ~3e-6."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    exponents = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    inv = 1.0 / (10000 ** exponents.double()).float()
    angles = pos * inv[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> Params:
    return {"table": embed_init(gen, (vocab, d), dtype)}


def _vocab_part(mesh, local: int, vocab: int | None):
    """(first row, rows) of this rank's vocab slice when the mesh's model
    axis splits a vocab of ``vocab``, else None."""
    if vocab is None or not _model_sharded(mesh, local, vocab):
        return None
    rank, _ = hints.model_rank(mesh)
    return rank * local, local


def embed(p: Params, tokens: torch.Tensor, *, vocab: int | None = None) -> torch.Tensor:
    """Token embeddings.  Under a mesh whose ``model`` axis splits the table
    (of ``vocab`` rows), a vocab-parallel lookup: a token outside this
    rank's rows gives zeros, and the rows are summed over ``model``."""
    mesh = hints.active_mesh()
    part = _vocab_part(mesh, p["table"].shape[0], vocab)
    if part is None:
        return p["table"][tokens]
    lo, n = part
    local = tokens - lo
    mine = (local >= 0) & (local < n)
    rows = p["table"][local.clamp(0, n - 1)] * mine[..., None].to(p["table"].dtype)
    return hints.psum(rows, mesh)


def logits_from_hidden(h: torch.Tensor, emb: Params, w_out: torch.Tensor | None, *,
                       vocab: int | None = None) -> torch.Tensor:
    """LM head: tied embedding transpose or a separate output matrix.  Under
    a mesh whose ``model`` axis splits the vocab (of ``vocab``), every
    rank's logits are gathered along the vocab."""
    w = w_out if w_out is not None else emb["table"].T
    mesh = hints.active_mesh()
    if _vocab_part(mesh, w.shape[-1], vocab) is None:
        return h @ w
    return hints.all_gather(hints.copy(h, mesh) @ w, mesh, -1)


def chunked_softmax_xent(
    h: torch.Tensor,
    labels: torch.Tensor,
    mask: torch.Tensor,
    emb_or_w: torch.Tensor,
    *,
    chunk: int = 1024,
    transpose: bool = False,
    vocab: int | None = None,
) -> torch.Tensor:
    """Cross-entropy over a large vocab without materialising [T, V] logits.

    h: [B, S, d]; labels/mask: [B, S]; emb_or_w: [V, d] (transpose=True) or
    [d, V].  Loops over sequence chunks (the reference's rule: S // chunk of
    them, at least one, each S // n_chunks wide), so the forward's largest
    live logits are one chunk's [B, chunk, V] in float32.  Under autograd
    each chunk's float32 logits stay saved for the backward, as the
    reference's ``lax.scan`` keeps its residuals.  Returns the mean NLL over
    masked positions (float32).

    Under a mesh whose ``model`` axis splits the vocab (``vocab``: its full
    size), each rank holds [B, chunk, V / ext] logits: the log-sum-exp is a
    max over the shards, then a sum of exps over the shards, and the gold
    logit comes from the shard that owns the label (zero elsewhere, summed
    over ``model``).
    """
    b, s, _ = h.shape
    n_chunks = max(1, s // chunk)
    chunk = s // n_chunks
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    w = emb_or_w.T if transpose else emb_or_w
    mesh = hints.active_mesh()
    part = _vocab_part(mesh, w.shape[-1], vocab)
    if part is not None:
        h = hints.copy(h, mesh)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = (h[:, sl] @ w).float()
        if part is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        else:
            logz, gold = _sharded_logz_gold(logits, labels[:, sl], part, mesh)
        mc = mask[:, sl].float()
        total = total + ((logz - gold) * mc).sum()
        count = count + mc.sum()
    return total / torch.clamp(count, min=1.0)


def _sharded_logz_gold(logits: torch.Tensor, labels: torch.Tensor, part, mesh):
    """(log-sum-exp, gold logit) of this rank's vocab slice of ``logits``
    [B, c, V / ext], both over the whole vocab.  The max is a constant of
    the sum (its gradient cancels), so it is taken without one."""
    lo, n = part
    with torch.no_grad():
        m = torch.stack(mesh.gather_axis(logits.amax(dim=-1).contiguous(), "model")).amax(0)
    logz = m + torch.log(hints.psum(torch.exp(logits - m[..., None]).sum(-1), mesh))
    local = labels.long() - lo
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return logz, hints.psum(gold * mine, mesh)


def layer(stack: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in stack.items()}


def unstack(stack: Params, n: int) -> list[Params]:
    """The ``n`` layers of a stacked parameter tree as views, one ``unbind``
    per leaf: under autograd the layers' gradients return to the stacked
    leaf through one ``stack``, not one full-size scatter per layer."""
    trees = [{} for _ in range(n)]
    for k, v in stack.items():
        parts = unstack(v, n) if isinstance(v, dict) else torch.unbind(v)
        for tree, part in zip(trees, parts, strict=True):
            tree[k] = part
    return trees
