"""Wrapper of the Mamba-2 SSD chunk-scan kernel (B10).

Counterpart of ``repro/kernels/ssd_chunk/ops.py``, in the model layout with
B and C per group (the reference folds batch and heads into [BH, S, ...]
and repeats B and C per head): :func:`ssd_chunk` takes xdt [B, S, H, P],
la [B, S, H], b and c [B, S, G, N] and returns
``(y [B, S, H, P], h_final [B, H, P, N])``, float32.  The chunk keeps the
reference's rule: ``chunk = min(chunk, S)``, lowered until it divides S.

Dispatch is by the tensors' device: on the CPU the plain chunked version
(``ref.ssd_chunk_plain``) runs; on a CUDA device the hand-written kernel
(``csrc/ssd_chunk.cu``: 3xTF32 tensor-core products, five launches counted
as one call) runs for float32 contiguous inputs with P <= 64, N <= 128 and
a chunk <= 256, or the call raises.  Nothing falls back from the card.  ``ssd_chunk.launches`` counts
the calls that launched the kernel.

Gradients: when grad mode is on and an input requires grad,
:func:`ssd_chunk` goes through :class:`SSDChunk`, whose forward runs the
same dispatch and saves its inputs, and whose backward calls
:func:`ssd_chunk_bwd` (the states entering each chunk are recomputed, not
saved).  :func:`ssd_chunk_bwd` takes the forward's inputs and the output
cotangents dy [B, S, H, P] and ``dh_final`` [B, H, P, N] (``None``: zero,
as the models discard h_final) and returns (dxdt, dla, db, dc), db and dc
summed over the heads of each group: on the CPU ``ref.ssd_chunk_bwd_plain``,
on a CUDA device the hand-written backward kernel
(``csrc/ssd_chunk_bwd.cu``: 3xTF32 tensor-core products, C·Bᵀ formed once
per group, nine launches counted as one call, no atomics) under the
forward's limits, or the call raises.
``ssd_chunk_bwd.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_plain, ssd_chunk_plain

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_PTR] * 11 + [_I32] * 7 + [_PTR]
_BWD_ARGS = [_PTR] * 20 + [_I32] * 7 + [_PTR]
TILE = 64        # query and key rows of the kernel's score tiles (kT)
STATE_STEP = 32  # chunk steps per stage of the state product (kStateStep)
N_PAD = 128      # rows of a stage of the state product's Bᵀ (kMaxN)


def _check(xdt, la, b, c) -> None:
    for name, t in (("xdt", xdt), ("la", la), ("b", b), ("c", c)):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"ssd_chunk: {name} must be a floating torch.Tensor")
        if t.device != xdt.device:
            raise ValueError(f"ssd_chunk: {name} is on {t.device}, xdt on {xdt.device}")
    if xdt.ndim != 4 or la.shape != xdt.shape[:3] or b.ndim != 4 or c.shape != b.shape \
            or b.shape[:2] != xdt.shape[:2]:
        raise ValueError(f"ssd_chunk: expected xdt [B, S, H, P], la [B, S, H], b, c "
                         f"[B, S, G, N]; got {tuple(xdt.shape)}, {tuple(la.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    if b.shape[2] == 0 or xdt.shape[2] % b.shape[2]:
        raise ValueError(f"ssd_chunk: {xdt.shape[2]} heads over {b.shape[2]} groups")


def fit_chunk(s: int, chunk: int) -> int:
    """The reference's chunk rule: min(chunk, S), lowered until it divides S."""
    chunk = max(1, min(chunk, s))
    while s % chunk:
        chunk -= 1
    return chunk


def _kernel_inputs(who, p, n, chunk, **tensors) -> None:
    """Raise unless the CUDA kernels take these tensors and sizes."""
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{who}: the kernel takes float32 contiguous tensors; "
                             f"{name} is {t.dtype}, contiguous={t.is_contiguous()}")
    if p > MAX_P or n > MAX_N or chunk > MAX_CHUNK:
        raise ValueError(f"{who}: the kernel takes P <= {MAX_P}, N <= {MAX_N} and a "
                         f"chunk <= {MAX_CHUNK}; got P={p}, N={n}, chunk={chunk}")


def _forward(xdt, la, b, c, chunk):
    """One forward at a fitted ``chunk``: B10 on a CUDA tensor, the plain
    version on a CPU one."""
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    if xdt.device.type == "cpu":
        return ssd_chunk_plain(xdt, la, b, c, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {xdt.device}")
    _kernel_inputs("ssd_chunk", p, n, chunk, xdt=xdt, la=la, b=b, c=c)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    y = torch.empty((bsz, s, h, p), **f32)
    h_final = torch.zeros((bsz, h, p, n), **f32)
    if bsz == 0 or s == 0 or h == 0 or p == 0 or n == 0:
        return y, h_final
    nc = s // chunk
    ws = torch.empty((bsz * h, nc, p, n), **f32)
    cd = torch.empty((bsz * h, nc), **f32)
    tq = -(-chunk // TILE)
    ws_s = torch.empty((bsz * g, nc, tq * (tq + 1) // 2, TILE, TILE), **f32)
    ws_bt = torch.empty((bsz * g, nc, -(-chunk // STATE_STEP), 2, N_PAD * STATE_STEP), **f32)
    hp_img = torch.empty((bsz * h, nc, 2, TILE * N_PAD), **f32)
    _build.launch("ssd_chunk", "ssd_chunk_f32", _ARGS, xdt.device, xdt.data_ptr(),
                  la.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(), h_final.data_ptr(),
                  ws.data_ptr(), cd.data_ptr(), ws_s.data_ptr(), ws_bt.data_ptr(),
                  hp_img.data_ptr(), bsz, s, h, g, p, n, chunk)
    ssd_chunk.launches += 1
    return y, h_final


class SSDChunk(torch.autograd.Function):
    """The SSD scan with the B10 backward: ``apply(xdt, la, b, c, chunk)``
    at a fitted chunk returns ``(y, h_final)``."""

    @staticmethod
    def forward(ctx, xdt, la, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xdt, la, b, c)
        ctx.chunk = chunk
        return _forward(xdt, la, b, c, chunk)

    @staticmethod
    def backward(ctx, dy, dh_final):
        xdt, la, b, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xdt)
        return (*ssd_chunk_bwd(xdt, la, b, c, dy, dh_final, chunk=ctx.chunk), None)


def ssd_chunk(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
              chunk: int = 256):
    """Chunked SSD scan: (y [B, S, H, P], h_final [B, H, P, N])."""
    _check(xdt, la, b, c)
    chunk = fit_chunk(xdt.shape[1], chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, la, b, c)):
        return SSDChunk.apply(xdt, la, b, c, chunk)
    return _forward(xdt, la, b, c, chunk)


def ssd_chunk_bwd(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  dy: torch.Tensor, dh_final: torch.Tensor | None = None, *,
                  chunk: int = 256):
    """The SSD scan's backward: (dxdt [B, S, H, P], dla [B, S, H], db and dc
    [B, S, G, N])."""
    _check(xdt, la, b, c)
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    for name, t, shape in (("dy", dy, (bsz, s, h, p)), ("dh_final", dh_final, (bsz, h, p, n))):
        if t is None and name == "dh_final":
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.device != xdt.device:
            raise ValueError(f"ssd_chunk_bwd: {name} must be {shape} on {xdt.device}, got "
                             f"{getattr(t, 'shape', t)}")
    if any(t is not None and t.requires_grad for t in (xdt, la, b, c, dy, dh_final)) \
            and torch.is_grad_enabled():
        raise RuntimeError("ssd_chunk_bwd: the backward has no grad_fn of its own; call it "
                           "under torch.no_grad()")
    chunk = fit_chunk(s, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunk_bwd_plain(xdt, la, b, c, dy, dh_final, chunk=chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: no kernel for device {xdt.device}")
    dy = dy.contiguous()
    dh_final = None if dh_final is None else dh_final.contiguous()
    _kernel_inputs("ssd_chunk_bwd", p, n, chunk, xdt=xdt, la=la, b=b, c=c, dy=dy,
                   **({} if dh_final is None else {"dh_final": dh_final}))
    f32 = dict(dtype=torch.float32, device=xdt.device)
    empty = bsz == 0 or s == 0 or h == 0 or p == 0 or n == 0
    new = torch.zeros if empty else torch.empty  # the kernels write every element
    dxdt = new((bsz, s, h, p), **f32)
    dla = new((bsz, s, h), **f32)
    db = new((bsz, s, g, n), **f32)
    dc = new((bsz, s, g, n), **f32)
    if empty:
        return dxdt, dla, db, dc
    nc, tq = s // chunk, -(-chunk // TILE)
    ws_s = torch.empty((bsz * h, nc, p, n), **f32)
    ws_e = torch.empty((bsz * h, nc, p, n), **f32)
    cd = torch.empty((bsz * h, nc), **f32)
    cross = torch.empty((bsz * h, nc, tq, chunk), **f32)
    qpart, spart = (torch.empty((bsz, s, h), **f32) for _ in range(2))
    dbp, dcp = (torch.empty((bsz, s, h, n), **f32) for _ in range(2))
    ws_sc = torch.empty((bsz * g, nc, tq * (tq + 1), TILE, TILE), **f32)
    img = torch.empty((bsz * g, nc, 2, 2, 2 * tq, N_PAD * STATE_STEP), **f32)
    _build.launch("ssd_chunk_bwd", "ssd_chunk_bwd_f32", _BWD_ARGS, xdt.device, xdt.data_ptr(),
                  la.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(), dxdt.data_ptr(),
                  dla.data_ptr(), db.data_ptr(), dc.data_ptr(), ws_s.data_ptr(),
                  ws_e.data_ptr(), cd.data_ptr(), cross.data_ptr(), qpart.data_ptr(),
                  spart.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), ws_sc.data_ptr(),
                  img.data_ptr(), bsz, s, h, g, p, n, chunk)
    ssd_chunk_bwd.launches += 1
    return dxdt, dla, db, dc


ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0

__all__ = ["SSDChunk", "fit_chunk", "ssd_chunk", "ssd_chunk_bwd", "ssd_chunk_bwd_plain",
           "ssd_chunk_plain"]
