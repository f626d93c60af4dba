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

The kernel has no backward: with grad mode on and an input that requires
grad, the call raises (on both devices) rather than return outputs with no
``grad_fn``.  Training the SSM family waits for ROADMAP queue A item 16.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 256
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_PTR] * 11 + [_I32] * 7 + [_PTR]
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


def ssd_chunk(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
              chunk: int = 256):
    """Chunked SSD scan: (y [B, S, H, P], h_final [B, H, P, N])."""
    _check(xdt, la, b, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, la, b, c)):
        raise NotImplementedError("ssd_chunk has no backward; training the SSM family "
                                  "waits for ROADMAP queue A item 16")
    bsz, s, h, p = xdt.shape
    g, n = b.shape[2], b.shape[3]
    chunk = fit_chunk(s, chunk)
    if xdt.device.type == "cpu":
        return ssd_chunk_plain(xdt, la, b, c, chunk)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {xdt.device}")
    for name, t in (("xdt", xdt), ("la", la), ("b", b), ("c", c)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ssd_chunk: the kernel takes float32 contiguous tensors; "
                             f"{name} is {t.dtype}, contiguous={t.is_contiguous()}")
    if p > MAX_P or n > MAX_N or chunk > MAX_CHUNK:
        raise ValueError(f"ssd_chunk: the kernel takes P <= {MAX_P}, N <= {MAX_N} and a "
                         f"chunk <= {MAX_CHUNK}; got P={p}, N={n}, chunk={chunk}")
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


ssd_chunk.launches = 0

__all__ = ["fit_chunk", "ssd_chunk", "ssd_chunk_plain"]
