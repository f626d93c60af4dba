"""Wrapper of the flash-attention forward kernel (B7).

Counterpart of ``repro/kernels/flash_attention/ops.py``'s forward, in the
model layout: :func:`flash_attention` takes q [B, S, H, D] and k, v
[B, S, Hkv, D] (H a multiple of Hkv: GQA, MQA) and returns ``(out, lse)``,
out [B, S, H, D] in q's dtype and the float32 row log-sum-exp [B, H, S].
Causal by default; ``window`` keeps keys j > i - window.  The strides of q,
k and v are passed to the kernel (their last axis must be contiguous), so
head slices of a projection need no copy.

Dispatch is by the tensors' device: on the CPU the plain version
(``ref.flash_attention_ref``) runs; on a CUDA device the hand-written kernel
(``csrc/flash_attention.cu``) launches for float32 or bf16 at head sizes 32,
64, 128 and 256, or the call raises.  Nothing falls back from the card.
``flash_attention.launches`` counts the calls that launched the kernel.

The backward (B8) and the ``torch.autograd.Function`` around both wait for
the training slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32,
         ctypes.POINTER(ctypes.c_longlong), _I32, _I32, ctypes.c_float, _PTR]


def _check(q, k, v, window) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"flash_attention: {name} must be a floating torch.Tensor")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, heads, D], "
                             f"got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"flash_attention: expected k, v [{b}, {s}, Hkv, {d}]; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads over {k.shape[2]} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal (optionally windowed) attention: (out [B, S, H, D], lse [B, H, S])."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPES or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes float32 or bf16 at head "
                         f"sizes {HEAD_DIMS}, got {q.dtype} at {d}")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out, lse
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, s, h, k.shape[2], d, strides, int(causal),
                 window or 0, d**-0.5, stream)
    _build.raise_on("flash_attention_fwd", err)
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_ref"]
