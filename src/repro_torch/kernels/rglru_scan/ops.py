"""Wrapper of the RG-LRU scan kernel (B9).

Counterpart of ``repro/kernels/rglru_scan/ops.py``: :func:`rglru_scan` takes
x, r, i [B, S, W] and lam [W] and returns ``(y [B, S, W], h_last [B, W])``,
float32, from h = 0.

x may be float32 or bf16, and so may the gates r and i (both alike; the
hybrid backbone's bf16 prefill gives bf16 x and float32 gates, whose bias
is float32); ``lam`` is float32.  The reference casts them to float32
before its kernel; widening is exact, so the function is that of the
float32 inputs either way.

Dispatch is by the tensors' device: on the CPU x, r and i are widened to
float32 (``lam`` is taken as it is) and the plain version
(``ref.rglru_scan_ref``) runs; on a CUDA
device the hand-written kernel (``csrc/rglru_scan.cu``) launches for
contiguous inputs, reading bf16 as it is, or the call raises.  Nothing
falls back from the card.  ``rglru_scan.launches`` counts the calls that
launched the kernel, ``rglru_scan.route_launches`` splits them by x's
dtype (``"float32"``, ``"bfloat16"``).

The kernel has no backward: with grad mode on and an input that requires
grad, the call raises (on both devices) rather than return outputs with no
``grad_fn``.  Training the hybrid family waits for ROADMAP queue A item 16.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

_PTR = ctypes.c_void_p
_ARGS = [_PTR] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [_PTR]
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _check(x, r, i, lam) -> None:
    for name, t in (("x", x), ("r", r), ("i", i), ("lam", lam)):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            raise TypeError(f"rglru_scan: {name} must be a floating torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"rglru_scan: {name} is on {t.device}, x on {x.device}")
    if x.ndim != 3 or r.shape != x.shape or i.shape != x.shape or lam.shape != x.shape[2:]:
        raise ValueError(f"rglru_scan: expected x, r, i [B, S, W] and lam [W]; got "
                         f"{tuple(x.shape)}, {tuple(r.shape)}, {tuple(i.shape)}, "
                         f"{tuple(lam.shape)}")


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor):
    """RG-LRU recurrence over [B, S, W]: (y, h_last)."""
    _check(x, r, i, lam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r, i, lam)):
        raise NotImplementedError("rglru_scan has no backward; training the hybrid "
                                  "family waits for ROADMAP queue A item 16")
    if x.device.type == "cpu":
        return rglru_scan_ref(x.float(), r.float(), i.float(), lam)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {x.device}")
    for name, t in (("x", x), ("r", r), ("i", i), ("lam", lam)):
        if (t.dtype != torch.float32 if name == "lam" else t.dtype not in _DTYPES) \
                or not t.is_contiguous():
            raise ValueError(f"rglru_scan: the kernel takes contiguous x, r, i in float32 or "
                             f"bf16 and lam in float32; {name} is {t.dtype}, "
                             f"contiguous={t.is_contiguous()}")
    if r.dtype != i.dtype:
        raise ValueError(f"rglru_scan: r and i must share a dtype; got {r.dtype}, {i.dtype}")
    b, s, w = x.shape
    y = torch.empty((b, s, w), dtype=torch.float32, device=x.device)
    if b == 0 or s == 0 or w == 0:
        return y, torch.zeros((b, w), dtype=torch.float32, device=x.device)
    h_last = torch.empty((b, w), dtype=torch.float32, device=x.device)
    _build.launch("rglru_scan", "rglru_scan", _ARGS, x.device, x.data_ptr(), r.data_ptr(),
                  i.data_ptr(), lam.data_ptr(), y.data_ptr(), h_last.data_ptr(), b, s, w,
                  int(x.dtype == torch.bfloat16), int(r.dtype == torch.bfloat16))
    rglru_scan.launches += 1
    rglru_scan.route_launches[_DTYPES[x.dtype]] += 1
    return y, h_last


rglru_scan.launches = 0
rglru_scan.route_launches = {"float32": 0, "bfloat16": 0}

__all__ = ["rglru_scan", "rglru_scan_ref"]
