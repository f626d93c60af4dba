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
at least float32 (``lam`` is taken as it is) and the plain version
(``ref.rglru_scan_ref``) runs; on a CUDA
device the hand-written kernel (``csrc/rglru_scan.cu``) launches for
contiguous inputs, reading bf16 as it is, or the call raises.  Nothing
falls back from the card.  ``rglru_scan.launches`` counts the calls that
launched the kernel, ``rglru_scan.route_launches`` splits them by x's
dtype (``"float32"``, ``"bfloat16"``).

Gradients: when grad mode is on and an input requires grad,
:func:`rglru_scan` goes through :class:`RGLRUScan`, whose forward runs the
same dispatch and saves its inputs and the float32 y (y is h, so the
backward reads h_{t-1} from it), and whose backward calls
:func:`rglru_scan_bwd`.  That takes the forward's inputs, y, and the
cotangents dy [B, S, W] and ``dh_last`` [B, W] (``None``: zero, as the
models discard h_last), and returns (dx, dr, di, dlam), dx, dr and di in
x's, r's and i's dtypes and dlam in lam's: on the CPU
``ref.rglru_scan_bwd_plain``, on a CUDA device the hand-written backward
kernel (``csrc/rglru_scan_bwd.cu``: staged as the forward is, a chain warp
per 32 lanes walking g backwards while worker warps stage the inputs and
form the rest, then a fixed-order sum of dlam over the batch; two launches
counted as one call) for the dtypes the forward takes, or the call
raises.  ``rglru_scan_bwd.launches`` and ``route_launches`` count them as
the forward's do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_plain, rglru_scan_ref

_PTR = ctypes.c_void_p
_ARGS = [_PTR] * 6 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [_PTR]
_BWD_ARGS = [_PTR] * 12 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [_PTR]
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


def _widen(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _kernel_inputs(who, x, r, i, lam) -> None:
    """Raise unless the CUDA kernels take these tensors."""
    for name, t in (("x", x), ("r", r), ("i", i), ("lam", lam)):
        if (t.dtype != torch.float32 if name == "lam" else t.dtype not in _DTYPES) \
                or not t.is_contiguous():
            raise ValueError(f"{who}: the kernel takes contiguous x, r, i in float32 or "
                             f"bf16 and lam in float32; {name} is {t.dtype}, "
                             f"contiguous={t.is_contiguous()}")
    if r.dtype != i.dtype:
        raise ValueError(f"{who}: r and i must share a dtype; got {r.dtype}, {i.dtype}")


def _forward(x, r, i, lam):
    """One forward: B9 on a CUDA tensor, the plain version on a CPU one."""
    if x.device.type == "cpu":
        return rglru_scan_ref(_widen(x), _widen(r), _widen(i), lam)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {x.device}")
    _kernel_inputs("rglru_scan", x, r, i, lam)
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


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan with the B9 backward: ``apply(x, r, i, lam)``
    returns ``(y, h_last)``."""

    @staticmethod
    def forward(ctx, x, r, i, lam):
        ctx.set_materialize_grads(False)
        y, h_last = _forward(x, r, i, lam)
        ctx.save_for_backward(x, r, i, lam, y)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, r, i, lam, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        return rglru_scan_bwd(x, r, i, lam, y, dy, dh_last)


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor):
    """RG-LRU recurrence over [B, S, W]: (y, h_last)."""
    _check(x, r, i, lam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, r, i, lam)):
        return RGLRUScan.apply(x, r, i, lam)
    return _forward(x, r, i, lam)


def rglru_scan_bwd(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor, lam: torch.Tensor,
                   y: torch.Tensor, dy: torch.Tensor, dh_last: torch.Tensor | None = None):
    """The RG-LRU scan's backward: (dx, dr, di [B, S, W], dlam [W])."""
    _check(x, r, i, lam)
    b, s, w = x.shape
    for name, t, shape in (("y", y, (b, s, w)), ("dy", dy, (b, s, w)),
                           ("dh_last", dh_last, (b, w))):
        if t is None and name == "dh_last":
            continue
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"rglru_scan_bwd: {name} must be {shape} on {x.device}, got "
                             f"{getattr(t, 'shape', t)}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, r, i, lam, y, dy, dh_last)):
        raise RuntimeError("rglru_scan_bwd: the backward has no grad_fn of its own; call it "
                           "under torch.no_grad()")
    if x.device.type == "cpu":
        return rglru_scan_bwd_plain(x, r, i, lam, y, dy, dh_last)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd: no kernel for device {x.device}")
    _kernel_inputs("rglru_scan_bwd", x, r, i, lam)
    y, dy = y.float().contiguous(), dy.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    dx, dr, di = (torch.empty_like(t) for t in (x, r, i))
    if b == 0 or s == 0 or w == 0:
        return dx, dr, di, torch.zeros((w,), dtype=torch.float32, device=x.device)
    dlam = torch.empty((w,), dtype=torch.float32, device=x.device)  # the kernel writes it
    dlam_part = torch.empty((b, w), dtype=torch.float32, device=x.device)
    _build.launch("rglru_scan_bwd", "rglru_scan_bwd", _BWD_ARGS, x.device, x.data_ptr(),
                  r.data_ptr(), i.data_ptr(), lam.data_ptr(), y.data_ptr(), dy.data_ptr(),
                  None if dh_last is None else dh_last.data_ptr(), dx.data_ptr(),
                  dr.data_ptr(), di.data_ptr(), dlam_part.data_ptr(), dlam.data_ptr(), b, s, w,
                  int(x.dtype == torch.bfloat16), int(r.dtype == torch.bfloat16))
    rglru_scan_bwd.launches += 1
    rglru_scan_bwd.route_launches[_DTYPES[x.dtype]] += 1
    return dx, dr, di, dlam


rglru_scan.launches = 0
rglru_scan.route_launches = {"float32": 0, "bfloat16": 0}
rglru_scan_bwd.launches = 0
rglru_scan_bwd.route_launches = {"float32": 0, "bfloat16": 0}

__all__ = ["RGLRUScan", "rglru_scan", "rglru_scan_bwd", "rglru_scan_bwd_plain",
           "rglru_scan_ref"]
