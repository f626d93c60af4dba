"""Wrappers of the flash-attention kernels: the forward (B7), the backward
(B8) and the ``torch.autograd.Function`` over both.

Counterpart of ``repro/kernels/flash_attention/ops.py``, in the model
layout: :func:`flash_attention` takes q [B, S, H, D], k [B, S, Hkv, D] and
v [B, S, Hkv, D_v] (H a multiple of Hkv: GQA, MQA) and returns ``(out,
lse)``, out [B, S, H, D_v] in q's dtype and the float32 row log-sum-exp
[B, H, S], with scores scaled by ``D^-½``.  D_v is D but for MLA's prefill
(``models/mla.py``), which attends with q/k 192 (128 nope + 64 rope) and v
128.
Causal by default (``causal=False`` lets every query attend every key:
whisper's encoder); ``window`` keeps keys j > i - window.  ``q_offset``
attends a stripe of queries: q holds Sq <= Sk rows (k and v [B, Sk, ...]),
row i at position ``q_offset + i`` (0 <= q_offset <= Sk - Sq) for both
rules, as the reference's ``attend_chunked(..., q_offset=)``; out and lse
then have Sq rows.  ``q_offset = 0`` with Sq = Sk is the square case,
launched as before.  The strides of q,
k and v are passed to the kernels (their last axis must be contiguous), so
head slices of a projection need no copy.

:func:`flash_attention_bwd` takes the forward's inputs, out and lse, and
the output gradient dO [B, S, H, D_v], and returns (dq [B, S, H, D], dk
[B, S, Hkv, D], dv [B, S, Hkv, D_v]) in q's dtype, dk and dv summed over the
query heads of each KV head.  It computes
``dvec = rowsum(dO∘O)`` in float32 before the launch, as the reference does
outside its Pallas kernels, and makes dO contiguous (a no-op for the dO that
autograd hands the model's attention, which arrives contiguous).

Dispatch is by the tensors' device: on the CPU the plain versions
(``ref.flash_attention_ref``, ``ref.flash_attention_bwd_ref``) run; on a
CUDA device the hand-written kernels launch for float32 or bf16 at the
head-size pairs (D, D_v) of ``HEAD_DIM_PAIRS`` (equal sizes 32, 64, 128 and
256, and MLA's (192, 128)), or the call raises.  Nothing falls back from the
card.  The C entry points (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) pick the kernel by dtype: bf16 runs on the
tensor cores (``csrc/flash_fwd_sm90.cuh``, ``csrc/flash_bwd_sm90.cuh``:
wgmma on tiles loaded by TMA, which needs q, k and v 16-byte aligned with
batch, sequence and head strides of whole 16 bytes; other bf16 inputs
raise), float32 on the tensor cores in 3xTF32 (the kernels of the two
``.cu`` files on ``csrc/flash_tf32x3_sm90.cuh``: each float32 operand split
into TF32 hi + lo, three TF32 products per step; any strides).
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count the
calls that launched kernels (B8's kernels count as one call); their
``route_launches`` split that count into ``"wgmma"`` (bf16) and
``"tf32x3"`` (float32).

Gradients: when grad mode is on and q, k or v requires grad,
:func:`flash_attention` goes through :class:`FlashAttention`, whose
forward saves (q, k, v, out, lse) and whose backward calls
:func:`flash_attention_bwd` — on both devices, so the CPU runs the same
plumbing as the card (the reference's ``custom_vjp``).  A kernel launch
yields tensors with no ``grad_fn``, so reaching B7 or B8 outside that path
with grad needed raises instead of detaching the attention silently.  B8
takes the head-size pairs B7 takes, MLA's (192, 128) among them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
)

HEAD_DIMS = (32, 64, 128, 256)
# (q/k head size, v head size) pairs the kernels are built for
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_ARGS = [_I32, _PTR, _PTR, _PTR, _PTR, _PTR] + [_I32] * 8 + [
    _STRIDES, _I32, _I32, ctypes.c_float, _PTR]
_BWD_ARGS = [_I32] + [_PTR] * 9 + [_I32] * 8 + [_STRIDES, _I32, _I32, ctypes.c_float, _PTR]


def _check(q, k, v, window, q_offset=0) -> None:
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
    s_k = k.shape[1]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: expected k [{b}, S_k, Hkv, {d}], v [{b}, S_k, "
                         f"Hkv, D_v]; got {tuple(k.shape)}, {tuple(v.shape)}")
    if not 0 <= q_offset <= s_k - s:
        raise ValueError(f"flash_attention: {s} query rows at q_offset {q_offset} do not lie "
                         f"within the {s_k} keys (0 <= q_offset <= S_k - S_q)")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads over {k.shape[2]} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")


def _grad_needed(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(who: str, *tensors) -> None:
    if _grad_needed(*tensors):
        raise RuntimeError(f"{who}: an input requires grad, and this call's outputs would "
                           "have no grad_fn; go through flash_attention (its autograd "
                           "Function) instead")


def _kernel_device(who: str, q: torch.Tensor, d_v: int) -> None:
    """Raise unless q lies on a CUDA device in a dtype and head sizes the
    kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {q.device}")
    if q.dtype not in _DTYPES or (q.shape[-1], d_v) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{who}: the kernel takes float32 or bf16 at head sizes (q/k, v) "
                         f"{HEAD_DIM_PAIRS}, got {q.dtype} at ({q.shape[-1]}, {d_v})")


def _route(dtype: torch.dtype) -> str:
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _check_tma(who: str, **tensors) -> None:
    """The bf16 kernels load their tiles with TMA: each tensor's address and
    its batch, sequence and head strides (where the axis has more than one
    entry) must be multiples of 16 bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name}'s data is not 16-byte aligned, which the bf16 "
                             "kernel's TMA loads need")
        for axis, label in enumerate(("batch", "sequence", "head")):
            if t.shape[axis] > 1 and t.stride(axis) * t.element_size() % 16:
                raise ValueError(f"{who}: {name}'s {label} stride ({t.stride(axis)} elements) "
                                 "is not a multiple of 16 bytes, which the bf16 kernel's TMA "
                                 "loads need")


def _strides(q, k, v):
    """q's, k's and v's batch, sequence and head strides in elements.  An
    axis of one entry is never stepped along, so it is given its contiguous
    stride whatever the tensor reports."""
    strides = []
    for t in (q, k, v):
        contiguous = (t.shape[1] * t.shape[2] * t.shape[3], t.shape[2] * t.shape[3], t.shape[3])
        strides += [t.stride(i) if t.shape[i] > 1 else contiguous[i] for i in range(3)]
    return (ctypes.c_longlong * 9)(*strides)


def _forward(q, k, v, causal, window, q_offset=0):
    """One forward: B7 on a CUDA tensor, the plain version on a CPU one."""
    _refuse_grad("flash_attention's forward", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    b, s, h, d = q.shape
    d_v = v.shape[-1]
    _kernel_device("flash_attention", q, d_v)
    out = torch.empty((b, s, h, d_v), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b == 0 or s == 0 or h == 0:
        return out, lse
    if q.dtype == torch.bfloat16:
        _check_tma("flash_attention", q=q, k=k, v=v)
    _build.launch("flash_attention", "flash_attention_fwd", _ARGS, q.device, _DTYPES[q.dtype],
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b,
                  s, k.shape[1], q_offset, h, k.shape[2], d, d_v, _strides(q, k, v), int(causal),
                  window or 0, d**-0.5)
    flash_attention.launches += 1
    flash_attention.route_launches[_route(q.dtype)] += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Attention with the B8 backward: ``apply(q, k, v, causal, window,
    q_offset)`` returns ``(out, lse)``; lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset=0):
        out, lse = _forward(q, k, v, causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         window=ctx.window, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal (or, with ``causal=False``, full), optionally windowed,
    attention of Sq query rows from position ``q_offset`` on: (out
    [B, Sq, H, D_v], lse [B, H, Sq])."""
    q_offset = int(q_offset)
    _check(q, k, v, window, q_offset)
    if _grad_needed(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward: (dq [B, Sq, H, D], dk [B, Sk, Hkv, D], dv
    [B, Sk, Hkv, D_v])."""
    q_offset = int(q_offset)
    _check(q, k, v, window, q_offset)
    b, s, h, d = q.shape
    s_k = k.shape[1]
    d_v = v.shape[-1]
    for name, t, shape in (("out", out, (b, s, h, d_v)), ("do", do, (b, s, h, d_v)),
                           ("lse", lse, (b, h, s))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != tuple(shape) \
                or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be {tuple(shape)} on "
                             f"{q.device}, got {getattr(t, 'shape', t)}")
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32, got {lse.dtype}")
    _refuse_grad("flash_attention_bwd", q, k, v, out, do)
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window,
                                       q_offset=q_offset)
    _kernel_device("flash_attention_bwd", q, d_v)
    hkv = k.shape[2]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s_k, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s_k, hkv, d_v), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0 or h == 0:  # no query: the keys get no gradient
        return dq, dk.zero_(), dv.zero_()
    do = do.to(q.dtype).contiguous()
    if q.dtype == torch.bfloat16:
        _check_tma("flash_attention_bwd", q=q, k=k, v=v, do=do)
    dvec = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()   # [B, H, S]
    lse = lse.contiguous()
    _build.launch("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGS, q.device,
                  _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                  lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, s, s_k, q_offset, h, hkv, d, d_v, _strides(q, k, v), int(causal),
                  window or 0, d**-0.5)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.route_launches[_route(q.dtype)] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
flash_attention.route_launches = {"wgmma": 0, "tf32x3": 0}
flash_attention_bwd.route_launches = {"wgmma": 0, "tf32x3": 0}

__all__ = ["FlashAttention", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref"]
