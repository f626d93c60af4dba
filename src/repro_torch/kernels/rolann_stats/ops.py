"""Wrapper of the ROLANN sufficient-statistics kernel.

Counterpart of ``repro/kernels/rolann_stats/ops.py`` ``rolann_stats``, with
its contract:

* inputs are cast to float32 for the kernel, which sums in float32; results
  come back in the promoted input dtype (bf16 in, bf16 out; float64 in,
  float64 out with float32-level error);
* ``n == 0``, ``m == 0`` or ``o == 0`` returns zeros;
* device, dtype, shape and contiguity are checked, and what the kernel does
  not take raises.

Dispatch is by the tensors' device: on the CPU the plain version runs
(:func:`rolann_stats_plain`, the same contract in plain torch); on a CUDA
device the hand-written kernel (``csrc/rolann_stats.cu``) launches, or the
call raises.  Nothing falls back from the card to the plain version.

``rolann_stats.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rolann_stats.ref import rolann_stats_ref

TILE = 32             # G tile edge of the kernel (kTile in the source)
CHUNK = 64            # samples per staged chunk (kChunk); slices are multiples
BLOCKS_PER_SM = 8     # partial-kernel blocks to aim for per SM
MIN_SLICE = 1024      # fewest samples worth a slice of their own
MAX_GRID_Z = 65535    # CUDA's limit on gridDim.z (the slices)

_FN = "rolann_stats_f32"


def _check(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor) -> None:
    for name, t in (("xa", xa), ("fsq", fsq), ("fd", fd)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"rolann_stats: {name} must be a torch.Tensor")
        if t.ndim != 2:
            raise ValueError(f"rolann_stats: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"rolann_stats: {name} must be floating, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"rolann_stats: {name} must be contiguous")
        if t.device != xa.device:
            raise ValueError(
                f"rolann_stats: {name} is on {t.device}, xa on {xa.device}"
            )
    n = xa.shape[1]
    if fsq.shape != fd.shape or fsq.shape[1] != n:
        raise ValueError(
            "rolann_stats: expected xa [m, n] and fsq, fd [o, n]; got "
            f"{tuple(xa.shape)}, {tuple(fsq.shape)}, {tuple(fd.shape)}"
        )


def _out_dtype(xa, fsq, fd) -> torch.dtype:
    return torch.promote_types(torch.promote_types(xa.dtype, fsq.dtype), fd.dtype)


def rolann_stats_plain(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """The wrapper's contract in plain torch, on any device: float32 sums of
    the reference einsums, returned in the promoted input dtype."""
    out = _out_dtype(xa, fsq, fd)
    g, mv = rolann_stats_ref(xa.float(), fsq.float(), fd.float())
    return g.to(out), mv.to(out)


def plan_slices(m: int, n: int, o: int, sm_count: int) -> tuple[int, int]:
    """(slices, slice_len) for the partial kernel's sample axis.

    Enough slices that the grid (o, tiles, slices) gives about
    ``BLOCKS_PER_SM`` blocks per SM, but none narrower than ``MIN_SLICE``
    samples; ``slice_len`` is a multiple of ``CHUNK`` and every slice starts
    below ``n``.  Depends on shapes and the SM count only, so a given card
    sums in the same order on every call.
    """
    tiles = -(-m // TILE)
    per_slice = o * tiles * (tiles + 1) // 2
    want = -(-BLOCKS_PER_SM * sm_count // per_slice)
    slices = max(1, min(want, -(-n // MIN_SLICE), MAX_GRID_Z))
    slice_len = -(-n // slices)
    slice_len = -(-slice_len // CHUNK) * CHUNK
    return -(-n // slice_len), slice_len


def _library() -> ctypes.CDLL:
    lib = _build.load("rolann_stats")
    fn = getattr(lib, _FN)
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 7 + [i32, i64, i32, i32, i64, ptr]
        fn.restype = ctypes.c_int
    return lib


def _launch(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """Run the kernel on float32 contiguous CUDA tensors; returns (G, M)."""
    m, n = xa.shape
    o = fsq.shape[0]
    dev = xa.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, slice_len = plan_slices(m, n, o, sm_count)
    f32 = dict(dtype=torch.float32, device=dev)
    ws_g = torch.empty((slices, o, m, m), **f32)
    ws_m = torch.empty((slices, o, m), **f32)
    g = torch.empty((o, m, m), **f32)
    mv = torch.empty((o, m), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_library(), _FN)(
            xa.data_ptr(), fsq.data_ptr(), fd.data_ptr(), ws_g.data_ptr(),
            ws_m.data_ptr(), g.data_ptr(), mv.data_ptr(), m, n, o, slices,
            slice_len, stream,
        )
    if err != 0:
        raise RuntimeError(f"rolann_stats: kernel launch failed with CUDA error {err}")
    return g, mv


def rolann_stats(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """Fused (G, M) statistics.  xa [m, n]; fsq, fd [o, n] -> G [o, m, m], M [o, m]."""
    _check(xa, fsq, fd)
    m, n = xa.shape
    o = fsq.shape[0]
    out = _out_dtype(xa, fsq, fd)
    if n == 0 or m == 0 or o == 0:
        return (torch.zeros((o, m, m), dtype=out, device=xa.device),
                torch.zeros((o, m), dtype=out, device=xa.device))
    if xa.device.type == "cpu":
        return rolann_stats_plain(xa, fsq, fd)
    if xa.device.type != "cuda":
        raise ValueError(f"rolann_stats: no kernel for device {xa.device}")
    g, mv = _launch(xa.float(), fsq.float(), fd.float())
    rolann_stats.launches += 1
    return g.to(out), mv.to(out)


rolann_stats.launches = 0
