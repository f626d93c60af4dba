"""Wrappers of the ROLANN sufficient-statistics kernels.

Counterparts of ``repro/kernels/rolann_stats/ops.py``, with their contracts:

* :func:`rolann_stats` (B1): (G, M) of one sample block.  Inputs are cast
  to float32 for the kernel, which sums in float32; results come back in the
  promoted input dtype (bf16 in, bf16 out; float64 in, float64 out with
  float32-level error).  ``n == 0``, ``m == 0`` or ``o == 0`` returns zeros.
* :func:`rolann_stats_acc` (B2): B1's statistics of one chunk added into
  running accumulators ``g``, ``mv``.  :func:`rolann_fused_chunk` (B3): the
  whole fold of one ELM-AE chunk (stage-1 product and activation, target
  transform, mask, (G, M)) added into ``g``, ``mv``.  Both sum in float32
  and fold **in place**: the accumulators keep their dtype (float32 ones are
  updated by the kernel directly, others through a float32 copy written
  back) and the call returns the same two tensors, where the reference
  aliased them onto its outputs.  ``n == 0`` (or an empty dimension) returns
  them unchanged, with no launch.
* :func:`rolann_stats_batched` (B4), :func:`rolann_stats_acc_batched` (B5)
  and :func:`rolann_fused_chunk_batched` (B6): the same three over a
  leading tenant axis [k] of every input and accumulator, one launch for
  the whole fleet, with B1–B3's contracts (``k == 0`` is one more empty
  dimension).  B6 takes every tenant's own stage-1 ``w`` [k, m_l, m_c1],
  ``b`` [k, m_c1] and ``mask`` [k, n].

Device, dtype, shape and contiguity are checked, and what a kernel does not
take raises (a column slice ``x[:, a:b]`` is not contiguous, nor is one
tenant's column slice ``xs[:, :, a:b]`` or a broadcast ``expand``).  Dispatch is
by the tensors' device: on the CPU the plain version runs (``*_plain``, the
same contract in plain torch); on a CUDA device the hand-written kernel
(``csrc/``) launches, or the call raises.  Nothing falls back from the card
to the plain version.

Each wrapper counts the calls that launched its kernel in ``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import activations, stats_backend
from repro_torch.kernels import _build
from repro_torch.kernels.rolann_stats.ref import rolann_stats_ref

TILE = 32             # G tile edge of the kernels (kTile in the sources)
CHUNK = 64            # samples per staged chunk (kChunk); slices are multiples
BLOCKS_PER_SM = 8     # partial-kernel blocks to aim for per SM
MIN_SLICE = 1024      # fewest samples worth a slice of their own
MAX_GRID_Z = 65535    # CUDA's limit on gridDim.z (the slices)

_FN = "rolann_stats_f32"
_FN_ACC = "rolann_stats_acc_f32"
_FN_FUSED = "rolann_fused_chunk_f32"
_FN_BATCHED = "rolann_stats_batched_f32"
_FN_ACC_BATCHED = "rolann_stats_acc_batched_f32"
_FN_FUSED_BATCHED = "rolann_fused_chunk_batched_f32"
#: Activations B3 computes on chip, as the source numbers them.
FUSED_ACTS = {"logsig": 0, "tanh": 1}


def _check_tensors(who: str, device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{who}: {name} must be a torch.Tensor")
        if not t.is_floating_point():
            raise TypeError(f"{who}: {name} must be floating, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{who}: {name} is on {t.device}, expected {device}")


def _check(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor, who="rolann_stats") -> None:
    for name, t in (("xa", xa), ("fsq", fsq), ("fd", fd)):
        if isinstance(t, torch.Tensor) and t.ndim != 2:
            raise ValueError(f"{who}: {name} must be 2-D, got {tuple(t.shape)}")
    if not isinstance(xa, torch.Tensor):
        raise TypeError(f"{who}: xa must be a torch.Tensor")
    _check_tensors(who, xa.device, xa=xa, fsq=fsq, fd=fd)
    n = xa.shape[1]
    if fsq.shape != fd.shape or fsq.shape[1] != n:
        raise ValueError(
            f"{who}: expected xa [m, n] and fsq, fd [o, n]; got "
            f"{tuple(xa.shape)}, {tuple(fsq.shape)}, {tuple(fd.shape)}"
        )


def _check_batched(xa, fsq, fd, who) -> None:
    for name, t in (("xa", xa), ("fsq", fsq), ("fd", fd)):
        if isinstance(t, torch.Tensor) and t.ndim != 3:
            raise ValueError(f"{who}: {name} must be 3-D, got {tuple(t.shape)}")
    if not isinstance(xa, torch.Tensor):
        raise TypeError(f"{who}: xa must be a torch.Tensor")
    _check_tensors(who, xa.device, xa=xa, fsq=fsq, fd=fd)
    k, _, n = xa.shape
    if fsq.shape != fd.shape or fsq.shape[0] != k or fsq.shape[2] != n:
        raise ValueError(
            f"{who}: expected xa [k, m, n] and fsq, fd [k, o, n]; got "
            f"{tuple(xa.shape)}, {tuple(fsq.shape)}, {tuple(fd.shape)}"
        )


def _check_acc(who: str, g, mv, o: int, m: int, device: torch.device,
               lead: tuple[int, ...] = ()) -> None:
    _check_tensors(who, device, g=g, mv=mv)
    want_g, want_m = (*lead, o, m, m), (*lead, o, m)
    if tuple(g.shape) != want_g or tuple(mv.shape) != want_m:
        raise ValueError(
            f"{who}: expected accumulators g {list(want_g)} and mv {list(want_m)}; got "
            f"{tuple(g.shape)}, {tuple(mv.shape)}"
        )


def _out_dtype(xa, fsq, fd) -> torch.dtype:
    return torch.promote_types(torch.promote_types(xa.dtype, fsq.dtype), fd.dtype)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when float32, else a float32 copy to fold into."""
    return t if t.dtype == torch.float32 else t.float()


def _store(acc: torch.Tensor, acc32: torch.Tensor) -> None:
    """Write a float32 fold back into the caller's accumulator."""
    if acc32 is not acc:
        acc.copy_(acc32)


def rolann_stats_plain(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """The wrapper's contract in plain torch, on any device: float32 sums of
    the reference einsums, returned in the promoted input dtype."""
    out = _out_dtype(xa, fsq, fd)
    g, mv = rolann_stats_ref(xa.float(), fsq.float(), fd.float())
    return g.to(out), mv.to(out)


def rolann_stats_acc_plain(g, mv, xa, fsq, fd):
    """B2's contract in plain torch: ``(g, mv) += rolann_stats_ref(...)``,
    summed in float32, in place, in the accumulators' dtype."""
    g32, m32 = _f32(g), _f32(mv)
    dg, dm = rolann_stats_ref(xa.float(), fsq.float(), fd.float())
    g32 += dg
    m32 += dm
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def rolann_fused_chunk_plain(g, mv, h, w, b, mask, act_name: str):
    """B3's contract in plain torch: the einsum route of
    ``stats_backend.fused_chunk_acc`` (``_fused_chunk_acc_unbatched``) on
    float32 copies of the inputs, folded in place into ``g``, ``mv``."""
    g32, m32 = _f32(g), _f32(mv)
    stats_backend._fused_chunk_acc_unbatched(
        g32, m32, h.float(), w.float(), b.float(), mask.float(),
        activations.get(act_name),
    )
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def rolann_stats_batched_plain(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """B4's contract in plain torch: :func:`rolann_stats_plain` over the
    tenant axis (float32 sums, the promoted input dtype out)."""
    out = _out_dtype(xa, fsq, fd)
    xa32 = xa.float()
    g = torch.einsum("kin,kon,kjn->koij", xa32, fsq.float(), xa32)
    mv = torch.einsum("kin,kon->koi", xa32, fd.float())
    return g.to(out), mv.to(out)


def rolann_stats_acc_batched_plain(g, mv, xa, fsq, fd):
    """B5's contract in plain torch: :func:`rolann_stats_acc_plain` over the
    tenant axis, in place, in the accumulators' dtype."""
    g32, m32 = _f32(g), _f32(mv)
    dg, dm = rolann_stats_batched_plain(xa.float(), fsq.float(), fd.float())
    g32 += dg
    m32 += dm
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def rolann_fused_chunk_batched_plain(g, mv, h, w, b, mask, act_name: str):
    """B6's contract in plain torch: the einsum route of
    ``stats_backend.fused_chunk_acc_batched`` on float32 copies of the
    inputs, folded in place into ``g``, ``mv``."""
    g32, m32 = _f32(g), _f32(mv)
    stats_backend._fused_chunk_acc_batched_einsum(
        g32, m32, h.float(), w.float(), b.float(), mask.float(),
        activations.get(act_name),
    )
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def plan_slices(m: int, n: int, o: int, sm_count: int) -> tuple[int, int]:
    """(slices, slice_len) for the partial kernel's sample axis.

    ``o`` counts the (tenant, output) pairs of a launch: ``k * o`` for the
    batched kernels, whose grid axis x runs over them.  Enough slices that
    the grid (o, tiles, slices) gives about
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


def _function(library: str, name: str, argtypes):
    fn = getattr(_build.load(library), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _workspace(slices: int, o: int, m: int, dev: torch.device):
    f32 = dict(dtype=torch.float32, device=dev)
    return torch.empty((slices, o, m, m), **f32), torch.empty((slices, o, m), **f32)


def _raise_on(who: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {err}")


def _launch(fn_name: str, xa, fsq, fd, g, mv) -> None:
    """B1/B2 (xa [m, n]) or B4/B5 (xa [k, m, n]) on float32 contiguous CUDA
    tensors, into float32 g, mv."""
    batched = xa.ndim == 3
    k = xa.shape[0] if batched else 1
    m, n = xa.shape[-2:]
    o = fsq.shape[-2]
    dev = xa.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, slice_len = plan_slices(m, n, k * o, sm_count)
    ws_g, ws_m = _workspace(slices, k * o, m, dev)
    args = [_PTR] * 7 + [_I32, _I64, _I32, _I32, _I64, _PTR]
    fn = _function("rolann_stats", fn_name, args[:7] + [_I32] + args[7:] if batched else args)
    shape = (k, m, n, o) if batched else (m, n, o)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xa.data_ptr(), fsq.data_ptr(), fd.data_ptr(), ws_g.data_ptr(),
                 ws_m.data_ptr(), g.data_ptr(), mv.data_ptr(), *shape, slices,
                 slice_len, stream)
    _raise_on(fn_name, err)


def _cuda_or_raise(who: str, device: torch.device) -> None:
    if device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {device}")


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
    _cuda_or_raise("rolann_stats", xa.device)
    f32 = dict(dtype=torch.float32, device=xa.device)
    g, mv = torch.empty((o, m, m), **f32), torch.empty((o, m), **f32)
    _launch(_FN, xa.float(), fsq.float(), fd.float(), g, mv)
    rolann_stats.launches += 1
    return g.to(out), mv.to(out)


def rolann_stats_acc(g: torch.Tensor, mv: torch.Tensor, xa: torch.Tensor,
                     fsq: torch.Tensor, fd: torch.Tensor):
    """Fold one chunk into running stats, in place: (g, mv) += stats(xa, fsq, fd).

    g [o, m, m], mv [o, m]; xa [m, n_chunk]; fsq, fd [o, n_chunk].  Returns
    ``g`` and ``mv`` themselves, in their own dtype.
    """
    who = "rolann_stats_acc"
    _check(xa, fsq, fd, who)
    m, n = xa.shape
    o = fsq.shape[0]
    _check_acc(who, g, mv, o, m, xa.device)
    if n == 0 or m == 0 or o == 0:
        return g, mv
    if xa.device.type == "cpu":
        return rolann_stats_acc_plain(g, mv, xa, fsq, fd)
    _cuda_or_raise(who, xa.device)
    g32, m32 = _f32(g), _f32(mv)
    _launch(_FN_ACC, xa.float(), fsq.float(), fd.float(), g32, m32)
    rolann_stats_acc.launches += 1
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def _check_fused(g, mv, h, w, b, mask, act_name: str) -> None:
    who = "rolann_fused_chunk"
    if act_name not in FUSED_ACTS:
        raise ValueError(f"{who}: act_name must be one of {sorted(FUSED_ACTS)}, got {act_name!r}")
    if not isinstance(h, torch.Tensor):
        raise TypeError(f"{who}: h must be a torch.Tensor")
    _check_tensors(who, h.device, h=h, w=w, b=b, mask=mask)
    if not (h.ndim == 2 and w.ndim == 2 and b.ndim == 1 and mask.ndim == 1
            and w.shape[0] == h.shape[0] and b.shape[0] == w.shape[1]
            and mask.shape[0] == h.shape[1]):
        raise ValueError(f"{who}: expected h [m_l, n], w [m_l, m_c1], b [m_c1], mask [n]; got "
                         f"{tuple(h.shape)}, {tuple(w.shape)}, {tuple(b.shape)}, "
                         f"{tuple(mask.shape)}")
    _check_acc(who, g, mv, h.shape[0], w.shape[1] + 1, h.device)


def rolann_fused_chunk(g: torch.Tensor, mv: torch.Tensor, h: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor, mask: torch.Tensor | None = None,
                       *, act_name: str):
    """Fold one streamed ELM-AE chunk into running stats, in place, the
    activation computed on chip.

    g [o, ma, ma], mv [o, ma] with o == m_l (the auxiliary autoencoder
    reconstructs its input) and ma == m_c1 + 1; h [m_l, n_chunk] is the
    chunk's layer input; w [m_l, m_c1], b [m_c1] the stage-1 encoder;
    mask [n_chunk] weights samples (None: all ones; padded tail columns get 0
    so ragged chunks fold exactly).  ``act_name`` is ``"logsig"`` or
    ``"tanh"``.  Returns ``g`` and ``mv`` themselves, in their own dtype.
    """
    who = "rolann_fused_chunk"
    if mask is None and isinstance(h, torch.Tensor):
        mask = torch.ones((h.shape[-1],), dtype=h.dtype, device=h.device)
    _check_fused(g, mv, h, w, b, mask, act_name)
    m_l, n = h.shape
    m_c1 = w.shape[1]
    if n == 0 or m_l == 0:
        return g, mv
    if h.device.type == "cpu":
        return rolann_fused_chunk_plain(g, mv, h, w, b, mask, act_name)
    _cuda_or_raise(who, h.device)
    g32, m32 = _f32(g), _f32(mv)
    _launch_fused(_FN_FUSED, g32, m32, h.float(), w.float(), b.float(), mask.float(),
                  act_name)
    rolann_fused_chunk.launches += 1
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def _launch_fused(fn_name: str, g, mv, h, w, b, mask, act_name: str) -> None:
    """B3 (h [m_l, n]) or B6 (h [k, m_l, n]) on float32 contiguous CUDA
    tensors, into float32 g, mv."""
    batched = h.ndim == 3
    k = h.shape[0] if batched else 1
    m_l, n = h.shape[-2:]
    m_c1 = w.shape[-1]
    ma = m_c1 + 1
    dev = h.device
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, slice_len = plan_slices(ma, n, k * m_l, sm_count)
    ws_g, ws_m = _workspace(slices, k * m_l, ma, dev)
    args = [_PTR] * 8 + [_I32, _I32, _I64, _I32, _I32, _I64, _PTR]
    fn = _function("rolann_fused_chunk", fn_name, args[:8] + [_I32] + args[8:] if batched else args)
    shape = (k, m_l, m_c1, n) if batched else (m_l, m_c1, n)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(),
                 ws_g.data_ptr(), ws_m.data_ptr(), g.data_ptr(), mv.data_ptr(),
                 *shape, FUSED_ACTS[act_name], slices, slice_len, stream)
    _raise_on(fn_name, err)


def rolann_stats_batched(xa: torch.Tensor, fsq: torch.Tensor, fd: torch.Tensor):
    """Tenant-batched fused statistics, one launch: xa [k, m, n]; fsq, fd
    [k, o, n] -> G [k, o, m, m], M [k, o, m]."""
    who = "rolann_stats_batched"
    _check_batched(xa, fsq, fd, who)
    k, m, n = xa.shape
    o = fsq.shape[1]
    out = _out_dtype(xa, fsq, fd)
    if n == 0 or m == 0 or o == 0 or k == 0:
        return (torch.zeros((k, o, m, m), dtype=out, device=xa.device),
                torch.zeros((k, o, m), dtype=out, device=xa.device))
    if xa.device.type == "cpu":
        return rolann_stats_batched_plain(xa, fsq, fd)
    _cuda_or_raise(who, xa.device)
    f32 = dict(dtype=torch.float32, device=xa.device)
    g, mv = torch.empty((k, o, m, m), **f32), torch.empty((k, o, m), **f32)
    _launch(_FN_BATCHED, xa.float(), fsq.float(), fd.float(), g, mv)
    rolann_stats_batched.launches += 1
    return g.to(out), mv.to(out)


def rolann_stats_acc_batched(g: torch.Tensor, mv: torch.Tensor, xa: torch.Tensor,
                             fsq: torch.Tensor, fd: torch.Tensor):
    """Fold one fleet chunk into every tenant's running stats, in place, one
    launch: g [k, o, m, m], mv [k, o, m]; xa [k, m, n_chunk]; fsq, fd
    [k, o, n_chunk].  Returns ``g`` and ``mv`` themselves."""
    who = "rolann_stats_acc_batched"
    _check_batched(xa, fsq, fd, who)
    k, m, n = xa.shape
    o = fsq.shape[1]
    _check_acc(who, g, mv, o, m, xa.device, (k,))
    if n == 0 or m == 0 or o == 0 or k == 0:
        return g, mv
    if xa.device.type == "cpu":
        return rolann_stats_acc_batched_plain(g, mv, xa, fsq, fd)
    _cuda_or_raise(who, xa.device)
    g32, m32 = _f32(g), _f32(mv)
    _launch(_FN_ACC_BATCHED, xa.float(), fsq.float(), fd.float(), g32, m32)
    rolann_stats_acc_batched.launches += 1
    _store(g, g32)
    _store(mv, m32)
    return g, mv


def _check_fused_batched(g, mv, h, w, b, mask, act_name: str) -> None:
    who = "rolann_fused_chunk_batched"
    if act_name not in FUSED_ACTS:
        raise ValueError(f"{who}: act_name must be one of {sorted(FUSED_ACTS)}, got {act_name!r}")
    if not isinstance(h, torch.Tensor):
        raise TypeError(f"{who}: h must be a torch.Tensor")
    _check_tensors(who, h.device, h=h, w=w, b=b, mask=mask)
    if not (h.ndim == 3 and w.ndim == 3 and b.ndim == 2 and mask.ndim == 2
            and w.shape[:2] == h.shape[:2] and b.shape == (h.shape[0], w.shape[2])
            and mask.shape == (h.shape[0], h.shape[2])):
        raise ValueError(f"{who}: expected h [k, m_l, n], w [k, m_l, m_c1], b [k, m_c1], "
                         f"mask [k, n]; got {tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}, {tuple(mask.shape)}")
    _check_acc(who, g, mv, h.shape[1], w.shape[2] + 1, h.device, (h.shape[0],))


def rolann_fused_chunk_batched(g: torch.Tensor, mv: torch.Tensor, h: torch.Tensor,
                               w: torch.Tensor, b: torch.Tensor,
                               mask: torch.Tensor | None = None, *, act_name: str):
    """:func:`rolann_fused_chunk` for a whole fleet's chunk in one launch, in
    place: g [k, m_l, ma, ma], mv [k, m_l, ma]; h [k, m_l, n_chunk]; each
    tenant's stage-1 encoder w [k, m_l, m_c1], b [k, m_c1]; mask [k, n_chunk]
    (None: all ones).  Returns ``g`` and ``mv`` themselves."""
    who = "rolann_fused_chunk_batched"
    if mask is None and isinstance(h, torch.Tensor) and h.ndim == 3:
        mask = torch.ones((h.shape[0], h.shape[2]), dtype=h.dtype, device=h.device)
    _check_fused_batched(g, mv, h, w, b, mask, act_name)
    k, m_l, n = h.shape
    if n == 0 or m_l == 0 or k == 0:
        return g, mv
    if h.device.type == "cpu":
        return rolann_fused_chunk_batched_plain(g, mv, h, w, b, mask, act_name)
    _cuda_or_raise(who, h.device)
    g32, m32 = _f32(g), _f32(mv)
    _launch_fused(_FN_FUSED_BATCHED, g32, m32, h.float(), w.float(), b.float(),
                  mask.float(), act_name)
    rolann_fused_chunk_batched.launches += 1
    _store(g, g32)
    _store(mv, m32)
    return g, mv


rolann_stats.launches = 0
rolann_stats_acc.launches = 0
rolann_fused_chunk.launches = 0
rolann_stats_batched.launches = 0
rolann_stats_acc_batched.launches = 0
rolann_fused_chunk_batched.launches = 0
