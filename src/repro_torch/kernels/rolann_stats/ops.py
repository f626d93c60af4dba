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

Each wrapper counts the calls that launched its kernel in ``.launches``;
``rolann_stats.route_launches`` splits B1's count by route: ``"tf32x3"``
(m > ``SMALL_M``: the tensor-core kernel of ``csrc/rolann_stats_sm90.cuh``),
``"slice"`` (m <= ``SMALL_M`` and o <= ``FUSED_MAX_OUTPUTS``: a block per
tenant and sample slice staging xa once for all outputs,
``csrc/rolann_stats_slice.cuh``) or ``"fp32"`` (the FP32-core
``partial_kernel``), chosen by shape as :func:`tensor_core_route` and
:func:`stats_slice_route` say; ``rolann_stats_acc.route_launches`` splits
B2's (``"slice"`` or ``"fp32"``), ``rolann_stats_batched.route_launches``
B4's and ``rolann_stats_acc_batched.route_launches`` B5's by the same rule;
``rolann_fused_chunk.route_launches`` and
``rolann_fused_chunk_batched.route_launches`` split B3's and B6's:
``"slice"`` (a block per sample slice, and tenant, forming its activations
once, ``csrc/rolann_fused_slice.cuh``) or ``"tile"``
(``fused_partial_kernel``, a block per output and G tile), as
:func:`fused_slice_route` says.  The slice routes share one fold
(``csrc/rolann_slice_fold.cuh``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import activations, stats_backend
from repro_torch.kernels import _build
from repro_torch.kernels.rolann_stats.ref import rolann_stats_ref

TILE = 32             # G tile edge of the kernels (kTile in the sources)
CHUNK = 64            # samples per staged chunk (kChunk); slices are multiples
BLOCKS_PER_SM = 8     # partial-kernel blocks to aim for per SM
MIN_SLICE = 1024      # fewest samples worth a slice of their own
MAX_GRID_Z = 65535    # CUDA's limit on gridDim.z (the slices)
SMALL_M = 28          # largest m of the one-warp layout (kSmallM)
# B1's tensor-core route (rolann_stats_sm90.cuh): 64-row tiles, 4 outputs
# per block, 32-sample steps, two blocks per SM.
TC_TILE, TC_OUTPUTS, TC_STEP, TC_BLOCKS_PER_SM = 64, 4, 32, 2
# Most samples one accumulator of that route sums (kRunSamples in the
# source).  The tensor cores add each wgmma's product into the float32
# accumulator rounding toward zero, so a long run of adds drifts low: 2,048
# samples (768 adds) stay below a quarter of the 1e-4 bar, 10,007 (3,753
# adds) used 1.2 of it (PERF.md).  A block sums its slice in runs of this
# many samples, and the runs on the FP32 cores, so slices need no cap.
TC_MAX_SLICE = 2048
# The slice routes (rolann_slice_fold.cuh): B3 and B6 with ma <= SMALL_M
# (one G tile of 4x4 pieces a warp's lanes cover) and at most
# FUSED_MAX_OUTPUTS outputs (four a warp), B1, B2, B4 and B5 with m <=
# SMALL_M and as many outputs; slices of whole FUSED_STEP-sample steps.  B3
# (one tenant) plans about FUSED_BLOCKS_PER_SM blocks per SM (more steps a
# block beyond that).  B4, B5 and B6 plan a few slices a tenant: as many as give
# SLICE_BLOCKS_PER_SM blocks on every SM (the two a kernel's launch bounds
# keep resident), none shorter than SLICE_MIN_STEPS steps (a slice's
# partials, m_l (m (m + 1) / 2 + m) floats, outweigh a few steps' inputs).
# B1 and B2 (one tenant) plan as many blocks, none shorter than
# STATS_MIN_STEPS steps.
FUSED_STEP, FUSED_MAX_OUTPUTS, FUSED_BLOCKS_PER_SM = 64, 32, 3
SLICE_BLOCKS_PER_SM, SLICE_MIN_STEPS, STATS_MIN_STEPS = 2, 4, 1

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


def _store(acc: torch.Tensor, acc32: torch.Tensor, *, raw: bool = False) -> None:
    """Write a float32 fold back into the caller's accumulator.  ``raw``: a
    kernel folded into ``acc32`` through its data pointer, which moves no
    version counter, so the caller's float32 accumulator gets its version
    bumped here, as the plain versions' in-place additions bump it; autograd
    and ``analysis.donation.probe`` then see the card's fold as the host's."""
    if acc32 is not acc:
        acc.copy_(acc32)
    elif raw:
        torch.autograd.graph.increment_version(acc)


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


def tensor_core_route(k: int, m: int, accumulate: bool) -> bool:
    """Whether a launch takes the tensor-core kernel: one tenant, no running
    accumulators, m > ``SMALL_M`` (the rule of ``launch()`` in
    ``csrc/rolann_stats.cu``)."""
    return k == 1 and not accumulate and m > SMALL_M


def plan_slices_tf32x3(m: int, n: int, o: int, sm_count: int) -> tuple[int, int]:
    """(slices, slice_len) for the tensor-core route, for occupancy only:
    more than one slice only where the (tile pair, output group) blocks
    alone give fewer than ``TC_BLOCKS_PER_SM`` per SM, none narrower than
    ``MIN_SLICE``; ``slice_len`` a multiple of ``TC_STEP`` and every slice
    starting below ``n``.  The count does not grow with ``n`` (each block
    sums its slice in runs of ``TC_MAX_SLICE`` samples).  One slice (the
    DAEF head) writes G directly, with no workspace and no reduce pass."""
    tiles = -(-m // TC_TILE)
    per_slice = tiles * (tiles + 1) // 2 * -(-o // TC_OUTPUTS)
    want = -(-TC_BLOCKS_PER_SM * sm_count // per_slice)
    slices = max(1, min(want, -(-n // MIN_SLICE), MAX_GRID_Z))
    slice_len = -(-n // slices)
    slice_len = -(-slice_len // TC_STEP) * TC_STEP
    return -(-n // slice_len), slice_len


def fused_slice_route(k: int, m_l: int, m_c1: int) -> bool:
    """Whether a B3/B6 launch of ``k`` tenants takes the slice kernel: ma =
    m_c1 + 1 <= ``SMALL_M`` and at most ``FUSED_MAX_OUTPUTS`` outputs
    (``slice::takes`` in ``csrc/rolann_fused_slice.cuh``).  Every hidden
    layer of the streamed creditcard fit and of the chunked fleet fit takes
    it."""
    return k >= 1 and m_c1 + 1 <= SMALL_M and 1 <= m_l <= FUSED_MAX_OUTPUTS


def stats_slice_route(m: int, o: int) -> bool:
    """Whether a B1, B2, B4 or B5 launch takes the slice kernel: m <=
    ``SMALL_M`` and at most ``FUSED_MAX_OUTPUTS`` outputs, any number of
    tenants (``slice::stats_takes`` in ``csrc/rolann_stats_slice.cuh``).
    Every layer of the one-shot creditcard fit (B1) and of the fleet fit
    (B4) takes it, and the last layer of the logistic-output streamed fit
    (B2) and chunked fleet fit (B5)."""
    return 1 <= m <= SMALL_M and 1 <= o <= FUSED_MAX_OUTPUTS


@functools.lru_cache(maxsize=256)
def plan_fused_slices(n: int, sm_count: int) -> tuple[int, int]:
    """(slices, slice_len) for B3's slice kernel: about
    ``FUSED_BLOCKS_PER_SM`` blocks per SM, each a whole number of
    ``FUSED_STEP``-sample steps, every slice starting below ``n``.  The
    count does not grow with ``n``, nor the workspace."""
    slices = max(1, min(-(-n // FUSED_STEP), FUSED_BLOCKS_PER_SM * sm_count))
    slice_len = -(-n // slices)
    slice_len = -(-slice_len // FUSED_STEP) * FUSED_STEP
    return -(-n // slice_len), slice_len


@functools.lru_cache(maxsize=256)
def plan_batched_slices(k: int, n: int, sm_count: int,
                        min_steps: int = SLICE_MIN_STEPS) -> tuple[int, int]:
    """(slices a tenant, slice_len) for B4's, B5's and B6's slice kernels, whose
    grid is (tenant, slice): as many slices as give ``SLICE_BLOCKS_PER_SM``
    blocks on each SM, each at least ``min_steps`` whole
    ``FUSED_STEP``-sample steps (one slice where n is shorter), every slice
    starting below ``n``.  The count does not grow with ``n``, nor the
    workspace; it depends on shapes and the SM count only, so a card sums in
    one order.  The fleet's 1,024-sample chunks of 64 tenants take 4 slices
    of 256 on a 132-SM card."""
    steps = -(-n // FUSED_STEP)
    slices = max(1, min(SLICE_BLOCKS_PER_SM * sm_count // k, steps // min_steps))
    slice_len = -(-steps // slices) * FUSED_STEP
    return -(-n // slice_len), slice_len


def plan_stats_slices(n: int, sm_count: int) -> tuple[int, int]:
    """(slices, slice_len) for B1 and B2 on the slice kernel, one tenant
    (grid (1, slices)): :func:`plan_batched_slices` for k = 1 with slices of
    at least ``STATS_MIN_STEPS`` steps, so hundreds of them, summed by the
    block-per-row reduce.  On a 132-SM card the one-shot creditcard fit's
    255,883 samples take 250 slices of 1,024, a streamed 32,768-sample chunk
    256 of 128."""
    return plan_batched_slices(1, n, sm_count, STATS_MIN_STEPS)


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C entry points' argument types: B1/B2 (and with k, B4/B5), B3 (B6).
_ARGS = [_PTR] * 7 + [_I32, _I64, _I32, _I32, _I64, _PTR]
_ARGS_BATCHED = _ARGS[:7] + [_I32] + _ARGS[7:]
_ARGS_FUSED = [_PTR] * 8 + [_I32, _I32, _I64, _I32, _I32, _I64, _PTR]
_ARGS_FUSED_BATCHED = _ARGS_FUSED[:8] + [_I32] + _ARGS_FUSED[8:]


def _g_floats(m: int, packed: bool) -> int:
    """Floats of one partial G: m (m + 1) / 2 packed, else m * m."""
    return m * (m + 1) // 2 if packed else m * m


def _workspace(slices: int, o: int, m: int, dev: torch.device, packed: bool = False):
    """Scratch for the slices' partial G [slices, o, m, m] (``packed``: the
    upper triangles packed by rows, [slices, o, m (m + 1) / 2]) and M
    [slices, o, m], one allocation: (the buffer, G's address, M's address).
    The caller keeps the buffer until its launch is enqueued."""
    g_size = _g_floats(m, packed)
    buf = torch.empty(slices * o * (g_size + m), dtype=torch.float32, device=dev)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * slices * o * g_size


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    """SMs of CUDA device ``index`` (the planners' input), looked up once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_stats(k: int, m: int, n: int, o: int, accumulate: bool,
               sm_count: int) -> tuple[bool, int, int, int]:
    """(tensor_cores, slices, slice_len, workspace slices) of a B1, B2, B4
    or B5 launch off the slice route (the tensor cores or
    ``partial_kernel``).  One slice of the tensor-core route writes g and
    mv directly, with no workspace."""
    tensor_cores = tensor_core_route(k, m, accumulate)
    plan = plan_slices_tf32x3 if tensor_cores else plan_slices
    slices, slice_len = plan(m, n, k * o, sm_count)
    return tensor_cores, slices, slice_len, 0 if tensor_cores and slices == 1 else slices


def stats_route(k: int, m: int, o: int, accumulate: bool, batched: bool = False) -> str:
    """The kernel a launch of B1, B2 (``accumulate``), B4 (``batched``) or B5
    (both) takes by shape, the rule of ``launch()`` in
    ``csrc/rolann_stats.cu``: ``"slice"`` where :func:`stats_slice_route`
    holds; ``"tf32x3"`` where :func:`tensor_core_route` holds; else
    ``"fp32"`` (``partial_kernel``).  The rule is the same for the four
    entries, so ``batched`` does not change the route."""
    del batched
    if stats_slice_route(m, o):
        return "slice"
    return "tf32x3" if tensor_core_route(k, m, accumulate) else "fp32"


def _plan_launch(k: int, m: int, n: int, o: int, accumulate: bool, batched: bool,
                 sm_count: int) -> tuple[str, int, int, int, bool]:
    """(route, slices, slice_len, workspace slices, packed partials) of a
    B1, B2, B4 or B5 launch: the slice route has packed partials, B4 and B5
    a few slices a tenant and B1 and B2 hundreds; the others
    :func:`plan_stats`'s."""
    route = stats_route(k, m, o, accumulate, batched)
    if route == "slice":
        slices, slice_len = (plan_batched_slices(k, n, sm_count) if batched
                             else plan_stats_slices(n, sm_count))
        return route, slices, slice_len, slices, True
    _, slices, slice_len, ws = plan_stats(k, m, n, o, accumulate, sm_count)
    return route, slices, slice_len, ws, False


def workspace_bytes(k: int, m: int, n: int, o: int, accumulate: bool, sm_count: int,
                    batched: bool = False) -> int:
    """Bytes of scratch a B1, B2 or (``batched``) B4, B5 launch allocates."""
    _, _, _, ws, packed = _plan_launch(k, m, n, o, accumulate, batched, sm_count)
    return 4 * ws * k * o * (_g_floats(m, packed) + m)


def fused_workspace_bytes(k: int, m_l: int, m_c1: int, n: int, sm_count: int,
                          batched: bool) -> int:
    """Bytes of scratch a B3 or B6 (``batched``) launch allocates."""
    slices, _, packed = _plan_fused(k, m_l, m_c1, n, sm_count, batched)
    ma = m_c1 + 1
    return 4 * slices * k * m_l * (_g_floats(ma, packed) + ma)


def _launch(fn_name: str, xa, fsq, fd, g, mv) -> str:
    """B1/B2 (xa [m, n]) or B4/B5 (xa [k, m, n]) on float32 contiguous CUDA
    tensors, into float32 g, mv; the route it took ("slice", "fp32" or, for
    B1 and B4, "tf32x3")."""
    batched = xa.ndim == 3
    k = xa.shape[0] if batched else 1
    m, n = xa.shape[-2:]
    o = fsq.shape[-2]
    dev = xa.device
    route, slices, slice_len, ws, packed = _plan_launch(
        k, m, n, o, fn_name in (_FN_ACC, _FN_ACC_BATCHED), batched, _sm_count(dev.index))
    scratch, ws_g, ws_m = _workspace(ws, k * o, m, dev, packed)  # alive until the launch
    shape = (k, m, n, o) if batched else (m, n, o)
    _build.launch("rolann_stats", fn_name, _ARGS_BATCHED if batched else _ARGS, dev,
                  xa.data_ptr(), fsq.data_ptr(), fd.data_ptr(), ws_g, ws_m, g.data_ptr(),
                  mv.data_ptr(), *shape, slices, slice_len)
    return route


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
    route = _launch(_FN, xa.float(), fsq.float(), fd.float(), g, mv)
    rolann_stats.launches += 1
    rolann_stats.route_launches[route] += 1
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
    route = _launch(_FN_ACC, xa.float(), fsq.float(), fd.float(), g32, m32)
    rolann_stats_acc.launches += 1
    rolann_stats_acc.route_launches[route] += 1
    _store(g, g32, raw=True)
    _store(mv, m32, raw=True)
    return g, mv


def _check_fused(g, mv, h, w, b, mask, act_name: str) -> None:
    who = "rolann_fused_chunk"
    if act_name not in FUSED_ACTS:
        raise ValueError(f"{who}: act_name must be one of {sorted(FUSED_ACTS)}, got {act_name!r}")
    if not isinstance(h, torch.Tensor):
        raise TypeError(f"{who}: h must be a torch.Tensor")
    dev = h.device
    _check_tensors(who, dev, h=h, w=w, b=b, mask=mask)
    hs, ws, bs, ms = h.shape, w.shape, b.shape, mask.shape
    if not (len(hs) == 2 and len(ws) == 2 and len(bs) == 1 and len(ms) == 1
            and ws[0] == hs[0] and bs[0] == ws[1] and ms[0] == hs[1]):
        raise ValueError(f"{who}: expected h [m_l, n], w [m_l, m_c1], b [m_c1], mask [n]; got "
                         f"{tuple(hs)}, {tuple(ws)}, {tuple(bs)}, {tuple(ms)}")
    _check_acc(who, g, mv, hs[0], ws[1] + 1, dev)


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
    route = _launch_fused(_FN_FUSED, g32, m32, _f32(h), _f32(w), _f32(b), _f32(mask),
                          act_name)
    rolann_fused_chunk.launches += 1
    rolann_fused_chunk.route_launches[route] += 1
    _store(g, g32, raw=True)
    _store(mv, m32, raw=True)
    return g, mv


def _plan_fused(k: int, m_l: int, m_c1: int, n: int, sm_count: int,
                batched: bool) -> tuple[int, int, bool]:
    """(slices, slice_len, slice route) of a B3 or B6 (``batched``) launch:
    the slice route plans B3's many slices of one chunk or B6's few a
    tenant; the tile route plans for the k·m_l (tenant, output) pairs."""
    if fused_slice_route(k, m_l, m_c1):
        plan = plan_batched_slices(k, n, sm_count) if batched else plan_fused_slices(n, sm_count)
        return *plan, True
    return *plan_slices(m_c1 + 1, n, k * m_l, sm_count), False


def _launch_fused(fn_name: str, g, mv, h, w, b, mask, act_name: str) -> str:
    """B3 (h [m_l, n]) or B6 (h [k, m_l, n]) on float32 contiguous CUDA
    tensors, into float32 g, mv; the route it took ("slice" or "tile")."""
    batched = h.ndim == 3
    k = h.shape[0] if batched else 1
    m_l, n = h.shape[-2:]
    m_c1 = w.shape[-1]
    ma = m_c1 + 1
    dev = h.device
    slices, slice_len, slice_route = _plan_fused(k, m_l, m_c1, n, _sm_count(dev.index), batched)
    scratch, ws_g, ws_m = _workspace(slices, k * m_l, ma, dev, packed=slice_route)
    shape = (k, m_l, m_c1, n) if batched else (m_l, m_c1, n)
    _build.launch("rolann_fused_chunk", fn_name,
                  _ARGS_FUSED_BATCHED if batched else _ARGS_FUSED, dev, h.data_ptr(),
                  w.data_ptr(), b.data_ptr(), mask.data_ptr(), ws_g, ws_m, g.data_ptr(),
                  mv.data_ptr(), *shape, FUSED_ACTS[act_name], slices, slice_len)
    return "slice" if slice_route else "tile"


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
    route = _launch(_FN_BATCHED, xa.float(), fsq.float(), fd.float(), g, mv)
    rolann_stats_batched.launches += 1
    rolann_stats_batched.route_launches[route] += 1
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
    route = _launch(_FN_ACC_BATCHED, xa.float(), fsq.float(), fd.float(), g32, m32)
    rolann_stats_acc_batched.launches += 1
    rolann_stats_acc_batched.route_launches[route] += 1
    _store(g, g32, raw=True)
    _store(mv, m32, raw=True)
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
    route = _launch_fused(_FN_FUSED_BATCHED, g32, m32, h.float(), w.float(), b.float(),
                          mask.float(), act_name)
    rolann_fused_chunk_batched.launches += 1
    rolann_fused_chunk_batched.route_launches[route] += 1
    _store(g, g32, raw=True)
    _store(mv, m32, raw=True)
    return g, mv


rolann_stats.launches = 0
rolann_stats.route_launches = {"tf32x3": 0, "fp32": 0, "slice": 0}
rolann_stats_acc.launches = 0
rolann_stats_acc.route_launches = {"slice": 0, "fp32": 0}
rolann_fused_chunk.launches = 0
rolann_fused_chunk.route_launches = {"slice": 0, "tile": 0}
rolann_stats_batched.launches = 0
rolann_stats_batched.route_launches = {"slice": 0, "fp32": 0, "tf32x3": 0}
rolann_stats_acc_batched.launches = 0
rolann_stats_acc_batched.route_launches = {"slice": 0, "fp32": 0}
rolann_fused_chunk_batched.launches = 0
rolann_fused_chunk_batched.route_launches = {"slice": 0, "tile": 0}
