#!/usr/bin/env python3
"""Measure the port's slice-route statistics kernels (B1, B2, B4, B5, B6)
and B3's bits on one NVIDIA card.

    python3 scripts/torch_fleet_kernels.py profile      # the fits under the profiler
    python3 scripts/torch_fleet_kernels.py bits DIR     # B3 against DIR's sources
    python3 scripts/torch_fleet_kernels.py sweep        # time by slices (per tenant)

Run from the root of a checkout.  ``profile`` fits the one-tenant cell of
``chip_smoke.py`` (the full-scale creditcard replica, 255,883 samples)
one-shot (B1), streamed at 32,768-sample chunks (B3) and so with a
logistic output layer on [0, 1] data (B2, and B3), then its fleet cell (64
creditcard tenants of 3,998 samples) one-shot (B4), chunked at 1,024
samples and streamed from host chunks of 1,024 (B6), and chunked with a
logistic output layer on [0, 1] data (B5, and B6): each fit's host-clock
time (median of 5, ending in
``torch.cuda.synchronize()``), then one fit under ``torch.profiler`` with
its trace written to ``build/traces/``, from which every kernel's launches,
device time per launch, grid, block, registers and shared memory are
printed, and the device's busy share of the wall time.  It uses only entry
points an older checkout has too, so a copy of this script in an older
checkout's ``scripts/`` profiles that checkout alike.

``bits DIR`` builds ``rolann_fused_chunk.cu`` from the sources under DIR
(an unpacked older checkout) and runs its B3 entry point beside this
checkout's on the streamed creditcard fit's four hidden-layer shapes, at
the full 32,768-sample chunk and the ragged masked 26,507-sample one: G and
M must be the same bits; both entry points are timed with CUDA events
(median of 25) in turns (old, new, new, old), called as the wrapper calls
them, and the wrapper itself once.

``sweep`` times one launch of B6 at the fleet's four hidden-layer shapes
(k = 64, 1,024 samples), of B4 at its four (k = 64, 3,998 samples) and of
B5 at the logistic-output chunked fleet fit's (28, 29) (k = 64, 1,024
samples) with 1, 2, 4, 8 and 16 slices per tenant, then of B1 at the one-shot creditcard
fit's four (one tenant, 255,883 samples) and of B2 at the logistic-output
streamed fit's (28, 29) (one tenant, 32,768 samples) with slices of 1, 2,
4, 8, 16 and 32 steps of 64 samples; each beside the planner's choice.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "traces"


PORT_KERNELS = ("rolann", "partial_kernel", "slice_kernel", "reduce_kernel")


def _trace(path: Path) -> tuple[float, list[dict]]:
    """(the trace's span in µs, its kernel events)."""
    events = json.loads(path.read_text())["traceEvents"]
    timed = [e for e in events if "ts" in e and "dur" in e]
    span = (max(float(e["ts"]) + float(e["dur"]) for e in timed)
            - min(float(e["ts"]) for e in timed))
    return span, [e for e in events if e.get("cat") == "kernel"]


def profile_fit(label: str, run) -> None:
    """Host-clock time of ``run`` (median of 5), then one run under the
    profiler: busy share, the port's kernels per (name, grid) with their
    launches, µs each, block, registers and shared memory, and the five
    other kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"trace_{label.replace(' ', '_')}.json"
    prof.export_chrome_trace(str(path))
    span, kernels = _trace(path)
    busy = sum(float(e["dur"]) for e in kernels)
    cs.say("profile", f"{label}: host clock {statistics.median(host):.3f} ms (median of 5: "
           + ", ".join(f"{t:.3f}" for t in host) + f"); under the profiler wall "
           f"{wall * 1e3:.3f} ms, trace span {span / 1e3:.3f} ms, {len(kernels)} kernels busy "
           f"{busy / 1e3:.4f} ms ({100 * busy / span:.1f} % of the span)")
    port, other = {}, {}
    for e in kernels:
        a = e.get("args", {})
        if any(p in e["name"] for p in PORT_KERNELS):
            key = (e["name"].split("(")[0], tuple(a.get("grid", ())), tuple(a.get("block", ())),
                   a.get("registers per thread"), a.get("shared memory"))
            port.setdefault(key, []).append(float(e["dur"]))
        else:
            other.setdefault(e["name"][:80], []).append(float(e["dur"]))
    for (name, grid, block, regs, smem), d in sorted(port.items()):
        cs.say("profile", f"{label}: {name} grid {list(grid)} block {list(block)} {regs} "
               f"registers {smem} B shared: {len(d)} launches, "
               + ", ".join(f"{x:.2f}" for x in d) + " µs")
    for name, d in sorted(other.items(), key=lambda kv: -sum(kv[1]))[:5]:
        cs.say("profile", f"{label}: {name}: {len(d)} launches, {sum(d):.1f} µs")


def cmd_profile() -> None:
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import daef, fleet
    from repro_torch.kernels import _build

    cs.say("device", cs.phase_device())
    _build.build("rolann_stats", "rolann_fused_chunk")
    for name in ("rolann_stats", "rolann_fused_chunk"):
        cs._say_ptxas_named(name)
    cfg = daef.DAEFConfig(**cs.CREDITCARD, stats_backend="fused")
    (x_train, _, _), (xtr, _) = cs.load_data()
    profile_fit("one-shot fit", lambda: daef.fit(cfg, xtr, n_partitions=cs.N_PARTITIONS))
    profile_fit("streamed fit", lambda: daef.fit_chunked(cfg, xtr,
                                                         chunk_samples=cs.CHUNK_SAMPLES))
    # chip_smoke.py's B2 path: a logistic last layer on the replica rescaled
    # feature by feature into [0, 1]
    lo, hi = x_train.min(axis=1, keepdims=True), x_train.max(axis=1, keepdims=True)
    x01 = torch.as_tensor((x_train - lo) / np.where(hi > lo, hi - lo, 1.0), device="cuda")
    cfg_l = dataclasses.replace(cfg, act_last="logsig")
    profile_fit("logistic-output streamed fit", lambda: daef.fit_chunked(
        cfg_l, x01, chunk_samples=cs.CHUNK_SAMPLES))
    (xs, seeds, _, _), (xs_d, _) = cs.load_fleet_data()
    profile_fit("fleet fit", lambda: fleet._fit_fleet(cfg, xs_d, seeds=seeds))
    profile_fit("chunked fleet fit", lambda: fleet._fit_fleet_chunked(
        cfg, xs_d, chunk_samples=cs.FLEET_CHUNK, seeds=seeds))
    n = xs.shape[2]
    profile_fit("streamed fleet fit", lambda: fleet._fit_fleet_stream(
        cfg, lambda: (xs[:, :, i:i + cs.FLEET_CHUNK] for i in range(0, n, cs.FLEET_CHUNK)),
        seeds=seeds))
    # chip_smoke.py's B5 path: a logistic last layer on each tenant's data
    # rescaled feature by feature into [0, 1]
    lo, hi = xs.min(axis=2, keepdims=True), xs.max(axis=2, keepdims=True)
    x01 = torch.as_tensor((xs - lo) / np.where(hi > lo, hi - lo, 1.0), device="cuda")
    profile_fit("logistic-output chunked fleet fit", lambda: fleet._fit_fleet_chunked(
        cfg_l, x01, chunk_samples=cs.FLEET_CHUNK, seeds=seeds))


def _fused_args(m_l, m_c1, n, act, masked, seed):
    import torch

    h, w, b, mask = cs._fused_inputs(m_l, m_c1, n, act, masked, seed)
    g0, m0 = cs._running(m_l, m_c1 + 1, torch.float32, seed + 1)
    return h, w, b, mask, g0, m0


def cmd_bits(old_root: str) -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rolann_stats import ops, rolann_fused_chunk

    card = cs.phase_device()
    src = Path(old_root) / "src/repro_torch/kernels/rolann_stats/csrc/rolann_fused_chunk.cu"
    lib_path = ROOT / "build" / "old_rolann_fused_chunk.so"
    lib_path.parent.mkdir(exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    old = ctypes.CDLL(str(lib_path)).rolann_fused_chunk_f32
    old.argtypes, old.restype = ops._ARGS_FUSED, ctypes.c_int
    _build.build("rolann_fused_chunk")
    cs._say_ptxas_named("rolann_fused_chunk")
    sms = ops._sm_count(0)

    new = _build.function("rolann_fused_chunk", ops._FN_FUSED, ops._ARGS_FUSED)

    def raw(fn, g, mv, h, w, b, mask, act):
        """One B3 call of ``fn`` (a library's entry point) as the wrapper
        makes it: the same plan and workspace, no checks."""
        m_l, n = h.shape
        m_c1 = w.shape[1]
        slices, slice_len = ops.plan_fused_slices(n, sms)
        scratch, ws_g, ws_m = ops._workspace(slices, m_l, m_c1 + 1, h.device, packed=True)
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(), ws_g, ws_m,
                 g.data_ptr(), mv.data_ptr(), m_l, m_c1, n, ops.FUSED_ACTS[act], slices,
                 slice_len, torch.cuda.current_stream().cuda_stream)
        _build.raise_on("rolann_fused_chunk_f32", err)

    total = {"old": 0.0, "new": 0.0, "wrapper": 0.0}
    for i, (m_l, m_c1) in enumerate(((15, 18), (18, 21), (21, 24), (24, 27))):
        for n, act, masked in ((cs.CHUNK_SAMPLES, "logsig", False), (26_507, "tanh", True)):
            h, w, b, mask, g0, m0 = _fused_args(m_l, m_c1, n, act, masked, 50 + i)
            g_new, m_new, g_old, m_old = g0.clone(), m0.clone(), g0.clone(), m0.clone()
            rolann_fused_chunk(g_new, m_new, h, w, b, mask, act_name=act)
            raw(old, g_old, m_old, h, w, b, mask, act)
            torch.cuda.synchronize()
            same = torch.equal(g_new, g_old) and torch.equal(m_new, m_old)
            cs.check(same, f"B3 ({m_l}, {m_c1}) n={n}: not the old kernel's bits")
            times = {"old": [], "new": []}
            for which in ("old", "new", "new", "old"):
                g, mv = g0.clone(), m0.clone()
                fn = old if which == "old" else new
                times[which].append(cs.cuda_ms(lambda: raw(fn, g, mv, h, w, b, mask, act)))
            g, mv = g0.clone(), m0.clone()
            wrapped = cs.cuda_ms(lambda: rolann_fused_chunk(g, mv, h, w, b, mask, act_name=act))
            if n == cs.CHUNK_SAMPLES:
                for k in ("old", "new"):
                    total[k] += statistics.mean(times[k])
                total["wrapper"] += wrapped
            cs.say("bits", f"B3 ({m_l}, {m_c1}) n={n} {act}{' masked' if masked else ''}: "
                   "same bits as the old kernel; ms a call (entry point, in turns) old "
                   + ", ".join(f"{t:.4f}" for t in times["old"]) + ", new "
                   + ", ".join(f"{t:.4f}" for t in times["new"])
                   + f"; through the wrapper {wrapped:.4f}")
    cs.say("bits", f"per streamed fit (8 calls a layer at {cs.CHUNK_SAMPLES} samples): old "
           f"{8 * total['old']:.4f} ms, new {8 * total['new']:.4f} ms, new through the "
           f"wrapper {8 * total['wrapper']:.4f} ms; {card}")


def _say_sweep(label, fn, slices, slice_len, plan) -> None:
    ms = cs.cuda_ms(fn)
    times = cs._kernel_us(fn, ("slice_kernel", "slice_reduce_kernel"))
    cs.say("sweep", f"{label}: {slices} slices a tenant of {slice_len}"
           f"{' (planned)' if (slices, slice_len) == plan else ''}: {ms:.4f} ms a launch on "
           "CUDA events; device " + ", ".join(f"{name} {us:.2f} µs"
                                              for name, (_, us) in sorted(times.items())))


def cmd_sweep() -> None:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.rolann_stats import ops

    card = cs.phase_device()
    _build.build("rolann_stats", "rolann_fused_chunk")
    for name in ("rolann_stats", "rolann_fused_chunk"):
        cs._say_ptxas_named(name)
    sms = ops._sm_count(0)
    k = 64
    for m_l, m_c1 in ((15, 18), (18, 21), (21, 24), (24, 27)):
        n, ma = cs.FLEET_CHUNK, m_c1 + 1
        parts = [_fused_args(m_l, m_c1, n, "logsig", False, 70 + t) for t in range(k)]
        h, w, b, mask, g, mv = (torch.stack(p).contiguous() for p in zip(*parts))
        plan = ops.plan_batched_slices(k, n, sms)
        for per in sorted({1, 2, 4, 8, 16, plan[0]}):
            slice_len = -(-n // per // ops.FUSED_STEP) * ops.FUSED_STEP
            slices = -(-n // slice_len)
            scratch, ws_g, ws_m = ops._workspace(slices, k * m_l, ma, h.device, packed=True)
            args = (h.data_ptr(), w.data_ptr(), b.data_ptr(), mask.data_ptr(), ws_g, ws_m,
                    g.data_ptr(), mv.data_ptr(), k, m_l, m_c1, n, 0, slices, slice_len)
            def fn():
                _build.launch("rolann_fused_chunk", ops._FN_FUSED_BATCHED,
                              ops._ARGS_FUSED_BATCHED, h.device, *args)

            _say_sweep(f"B6 k={k} ({m_l}, {m_c1}) n={n}", fn, slices, slice_len, plan)
    batched = [("B4", ops._FN_BATCHED, m, o, 3_998) for m, o in ((19, 15), (22, 18), (25, 21),
                                                                (28, 24))]
    batched.append(("B5", ops._FN_ACC_BATCHED, 28, 29, cs.FLEET_CHUNK))
    for name, fn_name, m, o, n in batched:
        parts = [cs._stats_inputs(m, o, n, torch.float32, 90 + t) for t in range(k)]
        xa, fsq, fd = (torch.stack(p).contiguous() for p in zip(*parts))
        g = torch.zeros((k, o, m, m), device="cuda")
        mv = torch.zeros((k, o, m), device="cuda")
        plan = ops.plan_batched_slices(k, n, sms)
        for per in sorted({1, 2, 4, 8, 16, plan[0]}):
            slice_len = -(-n // per // ops.FUSED_STEP) * ops.FUSED_STEP
            slices = -(-n // slice_len)
            scratch, ws_g, ws_m = ops._workspace(slices, k * o, m, xa.device, packed=True)
            args = (xa.data_ptr(), fsq.data_ptr(), fd.data_ptr(), ws_g, ws_m, g.data_ptr(),
                    mv.data_ptr(), k, m, n, o, slices, slice_len)
            def fn():
                _build.launch("rolann_stats", fn_name, ops._ARGS_BATCHED, xa.device, *args)

            _say_sweep(f"{name} k={k} ({m}, {o}) n={n}", fn, slices, slice_len, plan)
    one_tenant = [("B1", ops._FN, m, o, 255_883) for m, o in ((19, 15), (22, 18), (25, 21),
                                                              (28, 24))]
    one_tenant.append(("B2", ops._FN_ACC, 28, 29, cs.CHUNK_SAMPLES))
    for name, fn_name, m, o, n in one_tenant:
        xa, fsq, fd = cs._stats_inputs(m, o, n, torch.float32, 95)
        g, mv = cs._running(o, m, torch.float32, 96)
        plan = ops.plan_stats_slices(n, sms)
        for steps in sorted({1, 2, 4, 8, 16, 32, plan[1] // ops.FUSED_STEP}):
            slice_len = steps * ops.FUSED_STEP
            slices = -(-n // slice_len)
            scratch, ws_g, ws_m = ops._workspace(slices, o, m, xa.device, packed=True)
            args = (xa.data_ptr(), fsq.data_ptr(), fd.data_ptr(), ws_g, ws_m, g.data_ptr(),
                    mv.data_ptr(), m, n, o, slices, slice_len)
            def fn():
                _build.launch("rolann_stats", fn_name, ops._ARGS, xa.device, *args)

            _say_sweep(f"{name} ({m}, {o}) n={n}", fn, slices, slice_len, plan)
    cs.say("sweep", card)


def main() -> int:
    cmd = sys.argv[1] if len(sys.argv) > 1 else "profile"
    try:
        if cmd == "profile":
            cmd_profile()
        elif cmd == "bits":
            cmd_bits(sys.argv[2])
        elif cmd == "sweep":
            cmd_sweep()
        else:
            print(__doc__, file=sys.stderr)
            return 2
    except cs.SmokeFailure as e:
        print(f"{Path(__file__).name}: FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
