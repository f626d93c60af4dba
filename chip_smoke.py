#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py      # from the root of a checkout

Phases, each printing its own lines; any failure exits non-zero and prints
no result:

1. device — needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` gives them; pins float32 matmuls and convolutions to full
   float32 (no TF32).
2. build — compiles every kernel of the port from the sources in the
   checkout (one ``nvcc`` per source, all started together).
3. kernel vs plain — each kernel's wrapper against its plain PyTorch
   version on the same inputs on the card: at the main path's shapes, at
   ragged and degenerate shapes and at bf16 and float64 inputs.  Tolerance:
   ``max|d| <= 1e-4 * max|plain|`` (two float32 sums of ~256k terms in other
   orders), one bf16 ulp for bf16 outputs.  Times the kernel, the plain
   version and a one-call PyTorch yardstick with CUDA events (median of 25
   after warm-up).  The folding kernels (B2 ``rolann_stats_acc``, B3
   ``rolann_fused_chunk``) are checked the same way at the streaming path's
   chunk shapes, with masks holding zeros, at n = 0 (no launch, accumulators
   unchanged) and with bf16 and float64 accumulators; also that G stays
   exactly symmetric, that a repeat is bit-identical and that the returned
   accumulators are the tensors passed in.  The tenant-batched twins (B4
   ``rolann_stats_batched``, B5 ``rolann_stats_acc_batched``, B6
   ``rolann_fused_chunk_batched``) are checked the same way at the fleet
   path's shapes (64 tenants), at ragged and masked shapes, at k = 1, at
   n = 0 and in bf16 and float64, and timed beside their plain versions and
   the one-call ``torch.einsum("kin,kon,kjn->koij", ...)`` yardstick (B6
   has none).
4. main path — the paper's Table 5 "creditcard" DAEF (29-15-18-21-24-27-29,
   lam 0.8/0.9, extreme-IQR rule) on the full-scale replica, fold 0:
   ``daef.fit(n_partitions=4)`` -> ``reconstruction_error`` -> ``threshold``
   -> ``classify`` -> ``evaluate`` with ``stats_backend="fused"``, after one
   warm-up.  Launch counts are zeroed just before and read just after;
   every kernel of the path must have run (rolann_stats: 4 per fit).  The
   same fit on the plain einsum backend must give the same first-layer
   statistics (1e-4 * max|G|); the weights' drift is reported.
5. streaming path — the same configuration and data through
   ``daef.fit_chunked`` and ``daef.fit_stream`` (a per-pass callable of
   32,768-wide numpy slices) with ``chunk_samples = 32768``: 8 chunks per
   pass, the last ragged and masked.  Launch counts per streamed fit:
   rolann_fused_chunk 32 (4 hidden layers x 8 chunks), the others 0.  Every
   layer's statistics must equal an einsum re-fold of the same chunks under
   the fit's own solved weights (1e-4 * max of the leaf): B3 against its
   plain version on identical inputs.  A fit with a logistic last layer on
   the replica rescaled into [0, 1] runs B2 (8 launches) and is re-folded
   the same way.
6. reference — the same replica fitted on the host in float32 (the CPU path
   the parity tests hold to the JAX package) and in float64: the card's
   fused fits, one-shot and streamed, must be no farther from the float64
   fit than the plain float32 fits are (see phase_reference); every fit's
   F1 is printed.
7. fleet — ``examples/fleet_anomaly.py``'s fleet shape with the creditcard
   DAEF per tenant: 32 sites (``make_dataset("creditcard", seed=s,
   scale=1/32)``, fold 0), each site's training normals split into two
   devices of 3,998 samples, seeds [s, s]: 64 tenants.  ``fleet_fit`` ->
   ``fleet_merge_pairwise`` (64 -> 32) -> ``fleet_scores`` on each site's
   test split -> ``fleet_thresholds`` -> ``fleet_classify`` -> per-site F1,
   fused backend, after one warm-up.  Launches per fit: rolann_stats_batched
   4, the others 0.  Every tenant's statistics equal an einsum re-fold under
   the fleet's own weights (1e-4 of the tenant's leaf max); the merged sites
   equal the port's one-tenant ``merge_models`` of the same device pairs
   (knowledge exactly, U S² Uᵀ at 1e-4, weights at the κ bar of
   tests/_torch_parity.py); tenants 0, 31 and 63 are no farther from a
   float64 host fit than the plain float32 fits (phase 6's bar); per-site
   labels within 4 (|Δtp| + |Δfp|) of the port's CPU fleet.  Then
   ``_fit_fleet_chunked`` and ``_fit_fleet_stream`` with 1,024-wide chunks
   (rolann_fused_chunk_batched 16 launches each, re-fold checked), and a
   logistic-output chunked fleet fit on [0, 1] data (rolann_stats_acc_batched
   4).  Times on the host clock, ending in ``torch.cuda.synchronize()``.
8. profile — one fused fit + score, one streamed fused fit, one fused fleet
   fit and one chunked fused fleet fit under ``torch.profiler``: device time
   by kernel, and the device's busy share of the wall time.

The last lines are a JSON object of per-shape numbers, the card's name and
power limit, a JSON object of per-kernel numbers for all six kernels, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

CREDITCARD = dict(layer_sizes=(29, 15, 18, 21, 24, 27, 29), lam_hidden=0.8,
                  lam_last=0.9, method="gram", gram_solver="chol")
RULE = "extreme_iqr"
N_PARTITIONS = 4
CHUNK_SAMPLES = 32_768


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, one CUDA-event pair per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    card = smi[torch.cuda.current_device()] if len(smi) > torch.cuda.current_device() else smi[0]
    props = torch.cuda.get_device_properties(0)
    say("device", f"{torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, tf32 off")
    return card


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import KERNELS, _build

    t0 = time.perf_counter()
    paths = _build.build(*KERNELS)
    say("build", f"{len(paths)} kernel(s) ready in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(p.name for p in paths.values()))
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3. kernel vs plain
# ---------------------------------------------------------------------------

def _stats_inputs(m, o, n, dtype, seed):
    """Inputs shaped and scaled like a hidden layer's: xa = [logsig; 1],
    fsq = f'^2 in (0, 1/16], fd = fsq * dbar."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((m, n), generator=gen, device="cuda")
    xa = torch.sigmoid(z)
    if m:
        xa[-1] = 1.0
    fsq = torch.rand((o, n), generator=gen, device="cuda") / 16.0
    fd = fsq * torch.randn((o, n), generator=gen, device="cuda") * 2.0
    return xa.to(dtype).contiguous(), fsq.to(dtype).contiguous(), fd.to(dtype).contiguous()


def _bound(flops, nbytes):
    """(ms, what bounds it): the larger of FP32 operations over the peak rate
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _stats_work(m, o, n):
    """FLOPs and bytes of B1: the upper triangle of G (o*n*m(m+1)/2 FMAs),
    the fsq scaling (o*m*n) and M (o*m*n FMAs), against reading xa, fsq, fd
    once and writing G and M once, in float32."""
    flops = 2 * o * n * m * (m + 1) // 2 + o * m * n + 2 * o * m * n
    nbytes = 4 * (m * n + 2 * o * n + o * m * m + o * m)
    return flops, nbytes


def _stats_bound(m, o, n):
    """Least time for B1's work."""
    return _bound(*_stats_work(m, o, n))


def _acc_bound(m, o, n):
    """Least time for B2's work: B1's, plus reading the accumulators."""
    flops, nbytes = _stats_work(m, o, n)
    return _bound(flops, nbytes + 4 * (o * m * m + o * m))


def _fused_work(m_l, m_c1, n):
    """FLOPs and bytes of B3: B1's (m = m_c1 + 1, o = m_l) plus one stage-1
    product per sample (2*m_l*m_c1*n), against reading h, the mask, w and b
    once and reading and writing the accumulators once (fsq and fd are
    formed on chip).  Transcendentals are not counted."""
    m, o = m_c1 + 1, m_l
    flops = _stats_work(m, o, n)[0] + 2 * m_l * m_c1 * n
    nbytes = 4 * (m_l * n + n + m_l * m_c1 + m_c1 + 2 * (o * m * m + o * m))
    return flops, nbytes


def _fused_bound(m_l, m_c1, n):
    """Least time for B3's work."""
    return _bound(*_fused_work(m_l, m_c1, n))


def phase_kernels(path_shapes, n_path):
    import torch

    from repro_torch.kernels.rolann_stats import rolann_stats, rolann_stats_plain

    cases = [(f"path m={m} o={o}", m, o, n_path, torch.float32) for m, o in path_shapes]
    cases += [
        ("ragged m=37 o=3", 37, 3, 100_003, torch.float32),  # 3 G tiles, n odd
        ("ragged m=5 o=2", 5, 2, 4_097, torch.float32),
        ("unit m=o=1", 1, 1, 777, torch.float32),
        ("wide m=70 o=4", 70, 4, 20_001, torch.float32),
        ("bf16 m=28 o=24", 28, 24, 65_537, torch.bfloat16),
        ("f64 m=19 o=15", 19, 15, 65_537, torch.float64),
    ]
    rows = []
    for i, (label, m, o, n, dtype) in enumerate(cases):
        xa, fsq, fd = _stats_inputs(m, o, n, dtype, seed=i)
        g, mv = rolann_stats(xa, fsq, fd)
        torch.cuda.synchronize()
        gp, mp = rolann_stats_plain(xa, fsq, fd)
        check(g.dtype == dtype and mv.dtype == dtype, f"{label}: dtype {g.dtype}")
        check(tuple(g.shape) == (o, m, m) and tuple(mv.shape) == (o, m), f"{label}: shape")
        check(bool(torch.isfinite(g).all() and torch.isfinite(mv).all()), f"{label}: not finite")
        check(bool((g == g.transpose(1, 2)).all()), f"{label}: G not symmetric")
        err = max(float((g.double() - gp.double()).abs().max()),
                  float((mv.double() - mp.double()).abs().max()))
        scale = max(float(gp.double().abs().max()), float(mp.double().abs().max()))
        tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
        check(err <= tol * scale, f"{label}: max|d| {err:.3e} > {tol:g} * {scale:.3e}")
        g2, m2 = rolann_stats(xa, fsq, fd)
        check(bool((g2 == g).all() and (m2 == mv).all()), f"{label}: not deterministic")
        say("kernel", f"rolann_stats {label} n={n} {str(dtype)[6:]}: max|d| {err:.3e} "
            f"(max|plain| {scale:.3e}, tol {tol:g}) ok")
        if label.startswith("path"):
            ms = cuda_ms(lambda: rolann_stats(xa, fsq, fd))
            plain_ms = cuda_ms(lambda: rolann_stats_plain(xa, fsq, fd))
            library_ms = cuda_ms(lambda: torch.einsum("in,on,jn->oij", xa, fsq, xa))
            bound_ms, bound_by = _stats_bound(m, o, n)
            rows.append(dict(m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"rolann_stats {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
    before = rolann_stats.launches
    z = torch.zeros((4, 0), device="cuda")
    g, mv = rolann_stats(z, z[:2], z[:2])
    check(tuple(g.shape) == (2, 4, 4) and not g.any() and rolann_stats.launches == before,
          "n == 0 must return zeros without a launch")
    say("kernel", "rolann_stats n=0: zeros, no launch, ok")
    return rows


def _running(o, m, dtype, seed):
    """A running accumulator as a fold leaves it: G exactly symmetric."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((o, m, m), generator=gen, device="cuda") * 100.0
    g = (a + a.transpose(1, 2)) / 2
    mv = torch.randn((o, m), generator=gen, device="cuda") * 10.0
    return g.to(dtype).contiguous(), mv.to(dtype).contiguous()


def _fused_inputs(m_l, m_c1, n, act, mask_zeros, seed):
    """B3 inputs shaped and scaled like a hidden layer's: h in the
    activation's range, Xavier-scaled w, N(0, 1) b; with ``mask_zeros`` one
    sample in ten and the last fifth of the chunk masked out."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.sigmoid(torch.randn((m_l, n), generator=gen, device="cuda") * 2.0)
    if act == "tanh":
        h = 2.0 * h - 1.0
    w = torch.randn((m_l, m_c1), generator=gen, device="cuda") * (2.0 / (m_l + m_c1)) ** 0.5
    b = torch.randn((m_c1,), generator=gen, device="cuda")
    mask = torch.ones((n,), device="cuda")
    if mask_zeros:
        mask = (torch.rand((n,), generator=gen, device="cuda") >= 0.1).float()
        mask[n - n // 5:] = 0.0
    return h.contiguous(), w.contiguous(), b, mask


def _check_fold(label, fold, plain, g0, m0):
    """Run a folding wrapper and its plain version from the same running
    accumulators; check identity, dtype, symmetry, agreement and
    repeatability.  Returns max|d|."""
    import torch

    g, mv = g0.clone(), m0.clone()
    out = fold(g, mv)
    torch.cuda.synchronize()
    check(out[0] is g and out[1] is mv, f"{label}: the accumulators passed in must be returned")
    check(g.dtype == g0.dtype and mv.dtype == m0.dtype, f"{label}: dtype {g.dtype}")
    check(bool(torch.isfinite(g).all() and torch.isfinite(mv).all()), f"{label}: not finite")
    check(bool((g == g.transpose(-1, -2)).all()), f"{label}: G not symmetric")
    gp, mp = plain(g0.clone(), m0.clone())
    err = max(float((g.double() - gp.double()).abs().max()),
              float((mv.double() - mp.double()).abs().max()))
    scale = max(float(gp.double().abs().max()), float(mp.double().abs().max()))
    tol = 2.0**-7 if g0.dtype == torch.bfloat16 else 1e-4
    check(err <= tol * scale, f"{label}: max|d| {err:.3e} > {tol:g} * {scale:.3e}")
    g2, m2 = g0.clone(), m0.clone()
    fold(g2, m2)
    check(bool(torch.equal(g2, g) and torch.equal(m2, mv)), f"{label}: not deterministic")
    say("kernel", f"{label} {str(g0.dtype)[6:]} acc: max|d| {err:.3e} (max|plain| {scale:.3e}, "
        f"tol {tol:g}), symmetric, repeatable, in place, ok")
    return err


def _time_fold(fold, plain, library, g0, m0):
    """(kernel, plain, library) ms of one call on scratch accumulators."""
    g, mv = g0.clone(), m0.clone()
    ms = cuda_ms(lambda: fold(g, mv))
    plain_ms = cuda_ms(lambda: plain(g, mv))
    library_ms = cuda_ms(library) if library is not None else None
    return ms, plain_ms, library_ms


def phase_fold_kernels(acc_shapes, fused_shapes, n_chunk):
    """B2 and B3 against their plain versions on the card.  ``acc_shapes``
    are the (m, o) of B2's launches on its path, ``fused_shapes`` the
    (m_l, m_c1) of B3's; ``n_chunk`` the chunk width."""
    import torch

    from repro_torch.kernels.rolann_stats import (
        rolann_fused_chunk,
        rolann_fused_chunk_plain,
        rolann_stats_acc,
        rolann_stats_acc_plain,
    )

    rows = {"rolann_stats_acc": [], "rolann_fused_chunk": []}
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    acc_cases = [(f"path m={m} o={o}", m, o, n_chunk, f32, False) for m, o in acc_shapes]
    acc_cases += [
        ("ragged masked m=28 o=29", 28, 29, 26_507, f32, True),
        ("wide m=70 o=4", 70, 4, 20_001, f32, False),
        ("bf16 m=28 o=29", 28, 29, n_chunk, bf16, False),
        ("f64 m=19 o=15", 19, 15, n_chunk, f64, False),
    ]
    for i, (label, m, o, n, dtype, masked) in enumerate(acc_cases):
        xa, fsq, fd = _stats_inputs(m, o, n, torch.float32, seed=100 + i)
        if masked:  # a padded tail: fsq and fd already masked upstream
            fsq[:, n - n // 5:] = 0.0
            fd[:, n - n // 5:] = 0.0
        g0, m0 = _running(o, m, dtype, seed=200 + i)
        fold = lambda g, mv: rolann_stats_acc(g, mv, xa, fsq, fd)  # noqa: E731
        plain = lambda g, mv: rolann_stats_acc_plain(g, mv, xa, fsq, fd)  # noqa: E731
        err = _check_fold(f"rolann_stats_acc {label} n={n}", fold, plain, g0, m0)
        if label.startswith("path"):
            ms, plain_ms, library_ms = _time_fold(
                fold, plain, lambda: torch.einsum("in,on,jn->oij", xa, fsq, xa), g0, m0)
            rows["rolann_stats_acc"].append(dict(m=m, o=o, n=n, max_abs_err=err, ms=ms,
                                                 plain_ms=plain_ms, library_ms=library_ms))
            say("kernel", f"rolann_stats_acc {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms")

    fused_cases = [(f"path m_l={a} m_c1={c}", a, c, n_chunk, "logsig", f32, False)
                   for a, c in fused_shapes]
    fused_cases += [
        ("tail masked m_l=24 m_c1=27", 24, 27, n_chunk, "logsig", f32, True),
        ("ragged masked tanh m_l=24 m_c1=27", 24, 27, 26_507, "tanh", f32, True),
        ("wide m_l=40 m_c1=50", 40, 50, 20_001, "logsig", f32, True),
        ("bf16 m_l=24 m_c1=27", 24, 27, n_chunk, "logsig", bf16, False),
        ("f64 m_l=15 m_c1=18", 15, 18, n_chunk, "tanh", f64, True),
    ]
    for i, (label, m_l, m_c1, n, act, dtype, masked) in enumerate(fused_cases):
        h, w, b, mask = _fused_inputs(m_l, m_c1, n, act, masked, seed=300 + i)
        g0, m0 = _running(m_l, m_c1 + 1, dtype, seed=400 + i)
        fold = lambda g, mv: rolann_fused_chunk(g, mv, h, w, b, mask, act_name=act)  # noqa: E731
        plain = lambda g, mv: rolann_fused_chunk_plain(g, mv, h, w, b, mask, act)  # noqa: E731
        err = _check_fold(f"rolann_fused_chunk {label} n={n} {act}", fold, plain, g0, m0)
        if label.startswith("path"):
            ms, plain_ms, _ = _time_fold(fold, plain, None, g0, m0)
            rows["rolann_fused_chunk"].append(dict(m_l=m_l, m_c1=m_c1, n=n, max_abs_err=err,
                                                   ms=ms, plain_ms=plain_ms, library_ms=None))
            say("kernel", f"rolann_fused_chunk {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, library none (no single PyTorch call computes the "
                "stage-1 activation, the target transform and the masked (G, M) fold)")

    before = (rolann_stats_acc.launches, rolann_fused_chunk.launches)
    g0, m0 = _running(3, 5, torch.float32, seed=7)
    g, mv = g0.clone(), m0.clone()
    z = torch.zeros((5, 0), device="cuda")
    out = rolann_stats_acc(g, mv, z, z[:3], z[:3])
    check(out[0] is g and torch.equal(g, g0) and torch.equal(mv, m0),
          "rolann_stats_acc n=0 must leave the accumulators unchanged")
    out = rolann_fused_chunk(g, mv, torch.zeros((3, 0), device="cuda"),
                             torch.zeros((3, 4), device="cuda"), torch.zeros(4, device="cuda"),
                             torch.zeros(0, device="cuda"), act_name="logsig")
    check(out[0] is g and torch.equal(g, g0) and torch.equal(mv, m0),
          "rolann_fused_chunk n=0 must leave the accumulators unchanged")
    check((rolann_stats_acc.launches, rolann_fused_chunk.launches) == before,
          "n == 0 must not launch")
    say("kernel", "rolann_stats_acc and rolann_fused_chunk n=0: unchanged, no launch, ok")
    return rows


# ---------------------------------------------------------------------------
# 4. main path
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _compare_backends(cfg, fused, plain) -> dict:
    """The fused-backend model against the einsum-backend one, both float32
    on the card.  The first decoder layer's statistics have the same inputs
    in both fits, so they compare the kernel with cuBLAS alone: atol
    1e-4 * max|G|, the kernel's bar.  Past that layer the two fits differ by
    float32 summation order amplified by the solves (condition numbers near
    1e5 in the hidden layers, 3e6 in the last), so the weights' drift is
    reported, and the outputs are held to a float64 fit in phase 5."""
    import torch

    k_f, k_p = fused.layer_knowledge[0], plain.layer_knowledge[0]
    for leaf in ("g", "m"):
        a, b = getattr(k_f, leaf).double(), getattr(k_p, leaf).double()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(err <= 1e-4 * scale, f"einsum vs fused: layer-1 {leaf} {err:.3e} > 1e-4 * {scale:.3e}")
    lams = [cfg.lam_hidden] * (len(plain.layer_knowledge) - 1) + [cfg.lam_last]
    drift = {}
    for i, (k, lam) in enumerate(zip(plain.layer_knowledge, lams)):
        g = k.g.double()
        eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
        kappa = float(torch.linalg.cond(g + lam * eye).max())
        drift[f"W{i + 1}"] = (_rel(fused.weights[i + 1], plain.weights[i + 1]), kappa)
    return drift


def _wrappers():
    from repro_torch.kernels.rolann_stats import rolann_fused_chunk, rolann_stats, rolann_stats_acc

    return {"rolann_stats": rolann_stats, "rolann_stats_acc": rolann_stats_acc,
            "rolann_fused_chunk": rolann_fused_chunk}


def zero_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def load_data():
    """The full-scale creditcard replica, fold 0, on the host and uploaded to
    the card (set-up)."""
    import torch

    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    x_train, x_test, y_test = synthetic.make_dataset("creditcard", scale=1.0).train_test_split(0)
    xtr = torch.as_tensor(x_train, device="cuda")
    xte = torch.as_tensor(x_test, device="cuda")
    torch.cuda.synchronize()
    say("data", f"creditcard replica fold 0: train {tuple(x_train.shape)}, test "
        f"{tuple(x_test.shape)} ({int(y_test.sum())} anomalies), made and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return (x_train, x_test, y_test), (xtr, xte)


def path_shapes(cfg) -> list[tuple[int, int]]:
    """(m, o) of each rolann_stats launch in one fit: m = hidden width + bias
    row, o = the width it reconstructs."""
    sizes = cfg.layer_sizes
    return [(sizes[li] + 1, sizes[li - 1]) for li in range(2, len(sizes) - 1)]


def phase_main_path(cfg, xtr, xte, y_test):
    import torch

    from repro_torch.core import anomaly, daef, elm_ae

    def run(c):
        model = daef.fit(c, xtr, n_partitions=N_PARTITIONS)
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = daef.reconstruction_error(c, model, xte)
        torch.cuda.synchronize()
        return model, scores, t

    t0 = time.perf_counter()
    _, _, t1 = run(cfg)  # first fit: stage-1 draws, cuBLAS/cuSOLVER set-up, allocator
    say("main", f"first (cold) fused fit {(t1 - t0) * 1e3:.2f} ms")
    zero_launches()
    t0 = time.perf_counter()
    model, scores, t1 = run(cfg)
    t2 = time.perf_counter()
    launches = read_launches()
    mu = anomaly.threshold(model.train_errors, RULE)
    pred = anomaly.classify(scores, mu)
    metrics = anomaly.evaluate(model.train_errors, scores, y_test, RULE)
    fit_ms, score_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    n_layers = len(path_shapes(cfg))
    check(launches == {"rolann_stats": n_layers, "rolann_stats_acc": 0, "rolann_fused_chunk": 0},
          f"one fit launched {launches}, expected rolann_stats {n_layers} times and no other "
          "kernel")
    check(tuple(model.train_errors.shape) == (xtr.shape[1],), "train error shape")
    check(tuple(scores.shape) == (xte.shape[1],), "score shape")
    check(bool(torch.isfinite(model.train_errors).all() and torch.isfinite(scores).all()),
          "non-finite errors")
    check(pred.dtype == torch.int32 and 0 < int(pred.sum()) < pred.numel(),
          "classification is degenerate")
    check(0.0 < metrics.f1 <= 1.0, f"F1 {metrics.f1}")
    say("main", f"fused fit {fit_ms:.2f} ms, score {score_ms:.2f} ms, launches "
        f"{launches}, mu {float(mu):.6g}, F1 {metrics.f1:.4f} (P {metrics.precision:.4f} "
        f"R {metrics.recall:.4f}, tp {metrics.tp} fp {metrics.fp} fn {metrics.fn} "
        f"tn {metrics.tn})")
    elm_ae._stage1_cached.cache_clear()
    t0 = time.perf_counter()
    daef.fit(cfg, xtr, n_partitions=N_PARTITIONS)
    torch.cuda.synchronize()
    say("main", f"fused fit with the stage-1 draws redone, as for a new seed, "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    cfg_e = dataclasses.replace(cfg, stats_backend="einsum")
    run(cfg_e)
    t0 = time.perf_counter()
    model_e, scores_e, t1 = run(cfg_e)
    metrics_e = anomaly.evaluate(model_e.train_errors, scores_e, y_test, RULE)
    say("main", f"einsum fit {(t1 - t0) * 1e3:.2f} ms, F1 {metrics_e.f1:.4f}")
    drift = _compare_backends(cfg, model, model_e)
    say("main", "fused vs einsum weight drift (max|d| / max|.|, max cond of G + lam I): "
        + ", ".join(f"{k} {d:.2e} ({c:.3g})" for k, (d, c) in drift.items()))
    card_fits = {"card fused": (model.train_errors, scores, metrics.f1),
                 "card einsum": (model_e.train_errors, scores_e, metrics_e.f1)}
    return launches, card_fits


def fused_shapes(cfg) -> list[tuple[int, int]]:
    """(m_l, m_c1) of each hidden layer's rolann_fused_chunk launches."""
    sizes = cfg.layer_sizes
    return [(sizes[li - 1], sizes[li]) for li in range(2, len(sizes) - 1)]


def _refold(cfg, model, passes, layer):
    """Re-fold decoder layer ``layer`` (its index in ``layer_knowledge``) on
    the einsum backend over the same chunks, with the fit's own solved
    weights before it: the statistics the fit should hold, computed by the
    plain route on identical inputs."""
    from repro_torch.core import daef, elm_ae, rolann

    plain = dataclasses.replace(cfg, stats_backend="einsum")
    sizes = cfg.layer_sizes
    f_hl, f_ll = daef._acts(cfg)
    dtype, device = model.weights[0].dtype, model.weights[0].device
    if layer == len(model.layer_knowledge) - 1:
        stats = rolann.init_stats(sizes[-2], sizes[0], f_ll, dtype, device=device)
        params = (model.weights[:-1], model.biases[:-1])
        for x, mask, _ in passes():
            daef._stream_last_step(plain, stats, params, x, mask)
        return stats
    li = layer + 2
    w_c1, b_c1 = elm_ae.stage1(cfg.layer_keys()[li], sizes[li - 1], sizes[li], cfg.init,
                               dtype, device)
    stats = rolann.init_stats(sizes[li], sizes[li - 1], f_hl, dtype, device=device)
    params = (model.weights[: li - 1], model.biases[: li - 2], w_c1, b_c1)
    for x, mask, _ in passes():
        daef._stream_layer_step(plain, stats, params, x, mask)
    return stats


def _check_refold(label, cfg, model, passes, layers):
    """Each listed layer's statistics against its einsum re-fold, at 1e-4 of
    the leaf's largest entry."""
    worst = 0.0
    for k in layers:
        ref = _refold(cfg, model, passes, k)
        for leaf in ("g", "m"):
            a, b = getattr(model.layer_knowledge[k], leaf).double(), getattr(ref, leaf).double()
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= 1e-4 * scale, f"{label}: layer {k + 1} {leaf} vs the einsum re-fold "
                  f"{err:.3e} > 1e-4 * {scale:.3e}")
            worst = max(worst, err / scale)
    say("stream", f"{label}: layers {[k + 1 for k in layers]} equal their einsum re-fold, "
        f"max|d| / max|.| {worst:.2e} (bar 1e-4)")


def phase_streaming(cfg, x_train, x_test, y_test, xtr, xte):
    """The streaming path: fused fit_chunked and fit_stream, their launch
    counts, the per-layer re-fold check, an einsum fit_chunked for
    comparison, and a logistic-output fit that runs B2."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly, daef

    n = xtr.shape[1]
    n_chunks = -(-n // CHUNK_SAMPLES)
    passes = daef._device_chunks(xtr, CHUNK_SAMPLES)
    n_hidden = len(fused_shapes(cfg))

    def host_chunks():
        return (x_train[:, i:i + CHUNK_SAMPLES] for i in range(0, n, CHUNK_SAMPLES))

    def timed(label, fit, c, expect):
        fit()  # warm-up
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        model = fit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_launches()
        scores = daef.reconstruction_error(c, model, xte)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        metrics = anomaly.evaluate(model.train_errors, scores, y_test, RULE)
        check(launches == expect, f"{label}: launched {launches}, expected {expect}")
        check(tuple(model.train_errors.shape) == (n,) and tuple(scores.shape) == (xte.shape[1],),
              f"{label}: error shapes")
        check(bool(torch.isfinite(model.train_errors).all() and torch.isfinite(scores).all()),
              f"{label}: non-finite errors")
        say("stream", f"{label}: fit {(t1 - t0) * 1e3:.2f} ms, score {(t2 - t1) * 1e3:.2f} ms, "
            f"launches {launches}, F1 {metrics.f1:.4f} (tp {metrics.tp} fp {metrics.fp} "
            f"fn {metrics.fn} tn {metrics.tn})")
        return model, scores, metrics, launches

    say("stream", f"chunk_samples {CHUNK_SAMPLES}: {n_chunks} chunks per pass, the last "
        f"{n - (n_chunks - 1) * CHUNK_SAMPLES} valid of {CHUNK_SAMPLES}")
    expect = {"rolann_stats": 0, "rolann_stats_acc": 0, "rolann_fused_chunk": n_hidden * n_chunks}
    model_c, scores_c, metrics_c, launches = timed(
        "fused fit_chunked", lambda: daef.fit_chunked(cfg, xtr, chunk_samples=CHUNK_SAMPLES),
        cfg, expect)
    _check_refold("fused fit_chunked", cfg, model_c, passes, range(len(model_c.layer_knowledge)))
    model_s, _, _, _ = timed("fused fit_stream", lambda: daef.fit_stream(cfg, host_chunks),
                             cfg, expect)
    _check_refold("fused fit_stream", cfg, model_s, passes, range(len(model_s.layer_knowledge)))
    cfg_e = dataclasses.replace(cfg, stats_backend="einsum")
    timed("einsum fit_chunked", lambda: daef.fit_chunked(cfg_e, xtr, chunk_samples=CHUNK_SAMPLES),
          cfg_e, dict.fromkeys(expect, 0))

    # B2's path: a logistic last layer, on the replica rescaled feature by
    # feature into [0, 1] with the training split's min and max.
    lo, hi = x_train.min(axis=1, keepdims=True), x_train.max(axis=1, keepdims=True)
    span = np.where(hi > lo, hi - lo, 1.0)
    x01 = torch.as_tensor((x_train - lo) / span, device="cuda")
    x01_te = torch.as_tensor((x_test - lo) / span, device="cuda")
    cfg_l = dataclasses.replace(cfg, act_last="logsig")
    zero_launches()
    model_l = daef.fit_chunked(cfg_l, x01, chunk_samples=CHUNK_SAMPLES)
    torch.cuda.synchronize()
    launches_l = read_launches()
    expect_l = {"rolann_stats": 0, "rolann_stats_acc": n_chunks,
                "rolann_fused_chunk": n_hidden * n_chunks}
    check(launches_l == expect_l, f"logsig-output fit launched {launches_l}, expected {expect_l}")
    scores_l = daef.reconstruction_error(cfg_l, model_l, x01_te)
    check(bool(torch.isfinite(model_l.train_errors).all() and torch.isfinite(scores_l).all()),
          "logsig-output fit: non-finite errors")
    _check_refold("fused fit_chunked, act_last=logsig", cfg_l, model_l,
                  daef._device_chunks(x01, CHUNK_SAMPLES), [len(model_l.layer_knowledge) - 1])
    f1_l = anomaly.evaluate(model_l.train_errors, scores_l, y_test, RULE).f1
    say("stream", f"fused fit_chunked, act_last=logsig on [0, 1] data: launches {launches_l}, "
        f"F1 {f1_l:.4f} (no bar: the paper's configuration has a linear output layer)")
    return ({"rolann_fused_chunk": launches["rolann_fused_chunk"],
             "rolann_stats_acc": launches_l["rolann_stats_acc"]},
            {"card fused streamed": (model_c.train_errors, scores_c, metrics_c.f1)})


CHECKED_FITS = ("card fused", "card fused streamed")


def phase_reference(cfg, x_train, x_test, y_test, card_fits):
    """The same replica fitted on the host in float32 (the path the CPU tests
    hold to the JAX package) and in float64.  Every float32 fit sits a few
    percent from the float64 one on this configuration (see
    ``_compare_backends``); each of the card's fused fits (one-shot and
    streamed) must be no farther from it than twice the farthest of the
    plain float32 fits (card einsum, host float32), plus 1e-4 (TOLS), in
    max|d| / max|float64| of the train errors and of the test scores."""
    import torch

    from repro_torch.core import anomaly, daef

    host_cfg = dataclasses.replace(cfg, stats_backend="einsum")
    t0 = time.perf_counter()
    m_host = daef.fit(host_cfg, x_train, n_partitions=N_PARTITIONS, device="cpu")
    host_s = time.perf_counter() - t0
    s_host = daef.reconstruction_error(host_cfg, m_host, x_test, device="cpu")
    f1_host = anomaly.evaluate(m_host.train_errors, s_host, y_test, RULE, device="cpu").f1
    x64 = torch.from_numpy(x_train).double()
    m_64 = daef.fit(host_cfg, x64, n_partitions=N_PARTITIONS, device="cpu")
    s_64 = daef.reconstruction_error(host_cfg, m_64, torch.from_numpy(x_test).double(),
                                     device="cpu")
    f1_64 = anomaly.evaluate(m_64.train_errors, s_64, y_test, RULE, device="cpu").f1
    fits = {**card_fits, "host float32": (m_host.train_errors, s_host, f1_host)}
    for i, (name, ref) in enumerate((("train errors", m_64.train_errors), ("test scores", s_64))):
        dist = {k: _rel(v[i].double().cpu(), ref) for k, v in fits.items()}
        plain = max(d for k, d in dist.items() if k not in CHECKED_FITS)
        for k in CHECKED_FITS:
            check(dist[k] <= 2 * plain + 1e-4,
                  f"{name}: the {k} fit is {dist[k]:.3e} from the float64 fit, the plain "
                  f"float32 fits at most {plain:.3e}")
        say("reference", f"{name}, max|d| / max|.| from the host float64 fit: "
            + ", ".join(f"{k} {d:.2e}" for k, d in dist.items()))
    say("reference", "F1: " + ", ".join(f"{k} {v[2]:.4f}" for k, v in fits.items())
        + f", host float64 {f1_64:.4f} (host float32 fit {host_s:.2f} s, "
        f"{torch.get_num_threads()} threads)")


# ---------------------------------------------------------------------------
# 8-9. the tenant fleet: B4, B5, B6 against their plain versions, then the
# fleet path
# ---------------------------------------------------------------------------

def _batched_work(k, work):
    """k tenants' FLOPs and bytes of a one-tenant launch's ``work``."""
    flops, nbytes = work
    return k * flops, k * nbytes


def _check_batched_stats(label, xa, fsq, fd):
    """B4 against its plain version: dtype, shape, finite, exactly symmetric
    G, agreement, repeatability.  Returns max|d|."""
    import torch

    from repro_torch.kernels.rolann_stats import rolann_stats_batched, rolann_stats_batched_plain

    k, m, _ = xa.shape
    o = fsq.shape[1]
    dtype = xa.dtype
    g, mv = rolann_stats_batched(xa, fsq, fd)
    torch.cuda.synchronize()
    gp, mp = rolann_stats_batched_plain(xa, fsq, fd)
    check(g.dtype == dtype and mv.dtype == dtype, f"{label}: dtype {g.dtype}")
    check(tuple(g.shape) == (k, o, m, m) and tuple(mv.shape) == (k, o, m), f"{label}: shape")
    check(bool(torch.isfinite(g).all() and torch.isfinite(mv).all()), f"{label}: not finite")
    check(bool((g == g.transpose(-1, -2)).all()), f"{label}: G not symmetric")
    err = max(float((g.double() - gp.double()).abs().max()),
              float((mv.double() - mp.double()).abs().max()))
    scale = max(float(gp.double().abs().max()), float(mp.double().abs().max()))
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    check(err <= tol * scale, f"{label}: max|d| {err:.3e} > {tol:g} * {scale:.3e}")
    g2, m2 = rolann_stats_batched(xa, fsq, fd)
    check(bool(torch.equal(g2, g) and torch.equal(m2, mv)), f"{label}: not deterministic")
    say("kernel", f"{label} {str(dtype)[6:]}: max|d| {err:.3e} (max|plain| {scale:.3e}, "
        f"tol {tol:g}), symmetric, repeatable, ok")
    return err


def phase_batched_kernels(k, stats_shapes, n_tenant, acc_shape, fused_shapes, n_chunk):
    """B4, B5 and B6 against their plain versions on the card, at the fleet
    path's shapes (``k`` tenants; B4 at each one-shot layer's (m, o) with
    ``n_tenant`` samples per tenant, B5 at ``acc_shape`` and B6 at each
    hidden layer's (m_l, m_c1), both with ``n_chunk``-wide chunks), at
    ragged and masked shapes, at k = 1, at n = 0 (no launch) and with bf16
    and float64 inputs and accumulators."""
    import torch

    from repro_torch.kernels.rolann_stats import (
        rolann_fused_chunk_batched,
        rolann_fused_chunk_batched_plain,
        rolann_stats_acc_batched,
        rolann_stats_acc_batched_plain,
        rolann_stats_batched,
        rolann_stats_batched_plain,
    )

    rows = {"rolann_stats_batched": [], "rolann_stats_acc_batched": [],
            "rolann_fused_chunk_batched": []}
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64

    def stats_in(kk, m, o, n, dtype, seed):
        parts = [_stats_inputs(m, o, n, f32, seed=seed * 1000 + t) for t in range(kk)]
        return tuple(torch.stack(p).to(dtype).contiguous() for p in zip(*parts))

    cases = [(f"path k={k} m={m} o={o}", k, m, o, n_tenant, f32) for m, o in stats_shapes]
    cases += [
        ("ragged k=3 m=37 o=3", 3, 37, 3, 10_007, f32),
        ("one tenant k=1 m=19 o=15", 1, 19, 15, 4_097, f32),
        ("bf16 k=8 m=28 o=24", 8, 28, 24, n_tenant, bf16),
        ("f64 k=8 m=19 o=15", 8, 19, 15, n_tenant, f64),
    ]
    for i, (label, kk, m, o, n, dtype) in enumerate(cases):
        xa, fsq, fd = stats_in(kk, m, o, n, dtype, seed=500 + i)
        err = _check_batched_stats(f"rolann_stats_batched {label} n={n}", xa, fsq, fd)
        if label.startswith("path"):
            ms = cuda_ms(lambda: rolann_stats_batched(xa, fsq, fd))
            plain_ms = cuda_ms(lambda: rolann_stats_batched_plain(xa, fsq, fd))
            library_ms = cuda_ms(lambda: torch.einsum("kin,kon,kjn->koij", xa, fsq, xa))
            bound_ms, bound_by = _bound(*_batched_work(kk, _stats_work(m, o, n)))
            rows["rolann_stats_batched"].append(dict(
                k=kk, m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"rolann_stats_batched {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")

    m, o = acc_shape
    acc_cases = [(f"path k={k} m={m} o={o}", k, m, o, n_chunk, f32, False),
                 ("ragged masked k=5 m=28 o=29", 5, 28, 29, 926, f32, True),
                 ("wide k=2 m=70 o=4", 2, 70, 4, 2_001, f32, False),
                 ("one tenant k=1 m=28 o=29", 1, 28, 29, n_chunk, f32, True),
                 ("bf16 k=8 m=28 o=29", 8, 28, 29, n_chunk, bf16, False),
                 ("f64 k=8 m=19 o=15", 8, 19, 15, n_chunk, f64, True)]
    for i, (label, kk, m, o, n, dtype, masked) in enumerate(acc_cases):
        xa, fsq, fd = stats_in(kk, m, o, n, f32, seed=600 + i)
        if masked:  # a padded tail, masked upstream
            fsq[..., n - n // 5:] = 0.0
            fd[..., n - n // 5:] = 0.0
        parts = [_running(o, m, dtype, seed=700 + 10 * i + t) for t in range(kk)]
        g0, m0 = (torch.stack(p).contiguous() for p in zip(*parts))
        fold = lambda g, mv: rolann_stats_acc_batched(g, mv, xa, fsq, fd)  # noqa: E731
        plain = lambda g, mv: rolann_stats_acc_batched_plain(g, mv, xa, fsq, fd)  # noqa: E731
        err = _check_fold(f"rolann_stats_acc_batched {label} n={n}", fold, plain, g0, m0)
        if label.startswith("path"):
            ms, plain_ms, library_ms = _time_fold(
                fold, plain, lambda: torch.einsum("kin,kon,kjn->koij", xa, fsq, xa), g0, m0)
            flops, nbytes = _stats_work(m, o, n)
            bound_ms, bound_by = _bound(*_batched_work(kk, (flops, nbytes + 4 * (o * m * m + o * m))))
            rows["rolann_stats_acc_batched"].append(dict(
                k=kk, m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"rolann_stats_acc_batched {label} n={n}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms")

    fused_cases = [(f"path k={k} m_l={a} m_c1={c}", k, a, c, n_chunk, "logsig", f32, False)
                   for a, c in fused_shapes]
    fused_cases += [
        ("tail masked k=64 m_l=24 m_c1=27", k, 24, 27, n_chunk, "logsig", f32, True),
        ("ragged masked tanh k=3 m_l=24 m_c1=27", 3, 24, 27, 926, "tanh", f32, True),
        ("wide k=2 m_l=40 m_c1=50", 2, 40, 50, 2_001, "logsig", f32, True),
        ("one tenant k=1 m_l=15 m_c1=18", 1, 15, 18, n_chunk, "tanh", f32, True),
        ("bf16 k=8 m_l=24 m_c1=27", 8, 24, 27, n_chunk, "logsig", bf16, False),
        ("f64 k=8 m_l=15 m_c1=18", 8, 15, 18, n_chunk, "tanh", f64, True),
    ]
    for i, (label, kk, m_l, m_c1, n, act, dtype, masked) in enumerate(fused_cases):
        parts = [_fused_inputs(m_l, m_c1, n, act, masked, seed=800 + 10 * i + t)
                 for t in range(kk)]
        h, w, b, mask = (torch.stack(p).contiguous() for p in zip(*parts))
        parts = [_running(m_l, m_c1 + 1, dtype, seed=900 + 10 * i + t) for t in range(kk)]
        g0, m0 = (torch.stack(p).contiguous() for p in zip(*parts))
        fold = lambda g, mv: rolann_fused_chunk_batched(g, mv, h, w, b, mask, act_name=act)  # noqa: E731
        plain = lambda g, mv: rolann_fused_chunk_batched_plain(g, mv, h, w, b, mask, act)  # noqa: E731
        err = _check_fold(f"rolann_fused_chunk_batched {label} n={n} {act}", fold, plain, g0, m0)
        if label.startswith("path"):
            ms, plain_ms, _ = _time_fold(fold, plain, None, g0, m0)
            bound_ms, bound_by = _bound(*_batched_work(kk, _fused_work(m_l, m_c1, n)))
            rows["rolann_fused_chunk_batched"].append(dict(
                k=kk, m_l=m_l, m_c1=m_c1, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"rolann_fused_chunk_batched {label} n={n}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library none")

    before = (rolann_stats_batched.launches, rolann_stats_acc_batched.launches,
              rolann_fused_chunk_batched.launches)
    g, mv = rolann_stats_batched(*stats_in(2, 5, 3, 0, f32, seed=1))
    check(tuple(g.shape) == (2, 3, 5, 5) and not g.any() and not mv.any(),
          "rolann_stats_batched n=0 must return zeros")
    parts = [_running(3, 5, f32, seed=t) for t in range(2)]
    g0, m0 = (torch.stack(p).contiguous() for p in zip(*parts))
    g, mv = g0.clone(), m0.clone()
    z = torch.zeros((2, 5, 0), device="cuda")
    out = rolann_stats_acc_batched(g, mv, z, z[:, :3], z[:, :3])
    check(out[0] is g and torch.equal(g, g0) and torch.equal(mv, m0),
          "rolann_stats_acc_batched n=0 must leave the accumulators unchanged")
    out = rolann_fused_chunk_batched(g, mv, torch.zeros((2, 3, 0), device="cuda"),
                                     torch.zeros((2, 3, 4), device="cuda"),
                                     torch.zeros((2, 4), device="cuda"),
                                     torch.zeros((2, 0), device="cuda"), act_name="logsig")
    check(out[0] is g and torch.equal(g, g0) and torch.equal(mv, m0),
          "rolann_fused_chunk_batched n=0 must leave the accumulators unchanged")
    check((rolann_stats_batched.launches, rolann_stats_acc_batched.launches,
           rolann_fused_chunk_batched.launches) == before, "n == 0 must not launch")
    say("kernel", "rolann_stats_batched, rolann_stats_acc_batched and "
        "rolann_fused_chunk_batched n=0: zeros / unchanged, no launch, ok")
    return rows


FLEET_SITES = 32
FLEET_CHUNK = 1_024
FLEET_CHECKED = (0, 31, 63)  # tenants held to a float64 host fit


def load_fleet_data():
    """The fleet cell: 32 creditcard sites (seed s, scale 1/32, fold 0), each
    site's training normals split into two devices of equal width; seeds
    [s, s] per site.  Set-up."""
    import numpy as np
    import torch

    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    splits = [synthetic.make_dataset("creditcard", seed=s, scale=1 / FLEET_SITES)
              .train_test_split(0) for s in range(FLEET_SITES)]
    n_half = min(s[0].shape[1] for s in splits) // 2
    xs = np.stack([x[:, d * n_half:(d + 1) * n_half] for x, _, _ in splits for d in (0, 1)])
    seeds = np.repeat(np.arange(FLEET_SITES, dtype=np.int32), 2)
    n_test = min(s[1].shape[1] for s in splits)
    tests = np.stack([x_te[:, :n_test] for _, x_te, _ in splits])
    truth = np.stack([y[:n_test] for _, _, y in splits])
    xs_d = torch.as_tensor(xs, device="cuda")
    tests_d = torch.as_tensor(tests, device="cuda")
    torch.cuda.synchronize()
    say("fleet", f"{xs.shape[0]} tenants x {xs.shape[1]} features x {xs.shape[2]} samples "
        f"({xs.shape[0] * xs.shape[2]} in all); {FLEET_SITES} site test splits of {n_test} "
        f"({int(truth.sum())} anomalies in all); made and uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    return (xs, seeds, tests, truth), (xs_d, tests_d)


def _fleet_wrappers():
    from repro_torch.kernels.rolann_stats import (
        rolann_fused_chunk_batched,
        rolann_stats_acc_batched,
        rolann_stats_batched,
    )

    return {"rolann_stats_batched": rolann_stats_batched,
            "rolann_stats_acc_batched": rolann_stats_acc_batched,
            "rolann_fused_chunk_batched": rolann_fused_chunk_batched}


def _refold_fleet(cfg, fl, passes, layer):
    """``_refold`` for every tenant of a fleet: decoder layer ``layer`` re-folded
    on the einsum backend over the same chunks, under the fleet's own solved
    weights."""
    from repro_torch.core import daef, elm_ae, fleet, rolann

    sizes = cfg.layer_sizes
    f_hl, f_ll = daef._acts(cfg)
    model = fl.model
    dtype, device = model.weights[0].dtype, model.weights[0].device
    if layer == len(model.layer_knowledge) - 1:
        stats = rolann.init_stats(sizes[-2], sizes[0], f_ll, dtype, device=device,
                                  tenants=fl.size)
        for x, mask, _ in passes():
            h = fleet._forward(cfg, x, model.weights[:-1], model.biases[:-1])
            rolann.accumulate_stats_batched(stats, h, x, f_ll, weights=mask, backend="einsum")
        return stats
    li = layer + 2
    keys = fleet._tenant_keys(cfg, fl.seeds)
    w_c1, b_c1 = elm_ae.stage1_batched(keys[:, li], sizes[li - 1], sizes[li], cfg.init,
                                       dtype, device)
    stats = rolann.init_stats(sizes[li], sizes[li - 1], f_hl, dtype, device=device,
                              tenants=fl.size)
    for x, mask, _ in passes():
        h = fleet._forward(cfg, x, model.weights[: li - 1], model.biases[: li - 2])
        elm_ae.accumulate_layer_stats_batched(stats, w_c1, b_c1, h, f_hl, weights=mask,
                                              backend="einsum")
    return stats


def _check_refold_fleet(label, cfg, fl, passes, layers):
    """Each listed layer's statistics, tenant by tenant, against the einsum
    re-fold, at 1e-4 of the tenant's leaf's largest entry."""
    worst = 0.0
    for k in layers:
        ref = _refold_fleet(cfg, fl, passes, k)
        for leaf in ("g", "m"):
            a = getattr(fl.model.layer_knowledge[k], leaf).double()
            b = getattr(ref, leaf).double()
            dims = tuple(range(1, a.ndim))
            rel = (a - b).abs().amax(dim=dims) / b.abs().amax(dim=dims)
            bad = int(rel.argmax())
            check(float(rel.max()) <= 1e-4, f"{label}: tenant {bad} layer {k + 1} {leaf} vs the "
                  f"einsum re-fold {float(rel[bad]):.3e} of its max (bar 1e-4)")
            worst = max(worst, float(rel.max()))
    say("fleet", f"{label}: layers {[k + 1 for k in layers]} of every tenant equal their einsum "
        f"re-fold, max|d| / max|.| {worst:.2e} (bar 1e-4)")


def _site_f1(pred, truth):
    from repro_torch.core import anomaly

    return [anomaly.binary_metrics(p, t) for p, t in zip(pred, truth)]


def _check_merged_sites(cfg, devices, sites):
    """Each merged site model against the port's one-tenant ``merge_models``
    of the same two device models, on the card: the knowledge sums and the
    train-error pools exactly; the encoder's S at 1e-4 and U S² Uᵀ at 1e-4
    of its max; each layer's W and b at 10·κ·eps·max|[W; b]| (the rule of
    tests/_torch_parity.py, κ of that site's G + λI)."""
    import torch

    from repro_torch.core import daef, fleet

    eps = float(torch.finfo(torch.float32).eps)
    worst_w = worst_u = 0.0
    for s in range(sites.size):
        cfg_s = dataclasses.replace(cfg, seed=int(devices.seeds[2 * s]),
                                    lam_hidden=float(devices.lam_hidden[2 * s]),
                                    lam_last=float(devices.lam_last[2 * s]))
        one = daef.merge_models(cfg_s, fleet.get_model(devices, 2 * s),
                                fleet.get_model(devices, 2 * s + 1))
        got = fleet.get_model(sites, s)
        for kg, ko in zip(got.layer_knowledge, one.layer_knowledge):
            check(torch.equal(kg.g, ko.g) and torch.equal(kg.m, ko.m),
                  f"site {s}: merged knowledge differs from merge_models'")
        check(torch.equal(got.train_errors, one.train_errors), f"site {s}: error pool differs")
        check(_rel(got.encoder_factors.s, one.encoder_factors.s) <= 1e-4, f"site {s}: encoder S")
        gu = (got.encoder_factors.u * got.encoder_factors.s**2) @ got.encoder_factors.u.T
        ou = (one.encoder_factors.u * one.encoder_factors.s**2) @ one.encoder_factors.u.T
        worst_u = max(worst_u, _rel(gu, ou))
        check(_rel(gu, ou) <= 1e-4, f"site {s}: encoder U S^2 U^T {_rel(gu, ou):.3e}")
        lams = [cfg_s.lam_hidden] * (len(one.layer_knowledge) - 1) + [cfg_s.lam_last]
        for i, (k, lam) in enumerate(zip(one.layer_knowledge, lams)):
            g = k.g.double()
            eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
            kappa = float(torch.linalg.cond(g + lam * eye).max())
            w_aug = torch.cat([one.weights[i + 1], one.biases[i][None]]).double()
            g_aug = torch.cat([got.weights[i + 1], got.biases[i][None]]).double()
            err = float((g_aug - w_aug).abs().max())
            bar = 10 * kappa * eps * float(w_aug.abs().max())
            check(err <= bar, f"site {s} layer {i + 2}: W, b differ by {err:.3e} > {bar:.3e}")
            worst_w = max(worst_w, err / bar)
    say("fleet", f"{sites.size} merged site models equal merge_models of their device pairs: "
        f"knowledge and error pools exact, U S^2 U^T max|d|/max {worst_u:.2e} (bar 1e-4), "
        f"W and b at most {worst_w:.3f} of their kappa bar")


def phase_fleet(cfg, data, data_d):
    """The fleet path on the card: fit -> merge pairwise -> score ->
    thresholds -> classify -> per-site F1, then the chunked, streamed and
    logistic-output chunked fits; launch counts, re-fold checks, the merged
    sites against one-tenant merges, a float64 host reference for a few
    tenants and the port's CPU fleet's per-site F1.  Returns the launches
    per path and the fused device fleet."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly, daef, fleet

    xs, seeds, tests, truth = data
    xs_d, tests_d = data_d
    k, m0, n = xs.shape
    wrappers = {**_wrappers(), **_fleet_wrappers()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in wrappers.items()}

    def expect(**nonzero):
        return {name: nonzero.get(name, 0) for name in wrappers}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def fit(c):
        return fleet.fleet_fit(c, xs_d, seeds=seeds)

    times = {}
    n_hidden = len(path_shapes(cfg))
    t0 = time.perf_counter()
    fit(cfg)  # first fit: stage-1 draws for 64 keys, cuSOLVER set-up, allocator
    torch.cuda.synchronize()
    say("fleet", f"first (cold) fused fleet fit {(time.perf_counter() - t0) * 1e3:.2f} ms")
    zero()
    devices, times["fleet fit"] = timed(lambda: fit(cfg))
    launches = {"fit": read()}
    check(launches["fit"] == expect(rolann_stats_batched=n_hidden),
          f"fleet fit launched {launches['fit']}, expected rolann_stats_batched {n_hidden} "
          "times and no other kernel")
    check(tuple(devices.model.train_errors.shape) == (k, n) and
          bool(torch.isfinite(devices.model.train_errors).all()), "fleet train errors")
    _check_refold_fleet("fused fleet fit", cfg, devices, fleet._device_chunks(xs_d, n),
                        range(len(devices.model.layer_knowledge)))

    merge = f"merge {k} -> {k // 2}"
    t0 = time.perf_counter()
    sites = fleet.fleet_merge_pairwise(cfg, devices)
    scores = fleet.fleet_scores(cfg, sites, tests_d)
    fleet.fleet_thresholds(sites)
    torch.cuda.synchronize()
    say("fleet", f"first (cold) {merge}, score and thresholds "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    zero()
    sites, times[merge] = timed(lambda: fleet.fleet_merge_pairwise(cfg, devices))
    check(read() == expect(), f"the merge launched {read()}, expected no kernel")
    scores, times["score sites"] = timed(lambda: fleet.fleet_scores(cfg, sites, tests_d))
    mus, times["thresholds"] = timed(lambda: fleet.fleet_thresholds(sites))
    pred = fleet.fleet_classify(scores, mus)
    check(tuple(scores.shape) == tests.shape[::2] and bool(torch.isfinite(scores).all()),
          "site scores")
    check(pred.dtype == torch.int32 and 0 < int(pred.sum()) < pred.numel(),
          "fleet classification is degenerate")
    site_m = _site_f1(pred.cpu(), torch.as_tensor(truth))
    say("fleet", f"fused fleet fit {times['fleet fit']:.2f} ms, {merge} "
        f"{times[merge]:.2f} ms, score {times['score sites']:.2f} ms, "
        f"thresholds {times['thresholds']:.2f} ms, launches {launches['fit']}")
    _check_merged_sites(cfg, devices, sites)

    # What the thresholds see (no bar): each site's first device model on the
    # site's test split with its own threshold, and the merged model with a
    # threshold from its own errors on the site's training data (the merged
    # model's error pool holds the device models' errors, from before the
    # merge).
    site_train = xs_d.reshape(k // 2, 2, m0, n).permute(0, 2, 1, 3).reshape(k // 2, m0, 2 * n)
    first = fleet._tree_map(lambda leaf: leaf[0::2].contiguous(), devices)
    variants = {
        "device model": fleet.fleet_classify(fleet.fleet_scores(cfg, first, tests_d),
                                             fleet.fleet_thresholds(first)),
        "merged model, own errors": fleet.fleet_classify(scores, anomaly.threshold(
            fleet.fleet_scores(cfg, sites, site_train), RULE)),
    }
    say("fleet", "mean site F1 with other thresholds (no bar): " + ", ".join(
        f"{name} {np.mean([x.f1 for x in _site_f1(p.cpu(), torch.as_tensor(truth))]):.4f}"
        for name, p in variants.items()))

    # The port's CPU fleet on the same data: per-site labels within a few
    # mislabels (bar: |dtp| + |dfp| <= 4 per site).
    t0 = time.perf_counter()
    cfg_h = dataclasses.replace(cfg, stats_backend="einsum")
    devices_h = fleet.fleet_fit(cfg_h, xs, seeds=seeds, device="cpu")
    sites_h = fleet.fleet_merge_pairwise(cfg_h, devices_h)
    scores_h = fleet.fleet_scores(cfg_h, sites_h, tests, device="cpu")
    pred_h = fleet.fleet_classify(scores_h, fleet.fleet_thresholds(sites_h), device="cpu")
    host_s = time.perf_counter() - t0
    site_h = _site_f1(pred_h, torch.as_tensor(truth))
    apart = [abs(a.tp - b.tp) + abs(a.fp - b.fp) for a, b in zip(site_m, site_h)]
    check(max(apart) <= 4, f"per-site labels: card and CPU fleets {max(apart)} apart at site "
          f"{int(np.argmax(apart))} (bar 4)")
    say("fleet", "per-site F1, card fused: " + " ".join(f"{x.f1:.3f}" for x in site_m))
    say("fleet", "per-site F1, CPU fleet:  " + " ".join(f"{x.f1:.3f}" for x in site_h))
    say("fleet", f"mean F1 card {np.mean([x.f1 for x in site_m]):.4f}, CPU "
        f"{np.mean([x.f1 for x in site_h]):.4f}; labels apart per site at most {max(apart)}, "
        f"{sum(apart)} in all (CPU fleet fit + merge + score {host_s:.2f} s, "
        f"{torch.get_num_threads()} threads)")

    # The fleet against a float64 host fit of a few tenants (phase_reference's
    # bar): no farther than twice the plain float32 fits, plus 1e-4.
    devices_e = fit(dataclasses.replace(cfg, stats_backend="einsum"))
    x_test = {t: tests[t // 2] for t in FLEET_CHECKED}
    for t in FLEET_CHECKED:
        cfg_t = dataclasses.replace(cfg_h, seed=int(seeds[t]))
        m64 = daef.fit(cfg_t, torch.from_numpy(xs[t]).double(), device="cpu")
        m32 = daef.fit(cfg_t, xs[t], device="cpu")
        fits = {"card fused fleet": fleet.get_model(devices, t),
                "card einsum fleet": fleet.get_model(devices_e, t), "host float32": m32}
        ref_s = daef.reconstruction_error(cfg_t, m64, torch.from_numpy(x_test[t]).double(),
                                          device="cpu")
        for i, (what, ref) in enumerate((("train errors", m64.train_errors),
                                         ("test scores", ref_s))):
            dist = {}
            for name, mdl in fits.items():
                got = (mdl.train_errors if i == 0 else daef.reconstruction_error(
                    cfg_t, mdl, x_test[t], device=mdl.weights[0].device))
                dist[name] = _rel(got.double().cpu(), ref)
            plain = max(d for name, d in dist.items() if name != "card fused fleet")
            check(dist["card fused fleet"] <= 2 * plain + 1e-4,
                  f"tenant {t} {what}: the fleet is {dist['card fused fleet']:.3e} from float64, "
                  f"the plain float32 fits at most {plain:.3e}")
            say("fleet", f"tenant {t} {what}, max|d| / max|.| from the host float64 fit: "
                + ", ".join(f"{name} {d:.2e}" for name, d in dist.items()))

    # Chunked and streamed: B6 per chunk of every tenant.
    n_chunks = -(-n // FLEET_CHUNK)
    passes = fleet._device_chunks(xs_d, FLEET_CHUNK)
    say("fleet", f"chunk_samples {FLEET_CHUNK}: {n_chunks} chunks per tenant per pass, the "
        f"last {n - (n_chunks - 1) * FLEET_CHUNK} valid; host chunks [{k}, {m0}, "
        f"{FLEET_CHUNK}] of {k * m0 * FLEET_CHUNK * 4 / 1e6:.1f} MB")

    def host_chunks():
        return (xs[:, :, i:i + FLEET_CHUNK] for i in range(0, n, FLEET_CHUNK))

    want = expect(rolann_fused_chunk_batched=n_hidden * n_chunks)
    for label, run in (
        ("chunked", lambda: fleet._fit_fleet_chunked(cfg, xs_d, chunk_samples=FLEET_CHUNK,
                                                     seeds=seeds)),
        ("streamed", lambda: fleet._fit_fleet_stream(cfg, host_chunks, seeds=seeds)),
    ):
        run()  # warm-up
        zero()
        fl, times[f"{label} fleet fit"] = timed(run)
        launches[label] = read()
        check(launches[label] == want, f"{label} fleet fit launched {launches[label]}, "
              f"expected {want}")
        check(bool(torch.isfinite(fl.model.train_errors).all()) and
              tuple(fl.model.train_errors.shape) == (k, n), f"{label} fleet train errors")
        _check_refold_fleet(f"fused {label} fleet fit", cfg, fl, passes,
                            range(len(fl.model.layer_knowledge)))
        s_fl = fleet.fleet_merge_pairwise(cfg, fl)
        p_fl = fleet.fleet_classify(fleet.fleet_scores(cfg, s_fl, tests_d),
                                    fleet.fleet_thresholds(s_fl))
        f1 = np.mean([x.f1 for x in _site_f1(p_fl.cpu(), torch.as_tensor(truth))])
        say("fleet", f"fused {label} fleet fit {times[f'{label} fleet fit']:.2f} ms, launches "
            f"{launches[label]}, mean site F1 {f1:.4f}")

    # B5's path: a logistic last layer on data rescaled per tenant and
    # feature into [0, 1] with that tenant's training min and max.
    lo, hi = xs.min(axis=2, keepdims=True), xs.max(axis=2, keepdims=True)
    x01 = torch.as_tensor((xs - lo) / np.where(hi > lo, hi - lo, 1.0), device="cuda")
    cfg_l = dataclasses.replace(cfg, act_last="logsig")
    zero()
    fl_l = fleet._fit_fleet_chunked(cfg_l, x01, chunk_samples=FLEET_CHUNK, seeds=seeds)
    torch.cuda.synchronize()
    launches["logsig"] = read()
    want_l = expect(rolann_fused_chunk_batched=n_hidden * n_chunks,
                    rolann_stats_acc_batched=n_chunks)
    check(launches["logsig"] == want_l, f"logsig-output fleet fit launched {launches['logsig']}, "
          f"expected {want_l}")
    check(bool(torch.isfinite(fl_l.model.train_errors).all()), "logsig-output fleet errors")
    _check_refold_fleet("fused chunked fleet fit, act_last=logsig", cfg_l, fl_l,
                        fleet._device_chunks(x01, FLEET_CHUNK),
                        [len(fl_l.model.layer_knowledge) - 1])
    say("fleet", f"fused chunked fleet fit, act_last=logsig on [0, 1] data: launches "
        f"{launches['logsig']}")
    say("fleet", "times (host clock, ending in torch.cuda.synchronize()): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    return launches, devices


def phase_profile(label, run):
    """One ``run()`` under torch.profiler: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(averages.table(sort_by=key, row_limit=25))
    # Kernels only: an aten op's row repeats the time of the kernels it launched.
    device_us = sum(getattr(e, key) for e in averages
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    say("profile", f"{label}: wall {wall * 1e3:.2f} ms, device busy {device_us / 1e3:.2f} ms "
        f"({100 * device_us / 1e6 / wall:.1f} %)")


def _per_launch_sum(rows):
    """One JSON row for a kernel launched once per row's shape in a fit."""
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": ("operations" if all(r["bound_by"] == "operations" for r in rows)
                     else "bytes"),
        "library_ms": sum(r["library_ms"] for r in rows),
    }


def _per_fit(rows, launches_per_shape, bound_fn, shape_keys, n_valid):
    """One JSON row for a kernel over one fit: every launch of a shape runs
    at the chunk width, so its time counts ``launches_per_shape`` times; the
    bound counts each chunk's valid samples."""
    bounds = [bound_fn(*(r[k] for k in shape_keys), nv) for r in rows for nv in n_valid]
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": launches_per_shape * sum(r["ms"] for r in rows),
        "plain_ms": launches_per_shape * sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(b[0] for b in bounds),
        "bound_by": "operations" if all(b[1] == "operations" for b in bounds) else "bytes",
        "library_ms": (None if rows[0]["library_ms"] is None
                       else launches_per_shape * sum(r["library_ms"] for r in rows)),
    }


def main() -> int:
    try:
        import torch

        card = phase_device()
        phase_build()
        from repro_torch.core import daef, fleet

        cfg = daef.DAEFConfig(**CREDITCARD, stats_backend="fused")
        (x_train, x_test, y_test), (xtr, xte) = load_data()
        rows = phase_kernels(path_shapes(cfg), xtr.shape[1])
        last = (cfg.layer_sizes[-2] + 1, cfg.layer_sizes[0])  # B2 on the logsig-output path
        fold_rows = phase_fold_kernels(path_shapes(cfg) + [last], fused_shapes(cfg),
                                       CHUNK_SAMPLES)
        fleet_data, fleet_data_d = load_fleet_data()
        k_fleet, _, n_tenant = fleet_data[0].shape
        batched_rows = phase_batched_kernels(k_fleet, path_shapes(cfg), n_tenant, last,
                                             fused_shapes(cfg), FLEET_CHUNK)
        launches, card_fits = phase_main_path(cfg, xtr, xte, y_test)
        stream_launches, stream_fits = phase_streaming(cfg, x_train, x_test, y_test, xtr, xte)
        phase_reference(cfg, x_train, x_test, y_test, {**card_fits, **stream_fits})
        fleet_launches, devices = phase_fleet(cfg, fleet_data, fleet_data_d)
        phase_profile("one-shot fused fit + score", lambda: daef.reconstruction_error(
            cfg, daef.fit(cfg, xtr, n_partitions=N_PARTITIONS), xte))
        phase_profile("streamed fused fit_chunked", lambda: daef.fit_chunked(
            cfg, xtr, chunk_samples=CHUNK_SAMPLES))
        fleet_seeds, xs_d = fleet_data[1], fleet_data_d[0]
        phase_profile("fused fleet fit (64 tenants)", lambda: fleet.fleet_fit(
            cfg, xs_d, seeds=fleet_seeds))
        phase_profile("fused chunked fleet fit (64 tenants)", lambda: fleet._fit_fleet_chunked(
            cfg, xs_d, chunk_samples=FLEET_CHUNK, seeds=fleet_seeds))
        phase_profile("fleet merge 64 -> 32", lambda: fleet.fleet_merge_pairwise(cfg, devices))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    source = "src/repro_torch/kernels/rolann_stats/csrc/"
    replaces = "src/repro/kernels/rolann_stats/kernel.py:"
    n = xtr.shape[1]
    n_valid = [min(CHUNK_SAMPLES, n - i) for i in range(0, n, CHUNK_SAMPLES)]
    # The fleet's chunks: every tenant's, each valid width counted k times.
    fleet_valid = [min(FLEET_CHUNK, n_tenant - i) for i in range(0, n_tenant, FLEET_CHUNK)]
    fleet_bound = {
        "acc": lambda m, o, nv: _bound(*_batched_work(k_fleet, (
            _stats_work(m, o, nv)[0], _stats_work(m, o, nv)[1] + 4 * (o * m * m + o * m)))),
        "fused": lambda m_l, m_c1, nv: _bound(*_batched_work(k_fleet, _fused_work(m_l, m_c1, nv))),
    }
    kernels = [
        {
            "name": "rolann_stats",
            "route": "cuda",
            "source": source + "rolann_stats.cu",
            "replaces": replaces + "48",
            "launches": launches["rolann_stats"],
            # Sums over the main path's launches (one per layer shape, one fit).
            **_per_launch_sum(rows),
        },
        {
            "name": "rolann_stats_acc",
            "route": "cuda",
            "source": source + "rolann_stats.cu",
            "replaces": replaces + "171",
            "launches": stream_launches["rolann_stats_acc"],
            # One logsig-output streamed fit: 8 launches at the last layer's shape.
            **_per_fit([r for r in fold_rows["rolann_stats_acc"] if (r["m"], r["o"]) == last],
                       len(n_valid), _acc_bound, ("m", "o"), n_valid),
        },
        {
            "name": "rolann_fused_chunk",
            "route": "cuda",
            "source": source + "rolann_fused_chunk.cu",
            "replaces": replaces + "330",
            "launches": stream_launches["rolann_fused_chunk"],
            # One streamed fit: 8 launches at each hidden layer's shape.
            **_per_fit(fold_rows["rolann_fused_chunk"], len(n_valid), _fused_bound,
                       ("m_l", "m_c1"), n_valid),
        },
        {
            "name": "rolann_stats_batched",
            "route": "cuda",
            "source": source + "rolann_stats.cu",
            "replaces": replaces + "102",
            "launches": fleet_launches["fit"]["rolann_stats_batched"],
            # One fleet fit: one launch per layer shape.
            **_per_launch_sum(batched_rows["rolann_stats_batched"]),
        },
        {
            "name": "rolann_stats_acc_batched",
            "route": "cuda",
            "source": source + "rolann_stats.cu",
            "replaces": replaces + "231",
            "launches": fleet_launches["logsig"]["rolann_stats_acc_batched"],
            # One logsig-output chunked fleet fit: 4 launches at the last layer's shape.
            **_per_fit(batched_rows["rolann_stats_acc_batched"], len(fleet_valid),
                       fleet_bound["acc"], ("m", "o"), fleet_valid),
        },
        {
            "name": "rolann_fused_chunk_batched",
            "route": "cuda",
            "source": source + "rolann_fused_chunk.cu",
            "replaces": replaces + "405",
            "launches": fleet_launches["chunked"]["rolann_fused_chunk_batched"],
            # One chunked fleet fit: 4 launches at each hidden layer's shape.
            **_per_fit(batched_rows["rolann_fused_chunk_batched"], len(fleet_valid),
                       fleet_bound["fused"], ("m_l", "m_c1"), fleet_valid),
        },
    ]
    print(json.dumps({"per_shape": {"rolann_stats": rows, **fold_rows, **batched_rows}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
