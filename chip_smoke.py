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
   after warm-up).
4. main path — the paper's Table 5 "creditcard" DAEF (29-15-18-21-24-27-29,
   lam 0.8/0.9, extreme-IQR rule) on the full-scale replica, fold 0:
   ``daef.fit(n_partitions=4)`` -> ``reconstruction_error`` -> ``threshold``
   -> ``classify`` -> ``evaluate`` with ``stats_backend="fused"``, after one
   warm-up.  Launch counts are zeroed just before and read just after;
   every kernel of the path must have run (rolann_stats: 4 per fit).  The
   same fit on the plain einsum backend must give the same first-layer
   statistics (1e-4 * max|G|); the weights' drift is reported.
5. reference — the same replica fitted on the host in float32 (the CPU path
   the parity tests hold to the JAX package) and in float64: the card's
   fused fit must be no farther from the float64 fit than the plain float32
   fits are (see phase_reference); every fit's F1 is printed.
6. profile — one fused fit + score under ``torch.profiler``: device time by
   kernel, and the device's busy share of the wall time.

The last two lines are a JSON object of per-kernel numbers and
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


def _stats_bound(m, o, n):
    """Least time for the work: the upper triangle of G (o*n*m(m+1)/2 FMAs),
    the fsq scaling (o*m*n) and M (o*m*n FMAs), against reading xa, fsq, fd
    once and writing G and M once, in float32."""
    flops = 2 * o * n * m * (m + 1) // 2 + o * m * n + 2 * o * m * n
    nbytes = 4 * (m * n + 2 * o * n + o * m * m + o * m)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    from repro_torch.kernels.rolann_stats import rolann_stats

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
    rolann_stats.launches = 0
    t0 = time.perf_counter()
    model, scores, t1 = run(cfg)
    t2 = time.perf_counter()
    mu = anomaly.threshold(model.train_errors, RULE)
    pred = anomaly.classify(scores, mu)
    metrics = anomaly.evaluate(model.train_errors, scores, y_test, RULE)
    launches = {"rolann_stats": rolann_stats.launches}
    fit_ms, score_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    n_layers = len(path_shapes(cfg))
    check(launches["rolann_stats"] == n_layers,
          f"rolann_stats launched {launches['rolann_stats']} times in one fit, "
          f"expected {n_layers}")
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


def phase_reference(cfg, x_train, x_test, y_test, card_fits):
    """The same replica fitted on the host in float32 (the path the CPU tests
    hold to the JAX package) and in float64.  Every float32 fit sits a few
    percent from the float64 one on this configuration (see
    ``_compare_backends``); the card's fused fit must be no farther from it
    than twice the farthest of the plain float32 fits, plus 1e-4 (TOLS), in
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
        plain = max(d for k, d in dist.items() if k != "card fused")
        check(dist["card fused"] <= 2 * plain + 1e-4,
              f"{name}: the card's fused fit is {dist['card fused']:.3e} from the float64 "
              f"fit, the plain float32 fits at most {plain:.3e}")
        say("reference", f"{name}, max|d| / max|.| from the host float64 fit: "
            + ", ".join(f"{k} {d:.2e}" for k, d in dist.items()))
    say("reference", "F1: " + ", ".join(f"{k} {v[2]:.4f}" for k, v in fits.items())
        + f", host float64 {f1_64:.4f} (host float32 fit {host_s:.2f} s, "
        f"{torch.get_num_threads()} threads)")


def phase_profile(cfg, xtr, xte):
    """One fused fit + score under torch.profiler: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import daef

    daef.reconstruction_error(cfg, daef.fit(cfg, xtr, n_partitions=N_PARTITIONS), xte)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        daef.reconstruction_error(cfg, daef.fit(cfg, xtr, n_partitions=N_PARTITIONS), xte)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(averages.table(sort_by=key, row_limit=25))
    # Kernels only: an aten op's row repeats the time of the kernels it launched.
    device_us = sum(getattr(e, key) for e in averages
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    say("profile", f"wall {wall * 1e3:.2f} ms, device busy {device_us / 1e3:.2f} ms "
        f"({100 * device_us / 1e6 / wall:.1f} %)")


def main() -> int:
    try:
        import torch

        card = phase_device()
        phase_build()
        from repro_torch.core import daef

        cfg = daef.DAEFConfig(**CREDITCARD, stats_backend="fused")
        (x_train, x_test, y_test), (xtr, xte) = load_data()
        rows = phase_kernels(path_shapes(cfg), xtr.shape[1])
        launches, card_fits = phase_main_path(cfg, xtr, xte, y_test)
        phase_reference(cfg, x_train, x_test, y_test, card_fits)
        phase_profile(cfg, xtr, xte)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernel = {
        "name": "rolann_stats",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rolann_stats/csrc/rolann_stats.cu",
        "replaces": "src/repro/kernels/rolann_stats/kernel.py:48",
        "launches": launches["rolann_stats"],
        # Sums over the main path's launches (one per layer shape, one fit).
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_ms"] for r in rows),
        "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows) else "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }
    print(json.dumps({"per_shape": {"rolann_stats": rows}}))
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
