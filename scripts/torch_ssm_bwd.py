"""The backwards of the SSM scans on the card: B10's (``ssd_chunk_bwd``) and
B9's (``rglru_scan_bwd``), held to their plain versions, timed, split into
their launches, and the forwards compared bit for bit with an older
checkout's kernels.

    python3 scripts/torch_ssm_bwd.py check
        Phase 24 (a) of chip_smoke.py: B10's backward at mamba2-780m's
        microbatch (2 x 2,048, 48 heads of P 64, N 128, chunk 256) and at
        G = 2 with S 1,000 (chunk 250), both with an h_final cotangent, at
        S = 1 and B = 0, and at mamba2's initial decays (cum reaches -10³
        within a chunk); P = 65 refused.  B9's backward at recurrentgemma-9b's
        microbatch (2 x 2,048 x 4,096, bf16 x and float32) and at S = 37
        (W = 100) and S = 1.  chip_smoke.py's bars, repeats bit-identical;
        ptxas's registers and spills of every backward kernel.
    python3 scripts/torch_ssm_bwd.py time [--src DIR]
        CUDA-events times (median of 25) of both backwards at the two
        microbatches, beside the plain versions and the bounds; the card's
        name and power limit first.  With --src, the kernels of the checkout
        whose src/ is DIR.
    python3 scripts/torch_ssm_bwd.py profile [--src DIR]
        The device time of each launch of both backwards by kernel name, from
        torch.profiler, at the two microbatches.
    python3 scripts/torch_ssm_bwd.py step [--src DIR]
        mamba2-780m's 10 bf16 train steps of phase 24 (c) and one profiled
        step: the median step, the device's busy share and where the device
        time goes (an older checkout's B10ᵇ kernels show under their own
        names among the largest).
    python3 scripts/torch_ssm_bwd.py bits OUT [--src DIR]
        B10's and B9's forwards and both backwards at the microbatches and at
        ragged shapes, from seeded inputs, saved to OUT.
    python3 scripts/torch_ssm_bwd.py compare A B
        Whether two `bits` files agree: every forward output bit for bit
        (else exit 1), and which backward outputs keep their bits.

Each mode needs a card, except `compare`.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, B, S, H, P, G, N, chunk, dh_final)
SSD_SHAPE = ("mamba2 train", 2, 2_048, 48, 64, 1, 128, 256, True)
# (label, B, S, W, x dtype, gate dtype)
RGLRU_SHAPES = (("recurrentgemma train", 2, 2_048, 4_096, "bfloat16", "float32"),
                ("recurrentgemma train float32", 2, 2_048, 4_096, "float32", "float32"))


def _ssd_args(gen, b, s, h, p, g, n, final, decays=False):
    """Seeded B10 backward inputs; ``decays``: mamba2's initial la = -a·dt,
    a = linspace(1, 16, H), dt = softplus(N(0, 1)), else la in [-0.1, 0]."""
    import torch

    xdt, dy = (torch.randn((b, s, h, p), generator=gen, device="cuda") for _ in range(2))
    if decays:
        a = torch.linspace(1.0, 16.0, h, device="cuda")
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
        la = -a * dt
    else:
        la = -torch.rand((b, s, h), generator=gen, device="cuda") * 0.1
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda") for _ in range(2))
    dh = torch.randn((b, h, p, n), generator=gen, device="cuda") if final else None
    return xdt, la, bm, cm, dy, dh


def _rglru_args(gen, b, s, w, x_dtype, g_dtype):
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan

    xd, gd = getattr(torch, x_dtype), getattr(torch, g_dtype)
    x = torch.randn((b, s, w), generator=gen, device="cuda").to(xd)
    r, i = (torch.sigmoid(torch.randn((b, s, w), generator=gen, device="cuda")).to(gd)
            for _ in range(2))
    lam = torch.randn((w,), generator=gen, device="cuda") + 4
    y, _ = rglru_scan(x, r, i, lam)
    dy = torch.randn((b, s, w), generator=gen, device="cuda")
    dh = torch.randn((b, w), generator=gen, device="cuda")
    return x, r, i, lam, y, dy, dh


def check(cs) -> None:
    import torch

    from repro_torch.kernels import _build

    card = cs.phase_device()
    cs._ssd_bwd_checks(card)
    cs._rglru_bwd_checks(card)
    torch.cuda.empty_cache()
    for lib, kernels in (("ssd_chunk_bwd", cs.SSM_PROFILE_GROUPS["B10 backward"]),
                         ("rglru_scan_bwd", cs.SSM_PROFILE_GROUPS["B9 backward"])):
        for kernel in kernels:
            for args, (regs, stores, loads) in sorted(cs._ptxas(lib, kernel).items()):
                cs.say("ssm-bwd", f"ptxas {kernel}<{args}>: {regs} registers, spill stores "
                       f"{stores} B, spill loads {loads} B")
        for line in _build.build_log(lib).splitlines():
            if "wgmma" in line or "arning" in line:  # serialised wgmmas, other warnings
                cs.say("ssm-bwd", f"ptxas {lib}: {line.strip()}")


def time_kernels(cs) -> None:
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_bwd_plain
    from repro_torch.kernels.ssd_chunk import fit_chunk, ssd_chunk_bwd, ssd_chunk_bwd_plain

    card = cs.phase_device()
    cs.say("ssm-bwd", f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(38)
    label, b, s, h, p, g, n, chunk, final = SSD_SHAPE
    args = _ssd_args(gen, b, s, h, p, g, n, final)
    q = fit_chunk(s, chunk)
    ms = cs.cuda_ms(lambda: ssd_chunk_bwd(*args, chunk=chunk))
    plain_ms = cs.cuda_ms(lambda: ssd_chunk_bwd_plain(*args, chunk=q), reps=5, warmup=1)
    work = cs._ssd_bwd_work(b, s, h, p, g, n, q)
    bound_ms, bound_by = cs._bound(*work, cs.PEAK_TF32X3_FLOPS)
    fp32_ms, _ = cs._bound(*work)
    cs.say("ssm-bwd", f"ssd_chunk_bwd {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
           f"bound {bound_ms:.4f} ms at 3xTF32 ({bound_by}), {fp32_ms:.4f} ms on FP32 cores, "
           f"{ms / bound_ms:.2f}x the bound")
    del args
    for label, b, s, w, xd, gd in RGLRU_SHAPES:
        args = _rglru_args(gen, b, s, w, xd, gd)
        ms = cs.cuda_ms(lambda: rglru_scan_bwd(*args))
        plain_ms = cs.cuda_ms(lambda: rglru_scan_bwd_plain(*args), reps=5, warmup=1)
        bound_ms, bound_by = cs._bound(*cs._rglru_bwd_work(b, s, w, args[0].element_size(),
                                                          args[1].element_size()))
        cs.say("ssm-bwd", f"rglru_scan_bwd {label} (x {xd}, gates {gd}): kernel {ms:.4f} ms, "
               f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
               f"{ms / bound_ms:.2f}x the bound")
        del args
        torch.cuda.empty_cache()


def profile(cs) -> None:
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd

    card = cs.phase_device()
    cs.say("ssm-bwd", f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(39)
    label, b, s, h, p, g, n, chunk, final = SSD_SHAPE
    args = _ssd_args(gen, b, s, h, p, g, n, final)
    split = cs._kernel_us(lambda: ssd_chunk_bwd(*args, chunk=chunk), ("",))  # every kernel
    cs.say("ssm-bwd", f"ssd_chunk_bwd {label}, device ms a launch: "
           + ", ".join(f"{k[:60]} {us / 1e3:.4f}" for k, (_, us) in split.items())
           + f"; sum {sum(us for _, us in split.values()) / 1e3:.4f} ms")
    cs.say("ssm-bwd", f"ssd_chunk_bwd {label}: the host enqueues a call in "
           f"{_host_us(lambda: ssd_chunk_bwd(*args, chunk=chunk)):.1f} µs")
    del args
    for label, b, s, w, xd, gd in RGLRU_SHAPES:
        args = _rglru_args(gen, b, s, w, xd, gd)
        split = cs._kernel_us(lambda: rglru_scan_bwd(*args), ("",))
        cs.say("ssm-bwd", f"rglru_scan_bwd {label}, device ms a launch: "
               + ", ".join(f"{k[:60]} {us / 1e3:.4f}" for k, (_, us) in split.items())
               + f"; the host enqueues a call in {_host_us(lambda: rglru_scan_bwd(*args)):.1f} µs")
        del args
        torch.cuda.empty_cache()


def step(cs) -> None:
    card = cs.phase_device()
    cs.say("ssm-bwd", f"card: {card}")
    b, s, changes = cs.SSM_TRAIN[cs.MAMBA2]
    cfg, _, params, state, step_fn, *_ = cs._train_steps(
        cs.MAMBA2, card, b, s, changes, seed=90, tag="ssm-bwd")
    cs._profile_train_step(cs.MAMBA2, step_fn, params, state,
                           cs._train_batch(cfg, b, s, seed=cs.TRAIN_STEPS))


def _host_us(fn, reps=20):
    """The host's time to enqueue one call of ``fn`` (median, µs), each call
    after the card has drained, so that no call waits for room in the queue."""
    import statistics
    import time

    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bits(out_path: str) -> None:
    """Seeded inputs through B10, B9 and their backwards; the outputs saved
    on the host, keyed "forward ..." and "backward ..."."""
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    saved = {}
    for b, s, h, p, g, n, chunk, decays in ((4, 4_096, 48, 64, 1, 128, 256, False),
                                            (2, 2_048, 48, 64, 1, 128, 256, True),
                                            (2, 1_000, 8, 64, 2, 128, 256, False),
                                            (1, 300, 6, 16, 3, 32, 256, False)):
        xdt, la, bm, cm, dy, dh = _ssd_args(gen, b, s, h, p, g, n, True, decays)
        key = f"B10 {b}x{s} H={h} P={p} G={g} N={n}{' decays' if decays else ''}"
        y, hf = ssd_chunk(xdt, la, bm, cm, chunk=chunk)
        saved[f"forward {key} y"], saved[f"forward {key} h_final"] = y.cpu(), hf.cpu()
        for name, t in zip(("dxdt", "dla", "db", "dc"),
                           ssd_chunk_bwd(xdt, la, bm, cm, dy, dh, chunk=chunk)):
            saved[f"backward {key} {name}"] = t.cpu()
        del xdt, la, bm, cm, dy, dh, y, hf
    for b, s, w, xd, gd in ((2, 4_096, 4_096, "bfloat16", "float32"),
                            (2, 2_048, 4_096, "bfloat16", "float32"),
                            (2, 2_048, 4_096, "float32", "float32"),
                            (2, 37, 100, "bfloat16", "bfloat16"),
                            (3, 1, 77, "float32", "float32"),
                            (2, 1_000, 4_096, "bfloat16", "bfloat16")):
        x, r, i, lam, y, dy, dh = _rglru_args(gen, b, s, w, xd, gd)
        key = f"B9 {b}x{s}x{w} x {xd} gates {gd}"
        saved[f"forward {key} y"] = y.cpu()
        saved[f"forward {key} h_last"] = rglru_scan(x, r, i, lam)[1].cpu()
        for name, t in zip(("dx", "dr", "di", "dlam"), rglru_scan_bwd(x, r, i, lam, y, dy, dh)):
            saved[f"backward {key} {name}"] = t.cpu()
        del x, r, i, lam, y, dy, dh
    torch.save(saved, out_path)
    print(f"[bits] {len(saved)} tensors to {out_path}", flush=True)


def compare(a: str, b: str) -> int:
    import torch

    x, y = torch.load(a), torch.load(b)
    assert x.keys() == y.keys(), f"different tensors: {sorted(set(x) ^ set(y))}"
    differ = [k for k in x if not torch.equal(x[k], y[k])]
    for k in x:
        print(f"[bits] {k}: {'bit for bit' if k not in differ else 'DIFFERS'}", flush=True)
    fwd = [k for k in x if k.startswith("forward")]
    bad = [k for k in fwd if k in differ]
    print(f"[bits] forwards: {len(fwd) - len(bad)} of {len(fwd)} tensors bit for bit; "
          f"backwards: {len(x) - len(fwd) - len(differ) + len(bad)} of {len(x) - len(fwd)}",
          flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "time", "profile", "step", "bits", "compare"))
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--src", default=None, help="the src/ of the checkout whose kernels run")
    args = ap.parse_args(argv)
    if args.mode == "compare":
        return compare(*args.paths)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # puts this checkout's src/ first on the path

    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    if args.mode == "bits":
        bits(args.paths[0])
    elif args.mode == "check":
        check(cs)
    elif args.mode == "profile":
        profile(cs)
    elif args.mode == "step":
        step(cs)
    else:
        time_kernels(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
