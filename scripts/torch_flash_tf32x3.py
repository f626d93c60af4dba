"""B7's and B8's float32 route (3xTF32 wgmma) on the card: held to the
plain versions, timed, and the other tensor-core routes compared bit for
bit with an older checkout's kernels.

    python3 scripts/torch_flash_tf32x3.py check
        B7 and B8 in float32 at the five head-size pairs, causal and not,
        windows 1 and 17, a q_offset stripe, MQA and ragged S, against their
        plain versions under chip_smoke.py's bars (B7 out 1e-5 of max(1,
        max|ref|), lse 1e-5 of max|lse|; B8 each element 1e-5 of its term
        magnitude), each repeat bit-identical and counted on
        route_launches["tf32x3"]; ptxas's registers and spills of every
        float32 instantiation.
    python3 scripts/torch_flash_tf32x3.py time
        CUDA-events times (median of 25) of the float32 route at the path
        shapes chip_smoke.py times (MLA's (192, 128), whisper's encoder,
        qwen2's stripes, qwen3's train shape), beside the plain version,
        SDPA in float32 and the 3xTF32 bound; the card's name and power
        limit first.
    python3 scripts/torch_flash_tf32x3.py profile
        The device time of each float32 kernel (B7's, B8's dq and dk/dv
        launches) by name, from torch.profiler, at MLA's (192, 128) and at
        qwen3's train shape: where B8's time goes.
    python3 scripts/torch_flash_tf32x3.py bits OUT [--src DIR]
        The outputs of B7's and B8's bf16 kernels, B1's 3xTF32 route and
        B10 at the shapes chip_smoke.py checks, from seeded inputs, saved to
        OUT; with --src, the kernels of the checkout whose src/ is DIR.
    python3 scripts/torch_flash_tf32x3.py compare A B
        Whether two `bits` files are equal, tensor for tensor, bit for bit.

Each mode needs a card, except `compare`.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, B, Sq, Sk, H, Hkv, D, D_v, causal, window, q_offset)
CHECK_CASES = [
    ("D 32 window 17", 2, 512, 512, 8, 2, 32, 32, True, 17, 0),
    ("D 64 ragged", 1, 1_000, 1_000, 8, 2, 64, 64, True, None, 0),
    ("D 64 causal=False", 2, 1_500, 1_500, 6, 6, 64, 64, False, None, 0),
    ("D 128 GQA", 2, 512, 512, 16, 8, 128, 128, True, None, 0),
    ("D 128 window 1 MQA", 1, 300, 300, 4, 1, 128, 128, True, 1, 0),
    ("D 128 stripe", 2, 512, 2_048, 12, 2, 128, 128, True, None, 1_024),
    ("D 256 window 17 MQA", 2, 600, 600, 16, 1, 256, 256, True, 17, 0),
    ("D 256 ragged", 1, 333, 333, 4, 2, 256, 256, False, None, 0),
    ("(192, 128) ragged", 1, 1_000, 1_000, 8, 8, 192, 128, True, None, 0),
    ("(192, 128) causal=False", 1, 257, 257, 4, 4, 192, 128, False, None, 0),
]


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def _inputs(gen, b, sq, sk, h, hkv, d, d_v, dtype):
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return randn(b, sq, h, d), randn(b, sk, hkv, d), randn(b, sk, hkv, d_v), randn(b, sq, h, d_v)


def check() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_magnitudes,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    cs.phase_device()
    gen = torch.Generator(device="cuda").manual_seed(37)
    for label, b, sq, sk, h, hkv, d, d_v, causal, window, off in CHECK_CASES:
        q, k, v, do = _inputs(gen, b, sq, sk, h, hkv, d, d_v, torch.float32)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = (flash_attention.route_launches["tf32x3"],
                  flash_attention_bwd.route_launches["tf32x3"])
        out, lse = flash_attention(q, k, v, **kw)
        grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        cs.check((flash_attention.route_launches["tf32x3"],
                  flash_attention_bwd.route_launches["tf32x3"]) == (before[0] + 1, before[1] + 1),
                 f"{label}: not counted on tf32x3")
        ref, ref_lse = flash_attention_ref(q, k, v, **kw)
        err, scale = cs._agree(f"B7 {label} out", out, ref, 1e-5, 1.0)
        err_lse, scale_lse = cs._agree(f"B7 {label} lse", lse, ref_lse, 1e-5)
        mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, do, **kw)
        err_b, used_b = cs._agree_bwd(label, grads, flash_attention_bwd_ref(
            q, k, v, out, lse, do, **kw), mags, torch.float32)
        again = flash_attention(q, k, v, **kw)
        again_b = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        cs.check(all(torch.equal(x, y) for x, y in zip((*again, *again_b), (out, lse, *grads))),
                 f"{label}: a repeat is not bit-identical")
        cs.say("tf32x3", f"{label} B={b} Sq={sq} Sk={sk} H={h}/{hkv} ({d}, {d_v}) causal={causal} "
               f"window={window} q_offset={off}: B7 out {err / (1e-5 * scale):.3f} and lse "
               f"{err_lse / (1e-5 * scale_lse):.3f} of their bars, B8 worst {used_b:.3f} of its "
               "per-element bar, repeats bit-identical, ok")
        del q, k, v, do, out, lse, grads, ref, ref_lse, mags, again, again_b
        torch.cuda.empty_cache()
    for lib, kernels in (("flash_attention", ["flash_fwd_tf32x3_kernel"]),
                         ("flash_attention_bwd", ["flash_bwd_dq_tf32x3_kernel",
                                                  "flash_bwd_dkv_tf32x3_kernel"])):
        for kernel in kernels:
            for args, (regs, stores, loads) in sorted(cs._ptxas(lib, kernel).items()):
                cs.say("tf32x3", f"ptxas {kernel}<{args}>: {regs} registers, spill stores "
                       f"{stores} B, spill loads {loads} B")


def _time_row(cs, label, fn, plain, library, flops, nbytes, plain_reps=5):
    ms = cs.cuda_ms(fn)
    plain_ms = cs.cuda_ms(plain, reps=plain_reps, warmup=1)
    try:
        library_ms = cs.cuda_ms(library)
    except RuntimeError as exc:  # SDPA refuses the shapes: say so
        library_ms = None
        cs.say("tf32x3", f"{label}: SDPA refused ({str(exc)[:100]})")
    bound_ms, bound_by = cs._bound(flops, nbytes, cs.PEAK_TF32X3_FLOPS)
    cs.say("tf32x3", f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA float32 "
           f"{'refused' if library_ms is None else f'{library_ms:.4f} ms'}, 3xTF32 bound "
           f"{bound_ms:.4f} ms ({bound_by}, {flops:.4g} FLOP), {bound_ms / ms:.1%} of it")


def time_routes() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    cs.phase_device()
    cs.say("tf32x3", f"card: {_card()}")
    gen = torch.Generator(device="cuda").manual_seed(38)
    f32 = torch.float32
    # (label, B, S, H, Hkv, D, D_v, causal, forward)
    cases = [
        ("B7 MLA (192, 128) 1 x 4,096, 128 heads", 1, 4_096, 128, 128, 192, 128, True, True),
        ("B8 MLA (192, 128) 2 x 2,048, 128 heads", 2, 2_048, 128, 128, 192, 128, True, False),
        ("B7 whisper encoder 16 x 1,500 x 6 x 64", 16, 1_500, 6, 6, 64, 64, False, True),
        ("B8 whisper encoder 8 x 1,500 x 6 x 64", 8, 1_500, 6, 6, 64, 64, False, False),
        ("B7 qwen3 train shape 2 x 2,048, 16/8 x 128", 2, 2_048, 16, 8, 128, 128, True, True),
        ("B8 qwen3 train shape 2 x 2,048, 16/8 x 128", 2, 2_048, 16, 8, 128, 128, True, False),
    ]
    for label, b, s, h, hkv, d, d_v, causal, forward in cases:
        q, k, v, do = _inputs(gen, b, s, s, h, hkv, d, d_v, f32)
        kw = dict(causal=causal)
        if forward:
            flops, nbytes = cs._attention_work(b, s, h, hkv, d, 4, None, d_v, causal)
            _time_row(cs, label, lambda: flash_attention(q, k, v, **kw),
                      lambda: flash_attention_ref(q, k, v, **kw),
                      lambda: cs._sdpa(q, k, v, None, causal), flops, nbytes)
        else:
            out, lse = flash_attention(q, k, v, **kw)
            flops, nbytes = cs._attention_bwd_work(b, s, h, hkv, d, 4, None, d_v, causal)
            _time_row(cs, label, lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw),
                      lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                      cs._sdpa_bwd(q, k, v, do, None, causal), flops, nbytes)
            del out, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    st = cs.STRIPE
    for offset in cs.STRIPE_OFFSETS:
        q, do = (torch.randn((st["b"], st["sq"], st["h"], st["d"]), generator=gen,
                             device="cuda") for _ in range(2))
        k, v = (torch.randn((st["b"], st["sk"], st["hkv"], st["d"]), generator=gen,
                            device="cuda") for _ in range(2))
        kw = dict(q_offset=offset)
        args = (st["b"], st["sq"], st["sk"], st["h"], st["hkv"], st["d"], 4, offset)
        _time_row(cs, f"B7 qwen2 stripe at {offset}", lambda: flash_attention(q, k, v, **kw),
                  lambda: flash_attention_ref(q, k, v, **kw),
                  lambda: cs._sdpa_stripe(q, k, v, offset), *cs._stripe_work(*args))
        out, lse = flash_attention(q, k, v, **kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        sd_out = cs._sdpa_stripe(*leaves, offset)
        _time_row(cs, f"B8 qwen2 stripe at {offset}",
                  lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw),
                  lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                  lambda: torch.autograd.grad(sd_out, leaves, do.transpose(1, 2),
                                              retain_graph=True),
                  *cs._stripe_work(*args, backward=True))
        del q, k, v, do, out, lse, leaves, sd_out
        torch.cuda.empty_cache()


def profile() -> None:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    cs.phase_device()
    cs.say("tf32x3", f"card: {_card()}")
    gen = torch.Generator(device="cuda").manual_seed(39)
    for label, b, s, h, hkv, d, d_v in (("MLA (192, 128) 2 x 2,048, 128 heads", 2, 2_048, 128, 128,
                                         192, 128),
                                        ("qwen3 train shape 2 x 2,048, 16/8 x 128", 2, 2_048, 16,
                                         8, 128, 128)):
        q, k, v, do = _inputs(gen, b, s, s, h, hkv, d, d_v, torch.float32)
        out, lse = flash_attention(q, k, v)
        for _ in range(2):
            flash_attention(q, k, v)
            flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                flash_attention(q, k, v)
                flash_attention_bwd(q, k, v, out, lse, do)
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            if "tf32x3" in evt.key:
                dev = getattr(evt, "device_time_total", None) or evt.cuda_time_total
                cs.say("tf32x3", f"{label}: {evt.key[:90]} x{evt.count}: "
                       f"{dev / evt.count / 1e3:.4f} ms a launch")
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def bits(out_path: str) -> None:
    """Seeded inputs through the bf16 B7/B8 kernels, B1's tensor-core route
    and B10, at chip_smoke.py's shapes; the outputs saved on the host."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rolann_stats import rolann_stats
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16 = torch.bfloat16
    saved = {}
    # (label, B, Sq, Sk, H, Hkv, D, D_v, causal, window, q_offset)
    for label, b, sq, sk, h, hkv, d, d_v, causal, window, off in [
            ("train", 2, 2_048, 2_048, 16, 8, 128, 128, True, None, 0),
            ("recurrentgemma", 2, 4_096, 4_096, 16, 1, 256, 256, True, 2_048, 0),
            ("ragged window", 2, 1_000, 1_000, 8, 2, 64, 64, True, 300, 0),
            ("head 32", 2, 512, 512, 8, 2, 32, 32, True, 77, 0),
            ("encoder", 8, 1_500, 1_500, 6, 6, 64, 64, False, None, 0),
            ("mla", 2, 2_048, 2_048, 128, 128, 192, 128, True, None, 0),
            ("mla ragged", 1, 1_000, 1_000, 128, 128, 192, 128, True, None, 0),
            ("stripe", 2, 512, 2_048, 12, 2, 128, 128, True, None, 1_024)]:
        q, k, v, do = _inputs(gen, b, sq, sk, h, hkv, d, d_v, bf16)
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = flash_attention(q, k, v, **kw)
        grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        for name, t in zip(("out", "lse", "dq", "dk", "dv"), (out, lse, *grads)):
            saved[f"B7/B8 bf16 {label} {name}"] = t.cpu()
        del q, k, v, do, out, lse, grads
    for m, o, n in ((513, 256, 2_048), (513, 256, 65_536), (37, 3, 517), (29, 2, 10_007)):
        z = torch.randn((m, n), generator=gen, device="cuda")
        xa = torch.sigmoid(z)
        xa[-1] = 1.0
        fsq = torch.rand((o, n), generator=gen, device="cuda") / 16.0
        fd = fsq * torch.randn((o, n), generator=gen, device="cuda") * 2.0
        g, mv = rolann_stats(xa, fsq, fd)
        saved[f"B1 tf32x3 m={m} o={o} n={n} G"], saved[f"B1 tf32x3 m={m} o={o} n={n} M"] = \
            g.cpu(), mv.cpu()
    route = rolann_stats.route_launches
    assert route["tf32x3"] == 4, f"B1 not on its tensor-core route: {route}"
    for b, s, h, p, g, n, chunk in ((4, 4_096, 48, 64, 1, 128, 256), (2, 1_000, 48, 64, 1, 128, 256),
                                    (2, 1_024, 8, 64, 2, 128, 256)):
        xdt = torch.randn((b, s, h, p), generator=gen, device="cuda")
        la = -torch.rand((b, s, h), generator=gen, device="cuda") * 0.1
        bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda") for _ in range(2))
        y, hf = ssd_chunk(xdt, la, bm, cm, chunk=chunk)
        saved[f"B10 {b}x{s} H={h} G={g} y"], saved[f"B10 {b}x{s} H={h} G={g} h_final"] = \
            y.cpu(), hf.cpu()
    torch.save(saved, out_path)
    print(f"[bits] {len(saved)} tensors to {out_path}", flush=True)


def compare(a: str, b: str) -> int:
    import torch

    x, y = torch.load(a), torch.load(b)
    assert x.keys() == y.keys(), f"different tensors: {sorted(set(x) ^ set(y))}"
    differ = [k for k in x if not torch.equal(x[k], y[k])]
    for k in x:
        print(f"[bits] {k}: {'bit for bit' if k not in differ else 'DIFFERS'}", flush=True)
    print(f"[bits] {len(x) - len(differ)} of {len(x)} tensors bit for bit", flush=True)
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "time", "profile", "bits", "compare"))
    ap.add_argument("paths", nargs="*")
    ap.add_argument("--src", default=None, help="the src/ of the checkout whose kernels run")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.mode == "bits":
        sys.path.insert(0, str(Path(args.src).resolve() if args.src else ROOT / "src"))
        bits(args.paths[0])
    elif args.mode == "compare":
        return compare(*args.paths)
    elif args.mode == "check":
        check()
    elif args.mode == "profile":
        profile()
    else:
        time_routes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
