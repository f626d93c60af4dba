"""How often torch.profiler records no device event for one short call on
the card, and where the recorded kernels lie against their host launch.

    python3 scripts/torch_profiler_window.py fresh
        In a fresh process, 100 profiles of one B1 call (slice route) for
        each of idle host padding 0, 2 ms and 20 ms on both sides of the
        call, with and without host ops; 100 of one tiny aten kernel; then
        the first five profiles of each of four fresh processes.  Prints
        the indices of the profiles that recorded no device event.
    python3 scripts/torch_profiler_window.py loaded SECONDS
        For SECONDS, ~4 s of bf16 GEMMs on the card, then two profiles of a
        tiny aten kernel followed by one B1 call: bare, and with 20 ms of
        idle host time on both sides.  Prints how many device events each
        recorded and, for each, its start minus the aten op's host start
        (µs).

Each mode needs a card; run from the repo's root.
"""
import json
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, "src")
from repro_torch.kernels.rolann_stats import ops, rolann_stats  # noqa: E402


def _inputs():
    m, o = next((m, o) for m in (9, 17, 25, 33, 65) for o in (8, 16, 24, 32)
                if ops.stats_slice_route(m, o))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 100_000
    xa = torch.sigmoid(torch.randn((m, n), generator=gen, device="cuda"))
    fsq = torch.rand((o, n), generator=gen, device="cuda") / 16
    fd = fsq * torch.randn((o, n), generator=gen, device="cuda")
    return (m, o), (xa, fsq, fd)


def _count(fn, pad, cpu=True):
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        if pad:
            time.sleep(pad)
        fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    av = prof.key_averages()
    return sum(1 for e in av if e.device_type == torch.autograd.DeviceType.CUDA)


def fresh(first_only=False):
    shape, args = _inputs()
    fn = lambda: rolann_stats(*args)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    if first_only:
        print(json.dumps({"first": [_count(fn, 0) for _ in range(5)]}), flush=True)
        return
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda, "shape": shape}))
    for pad in (0, 0.002, 0.02):
        for cpu in (True, False):
            t0 = time.perf_counter()
            empty = [i for i in range(100) if _count(fn, pad, cpu) == 0]
            print(json.dumps({"pad": pad, "cpu": cpu, "empty": empty,
                              "s": time.perf_counter() - t0}), flush=True)
    tiny = torch.ones(1 << 10, device="cuda")
    empty = [i for i in range(100) if _count(lambda: tiny.mul_(1.0), 0) == 0]
    print(json.dumps({"aten tiny": empty}), flush=True)
    for _ in range(4):
        out = subprocess.run([sys.executable, __file__, "first"], capture_output=True,
                             text=True, timeout=120)
        print(out.stdout.strip()[-300:], out.stderr.strip()[-300:] if out.returncode else "",
              flush=True)


def _sample(fn, tiny, pad):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if pad:
            time.sleep(pad)
        tiny.mul_(1.0)
        fn()
        torch.cuda.synchronize()
        if pad:
            time.sleep(pad)
    ev = prof.events()
    cpu = [e.time_range.start for e in ev if e.name == "aten::mul_"]
    dev = {e.name.split("(")[0][-40:]: e.time_range.start for e in ev
           if e.device_type == torch.autograd.DeviceType.CUDA}
    return {"n_dev": len(dev), "gap_us": {k: v - cpu[0] for k, v in dev.items()} if cpu else None}


def loaded(seconds):
    gen = torch.Generator(device="cuda").manual_seed(0)
    xa = torch.sigmoid(torch.randn((9, 100_000), generator=gen, device="cuda"))
    fsq = torch.rand((8, 100_000), generator=gen, device="cuda") / 16
    fd = fsq * 0.5
    fn = lambda: rolann_stats(xa, fsq, fd)  # noqa: E731
    tiny = torch.ones(1024, device="cuda")
    a = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    fn()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 4:
            for _ in range(20):
                a = (a @ a).clamp_(-1, 1)
            torch.cuda.synchronize()
        row = {"t": round(time.perf_counter() - t0, 1), "bare": _sample(fn, tiny, 0),
               "pad": _sample(fn, tiny, 0.02)}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1:2]
    if mode == ["fresh"]:
        fresh()
    elif mode == ["first"]:
        fresh(first_only=True)
    elif mode == ["loaded"]:
        loaded(float(sys.argv[2]))
    else:
        sys.exit(__doc__)
