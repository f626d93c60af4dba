"""One CLI for the port's analysis tooling (counterpart of
``repro/analysis/__main__.py``).

* ``python -m repro_torch.analysis [lint] <paths...>`` — the port's
  repro-lint over files/dirs (see ``python -m repro_torch.analysis.lint
  --help``).
* ``python -m repro_torch.analysis donation [--device cpu]`` — runtime
  self-check: probe the port's reused hot buffers (the serving tile and
  the streaming accumulator fold) on this device and print per-call-site
  reports.
* ``python -m repro_torch.analysis retrace [--device cpu]`` — runtime
  self-check: build a tiny fleet server, warm it up, and verify a mixed
  ragged serve captures no CUDA graph and loads no kernel library.

The self-checks run on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

#: The retrace self-check's ragged requests, (tenant, samples): the
#: reference's list.
RAGGED_REQUESTS = ((0, 3), (1, 17), (2, 1), (3, 9), (0, 30), (2, 5))


def _device(argv: list[str], what: str):
    parser = argparse.ArgumentParser(prog=f"python -m repro_torch.analysis {what}")
    parser.add_argument("--device", default=None,
                        help="cpu, or the card (default; raises without one)")
    return parser.parse_args(argv).device


def retrace_serve(device=None) -> dict:
    """The retrace self-check's serve: a (6, 3, 6) DAEF fleet of four
    tenants (λ 0.9, seeds 0..3) behind ``FleetServer(tile_width=8,
    use_cache=False)``, warmed up, then the reference's mixed ragged
    requests under ``trace_guard(max_traces=0, max_compiles=0)``.

    Returns ``{"shapes", "warmup", "serve", "results"}``: the shape count
    warmup returned, the warmup's and the serve's TraceReports, and the
    served ``ScoreResult``s by request id.  Raises TraceBudgetExceeded if
    the serve captured or loaded anything."""
    import numpy as np

    from repro_torch.analysis import retrace
    from repro_torch.core import daef
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.serving import server as server_mod

    cfg = daef.DAEFConfig(layer_sizes=(6, 3, 6), lam_hidden=0.9, lam_last=0.9)
    engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=4), device=device)
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4, 6, 48)).astype(np.float32)
    fl = engine.fit(xs, seeds=np.arange(4))
    srv = server_mod.FleetServer(engine, fl, tile_width=8, use_cache=False)
    with retrace.trace_guard(what="warmup") as warm:
        n_shapes = srv.warmup()
    with retrace.trace_guard(max_traces=0, max_compiles=0,
                             what="mixed ragged serve") as rep:
        for rid, (tenant, n) in enumerate(RAGGED_REQUESTS):
            srv.submit(tenant, rng.normal(size=(6, n)).astype(np.float32),
                       request_id=rid)
        srv.flush()
    results = {rid: srv.take(rid) for rid in range(len(RAGGED_REQUESTS))}
    return {"shapes": n_shapes, "warmup": warm, "serve": rep, "results": results}


def _retrace_selfcheck(argv: list[str]) -> int:
    out = retrace_serve(_device(argv, "retrace"))
    print(f"retrace self-check: warmed {out['shapes']} tile shapes ({out['warmup']}), "
          f"then {out['serve']} during a mixed ragged serve — zero-capture, "
          "zero-load claim holds")
    return 0


def donation_reports(device=None) -> list:
    """The donation self-check's two reports: ``FleetServer.probe_donation``
    of a warmed two-tenant server, and `donation.probe` of the streaming
    fold ``daef._stream_layer_step`` (its (G, M) statistics, argument 1,
    folded in place: B3 on the fused backend) on one 8-sample chunk."""
    import numpy as np
    import torch

    from repro_torch.analysis import donation
    from repro_torch.core import daef, elm_ae, rolann
    from repro_torch.device import as_tensor
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.serving import server as server_mod

    cfg = daef.DAEFConfig(layer_sizes=(6, 3, 6), lam_hidden=0.9, lam_last=0.9)
    engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=2), device=device)
    dev = engine.device
    xs = np.random.default_rng(0).normal(size=(2, 6, 32)).astype(np.float32)
    fl = engine.fit(xs, seeds=np.arange(2))
    srv = server_mod.FleetServer(engine, fl, tile_width=8, use_cache=False)
    srv.warmup()
    reports = [srv.donation]

    # the streaming fold of a (6, 3, 4, 6) net's decoder layer, as
    # fit_stream's pass over it calls it on each chunk
    scfg = daef.DAEFConfig(layer_sizes=(6, 3, 4, 6), lam_hidden=0.9,
                           lam_last=0.9).resolved(dev)
    sizes, f_hl = scfg.layer_sizes, daef._acts(scfg)[0]
    w_enc = daef.fit(scfg, xs[0], device=dev).weights[0]
    w_c1, b_c1 = elm_ae.stage1(scfg.layer_keys()[2], sizes[1], sizes[2], scfg.init,
                               w_enc.dtype, dev)
    stats = rolann.init_stats(sizes[2], sizes[1], f_hl, w_enc.dtype, device=dev)
    x = as_tensor(xs[0, :, :8], dev)
    mask = torch.ones(8, device=dev)
    reports.append(donation.probe(daef._stream_layer_step, scfg, stats,
                                  ((w_enc,), (), w_c1, b_c1), x, mask, donate_argnums=(1,)))
    return reports


def _donation_selfcheck(argv: list[str]) -> int:
    failed = False
    for rep in donation_reports(_device(argv, "donation")):
        print(rep.describe())
        failed |= rep.ok is False
    print("donation self-check:",
          "all probed donations effective" if not failed
          else "some donations NOT effective on this device (reported above)")
    return 0  # informational: a buffer that copies is a fact, not a bug


def main(argv: list[str]) -> int:
    if argv and argv[0] == "donation":
        return _donation_selfcheck(argv[1:])
    if argv and argv[0] == "retrace":
        return _retrace_selfcheck(argv[1:])
    if argv and argv[0] == "lint":
        argv = argv[1:]
    from repro_torch.analysis import lint

    return lint.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
