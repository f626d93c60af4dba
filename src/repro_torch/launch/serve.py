"""Serving launcher: LM decode, a DAEF fleet scorer, async federation or the
privacy smoke, on the card (counterpart of ``repro/launch/serve.py``).

* LM serve (default, ``--arch``) — prefill a batch of synthetic prompts by
  stepping them through the backbone's decode, then decode ``--gen``
  tokens greedily against a float32 cache (:func:`generate`).  Every family
  runs: dense, VLM (its decoder: the image prefix belongs to a prefill),
  MoE, SSM, hybrid, and the encoder-decoder, whose synthetic frames
  (``jax.random.normal(PRNGKey(2), ...)``'s bits, drawn by
  ``core.threefry``) are encoded once and their cross K/V put in the cache
  before the prompt is stepped through.
* Fleet serve (``--fleet K``) — train K per-tenant DAEF anomaly detectors in
  one batched fleet fit, then serve rounds of ragged per-tenant request
  batches.  ``--packing continuous`` (default) routes them through the
  production serving layer (`repro_torch.serving.FleetServer`): requests
  pack into dense tenant x sample tiles, scores+flags come back from one
  CUDA-graph replay per tile, repeated samples against an unchanged tenant
  hit the score cache.  ``--packing pad`` keeps the pad-to-max baseline:
  every round padded to [K, m0, n_pad] and scored + thresholded for the
  whole fleet (scores of padding columns are NaN-masked).
* Async federation (``--async-rounds R``) — drive a continual
  ``FederationSession`` over ``--sites`` edge sites where a ``--straggle``
  fraction of sites misses each round: stragglers fall out of the live
  global model once past ``--max-staleness`` and rejoin with their full
  backlog on their next report; ``--dp-epsilon`` and ``--secagg`` select
  the privacy tier.
* The privacy smoke (``--privacy``): a DP fit at epsilon=8 and one secagg
  round checked against the unmasked merge.

``--mesh-tenants D`` shards the fleet's tenants over a D-rank ``"tenants"``
mesh (``launch.mesh``): with D = 1 in this process; with D > 1 the CLI
starts itself once per rank (an NCCL group on the card, one card a rank,
or a gloo group with ``--device cpu``, from a ``FileStore`` in a temporary
directory), every rank makes the same seeded traffic, fits
and serves its K/D tenants, and rank 0 prints the lines with the counts
summed over the ranks.  ``--device cpu`` runs a mode on the host (the
default is the card).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 64 --rounds 20
  PYTHONPATH=src python -m repro_torch.launch.serve --async-rounds 6 --sites 8 \\
      --straggle 0.25 --max-staleness 1
  PYTHONPATH=src python -m repro_torch.launch.serve --privacy
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import threefry
from repro_torch.data import synthetic
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Generation(NamedTuple):
    tokens: torch.Tensor   # [B, gen] int32, the greedy tokens
    logits: torch.Tensor   # [B, 1, V], the last decode step's
    prefill_s: float       # stepping the prompt through decode
    decode_s: float        # the gen greedy steps


def _encdec_cache(bundle, params, frames, seq_len: int):
    """The encoder-decoder's float32 decode cache: ``frames`` [B, T_enc, d]
    encoded once, the cross K/V of their states computed once."""
    from repro_torch.models import encdec

    dev = params["embed"]["table"].device
    with torch.inference_mode():
        frames = torch.as_tensor(frames, device=dev)
        enc_out = encdec.encode(params, bundle.cfg, frames)
        return encdec.init_cache(params, bundle.cfg, enc_out, seq_len, torch.float32)


def generate(bundle, params, prompts, gen: int, frames=None) -> Generation:
    """The reference's serve loop: a float32 cache for prompt + ``gen``
    tokens on the parameters' device, the prompts [B, P] stepped through
    ``bundle.decode`` one position at a time (the prefill), then ``gen``
    greedy tokens, each fed back at the next position.  The
    encoder-decoder's cache also holds the cross K/V of ``frames`` [B,
    T_enc, d] (required for it), encoded before the clock starts, as the
    reference encodes them.  Both times are host clocks that end in a
    synchronize of the card."""
    dev = params["embed"]["table"].device
    prompts = torch.as_tensor(prompts, device=dev)
    batch, prompt_len = prompts.shape
    if bundle.cfg.family == "encdec":
        if frames is None:
            raise ValueError("generate: the encoder-decoder needs frames [B, T_enc, d]")
        cache = _encdec_cache(bundle, params, frames, prompt_len + gen)
    else:
        cache = bundle.init_cache(batch, prompt_len + gen, torch.float32, device=dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = bundle.decode(params, cache, prompts[:, t:t + 1], t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    t0 = time.perf_counter()
    for t in range(prompt_len, prompt_len + gen):
        generated.append(tok)
        logits, cache = bundle.decode(params, cache, tok, t)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    _sync(dev)
    return Generation(torch.cat(generated, dim=1), logits, t_prefill,
                      time.perf_counter() - t0)


def run_lm(args) -> None:
    """Serve a backbone: random weights (seed 0), synthetic prompts."""
    from repro_torch.models import get_bundle

    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = get_bundle(cfg, chunked_attn=False)
    params = bundle.init(0, device=resolve_device(args.device))
    prompts = synthetic.lm_token_stream(cfg.vocab_size, args.prompt_len, args.batch, seed=1)
    frames = None
    if cfg.family == "encdec":
        frames = threefry.normal(threefry.PRNGKey(2), (args.batch, cfg.encoder_seq, cfg.d_model))
    out = generate(bundle, params, prompts, args.gen, frames)
    print(f"prompts [{args.batch}, {args.prompt_len}] -> generated {tuple(out.tokens.shape)}")
    print("first sequence:", out.tokens[0].tolist())
    print(f"prefill {out.prefill_s:.2f}s; decode "
          f"{out.decode_s / max(1, args.gen) * 1000:.1f} ms/token")
    if not bool(torch.isfinite(out.logits).all()):
        raise RuntimeError("non-finite logits")
    print("serve OK")


def _spawn_ranks(args, argv: list) -> None:
    """Run this CLI once per rank of a ``--mesh-tenants`` mesh and relay
    rank 0's output: the ranks share a ``FileStore`` in a temporary
    directory; on the card each rank takes its own card under NCCL, and
    fewer cards than ranks raise; with ``--device cpu`` the ranks use
    gloo."""
    from repro_torch.engine import ExecutionPlan, PlanError

    d = args.mesh_tenants
    try:  # a plan the ranks would refuse fails here, once
        ExecutionPlan(mode="mesh", tenants=args.fleet, mesh_devices=d,
                      stats_backend=args.stats_backend,
                      chunk_samples=args.chunk_samples or None)
    except PlanError as e:
        raise SystemExit(f"error: {e}") from e
    if mesh_lib.rank_backend(args.device) == "nccl" and torch.cuda.device_count() < d:
        raise SystemExit(f"error: --mesh-tenants {d} on the card needs {d} cards, one a "
                         f"rank under NCCL; {torch.cuda.device_count()} present (pass "
                         "--device cpu to run the ranks on the host)")
    mesh_lib.spawn_ranks("repro_torch.launch.serve", argv, d,
                         lambda r, store: ["--rank", str(r), "--store", store])


def run_fleet(args) -> None:
    """Train + serve a fleet of per-tenant anomaly detectors (one rank of a
    ``--mesh-tenants`` mesh when ``--rank`` is given)."""
    if args.rank is None:
        _serve_fleet(args)
        return
    mesh_lib.init_process_group_from_file(args.store, args.rank, args.mesh_tenants,
                                          backend=mesh_lib.rank_backend(args.device))
    try:
        _serve_fleet(args)
    finally:
        torch.distributed.destroy_process_group()


def _serve_fleet(args) -> None:
    """Everything goes through the unified engine facade: placement
    (``--mesh-tenants``), the stats backend and the streaming chunk width
    are ExecutionPlan fields, not different call paths."""
    from repro_torch.core import daef, fleet_sharded
    from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError
    from repro_torch.serving import metrics as serving_metrics

    k, n_pad = args.fleet, args.pad
    datasets = [
        synthetic.make_dataset("cardio", seed=t, scale=args.scale) for t in range(k)
    ]
    splits = [ds.train_test_split(fold=0) for ds in datasets]
    n_train = min(s[0].shape[1] for s in splits)
    xs_train = np.stack([s[0][:, :n_train] for s in splits]).astype(np.float32)
    m0 = xs_train.shape[1]

    cfg = daef.DAEFConfig(layer_sizes=(m0, 4, 8, m0), lam_hidden=0.9, lam_last=0.9)
    try:
        plan = ExecutionPlan(
            mode="mesh" if args.mesh_tenants else "vmap",
            tenants=k,
            mesh_devices=args.mesh_tenants or None,
            stats_backend=args.stats_backend,
            chunk_samples=args.chunk_samples or None,
        )
        engine = DAEFEngine(cfg, plan, device=args.device)
        mesh = engine.mesh
    except PlanError as e:  # bad mesh sizes etc. -> clean CLI error
        raise SystemExit(f"error: {e}") from e
    dev = engine.device
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **kw: None)
    say(f"fleet: Gram-stats backend '{engine.config.stats_backend}' on {dev}")
    mine = slice(0, k)
    if mesh is not None:
        d = mesh.shape[fleet_sharded.TENANT_AXIS]
        mine = fleet_sharded._rank_slice(k, mesh)
        say(f"fleet: sharding {k} tenants over a {d}-device '"
            f"{fleet_sharded.TENANT_AXIS}' mesh axis ({k // d} per device)")

    def total(count) -> int:
        """A count summed over the ranks."""
        if mesh is None:
            return int(count)
        t = torch.tensor([int(count)], dtype=torch.int64, device=dev)
        return int(mesh.psum(t, mesh.axis_names)[0])

    t0 = time.perf_counter()
    seeds = np.arange(k, dtype=np.int32)
    if args.chunk_samples:
        # Streaming plan: the host iterator feeds fixed-shape [K, m0, chunk]
        # chunks into the engine — the training data never sits on device as
        # one array.
        c = args.chunk_samples
        fl = engine.fit_stream(
            lambda: (xs_train[:, :, i:i + c] for i in range(0, n_train, c)),
            seeds=seeds,
        )
        how = f"streamed in {c}-sample chunks"
    else:
        fl = engine.fit(xs_train, seeds=seeds)
        how = "in one batched fit"
    _sync(dev)
    t_fit = time.perf_counter() - t0
    mus = engine.thresholds(fl, rule="q90")
    say(f"fleet: trained {k} tenant models [{m0} features, {n_train} samples] "
        f"{how} ({t_fit:.2f}s incl. kernel build)")

    # Serving loop: ragged tenant request batches — either through the
    # continuous-batching FleetServer (production path) or the pad-to-max
    # baseline (one [K, m0, n_pad] call per round).
    server = None
    if args.packing == "continuous":
        from repro_torch.serving import FleetServer

        # a mesh rank serves its own tenants through a plain engine of them
        serve_engine = engine if mesh is None else DAEFEngine(
            engine.config, ExecutionPlan(tenants=fl.size), device=dev)
        server = FleetServer(serve_engine, fl, tile_width=args.tile_width,
                             rule="q90")
        n_shapes = server.warmup()
        what = "captured a CUDA graph for each of" if dev.type == "cuda" else "scored"
        say(f"fleet: {what} {n_shapes} tile shapes (none in the serving path)")
    rng = np.random.default_rng(0)
    round_served = []
    flagged = 0
    lat = []
    for _ in range(args.rounds):
        counts = rng.integers(1, n_pad + 1, size=k)
        requests = []
        for t in range(k):
            x_test = splits[t][1]
            # A tenant's request burst can't exceed its test pool when
            # sampling without replacement.
            counts[t] = min(int(counts[t]), x_test.shape[1])
            idx = rng.choice(x_test.shape[1], size=counts[t], replace=False)
            requests.append(x_test[:, idx].astype(np.float32))
        if server is not None:
            t0 = time.perf_counter()
            rids = [server.submit(t - mine.start, requests[t])
                    for t in range(mine.start, mine.stop)]
            server.flush()
            results = [server.take(rid) for rid in rids]
            lat.append(time.perf_counter() - t0)
            flagged += int(sum(r.flags.sum() for r in results))
        else:
            batch = np.zeros((k, m0, n_pad), np.float32)
            for t in range(k):
                batch[t, :, : counts[t]] = requests[t]
            t0 = time.perf_counter()
            scores = engine.scores(fl, batch, n_valid=counts)
            flags = engine.classify(scores, mus)
            flagged += int(flags.sum())  # reads the flags back: a sync
            lat.append(time.perf_counter() - t0)
        round_served.append(int(counts.sum()))
    # Steady-state stats exclude round 0 (warm-up) from the time, the
    # percentiles AND the served-request count — one denominator for all
    # three (unless a single round ran).
    steady = slice(1, None) if len(lat) > 1 else slice(None)
    summary = serving_metrics.latency_summary(
        lat[steady], sum(round_served[steady])
    )
    flagged = total(flagged)
    how = (f"continuous batching, <= {args.tile_width}-wide dense tiles"
           if server is not None
           else f"{k} tenants x <= {n_pad} padded samples per call")
    say(f"served {summary['served']} requests over {summary['rounds']} "
        f"steady-state rounds (+1 warm-up; {how})")
    say(f"latency p50 {summary['p50_ms_per_round']:.2f} / "
        f"p95 {summary['p95_ms_per_round']:.2f} ms/round; "
        f"throughput {summary['scores_per_sec']:.0f} scores/sec "
        f"(steady-state); flagged {flagged} anomalies")
    if server is not None:
        s = {key: total(v) for key, v in server.stats.items()}
        say(f"serving: {s['dispatches']} tile dispatches, "
            f"{s['dispatched_cols']} dispatched columns for "
            f"{s['scored']} scored samples, "
            f"{s['cache_hit_cols']} cache-hit columns")
    if total(not bool(torch.isfinite(fl.model.train_errors).all())):
        raise SystemExit("error: non-finite fit")
    say("fleet serve OK")


def run_async(args) -> None:
    """Drive a continual async federation over straggling edge sites.

    Every round each site produces a fresh data block, but only a random
    (1 - ``--straggle``) subset reports; the rest bank their blocks as a
    backlog and submit it whole on their next report (delta replay).  The
    session rebuilds the live global model from whichever sites are within
    ``--max-staleness`` refreshes — no barrier ever blocks a round.
    """
    from repro_torch.core import daef
    from repro_torch.engine import DAEFEngine, ExecutionPlan, PlanError

    s_count = args.sites
    datasets = [
        synthetic.make_dataset("cardio", seed=t, scale=args.scale)
        for t in range(s_count)
    ]
    splits = [ds.train_test_split(fold=0) for ds in datasets]
    m0 = splits[0][0].shape[0]
    cfg = daef.DAEFConfig(layer_sizes=(m0, 4, 8, m0), lam_hidden=0.9,
                          lam_last=0.9)
    privacy = _privacy_spec(args)
    max_staleness = args.max_staleness
    if privacy is not None and privacy.secagg and max_staleness:
        # Masked aggregation hides per-site states from the broker, so
        # stale sites cannot be excluded — the plan would reject the combo.
        print("secagg: forcing max_staleness=0 (masked aggregation cannot "
              "exclude stale sites)")
        max_staleness = 0
    args.max_staleness = max_staleness
    try:
        plan = ExecutionPlan(federation="async", merge="pairwise",
                             max_staleness=max_staleness,
                             privacy=privacy)
        engine = DAEFEngine(cfg, plan, device=args.device)
    except PlanError as e:
        raise SystemExit(f"error: {e}") from e
    dev = engine.device
    session = engine.session()
    print(f"async federation: {s_count} sites, straggle fraction "
          f"{args.straggle}, max_staleness {max_staleness}, on {dev}")
    if privacy is not None:
        print(f"privacy: dp epsilon={privacy.epsilon} delta={privacy.delta} "
              f"clip={privacy.clip}, secagg={privacy.secagg}")

    # Pre-slice each site's train pool into one block per round.
    rounds = args.async_rounds
    blocks = []
    for x_train in (s[0] for s in splits):
        bounds = np.linspace(0, x_train.shape[1], rounds + 1).astype(int)
        blocks.append([
            x_train[:, bounds[r]:bounds[r + 1]].astype(np.float32)
            for r in range(rounds)
        ])

    rng = np.random.default_rng(0)
    backlog: list[list] = [[] for _ in range(s_count)]
    for r in range(rounds):
        report = rng.random(s_count) >= args.straggle
        if not report.any():
            report[rng.integers(s_count)] = True  # someone always reports
        parts = {}
        for t in range(s_count):
            backlog[t].append(blocks[t][r])
            if report[t]:
                # The site ships its whole backlog: missed blocks replay as
                # one delta the moment it comes back.
                parts[t] = np.concatenate(backlog[t], axis=1)
                backlog[t] = []
        t0 = time.perf_counter()
        session.round(parts)
        _sync(dev)
        dt = time.perf_counter() - t0
        fresh = sum(
            stale <= args.max_staleness for stale in session.sites.values()
        )
        print(f"round {r + 1}/{rounds}: {len(parts)}/{s_count} sites "
              f"reported, {fresh} fresh in the live model "
              f"({dt * 1e3:.0f} ms)")

    # One global model scores every site's held-out split.
    mses = [
        float(torch.mean(daef.reconstruction_error(
            cfg, session.model, s[1].astype(np.float32), device=dev
        )))
        for s in splits
    ]
    print(f"held-out reconstruction MSE across {s_count} sites: "
          f"mean {np.mean(mses):.4f} (min {min(mses):.4f}, "
          f"max {max(mses):.4f})")
    if privacy is not None and privacy.dp_enabled:
        eps_spent = [session.privacy_spent(t)[0] for t in range(s_count)]
        print(f"privacy: cumulative epsilon spent per site — "
              f"min {min(eps_spent):.2f}, max {max(eps_spent):.2f}")
    if not bool(torch.isfinite(session.model.weights[-1]).all()):
        raise SystemExit("error: non-finite model")
    print("async federation OK")


def _privacy_spec(args):
    """Build a PrivacySpec from the --dp-*/--secagg flags, or None when the
    privacy tier is off (plain exchanges, bit-exact with the old paths)."""
    if args.dp_epsilon is None and not args.secagg:
        return None
    from repro_torch.privacy import PrivacySpec

    return PrivacySpec(
        epsilon=args.dp_epsilon,
        delta=args.dp_delta,
        clip=args.dp_clip,
        secagg=args.secagg,
    )


def run_privacy_smoke(args) -> None:
    """Smoke of the privacy tier end to end: a DP-calibrated federated fit
    at epsilon=8 and one secagg-masked round checked against the unmasked
    merge."""
    from repro_torch.core import daef
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.privacy import PrivacySpec

    ds = synthetic.make_dataset("cardio", seed=0, scale=args.scale)
    split = ds.train_test_split(fold=0)
    x_train, x_test = split[0], split[1]
    m0 = x_train.shape[0]
    half = x_train.shape[1] // 2
    parts = {"a": x_train[:, :half].astype(np.float32),
             "b": x_train[:, half:].astype(np.float32)}
    cfg = daef.DAEFConfig(layer_sizes=(m0, 4, 8, m0), lam_hidden=0.9,
                          lam_last=0.9)
    dev = resolve_device(args.device)

    def engine(spec=None):
        return DAEFEngine(cfg, ExecutionPlan(federation="async", merge="pairwise",
                                             privacy=spec), device=dev)

    # 1. DP release at epsilon=8: every exchanged block noised, finite model.
    t0 = time.perf_counter()
    session = engine(PrivacySpec(epsilon=8.0)).session()
    model = session.round(parts)
    _sync(dev)
    if not bool(torch.isfinite(model.weights[-1]).all()):
        raise SystemExit("error: non-finite DP model")
    mse = float(torch.mean(daef.reconstruction_error(
        cfg, model, x_test.astype(np.float32), device=dev
    )))
    eps, delta = session.privacy_spent("a")
    print(f"privacy smoke: DP fit at epsilon=8 over {len(parts)} sites on {dev} "
          f"({time.perf_counter() - t0:.2f}s incl. kernel build) — held-out MSE "
          f"{mse:.4f}, per-site spend ({eps:.1f}, {delta:.1e})")

    # 2. One secagg round: masked aggregate must match the unmasked merge.
    t0 = time.perf_counter()
    masked = engine(PrivacySpec(secagg=True)).session().round(parts)
    plain = engine().session().round(parts)
    for wm, wp in zip(masked.weights, plain.weights):
        np.testing.assert_allclose(wm.cpu().numpy(), wp.cpu().numpy(),
                                   atol=5e-4, rtol=1e-3)
    print(f"privacy smoke: secagg round matches unmasked merge "
          f"({time.perf_counter() - t0:.2f}s)")
    print("privacy smoke OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve a DAEF fleet of this many tenants instead of an LM")
    ap.add_argument("--mesh-tenants", type=int, default=0,
                    help="fleet mode: shard the tenant axis over this many "
                         "ranks of a 'tenants' mesh (more than 1: one process "
                         "a rank, started by this CLI)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--packing", default="continuous",
                    choices=["continuous", "pad"],
                    help="fleet mode: request batching — 'continuous' "
                         "(production serving layer: dense tenant x sample "
                         "tiles, score cache, online thresholds) or 'pad' "
                         "(baseline: every round padded to [K, m0, --pad] "
                         "and scored fleet-wide)")
    ap.add_argument("--tile-width", type=int, default=32,
                    help="fleet mode, continuous packing: max samples per "
                         "tile slot")
    ap.add_argument("--pad", type=int, default=64,
                    help="fleet mode: per-tenant sample padding per dispatch")
    ap.add_argument("--rounds", type=int, default=10,
                    help="fleet mode: number of serving rounds")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="fleet mode: synthetic dataset scale")
    ap.add_argument("--stats-backend", default=None,
                    choices=["einsum", "fused", "auto"],
                    help="fleet mode: Gram-stats producer (default: "
                         "$REPRO_STATS_BACKEND or 'auto'; 'fused' forces "
                         "training stats through the port's CUDA kernels)")
    ap.add_argument("--chunk-samples", type=int, default=0,
                    help="fleet mode: train with a streaming (chunked) "
                         "ExecutionPlan — per-layer Gram stats accumulate "
                         "over sample chunks of this width via "
                         "engine.fit_stream, bounding training memory")
    ap.add_argument("--async-rounds", type=int, default=0,
                    help="drive this many continual async federation rounds "
                         "(ExecutionPlan(federation='async')) instead of an "
                         "LM or a fleet")
    ap.add_argument("--sites", type=int, default=8,
                    help="async mode: number of federated edge sites")
    ap.add_argument("--straggle", type=float, default=0.25,
                    help="async mode: fraction of sites that (randomly) miss "
                         "each round; they bank a backlog and replay it as "
                         "one delta on their next report")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="async mode: refresh rounds a site may lag before "
                         "it is excluded from the live global model")
    ap.add_argument("--dp-epsilon", type=float, default=None,
                    help="async mode: release every exchanged statistics "
                         "block under the Gaussian mechanism at this "
                         "per-round epsilon (default: no DP)")
    ap.add_argument("--dp-delta", type=float, default=1e-5,
                    help="async mode: DP delta for --dp-epsilon")
    ap.add_argument("--dp-clip", type=float, default=1.0,
                    help="async mode: per-sample L2 clip bound for the DP "
                         "release")
    ap.add_argument("--secagg", action="store_true",
                    help="async mode: pairwise-masked secure aggregation — "
                         "the broker only ever sees the round aggregate "
                         "(forces --max-staleness 0 semantics)")
    ap.add_argument("--privacy", action="store_true",
                    help="run the privacy-tier smoke instead of an LM/fleet: "
                         "a DP fit at epsilon=8 plus one secagg round "
                         "checked against the unmasked merge")
    ap.add_argument("--device", default=None,
                    help="where the port runs: the CUDA card by default, "
                         "'cpu' on a host without one")
    args = ap.parse_args(argv)

    # NOTE: several flags use 0 as their "mode/feature off" sentinel — the
    # messages state the accepted domain EXACTLY (the reference's
    # tests/test_serve_cli.py pins message <-> check agreement, and
    # tests/test_torch_serve_cli.py holds the port to the same messages).
    if args.fleet < 0:
        ap.error(f"--fleet must be a tenant count >= 1, or 0 to serve an "
                 f"LM instead; got {args.fleet}")
    if args.mesh_tenants < 0:
        ap.error(f"--mesh-tenants must be >= 1, or 0 to disable tenant "
                 f"sharding; got {args.mesh_tenants}")
    if args.mesh_tenants and not args.fleet:
        ap.error("--mesh-tenants only applies to --fleet mode")
    if args.stats_backend and not args.fleet:
        ap.error("--stats-backend only applies to --fleet mode")
    if args.chunk_samples and not args.fleet:
        ap.error("--chunk-samples only applies to --fleet mode")
    if args.chunk_samples < 0:
        ap.error(f"--chunk-samples must be >= 1, or 0 for one-shot "
                 f"(non-streaming) training; got {args.chunk_samples}")
    if args.fleet and args.rounds < 1:
        ap.error(f"--rounds must be >= 1, got {args.rounds}")
    if args.fleet and args.tile_width < 1:
        ap.error(f"--tile-width must be >= 1, got {args.tile_width}")
    if args.async_rounds < 0:
        ap.error(f"--async-rounds must be >= 1, or 0 for LM/fleet mode; "
                 f"got {args.async_rounds}")
    if args.async_rounds and args.fleet:
        ap.error("--async-rounds and --fleet are separate modes; pick one")
    if args.dp_epsilon is not None and args.dp_epsilon <= 0:
        ap.error(f"--dp-epsilon must be > 0, got {args.dp_epsilon}")
    if (args.dp_epsilon is not None or args.secagg) and not (
        args.async_rounds or args.privacy
    ):
        ap.error("--dp-epsilon/--secagg apply to --async-rounds federation "
                 "(or the --privacy smoke)")
    if args.privacy and (args.fleet or args.async_rounds):
        ap.error("--privacy is a standalone smoke mode; drop --fleet/"
                 "--async-rounds")
    if args.privacy:
        run_privacy_smoke(args)
        return
    if args.async_rounds:
        if args.sites < 1:
            ap.error(f"--sites must be >= 1, got {args.sites}")
        if not 0.0 <= args.straggle < 1.0:
            ap.error(f"--straggle must be in [0, 1), got {args.straggle}")
        if args.max_staleness < 0:
            ap.error(f"--max-staleness must be >= 0, got {args.max_staleness}")
        run_async(args)
        return
    if args.fleet:
        if args.mesh_tenants > 1 and args.rank is None:
            _spawn_ranks(args, list(sys.argv[1:] if argv is None else argv))
            return
        run_fleet(args)
        return
    if args.arch is None:
        ap.error("--arch is required unless --fleet is given")
    run_lm(args)


if __name__ == "__main__":
    main()
