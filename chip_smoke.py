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
   has none).  B1 and B2 at the creditcard paths' shapes (m <= 28,
   o <= 32), and B4, B5 and B6 at the fleet's, must take their slice routes
   (``csrc/rolann_stats_slice.cuh``, ``csrc/rolann_fused_slice.cuh``;
   ``route_launches["slice"]``), the wide shapes the others (B5's profile
   must show ``stats_slice_kernel`` and ``few_slice_reduce_kernel`` and no
   ``partial_kernel``); their path
   rows print each kernel's device time under the profiler, the call's
   CUDA-events time, the bound, the share of the bar and ptxas's
   registers and spills.
4. main path — the paper's Table 5 "creditcard" DAEF (29-15-18-21-24-27-29,
   lam 0.8/0.9, extreme-IQR rule) on the full-scale replica, fold 0:
   ``daef.fit(n_partitions=4)`` -> ``reconstruction_error`` -> ``threshold``
   -> ``classify`` -> ``evaluate`` with ``stats_backend="fused"``, after one
   warm-up.  Launch counts are zeroed just before and read just after;
   every kernel of the path must have run (rolann_stats: 4 per fit, all on
   its slice route, m <= 28 and o <= 32).  The
   same fit on the plain einsum backend must give the same first-layer
   statistics (1e-4 * max|G|); the weights' drift is reported.
5. streaming path — the same configuration and data through
   ``daef.fit_chunked`` and ``daef.fit_stream`` (a per-pass callable of
   32,768-wide numpy slices) with ``chunk_samples = 32768``: 8 chunks per
   pass, the last ragged and masked.  Launch counts per streamed fit:
   rolann_fused_chunk 32 (4 hidden layers x 8 chunks, all on its slice
   route, ``csrc/rolann_fused_slice.cuh``), the others 0.  Every
   layer's statistics must equal an einsum re-fold of the same chunks under
   the fit's own solved weights (1e-4 * max of the leaf): B3 against its
   plain version on identical inputs.  A fit with a logistic last layer on
   the replica rescaled into [0, 1] runs B2 (8 launches, all on its slice
   route) and is re-folded the same way.
6. reference — the same replica fitted on the host in float32 (the CPU path
   the parity tests hold to the JAX package) and in float64: the card's
   fused fits, one-shot and streamed, must be no farther from the float64
   fit than the plain float32 fits are (see phase_reference); every fit's
   F1 is printed.
7. fleet — ``examples/fleet_anomaly.py``'s fleet shape with the creditcard
   DAEF per tenant: 32 sites (``make_dataset("creditcard", seed=s,
   scale=1/32)``, fold 0), each site's training normals split into two
   devices of 3,998 samples, seeds [s, s]: 64 tenants.  ``_fit_fleet`` ->
   ``fleet_merge_pairwise`` (64 -> 32) -> ``fleet_scores`` on each site's
   test split -> ``fleet_thresholds`` -> ``fleet_classify`` -> per-site F1,
   fused backend, after one warm-up.  Launches per fit: rolann_stats_batched
   4 (all on its slice route), the others 0.  Every tenant's statistics
   equal an einsum re-fold under the fleet's own weights (1e-4 of the
   tenant's leaf max); the merged sites
   equal the port's one-tenant ``merge_models`` of the same device pairs
   (knowledge exactly, U S² Uᵀ at 1e-4, weights at the κ bar of
   tests/_torch_parity.py); tenants 0, 31 and 63 are no farther from a
   float64 host fit than the plain float32 fits (phase 6's bar); per-site
   labels within 4 (|Δtp| + |Δfp|) of the port's CPU fleet.  Then
   ``_fit_fleet_chunked`` and ``_fit_fleet_stream`` with 1,024-wide chunks
   (rolann_fused_chunk_batched 16 launches each, all on its slice route,
   re-fold checked), and a
   logistic-output chunked fleet fit on [0, 1] data (rolann_stats_acc_batched
   4, all on its slice route).  Times on the host clock, ending in
   ``torch.cuda.synchronize()``.
8. profile — one fused fit + score, one streamed fused fit, one fused fleet
   fit and one chunked fused fleet fit under ``torch.profiler``: device time
   by kernel, and the device's busy share of the wall time; each lists its
   slice kernels and their reduces (B1, B3, B4, B6) by name.
9. LM kernels vs plain — B7 ``flash_attention`` (the head path's
    64 x 256 x 16/8 heads of 128 in bf16, the long prefills' 4 x 4,096 GQA
    and 2 x 4,096 MQA at head size 256 with window 2,048, a ragged S,
    float32, windows 1 and 17), B9 ``rglru_scan`` (2 x 4,096 x 4,096 with the
    prefill's bf16 x and float32 gates, all bf16 and all float32; S = 1,
    W = 100, S = 4,097 with W = 77; a repeat bit-identical) and B10
    ``ssd_chunk`` (mamba2's 4 x 4,096 x 48 heads, P 64,
    N 128, chunk 256; S = 1,000; G = 2) against their plain versions, and
    B1 at the DAEF head's shape (m 513, o 256, n 2,048; exactly symmetric,
    a repeat bit-identical; its scratch bytes there and at 65,536 samples,
    where it is also held to its plain version with the memory it
    allocates checked).  Tolerances: bf16 outputs within one bf16 ulp
    of each element, 2^-7 |ref| + 2^-7 * 1e-2 (each side rounds a float32
    result once), float32 1e-5 of the largest magnitude (summation order),
    lse 1e-5; B1 1e-4 of max|G| and of max|M|.  The B1 and B10 lines print
    max|plain| and the share of the bar used.
    Path shapes timed (CUDA events, median of 25) beside the bound (bf16
    work against the tensor cores' 989 TFLOP/s, float32 against the CUDA
    cores' 67; B1 at the head's shape and B10, which run 3xTF32, against
    495 / 3 TFLOP/s, with the FP32-core bound printed beside it), the
    plain version and, for B7, SDPA.  bf16 B7 launches
    must take the tensor-core route (``flash_attention.route_launches``
    "wgmma"), float32 ones the FP32 kernel ("fp32"); ``ptxas``'s registers
    and spill bytes of every B7 instantiation are printed.
10. depth-cut agreement — qwen3-1.7b and mamba2-780m at full width cut to
    2 layers (1 x 512 tokens), recurrentgemma-9b cut to one (rec, rec,
    attn) period (1 x 2,560 tokens, beyond its 2,048 window), float32: the
    same weights on the card and on the host, final hidden states within
    1e-4 of their largest magnitude; B7 on its float32 route.
11. head path — the DAEF head on qwen3-1.7b at full width and depth in bf16
    (weights drawn on the card from a seed), ``examples/llm_feature_anomaly
    .py`` at full width (then one ``fit_head`` under ``torch.profiler``,
    B1's kernels listed by name): ``get_bundle(cfg).forward`` -> ``pooled_features``
    on 2,048 "normal" sequences (``lm_token_stream``, S = 256, batches of
    64) -> ``fit_head`` (2048-256-512-2048, fused stats) -> ``flag`` on 256
    normal and 256 uniform-random OOD sequences; after one warm-up.  Forward
    tokens/s, fit and score ms, OOD F1; launches B7 28 per forward batch
    (all on the tensor-core route), B1 once (on its 3xTF32 route), nothing
    else; the card's flags within 8 labels of 512 of the
    same head fitted and applied on the host from the same features.  The
    head is ``default_config`` with ``stats_backend="fused"`` asked for, so
    that its hidden decoder layer's fold is B1.
12. long prefills — ``get_bundle(cfg).prefill`` at full width and depth,
    bf16, after a warm-up: qwen3-1.7b 4 x 4,096 (B7 28), mamba2-780m
    4 x 4,096 (B10 48), recurrentgemma-9b 2 x 4,096 (B7 12, B9 26, every B9
    launch on the backbone's bf16 x), every B7 launch on the tensor-core
    route; finite last-token logits.  Each model is freed before the next.
13. LM profiles — one head-path forward batch, one mamba2-780m prefill
    (B10's five kernels listed by name) and one recurrentgemma-9b prefill
    under ``torch.profiler``: busy share and the device-time shares of B1,
    B7, B9, B10 and cuBLAS's GEMMs.
14. B8 vs plain — ``flash_attention_bwd`` (the attention backward) against
    its plain version at the train shape (2 x 2,048, 16/8 heads of 128,
    causal) in bf16 and float32, recurrentgemma's windowed MQA (2 x 4,096,
    16/1 heads of 256, window 2,048) in bf16, a ragged S = 1,000 at head
    size 64 and head size 32; in float32 also against autograd through
    B7's plain forward; a repeat must be bit-identical; bf16 on the
    tensor-core route, float32 on the FP32 one, ``ptxas`` lines of every B8
    instantiation printed.  Bars per element:
    float32 1e-5 of the element's term magnitude
    (``flash_attention_bwd_magnitudes``), bf16 one bf16 ulp plus 2e-5 of
    it.  The train shape timed beside its bound, the plain version and
    SDPA's backward (the yardstick; the port never calls SDPA).
15. gradient agreement — qwen3-1.7b at full width cut to 2 layers, float32,
    1 x 512 tokens: ``bundle.loss`` and every gradient leaf on the card
    (B7 4, B8 2, float32 route) against the host, 1e-4 of each leaf's
    largest entry.
16. train — qwen3-1.7b at full width and depth in bf16, 10 steps of
    ``make_train_step(microbatches=2, clip_norm=1.0)`` with AdamW as
    ``launch/train.py`` builds it for a 10-step run, 4 x 2,048 tokens per
    step: finite losses and global gradient norms, step 0 within 1.0 of
    ln V, every gradient leaf and layer nonzero, the loss on step 0's batch
    lower after the 10 steps; launches B7 112 and B8 56 per step, all on
    the tensor-core route; step
    time, tokens/s and peak memory; one more step under
    ``torch.profiler``, the cross-entropy and the optimiser timed with CUDA
    events.

17. svd — the paper-faithful ``method="svd"`` at full width, the creditcard
    configuration of phase 4 on the same replica: ``daef.fit(n_partitions=4)``
    -> ``reconstruction_error`` -> ``threshold`` -> ``classify`` ->
    ``evaluate`` after one warm-up, no kernel launched; the train errors and
    test scores no farther from phase 6's float64 fit than its bar, the
    labels within 2 x (the labels the card's fused and einsum gram fits are
    apart) + 4 of the fused gram fit's.  The two halves of the training
    samples fitted, then ``merge_models`` and ``partial_fit``: each layer's
    U S² Uᵀ and M equal the gram statistics of the same halves under the
    same weights (each half's einsum re-fold, summed) at 1e-4 of the leaf's
    max, the encoder's U S² Uᵀ equals X Xᵀ (their distance from the gram
    method's merge is reported: its weights differ by the solves' float32
    drift).  ``layer_knowledge_from_partition`` on 4 partitions of the first
    decoder layer's input with ``direct_svd`` and with ``gram_eigh`` (B1 4
    launches, all on its slice route), then ``merge_factors_list``: the
    one-shot layer's statistics at 1e-4.  The 64-tenant fleet of phase 7:
    ``_fit_fleet`` -> ``fleet_merge_pairwise`` -> ``fleet_scores`` ->
    thresholds -> per-site F1, no kernel launched; every tenant's U S² Uᵀ
    and M against the einsum re-fold under the fleet's weights at 1e-4 of
    its max; per-site labels within 4 (|Δtp| + |Δfp|) of the port's CPU
    svd fleet.  Times on the host clock.

18. engine — the engine and the paper's federated protocol at full width,
    the creditcard configuration and replica of phases 4–6, every plan with
    ``stats_backend="fused"``: ``DAEFEngine`` fit -> scores -> thresholds ->
    classify, bit-identical leaf for leaf to phase 4's ``daef.fit``; a sync
    ``merge="sequential"`` session over the four contiguous quarters
    (``daef._split``, ragged): the layer-synchronised protocol, B1 16
    launches (4 sites x 4 layers) on its slice route, train errors and test
    scores held to phase 6's float64 fit under phase 6's bar, labels within
    2 x (fused vs einsum labels apart) + 4 of phase 4's; a sync
    ``"pairwise"`` session on the same sites: every layer's (G, M) and the
    encoder's U S² Uᵀ equal the sum of the four local fits' at 1e-4 of the
    leaf's max, per-site labels (the test set's quarters) within 4 of the
    port's CPU session; an async session (``max_staleness=0``) over four
    sites of 63,970 samples in two blocks: round 1 all sites (one fleet fit:
    B4 4 launches), round 2 sites 0 and 1 (B4 4), a refresh-only round (no
    launch, the live model kept), round 3 sites 2 and 3; staleness of sites
    2 and 3 is 1 after round 2; the live model's statistics after round 2
    equal the einsum re-fold of exactly the fresh sites' blocks, after round
    1 the pairwise merge of the round's own local fits (1e-4; the distance
    to the sync pairwise session's, whose local fits are one-tenant ones, is
    reported); a secagg round (``PrivacySpec(secagg=True)``, pairwise) on
    the same parts: the masked aggregate equals the sum of the unmasked wires
    and decodes bit for bit; its score distance from, and F1 against, the
    unmasked round are reported; save / load of the one-tenant model and of
    phase 7's 64-tenant fleet, and of the async session after round 2 into a
    fresh engine (round 3 bit-identical on both); the engine's reduce 64 ->
    32 sequential against pairwise (phase 7's rules for merged sites: the
    knowledge and error pools bit-identical, the encoder's S and U S² Uᵀ at
    1e-4, each layer's W and b at the κ bar; every leaf's distance is
    printed); launches
    per round and a profile of the sequential round.  Times on the host
    clock.

19. dp + serving — the DP release and fleet serving at full width.  DP:
    phase 18's four creditcard quarters in a sync ``merge="pairwise"``
    session under ``PrivacySpec(epsilon=8, composition="basic",
    budget_epsilon=16)``, fused backend: two rounds (every site a
    ``dp.fit_dp`` release, B3 once per hidden layer), each round's noise
    draws bit-identical to the port's CPU session under the same keys and
    the merged noised blocks within 1e-4 of their max of it; every site's
    ledger at exactly (16, 2e-5), also after a save and a restore; the
    restored session's third round refused (``PrivacyBudgetExceeded``)
    before any draw, the spend unchanged.  Serving: phase 7's 64-tenant
    fleet (fused fit: B4 4) behind ``FleetServer(tile_width=32,
    rule="q90")``: ``warmup`` captures one CUDA graph per packer shape (36),
    each replay bit-identical to the eager ``_score_tile`` on random tiles;
    20 rounds of the serve CLI's traffic (each tenant 1-64 samples of its
    site's test split, ``default_rng(0)``) with scores within 1e-5 of their
    max of ``engine.scores`` on the padded batch and flags equal except at
    ties within 1e-6 of mu, no capture after warmup, flags within 4 a tenant
    of the port's CPU server on the same fleet; a repeated round served
    from the cache with no dispatch; ``partial_fit`` on a new block of 512
    samples a tenant (B4 4, and B6 4 under a chunked plan), recalibrated,
    re-served against the new fleet's padded scores; the pad-to-max path
    over the same 20 rounds; replay and eager tile times on CUDA events; a
    profile of a 20-round serve; then ``python -m repro_torch.launch.serve``
    with ``--fleet 64 --rounds 5``, ``--async-rounds 3 --sites 8
    --dp-epsilon 8`` and ``--privacy`` as three processes, each ending in
    its ``... OK`` line.  Times on the host clock.

The last lines are a JSON object of the svd phase's numbers, a JSON object
of the engine phase's numbers, a JSON object of phase 19's numbers, a JSON object of the LM paths' numbers, a JSON object of per-shape numbers, the card's name and power limit, a JSON object of
per-kernel numbers for all ten kernels, and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12     # tensor cores, dense
PEAK_TF32_FLOPS = 495e12     # tensor cores, dense
# float32 products as three TF32 ones (hi·hi + hi·lo + lo·hi): the function's
# work at a third of the TF32 rate
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3
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
    for name in ("rglru_scan", "rolann_fused_chunk", "rolann_stats"):
        _say_ptxas_named(name)


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


def _bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    """(ms, what bounds it): the larger of operations over the peak rate of
    their type (FP32 CUDA cores unless ``peak`` says otherwise; bf16 work is
    tensor-core work, ``PEAK_BF16_FLOPS``) and bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
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


STATS_SLICE_KERNELS = ("stats_slice_kernel", "slice_reduce_kernel")


def phase_kernels(path_shapes, n_path):
    import torch

    from repro_torch.kernels.rolann_stats import ops, rolann_stats, rolann_stats_plain

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
    stats_regs = _ptxas("rolann_stats", "stats_slice_kernel")
    for i, (label, m, o, n, dtype) in enumerate(cases):
        xa, fsq, fd = _stats_inputs(m, o, n, dtype, seed=i)
        route = ops.stats_route(1, m, o, False)
        before = rolann_stats.route_launches[route]
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
        check(rolann_stats.route_launches[route] == before + 2,
              f"rolann_stats {label}: not on the {route} route")
        used = err / (tol * scale)
        say("kernel", f"rolann_stats {label} n={n} {str(dtype)[6:]} ({route}): max|d| "
            f"{err:.3e} (max|plain| {scale:.3e}, tol {tol:g}: {used:.4f} of the bar), "
            "symmetric, repeatable, ok")
        if label.startswith("path"):
            check(route == "slice", f"B1 at the path's shape {label} must take the slice route")
            ms = cuda_ms(lambda: rolann_stats(xa, fsq, fd))
            plain_ms = cuda_ms(lambda: rolann_stats_plain(xa, fsq, fd))
            library_ms = cuda_ms(lambda: torch.einsum("in,on,jn->oij", xa, fsq, xa))
            bound_ms, bound_by = _stats_bound(m, o, n)
            times = _kernel_us(lambda: rolann_stats(xa, fsq, fd), STATS_SLICE_KERNELS)
            outs = -(-o // 8)
            rows.append(dict(m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             bar_used=used, device_us=sum(us for _, us in times.values())))
            say("kernel", f"rolann_stats {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            _say_slice_row(f"rolann_stats {label} n={n}", times,
                           f"stats_slice_kernel<{outs}> (registers, spill stores, spill loads) "
                           f"{stats_regs.get(str(outs), '?')}", ms, (bound_ms, bound_by), used)
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
    repeatability.  Returns max|d| and the share of the bar it uses."""
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
    used = err / (tol * scale)
    say("kernel", f"{label} {str(g0.dtype)[6:]} acc: max|d| {err:.3e} (max|plain| {scale:.3e}, "
        f"tol {tol:g}: {used:.4f} of the bar), symmetric, repeatable, in place, ok")
    return err, used


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
        ops,
        rolann_fused_chunk,
        rolann_fused_chunk_plain,
        rolann_stats_acc,
        rolann_stats_acc_plain,
    )

    rows = {"rolann_stats_acc": [], "rolann_fused_chunk": []}
    f32, bf16, f64 = torch.float32, torch.bfloat16, torch.float64
    stats_regs = _ptxas("rolann_stats", "stats_slice_kernel")
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
        route = ops.stats_route(1, m, o, True)
        before = rolann_stats_acc.route_launches[route]
        err, used = _check_fold(f"rolann_stats_acc {label} n={n} ({route})", fold, plain, g0,
                                m0)
        check(rolann_stats_acc.route_launches[route] == before + 2,
              f"rolann_stats_acc {label}: not on the {route} route")
        if label.startswith("path"):
            check(route == "slice", f"B2 at the path's shape {label} must take the slice route")
            ms, plain_ms, library_ms = _time_fold(
                fold, plain, lambda: torch.einsum("in,on,jn->oij", xa, fsq, xa), g0, m0)
            g, mv = g0.clone(), m0.clone()
            times = _kernel_us(lambda: fold(g, mv), STATS_SLICE_KERNELS)
            outs = -(-o // 8)
            rows["rolann_stats_acc"].append(dict(m=m, o=o, n=n, max_abs_err=err, ms=ms,
                                                 plain_ms=plain_ms, library_ms=library_ms,
                                                 bar_used=used,
                                                 device_us=sum(us for _, us in times.values())))
            say("kernel", f"rolann_stats_acc {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms")
            _say_slice_row(f"rolann_stats_acc {label} n={n}", times,
                           f"stats_slice_kernel<{outs}> (registers, spill stores, spill loads) "
                           f"{stats_regs.get(str(outs), '?')}", ms, _acc_bound(m, o, n), used)

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
        route = "slice" if ops.fused_slice_route(1, m_l, m_c1) else "tile"
        before = rolann_fused_chunk.route_launches[route]
        err, used = _check_fold(f"rolann_fused_chunk {label} n={n} {act} ({route})", fold,
                                plain, g0, m0)
        check(rolann_fused_chunk.route_launches[route] == before + 2,
              f"rolann_fused_chunk {label}: not on the {route} route")
        if label.startswith("path"):
            check(route == "slice", f"B3 at the path's shape {label} must take the slice route")
            ms, plain_ms, _ = _time_fold(fold, plain, None, g0, m0)
            bound_ms, bound_by = _fused_bound(m_l, m_c1, n)
            rows["rolann_fused_chunk"].append(dict(m_l=m_l, m_c1=m_c1, n=n, max_abs_err=err,
                                                   ms=ms, plain_ms=plain_ms, library_ms=None,
                                                   bound_ms=bound_ms, bound_by=bound_by,
                                                   bar_used=used))
            say("kernel", f"rolann_fused_chunk {label} n={n}: kernel {ms:.4f} ms a launch, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms on FP32 cores "
                f"({bound_by}), library none (no single PyTorch call computes the "
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
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


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
    from repro_torch.kernels.rolann_stats import rolann_stats
    check(rolann_stats.route_launches == {"tf32x3": 0, "fp32": 0, "slice": n_layers},
          f"creditcard's layers (m <= 28, o <= 32) must take B1's slice route; "
          f"routes {rolann_stats.route_launches}")
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
    from repro_torch.kernels.rolann_stats import rolann_fused_chunk
    check(rolann_fused_chunk.route_launches == {"slice": n_hidden * n_chunks, "tile": 0},
          f"the streamed fit's B3 launches by route {rolann_fused_chunk.route_launches}, "
          "expected all on the slice route")
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
    from repro_torch.kernels.rolann_stats import rolann_stats_acc
    check(rolann_stats_acc.route_launches == {"slice": n_chunks, "fp32": 0},
          f"the logsig-output fit's B2 launches by route {rolann_stats_acc.route_launches}, "
          "expected all on the slice route")
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
    max|d| / max|float64| of the train errors and of the test scores.
    Returns, for each of the two, the float64 fit's values and the plain
    float32 fits' largest distance from them (phase 17's bar)."""
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
    references = {}
    for i, (name, ref) in enumerate((("train errors", m_64.train_errors), ("test scores", s_64))):
        dist = {k: _rel(v[i].double().cpu(), ref) for k, v in fits.items()}
        plain = max(d for k, d in dist.items() if k not in CHECKED_FITS)
        references[name] = (ref, plain)
        for k in CHECKED_FITS:
            check(dist[k] <= 2 * plain + 1e-4,
                  f"{name}: the {k} fit is {dist[k]:.3e} from the float64 fit, the plain "
                  f"float32 fits at most {plain:.3e}")
        say("reference", f"{name}, max|d| / max|.| from the host float64 fit: "
            + ", ".join(f"{k} {d:.2e}" for k, d in dist.items()))
    say("reference", "F1: " + ", ".join(f"{k} {v[2]:.4f}" for k, v in fits.items())
        + f", host float64 {f1_64:.4f} (host float32 fit {host_s:.2f} s, "
        f"{torch.get_num_threads()} threads)")
    return references


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
    G, agreement, repeatability, both calls on the route its shape takes
    (``ops.stats_route``).  Returns max|d|, the share of the bar it
    uses and the route."""
    import torch

    from repro_torch.kernels.rolann_stats import (
        ops,
        rolann_stats_batched,
        rolann_stats_batched_plain,
    )

    k, m, _ = xa.shape
    o = fsq.shape[1]
    dtype = xa.dtype
    route = ops.stats_route(k, m, o, False, batched=True)
    before = rolann_stats_batched.route_launches[route]
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
    check(rolann_stats_batched.route_launches[route] == before + 2,
          f"{label}: not on the {route} route")
    used = err / (tol * scale)
    say("kernel", f"{label} {str(dtype)[6:]} ({route}): max|d| {err:.3e} (max|plain| "
        f"{scale:.3e}, tol {tol:g}: {used:.4f} of the bar), symmetric, repeatable, ok")
    return err, used, route


def _kernel_name(key):
    """A profiler kernel key without its return type and argument list."""
    return key.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def _kernel_us(fn, patterns, attempts=3):
    """Device time (µs) of one ``fn()`` under torch.profiler, by kernel, for
    the kernels whose names hold one of ``patterns``: {name: (launches,
    µs)}.  A profile that recorded none of them (the profiler now and then
    records no device event for a call) is taken again, ``attempts`` times
    in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
               else "self_cuda_time_total")
        times = {_kernel_name(e.key): (e.count, getattr(e, key))
                 for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(p in e.key for p in patterns)}
        if times:
            return times
    raise SmokeFailure(f"the profiler recorded no kernel named like {patterns} in "
                       f"{attempts} profiles of one call")


def _say_slice_row(label, times, regs, ms, bound, used):
    """One line of a slice-route kernel at a path shape: the device time
    of each of its kernels (profiler), the call's CUDA-events time, the
    bound, the share of the bar and ptxas's registers."""
    say("kernel", f"{label}: route slice; device " + ", ".join(
        f"{name} {us:.2f} µs" for name, (_, us) in sorted(times.items()))
        + f"; call {ms:.4f} ms (CUDA events, wrapper included); bound {bound[0]:.4f} ms "
        f"on FP32 cores ({bound[1]}); {used:.4f} of the bar; ptxas {regs}")


def phase_batched_kernels(k, stats_shapes, n_tenant, acc_shape, fused_shapes, n_chunk):
    """B4, B5 and B6 against their plain versions on the card, at the fleet
    path's shapes (``k`` tenants; B4 at each one-shot layer's (m, o) with
    ``n_tenant`` samples per tenant, B5 at ``acc_shape`` and B6 at each
    hidden layer's (m_l, m_c1), both with ``n_chunk``-wide chunks), at
    ragged and masked shapes, at k = 1, at n = 0 (no launch) and with bf16
    and float64 inputs and accumulators."""
    import torch

    from repro_torch.kernels.rolann_stats import (
        ops,
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
    stats_regs = _ptxas("rolann_stats", "stats_slice_kernel")
    fused_regs = _ptxas("rolann_fused_chunk", "fused_slice_kernel")
    for i, (label, kk, m, o, n, dtype) in enumerate(cases):
        xa, fsq, fd = stats_in(kk, m, o, n, dtype, seed=500 + i)
        err, used, route = _check_batched_stats(f"rolann_stats_batched {label} n={n}", xa, fsq,
                                                fd)
        if label.startswith("path"):
            check(route == "slice", f"B4 at the path's shape {label} must take the slice route")
            ms = cuda_ms(lambda: rolann_stats_batched(xa, fsq, fd))
            plain_ms = cuda_ms(lambda: rolann_stats_batched_plain(xa, fsq, fd))
            library_ms = cuda_ms(lambda: torch.einsum("kin,kon,kjn->koij", xa, fsq, xa))
            bound_ms, bound_by = _bound(*_batched_work(kk, _stats_work(m, o, n)))
            times = _kernel_us(lambda: rolann_stats_batched(xa, fsq, fd), STATS_SLICE_KERNELS)
            outs = -(-o // 8)
            regs = stats_regs.get(str(outs), "?")
            rows["rolann_stats_batched"].append(dict(
                k=kk, m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bar_used=used,
                device_us=sum(us for _, us in times.values())))
            say("kernel", f"rolann_stats_batched {label} n={n}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by})")
            _say_slice_row(f"rolann_stats_batched {label} n={n}", times,
                           f"stats_slice_kernel<{outs}> (registers, spill stores, spill loads) "
                           f"{regs}", ms, (bound_ms, bound_by), used)

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
        route = ops.stats_route(kk, m, o, True, batched=True)
        before = rolann_stats_acc_batched.route_launches[route]
        err, used = _check_fold(f"rolann_stats_acc_batched {label} n={n} ({route})", fold,
                                plain, g0, m0)
        check(rolann_stats_acc_batched.route_launches[route] == before + 2,
              f"rolann_stats_acc_batched {label}: not on the {route} route")
        if label.startswith("path"):
            check(route == "slice", f"B5 at the path's shape {label} must take the slice route")
            ms, plain_ms, library_ms = _time_fold(
                fold, plain, lambda: torch.einsum("kin,kon,kjn->koij", xa, fsq, xa), g0, m0)
            flops, nbytes = _stats_work(m, o, n)
            bound_ms, bound_by = _bound(*_batched_work(kk, (flops, nbytes + 4 * (o * m * m + o * m))))
            g, mv = g0.clone(), m0.clone()
            times = _kernel_us(lambda: fold(g, mv), STATS_SLICE_KERNELS + ("partial_kernel",))
            check(any("stats_slice_kernel" in name for name in times)
                  and any("few_slice_reduce_kernel" in name for name in times)
                  and not any("partial_kernel" in name for name in times),
                  f"B5 {label}: its profile {sorted(times)} must show stats_slice_kernel and "
                  "few_slice_reduce_kernel and no partial_kernel")
            outs = -(-o // 8)
            rows["rolann_stats_acc_batched"].append(dict(
                k=kk, m=m, o=o, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bar_used=used,
                device_us=sum(us for _, us in times.values())))
            say("kernel", f"rolann_stats_acc_batched {label} n={n}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms")
            _say_slice_row(f"rolann_stats_acc_batched {label} n={n}", times,
                           f"stats_slice_kernel<{outs}> (registers, spill stores, spill loads) "
                           f"{stats_regs.get(str(outs), '?')}", ms, (bound_ms, bound_by), used)

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
        route = "slice" if ops.fused_slice_route(kk, m_l, m_c1) else "tile"
        before = rolann_fused_chunk_batched.route_launches[route]
        err, used = _check_fold(f"rolann_fused_chunk_batched {label} n={n} {act} ({route})",
                                fold, plain, g0, m0)
        check(rolann_fused_chunk_batched.route_launches[route] == before + 2,
              f"rolann_fused_chunk_batched {label}: not on the {route} route")
        if label.startswith("path"):
            check(route == "slice", f"B6 at the path's shape {label} must take the slice route")
            ms, plain_ms, _ = _time_fold(fold, plain, None, g0, m0)
            bound_ms, bound_by = _bound(*_batched_work(kk, _fused_work(m_l, m_c1, n)))
            g, mv = g0.clone(), m0.clone()
            times = _kernel_us(lambda: fold(g, mv), ("fused_slice_kernel",
                                                     "few_slice_reduce_kernel"))
            outs = -(-m_l // 8)
            regs = fused_regs.get(f"{outs},0,1", "?")
            rows["rolann_fused_chunk_batched"].append(dict(
                k=kk, m_l=m_l, m_c1=m_c1, n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by, bar_used=used,
                device_us=sum(us for _, us in times.values())))
            say("kernel", f"rolann_fused_chunk_batched {label} n={n}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, library none")
            _say_slice_row(f"rolann_fused_chunk_batched {label} n={n}", times,
                           f"fused_slice_kernel<{outs}, logsig, batched> (registers, spill "
                           f"stores, spill loads) {regs}", ms, (bound_ms, bound_by), used)

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
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)

    def read():
        return {name: fn.launches for name, fn in wrappers.items()}

    def on_slice_route(name, launches):
        routes = wrappers[name].route_launches
        check(routes["slice"] == launches and sum(routes.values()) == launches,
              f"{name}: {routes}, expected all {launches} launches on the slice route")

    def expect(**nonzero):
        return {name: nonzero.get(name, 0) for name in wrappers}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def fit(c):
        return fleet._fit_fleet(c, xs_d, seeds=seeds)

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
    on_slice_route("rolann_stats_batched", n_hidden)
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
    devices_h = fleet._fit_fleet(cfg_h, xs, seeds=seeds, device="cpu")
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
        on_slice_route("rolann_fused_chunk_batched", n_hidden * n_chunks)
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
    on_slice_route("rolann_stats_acc_batched", n_chunks)
    check(bool(torch.isfinite(fl_l.model.train_errors).all()), "logsig-output fleet errors")
    _check_refold_fleet("fused chunked fleet fit, act_last=logsig", cfg_l, fl_l,
                        fleet._device_chunks(x01, FLEET_CHUNK),
                        [len(fl_l.model.layer_knowledge) - 1])
    say("fleet", f"fused chunked fleet fit, act_last=logsig on [0, 1] data: launches "
        f"{launches['logsig']}")
    say("fleet", "times (host clock, ending in torch.cuda.synchronize()): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    return launches, devices


def phase_profile(label, run, detail=(), warm=True):
    """One ``run()`` under torch.profiler (after an unprofiled one when
    ``warm``): device time by kernel, and the device's busy share of the
    wall time; each kernel whose name holds one of ``detail`` is listed by
    name with its launches and device time.  Returns the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
    for e in averages:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(p in e.key for p in detail):
            t = getattr(e, key)
            say("profile", f"{label}: {e.key.split('(')[0][:80]}: {e.count} launches, "
                f"{t / 1e3:.4f} ms ({t / max(e.count, 1):.2f} µs each)")
    return device_us / 1e6 / wall


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


# ---------------------------------------------------------------------------
# 17. the paper-faithful svd method: one tenant, its merges, the partition
# knowledge and the fleet
# ---------------------------------------------------------------------------

def _gram_of(knowledge):
    """A layer's knowledge in Gram form: factors as U S² Uᵀ, (G, M) as they
    are."""
    from repro_torch.core import rolann

    if isinstance(knowledge, rolann.RolannFactors):
        return rolann.factors_to_stats(knowledge)
    return knowledge


def _stats_apart(got, want, per_tenant=False):
    """max|d| / max|want| of G and of M (the larger), per tenant's leaf
    when ``per_tenant`` (then the worst tenant's)."""
    worst = 0.0
    for leaf in ("g", "m"):
        a, b = getattr(got, leaf).double(), getattr(want, leaf).double()
        dims = tuple(range(1 if per_tenant else 0, a.ndim))
        rel = (a - b).abs().amax(dim=dims) / b.abs().amax(dim=dims)
        worst = max(worst, float(rel.max()))
    return worst


def _labels_apart(a, b) -> int:
    return abs(a.tp - b.tp) + abs(a.fp - b.fp)


def phase_svd(cfg, xtr, xte, y_test, references, card_fits, fleet_data, fleet_data_d,
              gram_devices):
    """``method="svd"`` on the card at full width: the one-shot fit ->
    score -> threshold -> classify -> evaluate, the merge of two halves and
    a partial fit, the partition knowledge of the first decoder layer, and
    the 64-tenant fleet.  Returns the phase's numbers."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly, daef, elm_ae, fleet, rolann
    from repro_torch.kernels.rolann_stats import rolann_stats

    t_phase = time.perf_counter()
    cfg_s = dataclasses.replace(cfg, method="svd")
    wrappers = {**_wrappers(), **_fleet_wrappers()}
    none = dict.fromkeys(wrappers, 0)

    def zero():
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)

    def read():
        return {name: fn.launches for name, fn in wrappers.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    times, out = {}, {}

    # ---- one tenant: fit -> score -> threshold -> classify -> evaluate ----
    def fit():
        return daef.fit(cfg_s, xtr, n_partitions=N_PARTITIONS)

    _, cold = timed(fit)
    say("svd", f"first (cold) svd fit {cold:.2f} ms")
    zero()
    model, times["fit"] = timed(fit)
    scores, times["score"] = timed(lambda: daef.reconstruction_error(cfg_s, model, xte))
    mu, times["threshold"] = timed(lambda: anomaly.threshold(model.train_errors, RULE))
    pred, times["classify"] = timed(lambda: anomaly.classify(scores, mu))
    metrics, times["evaluate"] = timed(
        lambda: anomaly.evaluate(model.train_errors, scores, y_test, RULE))
    check(read() == none, f"the svd fit launched {read()}, expected no kernel")
    check(all(isinstance(k, rolann.RolannFactors) for k in model.layer_knowledge),
          "the svd fit must carry factor knowledge")
    check(tuple(model.train_errors.shape) == (xtr.shape[1],) and
          tuple(scores.shape) == (xte.shape[1],), "svd fit: error shapes")
    check(bool(torch.isfinite(model.train_errors).all() and torch.isfinite(scores).all()),
          "svd fit: non-finite errors")
    check(pred.dtype == torch.int32 and 0 < int(pred.sum()) < pred.numel(),
          "svd classification is degenerate")
    for i, (name, got) in enumerate((("train errors", model.train_errors),
                                     ("test scores", scores))):
        ref, plain = references[name]
        out[f"{name} from float64"] = d = _rel(got.double().cpu(), ref)
        check(d <= 2 * plain + 1e-4, f"svd fit {name}: {d:.3e} from the float64 fit, the plain "
              f"float32 fits at most {plain:.3e}")
        say("svd", f"svd fit {name}, max|d| / max|.| from the host float64 fit {d:.2e} (bar "
            f"2 x {plain:.2e} + 1e-4, phase 6)")
    # Labels against the card's gram fit; the bar: twice the labels its
    # fused and einsum fits are apart, plus 4.
    gram = {k: anomaly.evaluate(card_fits[k][0], card_fits[k][1], y_test, RULE)
            for k in ("card fused", "card einsum")}
    plain_apart = _labels_apart(gram["card fused"], gram["card einsum"])
    out["labels apart"] = apart = _labels_apart(metrics, gram["card fused"])
    check(apart <= 2 * plain_apart + 4, f"svd fit labels {apart} apart from the gram fit's "
          f"(|dtp| + |dfp|), its fused and einsum fits {plain_apart}")
    out["f1"] = metrics.f1
    say("svd", f"svd fit {times['fit']:.2f} ms, score {times['score']:.2f} ms, threshold "
        f"{times['threshold']:.2f} ms, classify {times['classify']:.2f} ms, evaluate "
        f"{times['evaluate']:.2f} ms; F1 {metrics.f1:.4f} (tp {metrics.tp} fp {metrics.fp} "
        f"fn {metrics.fn} tn {metrics.tn}), gram fit's {gram['card fused'].f1:.4f}; labels "
        f"{apart} apart from the gram fit (bar 2 x {plain_apart} + 4)")

    # ---- two halves: fit each, merge_models, partial_fit ----
    half = xtr.shape[1] // 2
    xa, xb = xtr[:, :half].contiguous(), xtr[:, half:].contiguous()
    ma, times["fit half"] = timed(lambda: daef.fit(cfg_s, xa))
    mb, _ = timed(lambda: daef.fit(cfg_s, xb))
    daef.merge_models(cfg_s, ma, mb)  # warm-up
    merged, times["merge_models"] = timed(lambda: daef.merge_models(cfg_s, ma, mb))
    updated, times["partial_fit"] = timed(lambda: daef.partial_fit(cfg_s, ma, xb))
    check(read() == none, f"the svd merges launched {read()}, expected no kernel")
    # Each layer against the gram method's statistics of the same halves
    # under the same weights: each half's einsum re-fold, summed.
    worst = 0.0
    for layer in range(len(merged.layer_knowledge)):
        want = rolann.merge_stats(
            _refold(cfg, ma, daef._device_chunks(xa, CHUNK_SAMPLES), layer),
            _refold(cfg, mb, daef._device_chunks(xb, CHUNK_SAMPLES), layer))
        for label, m in (("merge_models", merged), ("partial_fit", updated)):
            d = _stats_apart(_gram_of(m.layer_knowledge[layer]), want)
            check(d <= 1e-4, f"svd {label}: layer {layer + 1} U S^2 U^T or M {d:.3e} of its "
                  "max from the gram statistics of the same halves (bar 1e-4)")
            worst = max(worst, d)
    enc = merged.encoder_factors
    x64 = xtr.double()
    d_enc = _rel((enc.u * enc.s**2).double() @ enc.u.double().T, x64 @ x64.T)
    check(d_enc <= 1e-4, f"svd merge: encoder U S^2 U^T {d_enc:.3e} of max|X X^T| (bar 1e-4)")
    gram_merge = daef.merge_models(cfg, daef.fit(cfg, xa), daef.fit(cfg, xb))
    drift = [_stats_apart(_gram_of(k), g) for k, g in zip(merged.layer_knowledge,
                                                            gram_merge.layer_knowledge)]
    f1_merged = anomaly.evaluate(merged.train_errors, daef.reconstruction_error(
        cfg_s, merged, xte), y_test, RULE).f1
    out["merge worst"] = worst
    say("svd", f"halves of {half} and {xtr.shape[1] - half}: svd fit {times['fit half']:.2f} ms "
        f"a half, merge_models {times['merge_models']:.2f} ms, partial_fit "
        f"{times['partial_fit']:.2f} ms; every layer's U S^2 U^T and M equal the gram "
        f"statistics of the halves under the same weights, max|d| / max|.| {worst:.2e} (bar "
        f"1e-4); encoder U S^2 U^T {d_enc:.2e} of X X^T; merged F1 {f1_merged:.4f}; no bar: "
        "each layer's distance from the gram method's merge, whose weights differ by the "
        "solves' float32 drift, " + ", ".join(f"{d:.2e}" for d in drift))

    # ---- the first decoder layer's knowledge from 4 partitions ----
    f_hl, _ = daef._acts(cfg_s)
    h = f_hl.fn(model.weights[0].T @ xtr)
    sizes = cfg.layer_sizes
    key = cfg_s.layer_keys()[2]
    want = _gram_of(model.layer_knowledge[0])
    for factorization in ("direct_svd", "gram_eigh"):
        def knowledge():
            return rolann.merge_factors_list([elm_ae.layer_knowledge_from_partition(
                key, part, sizes[2], f_hl, method="svd", factorization=factorization,
                backend="fused") for part in daef._split(h, N_PARTITIONS)])

        knowledge()  # warm-up
        zero()
        merged_k, times[f"partitions {factorization}"] = timed(knowledge)
        eigh = factorization == "gram_eigh"
        check(read() == dict(none, rolann_stats=N_PARTITIONS if eigh else 0),
              f"{factorization} partitions launched {read()}")
        if eigh:
            check(rolann_stats.route_launches == {"tf32x3": 0, "fp32": 0,
                                                  "slice": N_PARTITIONS},
                  f"gram_eigh's B1 launches by route {rolann_stats.route_launches}, expected "
                  f"all {N_PARTITIONS} on the slice route")
        d = _stats_apart(_gram_of(merged_k), want)
        check(d <= 1e-4, f"{factorization}: {N_PARTITIONS} partitions merged are {d:.3e} of "
              "max|G| from the one-shot layer's statistics (bar 1e-4)")
        out[f"partitions {factorization}"] = d
        say("svd", f"layer_knowledge_from_partition x {N_PARTITIONS} ({factorization}) + "
            f"merge_factors_list {times[f'partitions {factorization}']:.2f} ms: U S^2 U^T and "
            f"M {d:.2e} of their max from the one-shot layer's (bar 1e-4); launches "
            f"{read()['rolann_stats']} of rolann_stats")

    # ---- the fleet: fit -> merge pairwise -> score -> per-site F1 ----
    xs, seeds, tests, truth = fleet_data
    xs_d, tests_d = fleet_data_d
    k, _, n = xs.shape

    def fit_fleet():
        return fleet._fit_fleet(cfg_s, xs_d, seeds=seeds)

    _, cold = timed(lambda: fleet.fleet_merge_pairwise(cfg_s, fit_fleet()))
    say("svd", f"first (cold) svd fleet fit and merge {cold:.2f} ms")
    zero()
    devices, times["fleet fit"] = timed(fit_fleet)
    sites, times["fleet merge"] = timed(lambda: fleet.fleet_merge_pairwise(cfg_s, devices))
    site_scores, times["fleet score"] = timed(lambda: fleet.fleet_scores(cfg_s, sites, tests_d))
    mus, times["fleet thresholds"] = timed(lambda: fleet.fleet_thresholds(sites))
    check(read() == none, f"the svd fleet launched {read()}, expected no kernel")
    check(bool(torch.isfinite(site_scores).all()), "svd fleet: non-finite site scores")
    site_m = _site_f1(fleet.fleet_classify(site_scores, mus).cpu(), torch.as_tensor(truth))
    worst = 0.0
    for layer in range(len(devices.model.layer_knowledge)):
        ref = _refold_fleet(cfg, devices, fleet._device_chunks(xs_d, n), layer)
        d = _stats_apart(_gram_of(devices.model.layer_knowledge[layer]), ref, per_tenant=True)
        check(d <= 1e-4, f"svd fleet: layer {layer + 1}'s U S^2 U^T or M {d:.3e} of a tenant's "
              "max from the gram statistics under the fleet's weights (bar 1e-4)")
        worst = max(worst, d)
    drift = [_stats_apart(_gram_of(a), b, per_tenant=True) for a, b in
             zip(devices.model.layer_knowledge, gram_devices.model.layer_knowledge)]
    t0 = time.perf_counter()
    cfg_h = dataclasses.replace(cfg_s, stats_backend="einsum")
    sites_h = fleet.fleet_merge_pairwise(cfg_h, fleet._fit_fleet(cfg_h, xs, seeds=seeds,
                                                                 device="cpu"))
    pred_h = fleet.fleet_classify(fleet.fleet_scores(cfg_h, sites_h, tests, device="cpu"),
                                  fleet.fleet_thresholds(sites_h), device="cpu")
    host_s = time.perf_counter() - t0
    site_h = _site_f1(pred_h, torch.as_tensor(truth))
    apart = [_labels_apart(a, b) for a, b in zip(site_m, site_h)]
    check(max(apart) <= 4, f"svd fleet per-site labels: card and CPU {max(apart)} apart at site "
          f"{int(np.argmax(apart))} (bar 4)")
    out["fleet labels apart"], out["fleet worst"] = max(apart), worst
    out["fleet mean f1"] = float(np.mean([x.f1 for x in site_m]))
    say("svd", f"{k}-tenant svd fleet: fit {times['fleet fit']:.2f} ms, merge {k} -> {k // 2} "
        f"{times['fleet merge']:.2f} ms, score {times['fleet score']:.2f} ms, thresholds "
        f"{times['fleet thresholds']:.2f} ms; every tenant's U S^2 U^T and M equal the gram "
        f"statistics under its own weights, max|d| / max|.| {worst:.2e} (bar 1e-4); no bar: "
        "each layer's worst tenant's distance from the gram fleet's (its weights differ by "
        "the solves' float32 drift) " + ", ".join(f"{d:.2e}" for d in drift))
    say("svd", f"svd fleet mean site F1 card {out['fleet mean f1']:.4f}, CPU "
        f"{np.mean([x.f1 for x in site_h]):.4f}; labels apart per site at most {max(apart)}, "
        f"{sum(apart)} in all (bar 4 a site; CPU svd fleet fit + merge + score {host_s:.2f} s)")
    say("svd", "times (host clock, ending in torch.cuda.synchronize()): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    phase_profile("svd fit", fit)
    phase_profile("svd fleet fit (64 tenants)", fit_fleet)
    say("svd", f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": times, **out}


# ---------------------------------------------------------------------------
# 18. the engine and federation sessions: the one-tenant engine path, sync
# (sequential, pairwise) and async rounds, secure aggregation, checkpoints,
# the engine's fleet reduce
# ---------------------------------------------------------------------------

ENGINE_SITES = 4


def _stats_rel(got, want) -> float:
    """max|d| / max|want| of a layer's G and M (the larger), want in float64."""
    return max(_rel(getattr(got, leaf).double(), getattr(want, leaf).double())
               for leaf in ("g", "m"))


def _enc_gram(f):
    """An encoder's U S² Uᵀ in float64."""
    u, s = f.u.double(), f.s.double()
    return (u * s**2) @ u.transpose(-1, -2)


def _summed_stats(models):
    """Each decoder layer's (G, M) summed over ``models`` in float64, and the
    sum of their encoders' U S² Uᵀ."""
    from repro_torch.core import rolann

    layers = [rolann.RolannStats(g=sum(m.layer_knowledge[i].g.double() for m in models),
                                 m=sum(m.layer_knowledge[i].m.double() for m in models))
              for i in range(len(models[0].layer_knowledge))]
    return layers, sum(_enc_gram(m.encoder_factors) for m in models)


def _model_stats_apart(model, layers, enc):
    """Each layer's distance and the encoder's from summed statistics."""
    apart = [_stats_rel(k, w) for k, w in zip(model.layer_knowledge, layers, strict=True)]
    return apart, _rel(_enc_gram(model.encoder_factors), enc)


def _tree_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files)


def _check_reduced_agree(a, b) -> float:
    """Two reductions of one fleet (the engine's sequential and pairwise)
    under the rules of _check_merged_sites: the knowledge, the error pools,
    seeds and lambdas bit-identical; the encoder's S and U S² Uᵀ within 1e-4
    of their max (U is free within near-equal singular values: a batched
    and a single SVD rotate it differently); each decoder layer's [W; b]
    within 10·κ·eps·max|[W; b]| of the site's G + λI (the solves of
    identical knowledge, batched and single, round differently, and the
    last layer's κ reaches 1e6).  Returns the worst share of the κ bar."""
    import torch

    from repro_torch.core import fleet

    eps = float(torch.finfo(torch.float32).eps)
    for name in ("seeds", "lam_hidden", "lam_last"):
        check(torch.equal(getattr(a, name), getattr(b, name)), f"reduce: {name} differ")
    worst = 0.0
    for s in range(a.size):
        ma, mb = fleet.get_model(a, s), fleet.get_model(b, s)
        for ka, kb in zip(ma.layer_knowledge, mb.layer_knowledge, strict=True):
            check(torch.equal(ka.g, kb.g) and torch.equal(ka.m, kb.m),
                  f"reduce: site {s} knowledge differs")
        check(torch.equal(ma.train_errors, mb.train_errors), f"reduce: site {s} error pool")
        check(_rel(ma.encoder_factors.s, mb.encoder_factors.s) <= 1e-4, f"reduce: site {s} S")
        d = _rel(_enc_gram(ma.encoder_factors), _enc_gram(mb.encoder_factors))
        check(d <= 1e-4, f"reduce: site {s} encoder U S^2 U^T {d:.3e} (bar 1e-4)")
        lams = [float(a.lam_hidden[s])] * (len(ma.layer_knowledge) - 1) + [float(a.lam_last[s])]
        for i, (k, lam) in enumerate(zip(ma.layer_knowledge, lams)):
            g = k.g.double()
            kappa = float(torch.linalg.cond(
                g + lam * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)).max())
            wa = torch.cat([ma.weights[i + 1], ma.biases[i][None]]).double()
            wb = torch.cat([mb.weights[i + 1], mb.biases[i][None]]).double()
            err, bar = float((wa - wb).abs().max()), 10 * kappa * eps * float(wa.abs().max())
            check(err <= bar, f"reduce: site {s} layer {i + 2} W, b differ by {err:.3e} > "
                  f"{bar:.3e}")
            worst = max(worst, err / bar)
    return worst


def phase_engine(cfg, y_test, xtr, xte, references, card_fits, fleet_data,
                 fleet_data_d):
    """The engine and the paper's federated protocol on the card at full
    width (the creditcard replica of phases 4–6, fused backend).  Returns the
    phase's numbers."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import anomaly, daef, fleet
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.kernels.rolann_stats import rolann_stats, rolann_stats_batched
    from repro_torch.privacy import PrivacySpec, secagg
    from repro_torch.train import checkpoint

    t_phase = time.perf_counter()
    base = daef.DAEFConfig(**CREDITCARD)  # no backend: the plans ask for "fused"
    wrappers = {**_wrappers(), **_fleet_wrappers()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)

    def read():
        return {name: fn.launches for name, fn in wrappers.items() if fn.launches}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def engine(device=None, **plan):
        return DAEFEngine(base, ExecutionPlan(stats_backend="fused", **plan), device=device)

    def same_leaves(a, b, what):
        la, lb = checkpoint.flatten(a), checkpoint.flatten(b)
        check(len(la) == len(lb) and all(
            x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device))
            for x, y in zip(la, lb)), f"{what}: not bit-identical leaf for leaf")

    n_hidden = len(path_shapes(cfg))
    times, launches, out = {}, {}, {}

    # ---- 1. the engine's one-tenant path == phase 4's daef.fit ----
    one = engine()
    check(one.config == cfg and one.device.type == "cuda",
          f"engine config {one.config} on {one.device}, expected phase 4's on the card")
    one.fit(xtr, n_partitions=N_PARTITIONS)
    zero()
    model, times["engine fit"] = timed(lambda: one.fit(xtr, n_partitions=N_PARTITIONS))
    launches["engine fit"] = read()
    check(launches["engine fit"] == {"rolann_stats": n_hidden},
          f"engine fit launched {launches['engine fit']}")
    same_leaves(model, daef.fit(cfg, xtr, n_partitions=N_PARTITIONS), "engine fit vs daef.fit")
    scores, times["engine score"] = timed(lambda: one.scores(model, xte))
    mu = one.thresholds(model)
    pred = one.classify(scores, mu)
    check(torch.equal(scores, daef.reconstruction_error(cfg, model, xte))
          and torch.equal(pred, anomaly.classify(scores, mu)), "engine scores / labels")
    m_one = anomaly.evaluate(model.train_errors, scores, y_test, RULE)
    m_einsum = anomaly.evaluate(*card_fits["card einsum"][:2], y_test, RULE)
    label_bar = 2 * _labels_apart(m_one, m_einsum) + 4
    say("engine", f"DAEFEngine(ExecutionPlan(stats_backend='fused')): fit {times['engine fit']:.2f}"
        f" ms, score {times['engine score']:.2f} ms, bit-identical to daef.fit leaf for leaf, "
        f"F1 {m_one.f1:.4f}; launches {launches['engine fit']}")

    # ---- 2. sync, merge="sequential": the layer-synchronised protocol ----
    sites = daef._split(xtr, ENGINE_SITES)
    widths = [p.shape[1] for p in sites]
    seq = engine(merge="sequential")
    seq.session().round(sites)
    zero()
    m_seq, times["sync sequential round"] = timed(lambda: seq.session().round(sites))
    launches["sync sequential round"] = read()
    want = ENGINE_SITES * n_hidden
    check(launches["sync sequential round"] == {"rolann_stats": want}
          and rolann_stats.route_launches["slice"] == want,
          f"sequential round launched {launches['sync sequential round']}, routes "
          f"{rolann_stats.route_launches}; expected B1 {want} times on its slice route")
    s_seq = seq.scores(m_seq, xte)
    for name, got in (("train errors", m_seq.train_errors), ("test scores", s_seq)):
        ref, plain = references[name]
        d = _rel(got.double().cpu(), ref)
        check(d <= 2 * plain + 1e-4, f"sequential round {name}: {d:.3e} from the float64 fit, "
              f"bar 2 x {plain:.3e} + 1e-4")
        out[f"sequential {name} from float64"] = d
    m_seqf = anomaly.evaluate(m_seq.train_errors, s_seq, y_test, RULE)
    apart = _labels_apart(m_seqf, m_one)
    check(apart <= label_bar, f"sequential round labels {apart} apart from phase 4's fit "
          f"(bar {label_bar})")
    say("engine", f"sync sequential round over {ENGINE_SITES} sites of {widths} samples: "
        f"{times['sync sequential round']:.2f} ms, launches {launches['sync sequential round']} "
        f"(slice route); train errors {out['sequential train errors from float64']:.2e} and test "
        f"scores {out['sequential test scores from float64']:.2e} from the float64 fit (phase "
        f"6's bar), F1 {m_seqf.f1:.4f}, labels {apart} apart from phase 4's fit (bar "
        f"{label_bar})")

    # ---- 3. sync, merge="pairwise": local fits, then pairwise merges ----
    pw = engine(merge="pairwise")
    pw.session().round(sites)
    zero()
    m_pw, times["sync pairwise round"] = timed(lambda: pw.session().round(sites))
    launches["sync pairwise round"] = read()
    check(launches["sync pairwise round"] == {"rolann_stats": want},
          f"pairwise round launched {launches['sync pairwise round']}")
    layers, enc = _summed_stats([daef.fit(cfg, p) for p in sites])
    apart_l, apart_e = _model_stats_apart(m_pw, layers, enc)
    check(max(apart_l + [apart_e]) <= 1e-4, f"pairwise round statistics vs the sum of the "
          f"local fits': layers {apart_l}, encoder {apart_e} (bar 1e-4)")
    host = engine(device="cpu", merge="pairwise")
    t0 = time.perf_counter()
    m_host = host.session().round([p.cpu() for p in sites])
    host_s = time.perf_counter() - t0
    n_te = xte.shape[1]
    qb = [round(i * n_te / ENGINE_SITES) for i in range(ENGINE_SITES + 1)]  # daef._split's
    x_test_q = [xte[:, a:b] for a, b in zip(qb, qb[1:])]
    y_test_q = [y_test[a:b] for a, b in zip(qb, qb[1:])]
    mu_c, mu_h = pw.thresholds(m_pw), host.thresholds(m_host)
    site_apart = []
    for xq, yq in zip(x_test_q, y_test_q):
        mc = anomaly.binary_metrics(pw.classify(pw.scores(m_pw, xq), mu_c), yq)
        mh = anomaly.binary_metrics(host.classify(host.scores(m_host, xq.cpu()), mu_h), yq,
                                    device="cpu")
        site_apart.append(_labels_apart(mc, mh))
    check(max(site_apart) <= 4, f"pairwise round per-site labels {site_apart} apart from the "
          "CPU session (bar 4)")
    out["pairwise statistics vs local sums"] = max(apart_l + [apart_e])
    say("engine", f"sync pairwise round: {times['sync pairwise round']:.2f} ms, launches "
        f"{launches['sync pairwise round']}; each layer's (G, M) and the encoder's U S^2 U^T vs "
        f"the sum of the four local fits' max|d|/max {max(apart_l + [apart_e]):.2e} (bar "
        f"1e-4); per-site labels vs the CPU session {site_apart} (bar 4; CPU round "
        f"{host_s:.2f} s)")

    # ---- 4. async, max_staleness=0: one fleet fit a round ----
    n_site = xtr.shape[1] // ENGINE_SITES
    half = n_site // 2
    blocks = [[xtr[:, s * n_site + b * half:s * n_site + (b + 1) * half] for b in (0, 1)]
              for s in range(ENGINE_SITES)]
    rounds = {"async round 1": {s: blocks[s][0] for s in range(ENGINE_SITES)},
              "async round 2": {0: blocks[0][1], 1: blocks[1][1]},
              "async refresh": {},
              "async round 3": {2: blocks[2][1], 3: blocks[3][1]}}
    asy = engine(federation="async", max_staleness=0)
    warm = asy.session()
    for parts in rounds.values():
        warm.round(parts)
    session = asy.session()
    live = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, parts in rounds.items():
            if name == "async refresh":  # save after round 2, restore in a fresh engine
                path, times["session save"] = timed(
                    lambda: asy.save(session, os.path.join(tmp, "session")))
                restored, times["session load"] = timed(
                    lambda: engine(federation="async", max_staleness=0).load(path))
                out["session bytes"] = _tree_bytes(path)
            zero()
            live[name], times[name] = timed(lambda: session.round(parts))
            launches[name] = read()
            if name == "async round 2":
                stale_after_2 = dict(session.sites)
        for name in ("async refresh", "async round 3"):
            restored_model = restored.round(rounds[name])
        same_leaves(restored_model, live["async round 3"],
                    "round 3 of the restored session vs the saved one")
    b4 = {name: launches[name].get("rolann_stats_batched", 0) for name in rounds}
    check(launches["async round 1"] == {"rolann_stats_batched": n_hidden}
          and launches["async round 2"] == {"rolann_stats_batched": n_hidden}
          and launches["async refresh"] == {},
          f"async rounds launched {launches}; expected B4 {n_hidden} in rounds 1 and 2, none "
          "in the refresh")
    check(live["async refresh"] is live["async round 2"], "the refresh round must keep the "
          "live model when no site is fresh")
    # after round 2 (sites 2 and 3 missed it): statistics == the einsum
    # re-fold of exactly the fresh sites' data under their local fits' weights
    fleets = [(fleet._fit_fleet(cfg, torch.stack([blocks[s][b] for s in tenants])), tenants, b)
              for b, tenants in ((0, range(ENGINE_SITES)), (1, (0, 1)))]
    refold, enc = None, 0
    for fl, tenants, b in fleets:
        xs = torch.stack([blocks[s][b] for s in tenants])
        per = [_refold_fleet(cfg, fl, fleet._device_chunks(xs, half), k)
               for k in range(len(fl.model.layer_knowledge))]
        for t, s in enumerate(tenants):
            if s in (0, 1):
                stats = [(k.g[t].double(), k.m[t].double()) for k in per]
                refold = stats if refold is None else [
                    (g + g2, m + m2) for (g, m), (g2, m2) in zip(refold, stats)]
                enc = enc + xs[t].double() @ xs[t].double().T
    from repro_torch.core import rolann

    refold = [rolann.RolannStats(g=g, m=m) for g, m in refold]
    apart_l, apart_e = _model_stats_apart(live["async round 2"], refold, enc)
    check(max(apart_l + [apart_e]) <= 1e-4, f"async live model after round 2 vs the einsum "
          f"re-fold of sites 0 and 1: layers {apart_l}, encoder {apart_e} (bar 1e-4)")
    out["async statistics vs re-fold"] = max(apart_l + [apart_e])
    check(stale_after_2 == {0: 0, 1: 0, 2: 1, 3: 1}, f"staleness after round 2: {stale_after_2}")
    # after round 1: the sync pairwise merge of the round's own four local
    # fits (the fleet fit above, bit for bit the session's)
    fl1 = fleets[0][0]
    loc = [fleet.get_model(fl1, i) for i in range(ENGINE_SITES)]
    m_pairs = daef.merge_models(cfg, daef.merge_models(cfg, loc[0], loc[1]),
                                daef.merge_models(cfg, loc[2], loc[3]))
    apart1_l, apart1_e = _model_stats_apart(live["async round 1"], *_summed_stats([m_pairs]))
    out["async round 1 vs pairwise merge"] = max(apart1_l + [apart1_e])
    check(out["async round 1 vs pairwise merge"] <= 1e-4, "async round 1 statistics vs the "
          f"pairwise merge of its local fits: layers {apart1_l}, encoder {apart1_e} (bar 1e-4)")
    # and against the sync pairwise session on the same parts, whose local fits
    # are one-tenant fits (B1): their float32 drift, amplified by each layer's
    # solve, separates the deeper layers (reported)
    pw_parts = [blocks[s][0] for s in range(ENGINE_SITES)]
    m_pw1 = pw.session().round(pw_parts)
    sess_l, sess_e = _model_stats_apart(live["async round 1"], *_summed_stats([m_pw1]))
    out["async round 1 vs sync pairwise session"] = {"layers": sess_l, "encoder": sess_e}
    say("engine", f"async round 1 vs the pairwise merge of its own local fits: layers "
        + ", ".join(f"{d:.2e}" for d in apart1_l) + f", encoder {apart1_e:.2e} (bar 1e-4); "
        "vs the sync pairwise session on the same parts (one-tenant local fits, no bar): "
        + ", ".join(f"{d:.2e}" for d in sess_l) + f", encoder {sess_e:.2e}")
    say("engine", f"async rounds (max_staleness=0, sites of {2 * half} samples in blocks of "
        f"{half}): " + ", ".join(f"{n} {times[n]:.2f} ms" for n in rounds)
        + f"; B4 launches {b4}; staleness after round 2 {stale_after_2}, at the end "
        f"{session.sites}; live model after round 2 vs the einsum re-fold of the fresh sites "
        f"{out['async statistics vs re-fold']:.2e} (bar 1e-4); restored session's round 3 "
        "bit-identical")

    # ---- 5. secure aggregation on the same four parts ----
    sec = engine(merge="pairwise", privacy=PrivacySpec(secagg=True))
    sec.session().round(pw_parts)
    seen = {}
    real_decode = secagg.decode

    def spy(wire, frac_bits, dtypes=None):
        seen["aggregate"] = [w.copy() for w in wire]
        return real_decode(wire, frac_bits, dtypes)

    s_sec = sec.session()
    secagg.decode = spy
    try:
        zero()
        m_sec, times["secagg round"] = timed(lambda: s_sec.round(pw_parts))
        launches["secagg round"] = read()
    finally:
        secagg.decode = real_decode
    from repro_torch.core import federated

    states = s_sec._local_states(list(enumerate(pw_parts)))
    frac = sec.plan.privacy.frac_bits
    wires = [secagg.encode(federated.exchange_to_additive(sec.config, st), frac)
             for st in states]
    plain = secagg.aggregate(wires, "pairwise")
    check(all(np.array_equal(a, b) for a, b in zip(seen["aggregate"], plain, strict=True)),
          "the masked aggregate differs from the sum of the unmasked wires")
    dec_m = secagg.decode(seen["aggregate"], frac, dtypes=[np.float64] * len(plain))
    dec_p = secagg.decode(plain, frac, dtypes=[np.float64] * len(plain))
    check(all(np.array_equal(a, b) for a, b in zip(dec_m, dec_p)),
          "the masked aggregate does not decode to the unmasked sum bit for bit")
    s_sec_test, s_pw_test = sec.scores(m_sec, xte), pw.scores(m_pw1, xte)
    f1_sec = anomaly.evaluate(m_sec.train_errors, s_sec_test, y_test, RULE).f1
    f1_pw = anomaly.evaluate(m_pw1.train_errors, s_pw_test, y_test, RULE).f1
    out["secagg score distance"] = _rel(s_sec_test.double(), s_pw_test.double())
    out["secagg f1"], out["unmasked f1"] = f1_sec, f1_pw
    say("engine", f"secagg round (pairwise, frac_bits {frac}): {times['secagg round']:.2f} ms, "
        f"launches {launches['secagg round']}; masked aggregate == unmasked sum and decodes "
        f"bit for bit; test scores max|d|/max {out['secagg score distance']:.2e} from the "
        f"unmasked pairwise round (no bar), F1 {f1_sec:.4f} against {f1_pw:.4f}")

    # ---- 6. save / load: the one-tenant model, a 64-tenant fleet ----
    xs_f, seeds_f = fleet_data_d[0], fleet_data[1]
    fl_eng = engine(mode="vmap", tenants=xs_f.shape[0])
    fl = fl_eng.fit(xs_f, seeds=seeds_f)
    with tempfile.TemporaryDirectory() as tmp:
        for name, eng, state in (("model", one, model), ("fleet", fl_eng, fl)):
            path, times[f"{name} save"] = timed(lambda: eng.save(state, os.path.join(tmp, name)))
            back, times[f"{name} load"] = timed(lambda: eng.load(path))
            same_leaves(back, state, f"{name} save/load")
            out[f"{name} bytes"] = _tree_bytes(path)
    say("engine", "save / load (bit-identical round trips): " + ", ".join(
        f"{n} {times[n + ' save']:.2f} / {times[n + ' load']:.2f} ms, {out[n + ' bytes']} bytes"
        for n in ("model", "fleet")) + f"; async session after round 2 saved in "
        f"{times['session save']:.2f} ms, loaded in {times['session load']:.2f} ms, "
        f"{out['session bytes']} bytes")

    # ---- 7. the engine's reduce 64 -> 32, sequential against pairwise ----
    red = {}
    for merge in ("sequential", "pairwise"):
        eng = engine(mode="vmap", tenants=fl.size, merge=merge)
        red[merge], times[f"reduce {merge}"] = timed(lambda: eng.reduce(fl, 2))
    la, lb = checkpoint.flatten(red["sequential"]), checkpoint.flatten(red["pairwise"])
    leaf_apart = [_rel(a.double(), b.double()) if a.is_floating_point()
                  else float(not torch.equal(a, b)) for a, b in zip(la, lb, strict=True)]
    out["reduce leaves apart"] = leaf_apart
    worst_kappa = _check_reduced_agree(red["sequential"], red["pairwise"])
    say("engine", f"reduce {fl.size} -> {fl.size // 2}: sequential {times['reduce sequential']:.2f}"
        f" ms, pairwise {times['reduce pairwise']:.2f} ms; knowledge, error pools, seeds and "
        f"lambdas bit-identical, encoder S and U S^2 U^T within 1e-4, each layer's W and b at "
        f"most {worst_kappa:.3f} of its kappa bar; every leaf's max|d|/max (no bar): "
        + " ".join(f"{d:.1e}" for d in leaf_apart))

    phase_profile("engine: sync sequential round (4 sites)",
                  lambda: seq.session().round(sites), ("slice_kernel", "slice_reduce_kernel"))
    say("engine", "launches per round: " + ", ".join(f"{n} {v}" for n, v in launches.items()))
    say("engine", "times (host clock, ending in torch.cuda.synchronize()): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    say("engine", f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": times, "launches": launches, **out}


# ---------------------------------------------------------------------------
# 19. the DP release and fleet serving
# ---------------------------------------------------------------------------

DP_SPEC = dict(epsilon=8.0, composition="basic", budget_epsilon=16.0)
SERVE_ROUNDS = 20
SERVE_PAD = 64         # each tenant sends 1..SERVE_PAD samples a round
SERVE_TILE = 32
SERVE_NEW_BLOCK = 512  # samples a tenant in the partial fit
SERVE_CLI = (["--fleet", "64", "--rounds", "5", "--stats-backend", "fused"],
             ["--async-rounds", "3", "--sites", "8", "--dp-epsilon", "8"],
             ["--privacy"])


def _start_cli_runs():
    """``python -m repro_torch.launch.serve`` in each mode of SERVE_CLI, as
    processes started together (each reaches the card on its own)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(argv, subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
            for argv in SERVE_CLI]


def _finish_cli_runs(runs) -> dict:
    """Wait for every CLI process; each must exit 0 with its OK line last."""
    out = {}
    for argv, proc in runs:
        try:
            stdout, stderr = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        lines = stdout.strip().splitlines()
        name = " ".join(argv)
        for line in lines:
            say("serve-cli", f"{name}: {line}")
        ok = {"--fleet": "fleet serve OK", "--async-rounds": "async federation OK",
              "--privacy": "privacy smoke OK"}[argv[0]]
        check(proc.returncode == 0 and lines and lines[-1] == ok,
              f"serve CLI {name} exited {proc.returncode}, last line "
              f"{lines[-1] if lines else None!r}; stderr tail: {stderr[-2000:]}")
        out[name] = lines[-2] if len(lines) > 1 else ""
    return out


def _serve_traffic(k, tests, rounds, seed=0):
    """The serve CLI's traffic: each round, each tenant 1..SERVE_PAD samples
    of its site's test split without replacement (tenants 2s and 2s + 1
    share site s's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        counts = rng.integers(1, SERVE_PAD + 1, size=k)
        reqs = []
        for t in range(k):
            x_test = tests[t // 2]
            c = min(int(counts[t]), x_test.shape[1])
            idx = rng.choice(x_test.shape[1], size=c, replace=False)
            reqs.append(np.ascontiguousarray(x_test[:, idx], np.float32))
        out.append(reqs)
    return out


def _serve_round(server, reqs):
    rids = [server.submit(t, x) for t, x in enumerate(reqs)]
    server.flush()
    return [server.take(rid) for rid in rids]


def _padded(reqs, m0):
    import numpy as np

    counts = np.array([x.shape[1] for x in reqs])
    batch = np.zeros((len(reqs), m0, SERVE_PAD), np.float32)
    for t, x in enumerate(reqs):
        batch[t, :, : counts[t]] = x
    return batch, counts


def _check_served(label, results, engine, state, reqs, mus):
    """Served scores against ``engine.scores`` on the padded batch (1e-5 of
    the max) and flags against those scores at the server's thresholds,
    except at ties within 1e-6 of mu.  Returns the worst share of the bar
    and the tie count."""
    import numpy as np

    batch, counts = _padded(reqs, engine.config.layer_sizes[0])
    pad = engine.scores(state, batch, n_valid=counts).cpu().numpy()
    worst, ties = 0.0, 0
    for t, res in enumerate(results):
        want = pad[t, : counts[t]]
        scale = max(float(np.abs(want).max()), 1e-30)
        d = float(np.abs(res.scores - want).max()) / scale
        check(d <= 1e-5, f"{label}: tenant {t} scores {d:.3e} of max from the padded path "
              "(bar 1e-5)")
        worst = max(worst, d / 1e-5)
        tie = np.abs(want - mus[t]) <= 1e-6 * abs(mus[t])
        ties += int(tie.sum())
        flags = (want > mus[t]).astype(np.int32)
        check(np.array_equal(res.flags[~tie], flags[~tie]),
              f"{label}: tenant {t} flags differ from the padded path's off ties")
    return worst, ties


def phase_dp_serving(cfg, xtr, fleet_data, fleet_data_d):
    """Phase 19: the DP release in a federation session and the fleet
    server, at full width.  Returns the phase's numbers."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import daef, threefry
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.privacy import PrivacyBudgetExceeded, PrivacySpec, dp
    from repro_torch.serving import FleetServer, latency_summary
    from repro_torch.serving import server as server_mod
    from repro_torch.train import checkpoint

    t_phase = time.perf_counter()
    base = daef.DAEFConfig(**CREDITCARD)
    wrappers = {**_wrappers(), **_fleet_wrappers()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in wrappers.items() if fn.launches}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, (time.perf_counter() - t0) * 1e3

    times, launches, out = {}, {}, {}
    n_hidden = len(path_shapes(cfg))

    # ---- DP: two sync pairwise rounds over phase 18's quarters ----
    spec = PrivacySpec(**DP_SPEC)
    plan = ExecutionPlan(merge="pairwise", stats_backend="fused", privacy=spec)
    sites = daef._split(xtr, ENGINE_SITES)
    DAEFEngine(base, plan).session().round(sites)  # warm-up, a throwaway ledger
    draws = {"card": [], "cpu": []}
    real_normal = dp._normal

    def spy(side):
        def normal(*args, **kwargs):
            z = real_normal(*args, **kwargs)
            draws[side].append(z.cpu())
            return z
        return normal

    card = DAEFEngine(base, plan)
    host = DAEFEngine(base, plan, device="cpu")
    s_card, s_host = card.session(), host.session()
    sites_h = [p.cpu() for p in sites]
    models = {}
    try:
        for r in (1, 2):
            zero()
            dp._normal = spy("card")
            models[r], times[f"dp round {r}"] = timed(lambda: s_card.round(sites))
            launches[f"dp round {r}"] = read()
            dp._normal = spy("cpu")
            t0 = time.perf_counter()
            host_model = s_host.round(sites_h)
            times[f"dp round {r} on the host"] = (time.perf_counter() - t0) * 1e3
        dp._normal = real_normal
        # a release draws the encoder's, each layer's G and M, the last
        # layer's G and M and the error counts' noise
        check(len(draws["card"]) == len(draws["cpu"]) == 2 * ENGINE_SITES * (2 * n_hidden + 4)
              and all(torch.equal(a, b) for a, b in zip(draws["card"], draws["cpu"])),
              f"DP draws: {len(draws['card'])} on the card, {len(draws['cpu'])} on the host, "
              "not bit-identical")
    finally:
        dp._normal = real_normal
    want_b3 = {"rolann_fused_chunk": ENGINE_SITES * n_hidden}
    check(all(launches[f"dp round {r}"] == want_b3 for r in (1, 2)),
          f"DP rounds launched {launches}; expected B3 {n_hidden} per release")
    on_host = checkpoint.map_leaves(lambda a: a.cpu(), models[2])
    apart = [_stats_rel(a, b) for a, b in zip(on_host.layer_knowledge,
                                              host_model.layer_knowledge, strict=True)]
    apart_e = _rel(_enc_gram(on_host.encoder_factors), _enc_gram(host_model.encoder_factors))
    check(max(apart + [apart_e]) <= 1e-4, f"DP session's noised blocks vs the CPU session: "
          f"layers {apart}, encoder {apart_e} (bar 1e-4)")
    out["dp blocks vs host"] = max(apart + [apart_e])
    spent = [s_card.privacy_spent(s) for s in range(ENGINE_SITES)]
    check(all(sp == (16.0, 2e-5) for sp in spent), f"ledgers after two rounds: {spent}")
    with tempfile.TemporaryDirectory() as tmp:
        path = card.save(s_card, os.path.join(tmp, "dp"))
        restored = DAEFEngine(base, plan).load(path)
    check(all(restored.privacy_spent(s) == (16.0, 2e-5) for s in range(ENGINE_SITES)),
          "ledgers after the restore")
    la, lb = checkpoint.flatten(restored.model), checkpoint.flatten(s_card.model)
    check(all(torch.equal(a, b) for a, b in zip(la, lb, strict=True)),
          "restored DP session's model differs")
    drawn = []
    dp._normal = lambda *a, **k: drawn.append(1) or real_normal(*a, **k)
    try:
        restored.round(sites)
        check(False, "a third DP round under budget_epsilon=16 was not refused")
    except PrivacyBudgetExceeded as e:
        out["budget refusal"] = str(e)
    finally:
        dp._normal = real_normal
    check(not drawn and restored.rounds_run == 2
          and all(restored.privacy_spent(s) == (16.0, 2e-5) for s in range(ENGINE_SITES)),
          f"refused round drew {len(drawn)} times, rounds {restored.rounds_run}")
    key = s_card._dp_key(0)
    fit = lambda: dp.fit_dp(card.config, sites[0], key, spec)  # noqa: E731
    fit()
    zero()
    _, times["fit_dp one site"] = timed(fit)
    launches["fit_dp one site"] = read()
    check(launches["fit_dp one site"] == {"rolann_fused_chunk": n_hidden},
          f"fit_dp launched {launches['fit_dp one site']}")
    say("dp", f"sync pairwise DP session, {ENGINE_SITES} sites of {[p.shape[1] for p in sites]}"
        f", PrivacySpec({DP_SPEC}): rounds {times['dp round 1']:.2f}, {times['dp round 2']:.2f}"
        f" ms (host: {times['dp round 1 on the host']:.0f}, {times['dp round 2 on the host']:.0f}"
        f" ms); B3 {n_hidden} launches per release ({launches['dp round 1']} a round); fit_dp "
        f"of one site {times['fit_dp one site']:.2f} ms; {len(draws['card'])} noise draws "
        f"bit-identical to the CPU session's; noised blocks after round 2 "
        f"{out['dp blocks vs host']:.2e} of their max from it (bar 1e-4); ledgers (16, 2e-5) "
        "before and after a save / restore; the third round refused before any draw: "
        f"{out['budget refusal']}")

    # ---- serving: the 64-tenant fleet behind FleetServer ----
    xs, seeds, tests, _ = fleet_data
    xs_d = fleet_data_d[0]
    k, m0, n = xs.shape
    fplan = ExecutionPlan(mode="vmap", tenants=k, stats_backend="fused")
    engine = DAEFEngine(base, fplan)
    zero()
    fl = engine.fit(xs_d, seeds=seeds)
    launches["fleet fit"] = read()
    check(launches["fleet fit"] == {"rolann_stats_batched": n_hidden},
          f"fleet fit launched {launches['fleet fit']}")
    traffic = _serve_traffic(k, tests, SERVE_ROUNDS)
    server = FleetServer(engine, fl, tile_width=SERVE_TILE, rule="q90")
    n_shapes, times["warmup (capture)"] = timed(server.warmup)
    check(n_shapes == len(server._graphs) == 36 and server.probe_donation().ok is True,
          f"warmup: {n_shapes} shapes, {len(server._graphs)} graphs")
    mus = server.thresholds
    mus_d = torch.as_tensor(mus, device="cuda")
    gen = np.random.default_rng(1)
    for (s, t), graph in server._graphs.items():
        x = torch.from_numpy(gen.normal(size=(s, m0, t)).astype(np.float32))
        meta = torch.stack([torch.from_numpy(gen.integers(0, k, size=s)),
                            torch.from_numpy(gen.integers(0, t + 1, size=s))])
        errs, flags = graph.replay(x.pin_memory(), meta.pin_memory())
        want_e, want_f = server_mod._score_tile(engine.config, server._leaves, x.cuda(),
                                                meta[0].cuda(), meta[1].cuda(), mus_d)
        check(torch.equal(torch.isnan(errs), torch.isnan(want_e))
              and torch.equal(torch.nan_to_num(errs), torch.nan_to_num(want_e))
              and torch.equal(flags, want_f), f"graph of shape {(s, t)} differs from eager")
    # per-tile times on CUDA events, the full tile and the smallest
    tile_us = {}
    for shape in ((k, SERVE_TILE), min(server._graphs)):
        graph = server._graphs[shape]
        args = (engine.config, server._leaves, graph.x, graph.meta[0], graph.meta[1], mus_d)
        tile_us[str(shape)] = {"replay": cuda_ms(graph.graph.replay, reps=200) * 1e3,
                               "eager": cuda_ms(lambda: server_mod._score_tile(*args),
                                                reps=200) * 1e3}
    lat, served, results = [], [], []
    for reqs in traffic:
        t0 = time.perf_counter()
        results.append(_serve_round(server, reqs))
        lat.append(time.perf_counter() - t0)
        served.append(sum(x.shape[1] for x in reqs))
    check(len(server._graphs) == 36, "a graph was captured after warmup")
    summary = latency_summary(lat[1:], sum(served[1:]))
    stats = dict(server.stats)
    worst, ties = 0.0, 0
    for reqs, res in zip(traffic, results):
        w, tie = _check_served("serve", res, engine, fl, reqs, mus)
        worst, ties = max(worst, w), ties + tie
    # a repeated round: every column from the cache, no dispatch
    before = server.stats["dispatches"]
    again, times["repeated round"] = timed(lambda: _serve_round(server, traffic[-1]))
    check(server.stats["dispatches"] == before
          and all(r.cached_cols == r.scores.size for r in again)
          and all(np.array_equal(a.scores, b.scores) for a, b in zip(again, results[-1])),
          "the repeated round was not served from the cache alone")
    # partial_fit on a new block: each tenant the first samples of its
    # sibling device's training block (same site, unseen by this tenant)
    new = np.ascontiguousarray(xs[np.arange(k) ^ 1][:, :, :SERVE_NEW_BLOCK])
    zero()
    fl2, times["partial_fit"] = timed(lambda: server.partial_fit(new))
    launches["server partial_fit"] = read()
    check(launches["server partial_fit"] == {"rolann_stats_batched": n_hidden}
          and server.stats["recalibrations"] == 1 and len(server._graphs) == 36,
          f"partial_fit launched {launches['server partial_fit']}, stats {server.stats}")
    refit = _serve_round(server, traffic[-1])
    check(all(r.cached_cols == 0 for r in refit), "the refit fleet served stale cache entries")
    w, tie = _check_served("after partial_fit", refit, engine, fl2, traffic[-1],
                           server.thresholds)
    worst, ties = max(worst, w), ties + tie
    # the pad-to-max path over the same traffic
    pad_lat = []
    pad_mus = engine.thresholds(fl, rule="q90")
    for reqs in traffic:
        batch, counts = _padded(reqs, m0)
        t0 = time.perf_counter()
        flags = engine.classify(engine.scores(fl, batch, n_valid=counts), pad_mus)
        int(flags.sum())  # the readback
        pad_lat.append(time.perf_counter() - t0)
    pad_summary = latency_summary(pad_lat[1:], sum(served[1:]))
    fresh = FleetServer(engine, fl, tile_width=SERVE_TILE, rule="q90")
    fresh.warmup()
    busy = phase_profile(f"serve: {SERVE_ROUNDS} rounds of 64 tenants (continuous)",
                         lambda: [_serve_round(fresh, reqs) for reqs in traffic], warm=False)
    # Untimed from here: the CLI's three modes run as processes of their own
    # meanwhile.
    cli = _start_cli_runs()
    try:
        chunked = DAEFEngine(base, ExecutionPlan(mode="vmap", tenants=k, stats_backend="fused",
                                                 chunk_samples=FLEET_CHUNK))
        zero()
        FleetServer(chunked, fl, tile_width=SERVE_TILE, rule="q90").partial_fit(new)
        launches["server partial_fit, chunked plan"] = read()
        check(launches["server partial_fit, chunked plan"]
              == {"rolann_fused_chunk_batched": n_hidden},
              f"chunked partial_fit launched {launches['server partial_fit, chunked plan']}")
        # the port's CPU server on the same fleet and traffic
        host_engine = DAEFEngine(base, ExecutionPlan(mode="vmap", tenants=k), device="cpu")
        host_server = FleetServer(host_engine, checkpoint.map_leaves(lambda a: a.cpu(), fl),
                                  tile_width=SERVE_TILE, rule="q90")
        flag_apart = np.zeros(k, np.int64)
        for reqs, res in zip(traffic, results):
            for t, (a, b) in enumerate(zip(res, _serve_round(host_server, reqs))):
                flag_apart[t] += int((a.flags != b.flags).sum())
        check(int(flag_apart.max()) <= 4, f"flags vs the CPU server: up to {flag_apart.max()} "
              "a tenant (bar 4)")
    finally:
        cli_lines = _finish_cli_runs(cli)
    out.update({
        "continuous": summary, "pad": pad_summary, "served stats": stats,
        "tile us": tile_us, "scores vs padded, share of the 1e-5 bar": worst,
        "flag ties": ties, "flags apart from the CPU server, worst tenant":
            int(flag_apart.max()), "serve busy share": busy,
    })
    say("serve", f"FleetServer over {k} tenants, tile width {SERVE_TILE}: warmup captured "
        f"{n_shapes} CUDA graphs in {times['warmup (capture)']:.1f} ms, each replay "
        f"bit-identical to eager; {SERVE_ROUNDS} rounds of the CLI's traffic: p50 "
        f"{summary['p50_ms_per_round']:.3f} / p95 {summary['p95_ms_per_round']:.3f} ms a "
        f"round, {summary['scores_per_sec']:.0f} scores/s (pad path p50 "
        f"{pad_summary['p50_ms_per_round']:.3f} / p95 {pad_summary['p95_ms_per_round']:.3f} ms, "
        f"{pad_summary['scores_per_sec']:.0f} scores/s); {stats['dispatches']} dispatches, "
        f"{stats['dispatched_cols']} dispatched columns for {stats['scored']} scored, "
        f"{stats['cache_hit_cols']} cache-hit columns; scores at most {worst:.3f} of the 1e-5 "
        f"bar from the padded path, {ties} ties; flags vs the CPU server at most "
        f"{int(flag_apart.max())} a tenant (bar 4); repeated round "
        f"{times['repeated round']:.2f} ms, all cached, no dispatch; partial_fit "
        f"{times['partial_fit']:.2f} ms, launches {launches['server partial_fit']} (chunked "
        f"plan {launches['server partial_fit, chunked plan']}); per tile (CUDA events): "
        + ", ".join(f"{sh} replay {v['replay']:.1f} µs, eager {v['eager']:.1f} µs"
                    for sh, v in tile_us.items())
        + f"; device busy {100 * busy:.1f} % of a {SERVE_ROUNDS}-round serve")
    out["cli"] = cli_lines
    say("serve", "launches: " + ", ".join(f"{n} {v}" for n, v in launches.items()))
    say("serve", "times (host clock, ending in torch.cuda.synchronize()): "
        + ", ".join(f"{name} {ms:.2f} ms" for name, ms in times.items()))
    say("serve", f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return {"ms": times, "launches": launches, **out}


# ---------------------------------------------------------------------------
# 9-13. the LM backbones' prefill and the DAEF head: B7, B9, B10 against
# their plain versions, depth-cut agreement with the host, the head path,
# the long prefills, profiles
# ---------------------------------------------------------------------------

QWEN3, MAMBA2, RGEMMA = "qwen3-1.7b", "mamba2-780m", "recurrentgemma-9b"
HEAD_FIT, HEAD_TEST, HEAD_SEQ, HEAD_BATCH = 2_048, 256, 256, 64
PREFILL = {QWEN3: (4, 4_096), MAMBA2: (4, 4_096), RGEMMA: (2, 4_096)}
HEAD_FLAG_BAR = 8        # labels of 512 the card's head may differ from the host's
QWEN3_D = 2_048          # qwen3-1.7b's d_model: the head is 2048-256-512-2048


def _lm_wrappers():
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.ssd_chunk import ssd_chunk

    return {**_wrappers(), **_fleet_wrappers(), "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd, "rglru_scan": rglru_scan,
            "ssd_chunk": ssd_chunk}


def _lm_zero():
    for fn in _lm_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def _lm_read(route="wgmma", **want):
    """The launch counts, checked against ``want`` (every kernel not named
    must not have run); every B7 and B8 launch must have taken ``route``
    (``"wgmma"``: the bf16 tensor-core kernels; ``"fp32"``: the float32
    ones)."""
    wrappers = _lm_wrappers()
    got = {name: fn.launches for name, fn in wrappers.items()}
    expected = {name: want.get(name, 0) for name in got}
    check(got == expected, f"launched {got}, expected {expected}")
    for name in ("flash_attention", "flash_attention_bwd"):
        routes = wrappers[name].route_launches
        check(routes[route] == got[name],
              f"{name}: launches by route {routes}, expected all {got[name]} on {route}")
    return got


def _ptxas(library, kernel):
    """(registers, spill store bytes, spill load bytes) of each instantiation
    of ``kernel`` in ``library``'s build log, keyed by its template
    arguments as they appear in the mangled name."""
    from repro_torch.kernels import _build

    out, name = {}, None
    for line in _build.build_log(library).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1) if kernel in entry.group(1) else None
        elif name and "spill stores" in line:
            spill = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            args = re.findall(r"L[ib](\d+)E", name.split(kernel, 1)[1])
            out[",".join(args)] = (regs, *spill)
            name = None
    return out


def _say_ptxas_named(library):
    """Registers and spill bytes of every kernel in ``library``'s build log,
    by mangled name."""
    from repro_torch.kernels import _build

    name = spill = None
    for line in _build.build_log(library).splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill", line)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            say("build", f"ptxas {library} {name}: {regs} registers, spill stores "
                f"{spill[0] if spill else '?'} B, spill loads {spill[1] if spill else '?'} B")
            name = None


def _say_ptxas(library, kernels):
    for kernel in kernels:
        for args, (regs, stores, loads) in sorted(_ptxas(library, kernel).items()):
            say("kernel", f"ptxas {kernel}<{args}>: {regs} registers, spill stores {stores} B, "
                f"spill loads {loads} B")


def _attention_work(b, s, h, hkv, d, elem, window):
    """FLOPs and bytes of B7 on these inputs: Q·Kᵀ and P·V over the (query,
    key) pairs the causal/window band keeps (2 FLOPs per multiply-add), the
    softmax not counted; q, k, v read once, out and lse written once."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    flops = 4 * d * pairs * b * h
    nbytes = elem * (b * s * (h + 2 * hkv) * d + b * s * h * d) + 4 * b * h * s
    return flops, nbytes


def _rglru_work(b, s, w, x_elem=4, gate_elem=4):
    """B9: ~10 operations per element (exp, expm1 and sqrt counted as one
    each); x (``x_elem`` bytes an element), r and i (``gate_elem`` each) and
    lam read once, y and h_last written once in float32."""
    return 10 * b * s * w, (x_elem + 2 * gate_elem) * b * s * w + 4 * (w + b * s * w + b * w)


def _ssd_work(b, s, h, p, g, n, chunk):
    """B10 per (b, h, chunk): the intra term over the Q(Q+1)/2 causal pairs
    (C·Bᵀ over N, then P·xdt over P) and the inter term and the state
    (Q·N·P each), 2 FLOPs per multiply-add; xdt, la, B, C read once, y and
    h_final written once, float32."""
    q = chunk
    per_chunk = q * (q + 1) // 2 * 2 * (n + p) + 4 * q * n * p
    flops = per_chunk * (s // q) * b * h
    nbytes = 4 * (2 * b * s * h * p + b * s * h + 2 * b * s * g * n + b * h * p * n)
    return flops, nbytes


def _sdpa(q, k, v, window):
    """The one-call PyTorch yardstick of B7 (timed here only; the port never
    calls it): fused attention in [B, H, S, D], causal or with the band
    mask, GQA in the call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_mask

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    mask = attention_mask(q.shape[1], True, window, q.device)
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _agree(label, got, want, tol, scale_floor=0.0):
    """max|got - want| <= tol * max(scale_floor, max|want|); returns max|d|."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(scale_floor, float(want.double().abs().max()))
    check(bool(got.isfinite().all()), f"{label}: not finite")
    check(err <= tol * scale, f"{label}: max|d| {err:.3e} > {tol:g} * {scale:.3e}")
    return err, scale


def _agree_each(label, got, want, rel, floor):
    """|got - want| <= rel * |want| + floor at every element; returns max|d|
    and the largest share of its own bar that any element used."""
    d = (got.double() - want.double()).abs()
    used = float((d / (rel * want.double().abs() + floor)).max())
    check(bool(got.isfinite().all()), f"{label}: not finite")
    check(used <= 1.0, f"{label}: an element's |d| is {used:.3f} of its bar "
          f"{rel:g} * |want| + {floor:g}")
    return float(d.max()), used


def phase_lm_kernels():
    """B7, B9 and B10 against their plain versions on the card, at the LM
    paths' shapes and at ragged and degenerate ones; the path shapes timed
    beside their bound, their plain version and (B7) SDPA."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_ref
    from repro_torch.kernels.ssd_chunk import fit_chunk, ssd_chunk, ssd_chunk_plain

    gen = torch.Generator(device="cuda").manual_seed(15)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    from repro_torch.kernels.rolann_stats import ops, rolann_stats, rolann_stats_plain

    rows = {"flash_attention": [], "rglru_scan": [], "ssd_chunk": [], "rolann_stats_head": []}
    # B1 at the DAEF head's one launch: the hidden decoder layer's 512 units
    # plus the bias row (m = 513) reconstructing the 256-wide latent (o).
    m, o, n = QWEN3_D // 4 + 1, QWEN3_D // 8, HEAD_FIT
    xa, fsq, fd = _stats_inputs(m, o, n, f32, seed=15)
    g, mv = rolann_stats(xa, fsq, fd)
    torch.cuda.synchronize()
    gp, mp = rolann_stats_plain(xa, fsq, fd)
    (err_g, scale_g), (err_m, scale_m) = (_agree("B1 head shape G", g, gp, 1e-4),
                                          _agree("B1 head shape M", mv, mp, 1e-4))
    err = max(err_g, err_m)
    check(bool((g == g.transpose(1, 2)).all()), "B1 head shape: G not symmetric")
    g2, m2 = rolann_stats(xa, fsq, fd)
    check(bool((g2 == g).all() and (m2 == mv).all()), "B1 head shape: not deterministic")
    ms, plain_ms = cuda_ms(lambda: rolann_stats(xa, fsq, fd)), cuda_ms(
        lambda: rolann_stats_plain(xa, fsq, fd))
    library_ms = cuda_ms(lambda: torch.einsum("in,on,jn->oij", xa, fsq, xa))
    fp32_ms, _ = _stats_bound(m, o, n)
    bound_ms, bound_by = _bound(*_stats_work(m, o, n), PEAK_TF32X3_FLOPS)
    rows["rolann_stats_head"].append(dict(m=m, o=o, n=n, max_abs_err=err, ms=ms,
                                          plain_ms=plain_ms, library_ms=library_ms,
                                          bound_ms=bound_ms, bound_by=bound_by,
                                          bound_fp32_ms=fp32_ms,
                                          bar_used=max(err_g / scale_g, err_m / scale_m) / 1e-4))
    say("kernel", f"rolann_stats at the DAEF head's shape m={m} o={o} n={n}: max|d| G "
        f"{err_g:.3e} of max|G| {scale_g:.4e} ({err_g / (1e-4 * scale_g):.4f} of the bar), "
        f"M {err_m:.3e} of max|M| {scale_m:.4e} ({err_m / (1e-4 * scale_m):.4f} of the bar) "
        f"(tol 1e-4 * max); G exactly symmetric, repeat bit-identical; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, einsum yardstick {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms at 3xTF32 ({bound_by}), {fp32_ms:.4f} ms on FP32 cores")

    # B1's scratch does not grow with n: at the head's (m, o) one slice sums
    # runs of 2,048 samples in G itself, at 2,048 samples or at 65,536.
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_big = 65_536
    scratch = {nn: ops.workspace_bytes(1, m, nn, o, False, sms) for nn in (n, n_big)}
    rows["rolann_stats_head"][-1]["scratch_bytes"] = scratch[n]
    xa, fsq, fd = _stats_inputs(m, o, n_big, f32, seed=16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    g, mv = rolann_stats(xa, fsq, fd)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    check(peak <= 4 * o * (m * m + m) + 2**20, f"B1 at n={n_big}: {peak} bytes allocated, "
          "more than G and M")
    # the plain version over 4,096-sample blocks, summed in float64 (in one
    # call its einsum would hold a 34 GB [o, m, n] intermediate)
    gp = torch.zeros((o, m, m), dtype=torch.float64, device="cuda")
    mp = torch.zeros((o, m), dtype=torch.float64, device="cuda")
    for k in range(0, n_big, 4_096):
        dg, dm = rolann_stats_plain(*(t[:, k:k + 4_096].contiguous() for t in (xa, fsq, fd)))
        gp += dg.double()
        mp += dm.double()
    (err_g, scale_g), (err_m, scale_m) = (_agree(f"B1 n={n_big} G", g, gp, 1e-4),
                                          _agree(f"B1 n={n_big} M", mv, mp, 1e-4))
    check(bool((g == g.transpose(1, 2)).all()), f"B1 n={n_big}: G not symmetric")
    g2, m2 = rolann_stats(xa, fsq, fd)
    check(bool(torch.equal(g2, g) and torch.equal(m2, mv)), f"B1 n={n_big}: not deterministic")
    ms_big = cuda_ms(lambda: rolann_stats(xa, fsq, fd), reps=5, warmup=1)
    say("kernel", f"rolann_stats scratch at m={m} o={o}: {scratch[n]} bytes at n={n}, "
        f"{scratch[n_big]} at n={n_big} (slices capped at 2,048 samples would take "
        f"{4 * -(-n_big // 2_048) * o * (m * m + m)}); at n={n_big}: {peak} bytes allocated "
        f"(G and M), G {err_g / (1e-4 * scale_g):.4f} and M {err_m / (1e-4 * scale_m):.4f} of "
        f"the bar, exactly symmetric, repeat bit-identical, kernel {ms_big:.3f} ms")
    del xa, fsq, fd, g, mv, g2, m2, gp, mp

    b_q, s_q = PREFILL[QWEN3]
    b_r, s_r = PREFILL[RGEMMA]
    attn_cases = [
        ("head path", HEAD_BATCH, HEAD_SEQ, 16, 8, 128, bf16, None, True),
        ("qwen3 prefill", b_q, s_q, 16, 8, 128, bf16, None, True),
        ("recurrentgemma prefill", b_r, s_r, 16, 1, 256, bf16, 2_048, True),
        ("ragged S", 1, 1_000, 16, 8, 128, bf16, None, False),
        ("float32", 2, 512, 8, 4, 64, f32, None, False),
        ("window 1", 1, 300, 4, 1, 128, f32, 1, False),
        ("window 17", 2, 600, 16, 1, 256, bf16, 17, False),
    ]
    _say_ptxas("flash_attention", ["flash_fwd_wgmma_kernel", "flash_fwd_kernel"])
    for label, b, s, h, hkv, d, dtype, window, timed in attn_cases:
        q, k, v = randn(b, s, h, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype), \
            randn(b, s, hkv, d, dtype=dtype)
        route = "wgmma" if dtype == bf16 else "fp32"
        before = flash_attention.route_launches[route]
        out, lse = flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        check(flash_attention.route_launches[route] == before + 1, f"B7 {label}: not on {route}")
        ref, ref_lse = flash_attention_ref(q, k, v, window=window)
        check(out.dtype == dtype and tuple(lse.shape) == (b, h, s), f"B7 {label}: shape/dtype")
        # bf16: the kernel and the plain version round float32 results that
        # differ in summation order once each, so each element is within one
        # bf16 ulp of itself (<= 2^-7 |ref|); the floor covers the float32
        # order's own error where |ref| is near 0.  float32: summation order.
        if dtype == bf16:
            err, used = _agree_each(f"B7 {label} out", out.float(), ref.float(),
                                    2.0**-7, 2.0**-7 * 1e-2)
            bar = f"2^-7 |ref| + 2^-7 * 1e-2 per element, worst {used:.3f} of its bar"
        else:
            err, _ = _agree(f"B7 {label} out", out.float(), ref.float(), 1e-5, 1.0)
            bar = "1e-5 * max(1, max|ref|)"
        err_lse, _ = _agree(f"B7 {label} lse", lse, ref_lse, 1e-5)
        say("kernel", f"flash_attention {label} B={b} S={s} H={h}/{hkv} D={d} "
            f"{str(dtype)[6:]} window={window} ({route}): max|d| out {err:.3e} ({bar}), "
            f"lse {err_lse:.3e}, ok")
        if timed:
            ms = cuda_ms(lambda: flash_attention(q, k, v, window=window))
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, window=window))
            library_ms = cuda_ms(lambda: _sdpa(q, k, v, window))
            flops, nbytes = _attention_work(b, s, h, hkv, d, q.element_size(), window)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            rows["flash_attention"].append(dict(
                shape=label, b=b, s=s, h=h, hkv=hkv, d=d, window=window,
                max_abs_err=max(err, err_lse), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"flash_attention {label}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}, {flops:.3g} FLOP, {nbytes / 1e6:.1f} MB)")

    # B9 on the prefill's inputs (the backbone's bf16 x, float32 gates: their
    # bias is float32), all bf16 and all float32; ragged S (a last tile of 1
    # or 5 of 32 steps) and W (a last lane group of 13 or 4; rows that are
    # not whole 16-byte chunks are loaded by the workers, not staged).
    w_r = 4_096
    for label, b, s, w, dtype, gdtype, timed in (
            ("recurrentgemma prefill", b_r, s_r, w_r, bf16, f32, True),
            ("recurrentgemma prefill, bf16 gates", b_r, s_r, w_r, bf16, bf16, True),
            ("recurrentgemma prefill float32", b_r, s_r, w_r, f32, f32, True),
            ("S = 1", 3, 1, w_r, f32, f32, False), ("S = 1 bf16", 3, 1, w_r, bf16, bf16, False),
            ("W = 100", 2, 37, 100, f32, f32, False),
            ("W = 100 bf16", 2, 37, 100, bf16, bf16, False),
            ("S = 4,097, W = 77 bf16 x", 2, 4_097, 77, bf16, f32, False)):
        x = randn(b, s, w, dtype=dtype)
        r = torch.sigmoid(randn(b, s, w)).to(gdtype)
        i = torch.sigmoid(randn(b, s, w)).to(gdtype)
        lam = randn(w) + 4.0
        name = f"x {str(dtype)[6:]}, gates {str(gdtype)[6:]}"
        before = rglru_scan.route_launches[str(dtype)[6:]]
        y, hl = rglru_scan(x, r, i, lam)
        torch.cuda.synchronize()
        check(rglru_scan.route_launches[str(dtype)[6:]] == before + 1,
              f"B9 {label}: not counted on x's dtype")
        xf, rf, i_f = x.float(), r.float(), i.float()
        yr, hr = rglru_scan_ref(xf, rf, i_f, lam)
        # the same operations in the same order on the same (widened)
        # values; the transcendentals' last bits
        (err_y, scale_y), (err_h, scale_h) = (_agree(f"B9 {label} y", y, yr, 1e-5, 1.0),
                                              _agree(f"B9 {label} h_last", hl, hr, 1e-5, 1.0))
        err, used = max(err_y, err_h), max(err_y / scale_y, err_h / scale_h) / 1e-5
        y2, h2 = rglru_scan(x, r, i, lam)
        check(bool(torch.equal(y, y2) and torch.equal(hl, h2)), f"B9 {label}: not deterministic")
        say("kernel", f"rglru_scan {label} B={b} S={s} W={w} {name}: max|d| {err:.3e} "
            f"({used:.4f} of the bar 1e-5 * max(1, max|plain|)), repeat bit-identical, ok")
        if timed:
            ms = cuda_ms(lambda: rglru_scan(x, r, i, lam))
            plain_ms = cuda_ms(lambda: rglru_scan_ref(xf, rf, i_f, lam))
            bound_ms, bound_by = _bound(*_rglru_work(b, s, w, x.element_size(),
                                                     r.element_size()))
            rows["rglru_scan"].append(dict(shape=label, b=b, s=s, w=w, dtypes=name,
                                           max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                           library_ms=None, bound_ms=bound_ms,
                                           bound_by=bound_by, bar_used=used))
            say("kernel", f"rglru_scan {label} ({name}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); library none (no "
                "single PyTorch call computes a gated linear recurrence)")

    b_m, s_m = PREFILL[MAMBA2]
    for label, b, s, h, p, g, n, chunk, timed in (
            ("mamba2 prefill", b_m, s_m, 48, 64, 1, 128, 256, True),
            ("S = 1,000 (chunk 250)", 2, 1_000, 48, 64, 1, 128, 256, False),
            ("G = 2", 2, 1_024, 8, 64, 2, 128, 256, False)):
        xdt = randn(b, s, h, p)
        la = -torch.rand((b, s, h), generator=gen, device="cuda") * 0.1
        bm, cm = randn(b, s, g, n), randn(b, s, g, n)
        y, hf = ssd_chunk(xdt, la, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        q = fit_chunk(s, chunk)
        yr, hr = ssd_chunk_plain(xdt, la, bm, cm, q)
        # float32 sums of up to Q·N terms in other orders
        (err_y, scale_y), (err_h, scale_h) = (_agree(f"B10 {label} y", y, yr, 1e-5),
                                              _agree(f"B10 {label} h_final", hf, hr, 1e-5))
        err = max(err_y, err_h)
        used = max(err_y / scale_y, err_h / scale_h) / 1e-5
        say("kernel", f"ssd_chunk {label} B={b} S={s} H={h} P={p} G={g} N={n} Q={q}: "
            f"max|d| y {err_y:.3e} of max|plain| {scale_y:.4e} "
            f"({err_y / (1e-5 * scale_y):.4f} of the bar), h_final {err_h:.3e} of "
            f"{scale_h:.4e} ({err_h / (1e-5 * scale_h):.4f} of the bar) "
            "(tol 1e-05 * max|plain|), ok")
        if timed:
            ms = cuda_ms(lambda: ssd_chunk(xdt, la, bm, cm, chunk=chunk))
            plain_ms = cuda_ms(lambda: ssd_chunk_plain(xdt, la, bm, cm, q))
            work = _ssd_work(b, s, h, p, g, n, q)
            fp32_ms, _ = _bound(*work)
            bound_ms, bound_by = _bound(*work, PEAK_TF32X3_FLOPS)
            rows["ssd_chunk"].append(dict(shape=label, b=b, s=s, h=h, p=p, g=g, n=n, chunk=q,
                                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                          library_ms=None, bound_ms=bound_ms,
                                          bound_by=bound_by, bound_fp32_ms=fp32_ms,
                                          bar_used=used))
            say("kernel", f"ssd_chunk {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms at 3xTF32 ({bound_by}, {work[0]:.4g} FLOP), "
                f"{fp32_ms:.4f} ms on FP32 cores; library none (no single PyTorch "
                "call computes the chunked SSD scan)")
    return rows


def _lm_params(name, dtype, seed, **changes):
    """A backbone's parameters drawn on the card from a seeded generator."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import registry
    from repro_torch.models import get_bundle

    cfg = dataclasses.replace(registry.get(name), **changes)
    bundle = get_bundle(cfg)
    t0 = time.perf_counter()
    params = bundle.init(seed, dtype, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in pytree.tree_leaves(params))
    say("lm", f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}) {n_params / 1e9:.3f}e9 "
        f"parameters in {str(dtype)[6:]}, drawn on the card in {time.perf_counter() - t0:.2f} s")
    return cfg, bundle, params


def phase_lm_agreement():
    """Each backbone at full width in float32, depth cut (qwen3 and mamba2 to
    2 layers at 1 x 512 tokens; recurrentgemma to one (rec, rec, attn) period
    at 1 x 2,560 tokens, longer than its 2,048 window): the same weights on
    the card (the kernels) and on the host (their plain versions, the CPU
    path the parity tests hold to the JAX package).  Final hidden states
    within 1e-4 of their largest magnitude: float32 sums in other orders
    (cuBLAS and the kernels against the host's BLAS) through a few layers."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data import synthetic

    for name, depth, seq in ((QWEN3, 2, 512), (MAMBA2, 2, 512), (RGEMMA, 3, 2_560)):
        cfg, bundle, params = _lm_params(name, torch.float32, seed=1, n_layers=depth)
        tokens = synthetic.lm_token_stream(cfg.vocab_size, seq, 1, seed=5)
        _lm_zero()
        t0 = time.perf_counter()
        h_card = bundle.forward(params, tokens).cpu()
        t1 = time.perf_counter()
        want = {QWEN3: dict(flash_attention=depth), MAMBA2: dict(ssd_chunk=depth),
                RGEMMA: dict(flash_attention=1, rglru_scan=2)}[name]
        _lm_read(route="fp32", **want)
        host = pytree.tree_map(lambda t: t.cpu(), params)
        del params
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        h_host = bundle.forward(host, tokens)
        t3 = time.perf_counter()
        err, scale = _agree(f"{cfg.name} depth {depth} card vs host", h_card, h_host, 1e-4)
        say("agree", f"{cfg.name} at depth {depth}, 1 x {seq} tokens, float32: card "
            f"{(t1 - t0) * 1e3:.1f} ms, host {(t3 - t2) * 1e3:.1f} ms, max|d| {err:.3e} "
            f"(max|h| {scale:.3e}, tol 1e-4), launches {want}, ok")
        del host


def _pooled(bundle, params, tokens):
    import torch

    from repro_torch.models import daef_head

    feats = [daef_head.pooled_features(lambda t: bundle.forward(params, t),
                                       tokens[i:i + HEAD_BATCH])
             for i in range(0, len(tokens), HEAD_BATCH)]
    return torch.cat(feats)


def phase_head(cfg, bundle, params):
    """The DAEF head on qwen3-1.7b, full width and depth, bf16, as
    ``examples/llm_feature_anomaly.py`` runs it at full width: fit on 2,048
    "normal" sequences, flag 256 normal and 256 uniform-random OOD
    sequences, S = 256 in batches of 64; after one warm-up.  Returns the
    launch counts and the numbers of the path."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly
    from repro_torch.data import synthetic
    from repro_torch.models import daef_head

    v = cfg.vocab_size
    fit_tokens = synthetic.lm_token_stream(v, HEAD_SEQ, HEAD_FIT, seed=0)
    test_tokens = np.concatenate([
        synthetic.lm_token_stream(v, HEAD_SEQ, HEAD_TEST, seed=7),
        np.random.default_rng(1).integers(0, v, (HEAD_TEST, HEAD_SEQ)).astype(np.int32)])
    truth = np.concatenate([np.zeros(HEAD_TEST, np.int32), np.ones(HEAD_TEST, np.int32)])

    # The fused stats backend, so that the hidden decoder layer's fold is B1
    # (the default config leaves the backend to the environment, then auto).
    head_cfg = dataclasses.replace(daef_head.default_config(cfg.d_model), stats_backend="fused")
    t0 = time.perf_counter()
    _pooled(bundle, params, fit_tokens[:HEAD_BATCH])
    gen = torch.Generator(device="cuda").manual_seed(0)
    daef_head.fit_head(torch.randn((HEAD_FIT, cfg.d_model), generator=gen, device="cuda"),
                       cfg=head_cfg)
    torch.cuda.synchronize()
    say("head", f"warm-up (one forward batch, one head fit) {(time.perf_counter() - t0):.2f} s")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    _lm_zero()
    feats, fwd_fit_ms = timed(lambda: _pooled(bundle, params, fit_tokens))
    test_feats, fwd_test_ms = timed(lambda: _pooled(bundle, params, test_tokens))
    head, fit_ms = timed(lambda: daef_head.fit_head(feats, cfg=head_cfg))
    flags, score_ms = timed(lambda: head.flag(test_feats))
    n_batches = -(-HEAD_FIT // HEAD_BATCH) + -(-2 * HEAD_TEST // HEAD_BATCH)
    launches = _lm_read(flash_attention=cfg.n_layers * n_batches, rolann_stats=1)
    from repro_torch.kernels.rolann_stats import rolann_stats
    check(rolann_stats.route_launches == {"tf32x3": 1, "fp32": 0, "slice": 0},
          f"the head fit's B1 launch (m 513) must take the tensor-core route; "
          f"routes {rolann_stats.route_launches}")
    n_seq = HEAD_FIT + 2 * HEAD_TEST
    tok_s = n_seq * HEAD_SEQ / ((fwd_fit_ms + fwd_test_ms) / 1e3)
    check(tuple(feats.shape) == (HEAD_FIT, cfg.d_model) and bool(feats.isfinite().all()),
          "head features: shape or not finite")
    check(bool(torch.isfinite(head.model.train_errors).all()), "head train errors")
    met = anomaly.binary_metrics(flags, truth)
    say("head", f"qwen3-1.7b forward {n_seq} x {HEAD_SEQ} tokens in {fwd_fit_ms + fwd_test_ms:.1f} ms "
        f"({tok_s:.0f} tokens/s), head fit {fit_ms:.2f} ms, score + flag {score_ms:.2f} ms, "
        f"launches {launches}")
    say("head", f"OOD flags: F1 {met.f1:.4f} (precision {met.precision:.4f}, recall "
        f"{met.recall:.4f}; tp {met.tp} fp {met.fp} fn {met.fn} tn {met.tn})")
    scores = head.score(test_feats)
    train_q = torch.quantile(head.model.train_errors, torch.tensor([0.5, 0.9], device="cuda"))
    say("head", "scores (median): train normals {:.4g} (q90 = threshold {:.4g}), held-out "
        "normals {:.4g}, OOD {:.4g}".format(float(train_q[0]), float(train_q[1]),
                                            float(scores[:HEAD_TEST].median()),
                                            float(scores[HEAD_TEST:].median())))

    # The same head on the host, from the same pooled features.
    t0 = time.perf_counter()
    head_h = daef_head.fit_head(feats.cpu(), cfg=head_cfg, device="cpu")
    flags_h = head_h.flag(test_feats.cpu())
    host_ms = (time.perf_counter() - t0) * 1e3
    diff = int((flags.cpu() != flags_h).sum())
    met_h = anomaly.binary_metrics(flags_h, truth, device="cpu")
    scores, scores_h = scores.cpu(), head_h.score(test_feats.cpu())
    rel = float((scores - scores_h).abs().max() / scores_h.abs().max())
    check(diff <= HEAD_FLAG_BAR, f"the card's head flags {diff} of {len(truth)} samples "
          f"otherwise than the host's (bar {HEAD_FLAG_BAR})")
    say("head", f"host head (fit + flag {host_ms:.0f} ms): F1 {met_h.f1:.4f}; flags differ on "
        f"{diff} of {len(truth)} (bar {HEAD_FLAG_BAR}); scores max|d|/max|.| {rel:.2e}; "
        f"thresholds {float(head.threshold):.6g} card, {float(head_h.threshold):.6g} host")
    lm_profile(f"DAEF head fit ({HEAD_FIT} x {cfg.d_model})",
               lambda: daef_head.fit_head(feats, cfg=head_cfg),
               detail=("partial_kernel", "rolann::reduce_kernel", "stats_tf32x3"))
    return launches, dict(tokens_per_s=tok_s, forward_ms=fwd_fit_ms + fwd_test_ms,
                          fit_ms=fit_ms, score_ms=score_ms, f1=met.f1,
                          precision=met.precision, recall=met.recall, host_f1=met_h.f1,
                          flags_differ=diff)


def phase_prefill(name, cfg, bundle, params, want):
    """One long prefill through ``bundle.prefill`` after a warm-up: tokens/s,
    the launch counts ``want``, finite last-token logits [B, 1, V]."""
    import torch

    from repro_torch.data import synthetic

    b, s = PREFILL[name]
    batch = {"tokens": synthetic.lm_token_stream(cfg.vocab_size, s, b, seed=11)}
    bundle.prefill(params, batch)
    torch.cuda.synchronize()
    _lm_zero()
    t0 = time.perf_counter()
    logits = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _lm_read(**want)
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{name} prefill logits: shape {tuple(logits.shape)} or not finite")
    say("prefill", f"{name} B={b} S={s}: {ms:.1f} ms ({b * s / ms * 1e3:.0f} tokens/s), "
        f"launches {want}, logits finite")
    return launches, dict(ms=ms, tokens_per_s=b * s / ms * 1e3)


def lm_profile(label, run, detail=()):
    """``phase_profile`` plus the device-time shares of the port's kernels
    and of cuBLAS's GEMMs; each kernel whose name holds one of ``detail``
    is listed by name with its launches and device time."""
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
    print(averages.table(sort_by=key, row_limit=15))
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, key) for e in kernels)
    groups = {"B7 flash_fwd_wgmma_kernel": ("flash_fwd_",), "B9 rglru_scan_kernel": ("rglru",),
              "B10 ssd kernels": ("bt_kernel", "chunk_state", "state_pass", "scores_kernel",
                                  "chunk_out"),
              "B1 rolann_stats kernels": ("partial_kernel", "rolann::reduce_kernel",
                                          "stats_tf32x3", "stats_slice_kernel",
                                          "slice::slice_reduce_kernel"),
              "GEMM (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass")}
    shares = {g: sum(getattr(e, key) for e in kernels if any(p in e.key for p in pats))
              for g, pats in groups.items()}
    say("profile", f"{label}: wall {wall * 1e3:.2f} ms, device busy {total / 1e3:.2f} ms "
        f"({100 * total / 1e6 / wall:.1f} %); device time shares: "
        + ", ".join(f"{g} {100 * t / max(total, 1):.1f} %" for g, t in shares.items()))
    for e in kernels:
        if any(p in e.key for p in detail):
            t = getattr(e, key)
            say("profile", f"{label}: {e.key[:90]}: {e.count} launches, {t / 1e3:.4f} ms "
                f"({t / 1e3 / max(e.count, 1):.4f} ms each, {100 * t / max(total, 1):.1f} %)")


def phase_lm():
    """The head path, then the long prefills, one family at a time, each
    model freed before the next; profiles.  Returns the launches per path and
    the numbers of each."""
    import torch

    from repro_torch.data import synthetic

    cfg, bundle, params = _lm_params(QWEN3, torch.bfloat16, seed=0)
    launches, numbers = {}, {}
    launches["head"], numbers["head"] = phase_head(cfg, bundle, params)
    launches[QWEN3], numbers[QWEN3] = phase_prefill(
        QWEN3, cfg, bundle, params, dict(flash_attention=cfg.n_layers))
    batch = synthetic.lm_token_stream(cfg.vocab_size, HEAD_SEQ, HEAD_BATCH, seed=0)
    lm_profile("qwen3-1.7b head-path forward batch (64 x 256)",
               lambda: bundle.forward(params, batch))
    del params
    torch.cuda.empty_cache()

    cfg, bundle, params = _lm_params(MAMBA2, torch.bfloat16, seed=2)
    launches[MAMBA2], numbers[MAMBA2] = phase_prefill(
        MAMBA2, cfg, bundle, params, dict(ssd_chunk=cfg.n_layers))
    b, s = PREFILL[MAMBA2]
    batch = {"tokens": synthetic.lm_token_stream(cfg.vocab_size, s, b, seed=11)}
    lm_profile("mamba2-780m prefill (4 x 4,096)", lambda: bundle.prefill(params, batch),
               detail=("bt_kernel", "chunk_state", "state_pass", "scores_kernel", "chunk_out"))
    del params
    torch.cuda.empty_cache()

    cfg, bundle, params = _lm_params(RGEMMA, torch.bfloat16, seed=3)
    n_attn = cfg.attn_layers
    launches[RGEMMA], numbers[RGEMMA] = phase_prefill(
        RGEMMA, cfg, bundle, params,
        dict(flash_attention=n_attn, rglru_scan=cfg.n_layers - n_attn))
    from repro_torch.kernels.rglru_scan import rglru_scan
    check(rglru_scan.route_launches == {"float32": 0, "bfloat16": cfg.n_layers - n_attn},
          f"recurrentgemma prefill: B9 launches by x's dtype {rglru_scan.route_launches}, "
          "expected all on the backbone's bf16")
    say("prefill", f"recurrentgemma-9b: B9's {cfg.n_layers - n_attn} launches took the "
        "backbone's bf16 x as it is (no float32 copy)")
    b, s = PREFILL[RGEMMA]
    batch = {"tokens": synthetic.lm_token_stream(cfg.vocab_size, s, b, seed=11)}
    lm_profile("recurrentgemma-9b prefill (2 x 4,096)", lambda: bundle.prefill(params, batch))
    del params
    torch.cuda.empty_cache()
    say("lm", "peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB over the LM phases")
    return launches, numbers


# ---------------------------------------------------------------------------
# 14-16. the training path: B8 against its plain version, the depth-cut
# gradient agreement, the full-width train steps
# ---------------------------------------------------------------------------

# 10 steps, the launcher's schedule for a 10-step run (2 warm-up steps).  At
# 6 steps its warm-up is 1 step, i.e. none: the first update is a full-rate
# Adam step (lr times the sign of every gradient) and the loss on step 0's
# batch ends above where it started (PERF.md, PR 17).
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_MICRO = 4, 2_048, 10, 2
TRAIN_LR = 3e-4          # launch/train.py's default --lr


def _attention_bwd_work(b, s, h, hkv, d, elem, window):
    """FLOPs and bytes of B8 (the wrapper's function): the five products of
    the backward (Q·Kᵀ recomputed, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K) over the band's
    (query, key) pairs, 2.5 times B7's two; q, k, v, out and dO read once,
    lse read, dq, dk and dv written once."""
    flops, _ = _attention_work(b, s, h, hkv, d, elem, window)
    nbytes = elem * (3 * b * s * h * d + 2 * b * s * hkv * d       # q, out, dO; k, v
                     + b * s * h * d + 2 * b * s * hkv * d) + 4 * b * h * s
    return 2.5 * flops, nbytes


def _sdpa_bwd(q, k, v, do, window):
    """SDPA's backward alone (the yardstick; the port never calls SDPA): a
    function that runs autograd through one SDPA forward kept alive."""
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, window)
    return lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)


def _agree_bwd(label, got, want, mags, dtype):
    """dq, dk, dv against the plain backward, element by element: float32
    within 1e-5 of the element's term magnitude (the sum of |term| over the
    products that make it; two float32 sums of the same terms in other
    orders differ by a small multiple of eps times that); bf16 within one
    bf16 ulp of the element (2^-7·|ref|: each side rounds its float32 result
    once) plus 2e-5 of the magnitude.  The magnitude of dk and dv sums over
    the G query heads of their group, as the sums themselves do, so the
    floor holds for the group sum too.  Returns (max|d|, worst share of a
    bar)."""
    import torch

    worst_err, worst_used = 0.0, 0.0
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        check(g.dtype == dtype and g.shape == w.shape, f"B8 {label} {name}: dtype/shape")
        check(bool(g.isfinite().all()), f"B8 {label} {name}: not finite")
        d = (g.double() - w.double()).abs()
        bar = (2.0**-7 * w.double().abs() + 2e-5 * m.double() if dtype == torch.bfloat16
               else 1e-5 * m.double())
        used = float((d / bar.clamp_min(1e-30)).max())
        check(used <= 1.0, f"B8 {label} {name}: an element's |d| is {used:.3f} of its bar")
        worst_err, worst_used = max(worst_err, float(d.max())), max(worst_used, used)
    return worst_err, worst_used


def phase_b8_kernels():
    """B8 against its plain version (and, in float32, against autograd
    through B7's plain forward) at the train shape, recurrentgemma's windowed
    MQA at head size 256, a ragged S at head size 64 and head size 32; a
    repeat must be bit-identical.  The train shape is timed beside its bound,
    the plain version and SDPA's backward."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_magnitudes,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    cases = [
        ("train", 2, TRAIN_S, 16, 8, 128, bf16, None, True),
        ("train float32", 2, TRAIN_S, 16, 8, 128, f32, None, False),
        ("recurrentgemma", 2, 4_096, 16, 1, 256, bf16, 2_048, False),
        ("ragged S", 1, 1_000, 8, 2, 64, f32, None, False),
        ("ragged S bf16 window", 2, 1_000, 8, 2, 64, bf16, 300, False),
        ("head size 32", 2, 512, 8, 2, 32, f32, 77, False),
    ]
    _say_ptxas("flash_attention_bwd", ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                                       "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"])
    for label, b, s, h, hkv, d, dtype, window, timed in cases:
        q, k, v, do = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype)
                       for n in (h, hkv, hkv, h))
        out, lse = flash_attention(q, k, v, window=window)
        route = "wgmma" if dtype == bf16 else "fp32"
        before = (flash_attention_bwd.launches, flash_attention_bwd.route_launches[route])
        got = flash_attention_bwd(q, k, v, out, lse, do, window=window)
        torch.cuda.synchronize()
        check((flash_attention_bwd.launches, flash_attention_bwd.route_launches[route])
              == (before[0] + 1, before[1] + 1), f"B8 {label}: launch count or route")
        want = flash_attention_bwd_ref(q, k, v, out, lse, do, window=window)
        mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, do, window=window)
        err, used = _agree_bwd(label, got, want, mags, dtype)
        msg = f"max|d| {err:.3e}, worst {used:.3f} of its per-element bar"
        if dtype == f32:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            ref_out, _ = flash_attention_ref(*leaves, window=window)
            auto = torch.autograd.grad(ref_out, leaves, do)
            err_a, used_a = _agree_bwd(label + " vs autograd", got, auto, mags, dtype)
            msg += f"; vs autograd through B7's plain forward {err_a:.3e} ({used_a:.3f})"
            del leaves, ref_out, auto
        if label == "train":
            again = flash_attention_bwd(q, k, v, out, lse, do, window=window)
            check(all(torch.equal(a, g) for a, g in zip(again, got)),
                  "B8 train: a repeat is not bit-identical")
            msg += "; a repeat is bit-identical"
        say("kernel", f"flash_attention_bwd {label} B={b} S={s} H={h}/{hkv} D={d} "
            f"{str(dtype)[6:]} window={window} ({route}): {msg}, ok")
        if timed:
            ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, window=window))
            plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                               window=window))
            library_ms = cuda_ms(_sdpa_bwd(q, k, v, do, window))
            flops, nbytes = _attention_bwd_work(b, s, h, hkv, d, q.element_size(), window)
            bound_ms, bound_by = _bound(flops, nbytes, PEAK_BF16_FLOPS)
            rows.append(dict(shape=label, b=b, s=s, h=h, hkv=hkv, d=d, window=window,
                             max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"flash_attention_bwd {label}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA backward yardstick {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}, {flops:.3g} FLOP, {nbytes / 1e6:.1f} MB)")
        del q, k, v, do, out, lse, got, want, mags
        torch.cuda.empty_cache()
    return rows


def phase_grad_agreement():
    """qwen3-1.7b at full width cut to 2 layers, float32, 1 x 512 tokens:
    ``bundle.loss`` and the gradient of every parameter leaf on the card (B7
    twice per layer with the remat, B8 once) against the same on the host
    (their plain versions).  Bar per leaf: max|d| <= 1e-4·max|g host|
    (float32 sums in other orders through two layers and a 151,936-way
    softmax); the loss within 1e-5 of itself."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data import synthetic

    cfg, bundle, params = _lm_params(QWEN3, torch.float32, seed=4, n_layers=2)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 512, 1, seed=6)

    def loss_and_grads(p):
        leaves, spec = pytree.tree_flatten(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = bundle.loss(p, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), pytree.tree_unflatten([g.cpu() for g in grads], spec)

    _lm_zero()
    t0 = time.perf_counter()
    loss_card, g_card = loss_and_grads(params)
    t1 = time.perf_counter()
    _lm_read(route="fp32", flash_attention=2 * cfg.n_layers, flash_attention_bwd=cfg.n_layers)
    host = pytree.tree_map(lambda t: t.detach().cpu(), params)
    del params
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    loss_host, g_host = loss_and_grads(host)
    t3 = time.perf_counter()
    check(abs(loss_card - loss_host) <= 1e-5 * abs(loss_host),
          f"2-layer loss: card {loss_card:.7f}, host {loss_host:.7f}")
    worst = 0.0
    for (path, gc), gh in zip(pytree.tree_flatten_with_path(g_card)[0],
                              pytree.tree_leaves(g_host)):
        scale = float(gh.abs().max())
        err = float((gc - gh).abs().max())
        name = pytree.keystr(path)
        check(scale > 0 and bool(gc.isfinite().all()), f"gradient {name}: zero or not finite")
        check(err <= 1e-4 * scale, f"gradient {name}: max|d| {err:.3e} > 1e-4 * {scale:.3e}")
        worst = max(worst, err / scale)
    say("agree", f"qwen3-1.7b at depth 2, 1 x 512 tokens, float32: loss card {loss_card:.6f}, "
        f"host {loss_host:.6f}; {len(pytree.tree_leaves(g_host))} gradient leaves, worst "
        f"max|d| / max|g| {worst:.2e} (bar 1e-4); card {(t1 - t0) * 1e3:.0f} ms, host "
        f"{(t3 - t2) * 1e3:.0f} ms, ok")


def _check_grads(grads):
    """Every gradient leaf finite, and nonzero in every layer of a stacked
    leaf (a detached attention output would leave wq, wk and wv at 0)."""
    import torch
    from torch.utils import _pytree as pytree

    for path, g in pytree.tree_flatten_with_path(grads)[0]:
        name = pytree.keystr(path)
        check(bool(torch.isfinite(g).all()), f"gradient {name} is not finite")
        per_layer = g.flatten(1).abs().amax(1) if "layers" in name else g.abs().amax()[None]
        check(bool((per_layer > 0).all()), f"gradient {name} is zero in a layer")


def phase_train(card):
    """qwen3-1.7b at full width and depth, bf16, trained for ``TRAIN_STEPS``
    steps as ``launch/train.py`` runs it: AdamW under
    ``linear_warmup_cosine(3e-4, steps // 10 + 1, steps)``, weight decay
    0.01, float32 moments; ``make_train_step(microbatches=2,
    clip_norm=1.0)`` with a float32 accumulator; batches of 4 x 2,048
    tokens from ``lm_token_stream(seed=step)``.  Every step's global
    gradient norm (the step's own, before the clip, read by wrapping
    ``optim.global_norm`` for the phase) and loss must be finite, and the
    gradients that reach the optimiser nonzero in every leaf and layer.
    Returns the launch counts of the steps and the path's numbers."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.data import synthetic
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import common

    cfg, bundle, params = _lm_params(QWEN3, torch.bfloat16, seed=0)
    opt = optim.adamw(optim.linear_warmup_cosine(TRAIN_LR, TRAIN_STEPS // 10 + 1, TRAIN_STEPS),
                      weight_decay=0.01)
    norms, global_norm = [], optim.global_norm

    def recorded_norm(tree):
        norm = global_norm(tree)
        norms.append(float(norm))
        return norm

    def observed_update(grads, state, p):
        _check_grads(grads)
        return opt.update(grads, state, p)

    step_fn = steps_mod.make_train_step(bundle, optim.Optimizer(opt.init, observed_update),
                                        microbatches=TRAIN_MICRO, clip_norm=1.0)
    state = opt.init(params)

    def batch(step):
        tokens = synthetic.lm_token_stream(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=step)
        return {"tokens": torch.as_tensor(tokens, device="cuda")}

    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    _lm_zero()
    optim.global_norm = recorded_norm  # the train step calls it through the module
    try:
        for step in range(TRAIN_STEPS):
            b = batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, b)
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
                  f"step {step}: loss {losses[-1]} or gradient norm {norms[-1]} not finite")
            say("train", f"step {step}: loss {losses[-1]:.4f}, global gradient norm "
                f"{norms[-1]:.4f} (before the clip to 1.0), {times[-1]:.0f} ms")
    finally:
        optim.global_norm = global_norm
    n_mb = TRAIN_STEPS * TRAIN_MICRO
    launches = _lm_read(flash_attention=2 * cfg.n_layers * n_mb,
                        flash_attention_bwd=cfg.n_layers * n_mb)
    peak = torch.cuda.max_memory_allocated()
    check(abs(losses[0] - np.log(cfg.vocab_size)) <= 1.0,
          f"step 0 loss {losses[0]:.4f} is not within 1.0 of ln V = {np.log(cfg.vocab_size):.4f}")
    with torch.no_grad():
        after = float(bundle.loss(params, batch(0)))
    check(after < losses[0], f"loss on step 0's batch {after:.4f} after {TRAIN_STEPS} steps is "
          f"not below {losses[0]:.4f}")
    step_ms = statistics.median(times[1:])
    tok_s = TRAIN_B * TRAIN_S / step_ms * 1e3
    say("train", f"qwen3-1.7b full width, {cfg.n_layers} layers, bf16, {TRAIN_STEPS} steps of "
        f"{TRAIN_B} x {TRAIN_S} tokens ({TRAIN_MICRO} microbatches): step {step_ms:.0f} ms "
        f"(median of steps 1-{TRAIN_STEPS - 1}; step 0 {times[0]:.0f} ms), {tok_s:.0f} "
        f"tokens/s, peak device memory {peak / 2**30:.2f} GiB, on {card}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, step 0's batch {after:.4f}; launches {launches}")

    # What the step is made of: one more step under the profiler, and the
    # cross-entropy (forward and backward, one microbatch) and one optimiser
    # update with CUDA events.
    b = batch(TRAIN_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    print(averages.table(sort_by=key, row_limit=20))
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, key) for e in kernels)
    groups = {"B7 flash_fwd_wgmma_kernel": ("flash_fwd_",),
              "B8 flash_bwd wgmma kernels": ("flash_bwd_",),
              "GEMM (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass")}
    shares = {g: sum(getattr(e, key) for e in kernels if any(p in e.key for p in pats))
              for g, pats in groups.items()}
    w = params["embed"]["table"]
    h = torch.randn((TRAIN_B // TRAIN_MICRO, TRAIN_S - 1, cfg.d_model), device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    labels = b["tokens"][:TRAIN_B // TRAIN_MICRO, 1:]
    mask = torch.ones(labels.shape, device="cuda")

    def xent():
        loss = common.chunked_softmax_xent(h, labels, mask, w, chunk=1_024, transpose=True)
        return torch.autograd.grad(loss, (h, w))

    xent_ms = cuda_ms(xent, reps=5, warmup=1)
    zero_grads = pytree.tree_map(lambda p: torch.zeros(p.shape, device="cuda"), params)
    opt_ms = cuda_ms(lambda: optim.apply_updates(params, opt.update(zero_grads, state,
                                                                    params)[0]),
                     reps=3, warmup=1)
    say("profile", f"one train step: wall {wall * 1e3:.0f} ms, device busy {total / 1e3:.0f} ms "
        f"({100 * total / 1e6 / wall:.1f} %); device time shares: "
        + ", ".join(f"{g} {100 * t / max(total, 1):.1f} % ({t / 1e3:.0f} ms)"
                    for g, t in shares.items())
        + f"; cross-entropy forward + backward {xent_ms:.1f} ms per microbatch "
        f"(x{TRAIN_MICRO} per step), AdamW update + apply {opt_ms:.1f} ms per step "
        "(CUDA events)")
    del params, state, zero_grads, h
    torch.cuda.empty_cache()
    return launches, dict(step_ms=step_ms, tokens_per_s=tok_s, peak_gib=peak / 2**30,
                          losses=losses, loss_after=after, grad_norms=norms,
                          profile_wall_ms=wall * 1e3, device_busy_ms=total / 1e3,
                          shares_ms={g: t / 1e3 for g, t in shares.items()},
                          xent_ms=xent_ms, optimizer_ms=opt_ms)


def _per_launch(rows, shape):
    """One JSON row: the kernel's numbers per launch at its main path's shape."""
    row = next(r for r in rows if r["shape"] == shape)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


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
        references = phase_reference(cfg, x_train, x_test, y_test, {**card_fits, **stream_fits})
        fleet_launches, devices = phase_fleet(cfg, fleet_data, fleet_data_d)
        slice_kernels = ("slice_kernel", "slice_reduce_kernel")
        phase_profile("one-shot fused fit + score", lambda: daef.reconstruction_error(
            cfg, daef.fit(cfg, xtr, n_partitions=N_PARTITIONS), xte), slice_kernels)
        phase_profile("streamed fused fit_chunked", lambda: daef.fit_chunked(
            cfg, xtr, chunk_samples=CHUNK_SAMPLES), slice_kernels)
        fleet_seeds, xs_d = fleet_data[1], fleet_data_d[0]
        phase_profile("fused fleet fit (64 tenants)", lambda: fleet._fit_fleet(
            cfg, xs_d, seeds=fleet_seeds), slice_kernels)
        phase_profile("fused chunked fleet fit (64 tenants)", lambda: fleet._fit_fleet_chunked(
            cfg, xs_d, chunk_samples=FLEET_CHUNK, seeds=fleet_seeds), slice_kernels)
        phase_profile("fleet merge 64 -> 32", lambda: fleet.fleet_merge_pairwise(cfg, devices))
        lm_rows = phase_lm_kernels()
        b8_rows = phase_b8_kernels()
        phase_lm_agreement()
        phase_grad_agreement()
        lm_launches, lm_numbers = phase_lm()
        train_launches, lm_numbers["train"] = phase_train(card)
        svd_numbers = phase_svd(cfg, xtr, xte, y_test, references, card_fits, fleet_data,
                                fleet_data_d, devices)
        engine_numbers = phase_engine(cfg, y_test, xtr, xte, references, card_fits,
                                      fleet_data, fleet_data_d)
        serving_numbers = phase_dp_serving(cfg, xtr, fleet_data, fleet_data_d)
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
    b1_fit = _per_launch_sum(rows)
    say("kernel", f"rolann_stats per one-shot fit ({len(rows)} launches, one a layer, slice "
        f"route): {b1_fit['ms']:.4f} ms on CUDA events, "
        f"{sum(r['device_us'] for r in rows) / 1e3:.4f} ms on the device (profiler), bound "
        f"{b1_fit['bound_ms']:.4f} ms on FP32 cores ({b1_fit['bound_by']}), einsum yardstick "
        f"{b1_fit['library_ms']:.4f} ms, worst share of the bar "
        f"{max(r['bar_used'] for r in rows):.4f}")
    b2_rows = [r for r in fold_rows["rolann_stats_acc"] if (r["m"], r["o"]) == last]
    b2_fit = _per_fit(b2_rows, len(n_valid), _acc_bound, ("m", "o"), n_valid)
    say("kernel", f"rolann_stats_acc per logistic-output streamed fit ({len(n_valid)} launches "
        f"at {last}, slice route): {b2_fit['ms']:.4f} ms on CUDA events, "
        f"{len(n_valid) * b2_rows[0]['device_us'] / 1e3:.4f} ms on the device (profiler), "
        f"bound {b2_fit['bound_ms']:.4f} ms on FP32 cores ({b2_fit['bound_by']}), einsum "
        f"yardstick {b2_fit['library_ms']:.4f} ms, share of the bar "
        f"{b2_rows[0]['bar_used']:.4f}")
    b3_rows = fold_rows["rolann_fused_chunk"]
    b3_fit = _per_fit(b3_rows, len(n_valid), _fused_bound, ("m_l", "m_c1"), n_valid)
    say("kernel", f"rolann_fused_chunk per streamed fit ({len(n_valid)} chunks x "
        f"{len(b3_rows)} layers = {stream_launches['rolann_fused_chunk']} launches): "
        f"{b3_fit['ms']:.4f} ms (per launch at the chunk width: "
        + ", ".join(f"({r['m_l']}, {r['m_c1']}) {r['ms']:.4f}" for r in b3_rows)
        + f" ms), bound {b3_fit['bound_ms']:.4f} ms on FP32 cores ({b3_fit['bound_by']}; "
        "no tensor-core route), worst share of the bar "
        f"{max(r['bar_used'] for r in b3_rows):.4f}")
    b4_rows = batched_rows["rolann_stats_batched"]
    b4_fit = _per_launch_sum(b4_rows)
    say("kernel", f"rolann_stats_batched per fleet fit ({len(b4_rows)} launches, one a "
        f"layer, slice route): {b4_fit['ms']:.4f} ms on CUDA events, "
        f"{sum(r['device_us'] for r in b4_rows) / 1e3:.4f} ms on the device (profiler), bound "
        f"{b4_fit['bound_ms']:.4f} ms on FP32 cores ({b4_fit['bound_by']}), einsum yardstick "
        f"{b4_fit['library_ms']:.4f} ms, worst share of the bar "
        f"{max(r['bar_used'] for r in b4_rows):.4f}")
    b5_rows = batched_rows["rolann_stats_acc_batched"]
    b5_fit = _per_fit(b5_rows, len(fleet_valid), fleet_bound["acc"], ("m", "o"), fleet_valid)
    say("kernel", f"rolann_stats_acc_batched per logistic-output chunked fleet fit "
        f"({len(fleet_valid)} launches at {last}, slice route): {b5_fit['ms']:.4f} ms on CUDA "
        f"events, {len(fleet_valid) * b5_rows[0]['device_us'] / 1e3:.4f} ms on the device "
        f"(profiler), bound {b5_fit['bound_ms']:.4f} ms on FP32 cores ({b5_fit['bound_by']}), "
        f"einsum yardstick {b5_fit['library_ms']:.4f} ms, share of the bar "
        f"{b5_rows[0]['bar_used']:.4f}")
    b6_rows = batched_rows["rolann_fused_chunk_batched"]
    b6_fit = _per_fit(b6_rows, len(fleet_valid), fleet_bound["fused"], ("m_l", "m_c1"),
                      fleet_valid)
    say("kernel", f"rolann_fused_chunk_batched per chunked fleet fit ({len(fleet_valid)} "
        f"chunks x {len(b6_rows)} layers = "
        f"{fleet_launches['chunked']['rolann_fused_chunk_batched']} launches, slice route): "
        f"{b6_fit['ms']:.4f} ms on CUDA events, "
        f"{len(fleet_valid) * sum(r['device_us'] for r in b6_rows) / 1e3:.4f} ms on the device "
        f"(profiler), bound {b6_fit['bound_ms']:.4f} ms on FP32 cores ({b6_fit['bound_by']}), "
        f"worst share of the bar {max(r['bar_used'] for r in b6_rows):.4f}")
    kernels = [
        {
            "name": "rolann_stats",
            "route": "cuda",
            "source": source + "rolann_stats_slice.cuh",
            "replaces": replaces + "48",
            "launches": launches["rolann_stats"],
            # Sums over the main path's launches (one per layer shape, one fit).
            **b1_fit,
        },
        {
            "name": "rolann_stats_acc",
            "route": "cuda",
            "source": source + "rolann_stats_slice.cuh",
            "replaces": replaces + "171",
            "launches": stream_launches["rolann_stats_acc"],
            # One logsig-output streamed fit: 8 launches at the last layer's shape.
            **b2_fit,
        },
        {
            "name": "rolann_fused_chunk",
            "route": "cuda",
            "source": source + "rolann_fused_slice.cuh",
            "replaces": replaces + "330",
            "launches": stream_launches["rolann_fused_chunk"],
            # One streamed fit: 8 launches at each hidden layer's shape.
            **b3_fit,
        },
        {
            "name": "rolann_stats_batched",
            "route": "cuda",
            "source": source + "rolann_stats_slice.cuh",
            "replaces": replaces + "102",
            "launches": fleet_launches["fit"]["rolann_stats_batched"],
            # One fleet fit: one launch per layer shape.
            **b4_fit,
        },
        {
            "name": "rolann_stats_acc_batched",
            "route": "cuda",
            "source": source + "rolann_stats_slice.cuh",
            "replaces": replaces + "231",
            "launches": fleet_launches["logsig"]["rolann_stats_acc_batched"],
            # One logsig-output chunked fleet fit: 4 launches at the last layer's shape.
            **b5_fit,
        },
        {
            "name": "rolann_fused_chunk_batched",
            "route": "cuda",
            "source": source + "rolann_fused_slice.cuh",
            "replaces": replaces + "405",
            "launches": fleet_launches["chunked"]["rolann_fused_chunk_batched"],
            # One chunked fleet fit: 4 launches at each hidden layer's shape.
            **b6_fit,
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "launches": lm_launches["head"]["flash_attention"],
            # Per launch at the head path's shape (64 x 256, 16/8 heads of 128, bf16).
            **_per_launch(lm_rows["flash_attention"], "head path"),
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd_sm90.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:212",
            "launches": train_launches["flash_attention_bwd"],
            # Per launch at the train shape (2 x 2,048, 16/8 heads of 128, bf16).
            **_per_launch(b8_rows, "train"),
        },
        {
            "name": "rglru_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:56",
            "launches": lm_launches[RGEMMA]["rglru_scan"],
            # Per launch at recurrentgemma-9b's prefill shape (2 x 4,096 x 4,096).
            **_per_launch(lm_rows["rglru_scan"], "recurrentgemma prefill"),
        },
        {
            "name": "ssd_chunk",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:76",
            "launches": lm_launches[MAMBA2]["ssd_chunk"],
            # Per launch at mamba2-780m's prefill shape (4 x 4,096, 48 heads).
            **_per_launch(lm_rows["ssd_chunk"], "mamba2 prefill"),
        },
    ]
    print(json.dumps({"svd": svd_numbers}))
    print(json.dumps({"engine": engine_numbers}))
    print(json.dumps({"serving": serving_numbers}))
    print(json.dumps({"lm": lm_numbers}))
    print(json.dumps({"per_shape": {"rolann_stats": rows, **fold_rows, **batched_rows,
                                    **lm_rows, "flash_attention_bwd": b8_rows}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
