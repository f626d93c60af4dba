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
    work against the tensor cores' 989 TFLOP/s, float32 on the CUDA cores
    against their 67; B1 at the head's shape, B10 and B7's float32 route,
    which run 3xTF32, against 495 / 3 TFLOP/s, B1 and B10 with the
    FP32-core bound printed beside it), the plain version and, for B7,
    SDPA (in float32 too, at qwen3's train shape, 2 x 2,048, 16/8 heads of
    128, the float32 route's lm-mesh shape).  bf16 B7 launches must take
    the bf16 tensor-core route (``flash_attention.route_launches``
    "wgmma"), float32 ones the 3xTF32 one ("tf32x3"); every float32 case
    repeats bit for bit; ``ptxas``'s registers and spill bytes of every B7
    instantiation are printed.
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
    B7's plain forward; a repeat must be bit-identical (the train shape
    and every float32 case); bf16 on the bf16 tensor-core route, float32 on
    the 3xTF32 one, ``ptxas`` lines of every B8 instantiation printed.  Bars per element:
    float32 1e-5 of the element's term magnitude
    (``flash_attention_bwd_magnitudes``), bf16 one bf16 ulp plus 2e-5 of
    it.  The train shape timed in bf16 and float32 beside its bound, the
    plain version and SDPA's backward (the yardstick; the port never calls
    SDPA).
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

18b. mesh — ROADMAP item 12's DAEF part, after phase 19 (~20 s).  (a) One
    rank in process: phase 7's 64-tenant fleet under
    ``ExecutionPlan(mode="mesh")`` (a one-rank mesh, no process group) bit
    for bit the vmap plan's for fit (B4 4), the chunked fit (B6 16),
    ``fit_stream`` (B6 16; logistic output: B5 4), ``partial_fit`` (B4 4,
    written into the shard's own leaves), scores and thresholds; the tree
    reduce 64 -> 32, 16, 1 (no launch) held to the engine's sequential and
    pairwise reduces by phase 7's rules (each tenant's (G, M) and error
    pool at 1e-4, the encoder's S and U S² Uᵀ at 1e-4, [W; b] at the κ
    bar); the sync tree round over phase 6's creditcard cut to 255,880
    samples in four quarters (B4 4; its statistics the sum of its local
    fits' at 1e-4, its model the pairwise merge of its local fits by phase
    7's rules; its test scores' distance from the float64 fit of the cut
    data reported), the async tree refresh (4 sites, then 3 fresh: a
    masked slot) against the sequential session at 1e-4, the secagg tree
    round (its wire sum the sequential sum bit for bit, its model the
    pairwise secagg round's).  (b) A one-rank NCCL group (``FileStore`` in
    a temporary directory): the data-mesh creditcard fit, gram (B1 4), svd
    with local SVDs and svd with ``gram_eigh`` (B1 4), each held to
    ``daef.fit`` of its method (the encoder's Gram and the first decoder
    layer's (G, M) at 1e-4) and its test scores to the float64 fit of its
    route by phase 6's rule (gram and local SVDs: the float64 fit of the
    cut data; ``gram_eigh``: the same plan on the host in float64, its
    plain distance that of the same plan on the host in float32), timed
    beside ``daef.fit``; ``fit_head(mesh=)`` on 2,048 seeded rows at
    qwen3-1.7b's width (B1 1 on its tensor-core route), its statistics the
    one-device head's at 1e-4.  (c) Four gloo ranks sharing the card
    (``python3 chip_smoke.py --mesh-rank R DIR``, one process each, the
    built kernels loaded): the tenant-sharded fleet fit (16 tenants and B4
    4 a rank) bit for bit the one-process fits of the ranks' shards, the
    tree reduce 64 -> 16 (local rounds) and 64 -> 1 (two cross rounds)
    held to one process by phase 7's rules, the data-sharded creditcard
    fit over 4 x 63,970 samples (B1 4 a rank) held to the float64 fit;
    what every rank holds alike is the same bits on every rank; then
    meshes over some of the ranks in the same launch: six
    tenants on the automatic tenant mesh of three ranks (rank 3 idle, its
    fit and reduce None; B4 4 a working rank), the fit and a tree reduce
    by twos per tenant against the one-process vmap plan's (bit for bit,
    or phase 7's fleet bar and the gap), and a data mesh over two ranks
    (``mesh_devices=2``; ranks 2 and 3 idle; B1 4 a working rank), its
    test scores held to the float64 fit.  NCCL across several cards is not
    checked: the machine has one.

analysis (after phase 20) — ``repro_torch.analysis``'s guard
    on the card.  The retrace self-check's serve (four tenants of a
    (6, 3, 6) net, ``tile_width=8``): warmup captures one CUDA graph per
    tile shape, the mixed ragged serve after it captures and loads nothing;
    phase 20's AE fits each capture their step once; a chunked fleet fit of
    two creditcard tenants (B6) loads as many kernel libraries at chunk 32
    as at chunk 16 (cold, after ``_build.clear_loaded``) and none warm; the
    donation self-check's two reports (the serving tile, the streaming
    fold) read effective.  An ``{"analysis": ...}`` line precedes
    ``{"lm_mesh": ...}``.

lm-mesh (after the mesh phase) — ROADMAP item 12's model-zoo part, the
    2-D (data, model) LM training layout of every family.  (a) B7 and
    B8 with ``q_offset`` at qwen2-1.5b's sequence-parallel stripes (q [2,
    512, 12, 128] against k and v [2, 2,048, 2, 128]) at offsets 0, 512,
    1,024 and 1,536, bf16 and float32, against their plain versions (B7
    per element within one bf16 ulp, float32 1e-5; B8 per element to its
    term magnitudes), timed (CUDA events, median of 25) beside the plain
    versions, SDPA on the same stripe and the bound of the stripe's own
    pairs.  (b) qwen3-1.7b at full width, float32, 14 of its 28 layers
    (cut for the script's time), on four gloo ranks sharing the card
    (``python3 chip_smoke.py --lm-mesh-rank R ROOT``, four processes
    started once for (b), (c) and (e)) at data 2 x model 2
    (head-parallel; FSDP on the stacked layer leaves): two AdamW steps of
    4 x 1,024 tokens held to one process on the card at the same inputs (the witness, run first): the loss at ``TOLS``, and per
    leaf each rank's slices of the step-1 gradients and of the parameters
    and moments after step 2 within 1e-4 of the witness leaf's largest
    entry (the witness's tensors shared with the ranks by CUDA IPC, its
    gradients freed once the ranks have held theirs); B7 56 and B8 28 a
    rank.  Step ms and the share of it in staged gloo exchanges.  (c)
    qwen2-1.5b at full width, 14 of its 28 layers, data 1 x model 4 (its
    2 KV heads and group of 6 do not divide 4: the sequence-parallel
    route, B7 and B8 with ``q_offset``), one step of 2 x 1,024, the same
    checks.  (e) One case
    of each other family at full width, float32, cut in depth, the same
    checks with the MoE dispatch masks of a forward held to the witness's
    bit for bit first and the launches of B7/B8, B9/B9ᵇ and B10/B10ᵇ a
    rank counted (``_loss_launches``): internvl2-2b at 6 of 24 layers,
    data 2 x model 2, 4 x (256 patches + 512 tokens), the witness in two
    microbatches; qwen2-moe-a2.7b at 2 of 24 layers, 1 x 4 (15 experts a
    rank), 2 x 1,024; deepseek-v2-236b cut to its dense layer and one MoE
    layer, 1 x 4 (40 experts and 32 MLA heads a rank), 1 x 1,024, one loss
    and its gradients only (AdamW's float32 moments of its 5.4e9
    parameters would not fit beside the witness); mamba2-780m at 8 of 48
    layers (at 24, regrouping the batch alone moves its float32 gradients
    past the bar: ``scripts/torch_grad_rounding.py``), 2 x 2, 4 x 1,024,
    the witness in two microbatches;
    recurrentgemma-9b cut to one (rec, rec, attn) period, 1 x 4, 2 x 1,024;
    whisper-tiny whole at 1 x 2 (two ranks) and 1 x 4 (its 6 heads do not
    split over 4: the sequence-parallel self-attentions, B7/B8 with
    ``q_offset`` and, in the encoder, without the causal mask), 4 x 448
    after 1,500 frames.  Each prints its step time, the share of it in
    staged exchanges and the peak a rank (since just before the step)
    beside the card's name and power limit.  (d)
    ``launch/train.py --model-parallel 2`` on one card exits naming the
    card count.  A ``{"lm_mesh": ...}`` line precedes ``{"mesh": ...}``;
    B7's and B8's kernels rows gain ``"q_offset"``.  NCCL across several
    cards is not checked: the machine has one.

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

20. comparison — the paper's Tables 2 and 3 on one fold, and the training
    CLI.  ``stats_backend.resolve("auto", "cuda")`` must equal the committed
    autotune cache's ``"cuda"`` verdict; the einsum-vs-fused verdict is
    re-measured beside it (``stats_verdict``; a timing difference does not
    fail).  On each of the seven replicas at the reference benchmark's scales
    (covertype and creditcard 0.1, the rest 1.0; fold 0): DAEF with Table
    5's layer sizes, lambdas and rule (``DAEF_ARCH``; the ``xavier`` init,
    no grid search), ``n_partitions=4`` and ``stats_backend`` left unset,
    timed after a warm-up fit by the host clock ending in a synchronize
    (the numpy training split uploaded inside, as the reference's benchmark
    times it), B1 one launch a hidden decoder layer; the iterative AE
    (``AE_ARCH``: Table 5's layer sizes and epochs, batch 128, seed 0) on its
    graphed step, its training loss lower after training than at init.
    Per dataset: both F1, DAEF ms, AE s, their ratio, the AE's µs a step
    graphed and eager (CUDA events over 200 steps of a fresh trainer).  On
    creditcard the fit is held to the port's host fits by phase 6's rule
    (labels within twice the plain fits' own distance + 4), 10 eager AE
    steps on the card to the host's (1e-4 of each leaf's max), and 200
    graph replays are profiled; on ionosphere the graphed AE fit must equal
    the eager one bit for bit.  Then ``launch/train.py --arch qwen3-1.7b
    --steps 6 --batch 4 --seq 2048 --microbatches 2 --dtype bfloat16`` in
    this process (B7 112 and B8 56 launches a step, all on the tensor-core
    route; finite losses, its ``s/step`` and ``loss a -> b`` lines).

21. decode — the serve CLI's LM mode and the backbones' decode (plain
    PyTorch, as the reference's is plain XLA) at full width in float32.
    (a) ``python -m repro_torch.launch.serve --arch A`` for qwen3-1.7b,
    mamba2-780m and recurrentgemma-9b (37.6 GB of float32 weights), three
    processes started together, each ending in ``serve OK`` (finite
    logits).  Then per model in this process, each freed before the next:
    (b) 2 x 64 seeded tokens teacher-forced through ``bundle.decode``, the
    last logits against ``bundle.prefill`` of the same tokens (B7 on its
    FP32 kernel, B9, B10: their launches counted; decode launches none) at
    the reference's bar, atol 2e-3 + rtol 1e-2 (tests/test_models.py
    ``test_decode_consistent_with_forward``); (c) the rings: qwen3 under
    ``sliding_window=16`` and recurrentgemma cut to one period and its
    two-block tail under ``local_window=16``, 2 x 48 tokens, the same bar
    (B7 windowed); (d) the model cut to two layers (one period), 16 decode
    steps on the card against the host, each step's logits within 1e-4 of
    their largest entry; decode ms/token and tokens/s at B = 4 through
    ``serve.generate`` (32 prompt tokens, 16 generated, after a warm-up),
    and a profile of 10 decode steps (busy share, top device ops).

22. the VLM and MoE families — internvl2-2b, qwen2-moe-a2.7b and
    deepseek-v2-236b (MLA) at full width, seeded random weights.  (e) first,
    while this process holds no model: ``python -m repro_torch.launch.serve
    --arch A`` for internvl2-2b and qwen2-moe-a2.7b in float32 (57 GB for
    qwen2-moe), two processes started together, each ending in ``serve
    OK``; their decode ms/token at B = 4.  (a) B7 at MLA's head sizes, q/k
    192 and v 128, 128 heads, causal: 1 x 4,096 in bf16 (the ``"wgmma"``
    route) and float32 (``"tf32x3"``), ragged S = 1,000 in both, against the
    plain version under phase 9's bars, each repeat bit-identical; timed
    (CUDA events, median of 25) beside its bound (2·(192 + 128) FLOP per
    (query, key) pair of the causal band at 989 TFLOP/s) and SDPA where
    SDPA takes the shapes; ptxas's registers and spills of the (192, 128)
    instantiations.  Then per model, each freed before the next: (d) full
    width in float32 (deepseek-v2 at its cut below), 2 x 64 seeded tokens
    teacher-forced through ``bundle.decode`` against the prefill (the VLM's
    text-only prefill: its decode is the decoder's) at the reference's bar,
    the MoE models with ``capacity_factor=16`` (the reference's
    tests/test_models.py: capacity routing drops otherwise one token at a
    time), deepseek-v2 with 160 / 6 (at 16 its prefill still drops); (b) cut in depth (internvl2 and qwen2-moe to 2 layers, all 60
    experts; deepseek-v2 to its dense layer and one MoE layer, 160
    experts, MLA at full width), float32, 1 x 256 tokens (internvl2 after
    its 256-patch prefix): every MoE layer's dispatch tensor card against
    host first (equal, or a differing choice whose two deciding
    probabilities lie within 1e-6, which reruns the model with the next
    seed), then the hidden states within 1e-4 of max|h|; (c) bf16 prefill
    after a warm-up: internvl2 full depth 4 x (256 patches + 3,840 tokens),
    qwen2-moe full depth 4 x 4,096, deepseek-v2 at its dense layer and 5
    MoE layers (42 GB; 7 would put the initialiser's float32 draw of an
    expert stack past the card) 1 x 4,096 with B7 at (192, 128) once a
    layer; every B7 launch on ``"wgmma"``, logits finite, tokens/s, and a
    profile of the qwen2-moe prefill split into B7, the expert einsums, the
    dispatch and combine einsums and the rest; (f) the DAEF head on
    qwen2-moe in bf16: ``pooled_features`` of 1,024 sequences of 256 tokens
    -> ``fit_head`` (fused: B1 once, its 3xTF32 route) -> ``flag`` on 256
    normal and 256 uniform-random OOD sequences, the card's flags within 8
    of 512 of the same head fitted on the host from the same features.

23. the encoder-decoder and the training of the VLM, MoE and
    encoder-decoder families.  First the serve CLI's LM mode for
    whisper-tiny (``--arch whisper-tiny``, float32, its frames
    ``jax.random.normal(PRNGKey(2), ...)``'s bits) ending in ``serve OK``.
    (a) B7 with ``causal=False`` at whisper-tiny's encoder shape (16 x
    1,500, 6 heads of 64) and a ragged S = 1,000, bf16 (``"wgmma"``) and
    float32 (``"tf32x3"``), against the plain version under phase 9's bars,
    each repeat bit-identical; the encoder shape timed beside its bound
    (2·128 FLOP a pair of the full square) and SDPA.  (b) B8 with
    ``causal=False`` at the encoder's training shape (a microbatch of (e),
    8 x 1,500) and B8 at MLA's (192, 128)
    (2 x 2,048 and a ragged 1 x 1,000, 128 heads, causal), both routes,
    against the plain version per element (phase 14's bars), each repeat
    bit-identical; timed beside the bound (2·(3·192 + 2·128) FLOP a pair
    of the band) and SDPA's backward; ptxas's registers and spills of the
    (192, 128) instantiations.  (c) whisper-tiny at full width and depth,
    float32, 2 x (1,500 frames + 64 tokens): the encoder states and the
    prefill's logits card against host (1e-4 of max), the tokens
    teacher-forced through ``bundle.decode`` from ``encdec.init_cache``
    against the prefill at the reference's bar (B7 12 launches on
    ``"tf32x3"``, decode none); a bf16 prefill of 16 x (1,500 frames + 448
    tokens) after a warm-up (B7 8, all ``"wgmma"``), decoder tokens/s and
    frames/s.  (d) ``bundle.loss`` and every gradient leaf, float32, card
    (B7 twice and B8 once an attention layer, ``"tf32x3"``) against host,
    each leaf within 1e-4 of its largest entry, the loss within 1e-5 of
    itself: whisper-tiny uncut (1 x (1,500 frames + 64 tokens)),
    internvl2-2b (after its 256 patches) and qwen2-moe-a2.7b cut to 2
    layers, deepseek-v2-236b cut to its dense layer and one MoE layer of
    160 experts (B8 at (192, 128)), 1 x 256 tokens; the MoE models'
    dispatch compared first (a near tie reruns with the next seed).  (e)
    10 bf16 train steps (AdamW under the launcher's schedule, 2
    microbatches, remat, clip 1.0): whisper-tiny 16 x (1,500 frames + 448
    tokens), internvl2-2b at full depth 4 x (256 patches + 1,792 tokens),
    qwen2-moe-a2.7b cut to 4 layers and deepseek-v2-236b cut to its dense
    layer (~1.4e9 parameters: one MoE layer adds 3.97e9), 4 x 2,048: finite
    losses and gradient norms, step 0 within 1.0 of ln V, every gradient
    leaf and layer nonzero, the loss on step 0's batch lower after the
    steps, every B7 and B8 launch on ``"wgmma"``; step time, positions/s
    and peak memory; then ``launch/train.py --arch whisper-tiny`` (3 bf16
    steps of 4 x 448 tokens) in process.
24. the training of the SSM and hybrid families.  (a) B10's backward
    (``ssd_chunk_bwd``: 3xTF32 wgmma, C·Bᵀ once per group, nine launches)
    against ``ssd_chunk_bwd_plain`` at mamba2-780m's microbatch (2 x 2,048,
    48 heads of P 64, N 128, G 1, chunk 256) and at G = 2 with a ragged S
    (1,000, chunk 250), both with a nonzero h_final cotangent, at S = 1 and
    B = 0, and at the microbatch with mamba2's initial decays (cum reaches
    -10³ within a chunk), and a P of 65 refused; the microbatch split into
    its launches by the profiler; B9's backward (``rglru_scan_bwd``: chain
    warps and worker warps over a staged ring) against ``rglru_scan_bwd_plain`` at
    recurrentgemma-9b's microbatch (2 x 2,048 x 4,096) with bf16 x and
    float32 gates and all in float32, at a ragged S = 37 (W = 100, bf16)
    and S = 1, all with a nonzero h_last cotangent.  dxdt, dB, dC, dx, dr,
    di to ``max|d| <= 1e-4 * max|plain|`` (bf16 outputs also one bf16 ulp
    of the element); dla and dlam, whose sums cancel, per element to 1e-5
    of their term magnitudes (``ref.*_bwd_magnitudes``); each repeat
    bit-identical; the microbatches timed beside the plain versions and the
    bounds (no one-call PyTorch yardstick).  (b) ``bundle.loss`` and every
    gradient leaf, float32, 1 x 512 tokens, card (``_loss_launches``: B10
    twice and its backward once a layer; B9 and B7 twice and their
    backwards once a period's block, once the tail's) against host, each
    leaf within 1e-4 of its largest entry: mamba2-780m cut to 2 layers and
    recurrentgemma-9b to one period.  (c) 10 bf16 train steps (AdamW under
    the launcher's schedule, 2 microbatches, remat, clip 1.0) of 4 x 2,048
    tokens: mamba2-780m at full width and depth (48 layers) and
    recurrentgemma-9b cut to one period and its 2-block tail (5 layers,
    ~2.2e9 parameters): finite losses and gradient norms, mamba2's step 0
    within 1.0 of ln V (recurrentgemma's untrained model echoes its input
    token through the tied, sqrt(d)-scaled embedding: ~60), every gradient
    leaf and layer nonzero, the loss on step 0's
    batch lower after the steps, every B9 backward launch on bf16 x; step
    time, tokens/s, peak memory, launches a step, and one more step under
    the profiler (device time of B10, B10's backward, B9, B9's backward,
    B7, B8 and cuBLAS).  (d) ``launch/train.py --arch mamba2-780m`` (3 bf16
    steps of 4 x 2,048 tokens) in process.
25. the registry's last two dense architectures at its shapes (after phase
    22): granite-20b (52 layers, d_model 6,144, 48 query heads over one KV
    head; 28.17e9 parameters with the config's defaults, SwiGLU and an
    untied head) and mistral-nemo-12b (40 layers, query width 32 x 128 =
    4,096 of d_model 5,120, vocab 131,072, RoPE theta 1e6), seeded random
    weights.  (f) first, while this process holds no model: ``python -m
    repro_torch.launch.serve --arch mistral-nemo-12b`` in float32 (49.0 GB;
    granite's 112.7 GB do not fit, its CLI runs ``--reduced`` on the host).
    (a) B7 at 1 x 32,768 (prefill_32k's length) with each model's heads,
    bf16 and float32, against the plain version on the last 1,024 query rows
    of two query heads through ``q_offset`` (one bf16 ulp an element;
    float32 1e-4 of max|plain|), each repeat bit-identical; bf16 timed
    (median of 5) beside its bound (13.34 and 8.89 ms), SDPA with k and v
    expanded to the query heads, and the plain version on the stripe; B8 at
    granite's group of 48, 2 x 4,096, both routes, per element against its
    plain version (phase 14's bars), bf16 timed, both split by the profiler
    into the dq and the dk/dv kernel beside their block counts.  Then per
    model: (d) mistral's decode against its prefill at full width in float32
    (2 x 64 tokens, the reference's bar); (b) the model cut to 2 layers,
    full width, float32: the forward and the last-token logits of 2 x 256
    tokens card against host (1e-4 of max), granite's decode against its
    prefill, 8 decode steps at positions 32,760-32,767 and at
    524,280-524,287 (long_500k's sliding-window variant, a ring of 4,096
    slots) from one seeded cache on card and host (1e-4 of max|logits|), the
    ring filled with the k and v of the windowed prefill of 4,096 tokens,
    then 64 decode steps past its last slot against the windowed prefill (B7
    ``window=4096``) of all 4,160 at the reference's bar, and the loss and
    every gradient leaf of 1 x 256 tokens card against host (phase 23's
    bars); (c) prefill_32k in bf16 at full width and depth, its batch of 32
    cut to 1: one prefill, traced on the device only (B7 against cuBLAS's
    GEMMs against the rest), B7 once a layer on ``"wgmma"``, tokens/s,
    finite logits, peak memory; (d) bf16 decode at full width from caches
    filled from a seed: decode_32k (a 32,768-slot cache, its batch of 128
    cut to 8 for granite and 4 for mistral) and long_500k (B = 1,
    ``init_cache(1, 524,288)`` holding the window's 4,096 slots), 8 steps at
    each shape's last positions, ms/token; (e) 4 bf16 train steps of the
    model cut to 2 layers, 4 x 4,096 tokens (train_4k's length, its batch of
    256 cut to 4), as phase 23's but at lr 3e-5 (a first AdamW step at the
    launcher's 3e-4 moves a projection of 6,144 inputs by ~150 % of its
    scale): B7 8 and B8 4 a step, peak memory.  Each model's time and the
    phase's are printed.

The last lines are a JSON object of the mesh phase's numbers, a JSON
object of phase 24's numbers, a JSON object of
phase 23's numbers, a JSON object of phase 25's numbers, a JSON object of
phase 22's numbers, a JSON object of phase 21's numbers, a JSON object of
phase 20's numbers, a JSON object of the svd phase's numbers, a JSON object
of the engine phase's numbers, a JSON object of phase 19's numbers, a JSON
object of the LM paths' numbers, a JSON object of per-shape numbers, the
card's name and power limit, a JSON object of per-kernel numbers for all
ten kernels (B7's and B8's rows with their routes of phases 22, 23 and 25, B9's
and B10's with their backwards of phase 24), and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import math
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

# The paper's Table 5 per dataset, as the reference's Table 2 benchmark holds it
# (benchmarks/table2_f1.py:22-39, which imports jax; the CPU tests hold this
# copy to it): DAEF (layer sizes, lambda_HL, lambda_LL, threshold rule) and
# the iterative AE (layer sizes, epochs).
DAEF_ARCH = {
    "shuttle": ((9, 3, 5, 7, 9), 0.8, 0.9, "extreme_iqr"),
    "covertype": ((10, 2, 4, 6, 8, 10), 0.7, 0.1, "q90"),
    "pendigits": ((16, 8, 12, 16), 0.005, 0.7, "q90"),
    "cardio": ((21, 4, 8, 12, 16, 21), 0.9, 0.9, "q90"),
    "creditcard": ((29, 15, 18, 21, 24, 27, 29), 0.8, 0.9, "extreme_iqr"),
    "ionosphere": ((33, 8, 14, 33), 0.01, 0.8, "extreme_iqr"),
    "optdigit": ((62, 10, 20, 30, 40, 50, 62), 0.8, 0.9, "extreme_iqr"),
}
AE_ARCH = {
    "shuttle": ((9, 7, 5, 7, 9), 30),
    "covertype": ((10, 8, 6, 8, 10), 100),
    "pendigits": ((16, 12, 4, 12, 16), 100),
    "cardio": ((21, 12, 4, 12, 21), 100),
    "creditcard": ((29, 25, 20, 15, 20, 25, 29), 100),
    "ionosphere": ((33, 25, 20, 15, 20, 25, 33), 100),
    "optdigit": ((62, 50, 40, 30, 20, 30, 40, 50, 62), 50),
}


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


# Idle host seconds on each side of a profiled call, one entry an attempt:
# see ``_profile_padded``.
PROFILE_PADS_S = (0.0, 0.05, 0.2, 0.8, 3.2)


def _profile_padded(run, pad=0.0):
    """``run()`` under torch.profiler (host ops and device kernels), with
    ``pad`` idle host seconds before it and after its synchronize, outside
    the timed span.  The profiler keeps a device event only where its time,
    on the device's clock taken to the host's, lies inside the profile's
    window; on an H100 profiles of one call of a few ms now and then
    recorded no device event several times running, while a profile of a
    multi-second run taken just after recorded its kernels, so a retry
    widens the window.  Returns (the profiler, what ``run`` returns, the
    run's wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(pad)
    return prof, out, wall


def _device_time_key(averages):
    return ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
            else "self_cuda_time_total")


def _kernel_us(fn, patterns, attempts=len(PROFILE_PADS_S), required=True):
    """Device time (µs) of one ``fn()`` under torch.profiler, by kernel, for
    the kernels whose names hold one of ``patterns``: {name: (launches,
    µs)}.  A profile that recorded none of them is said and taken again
    with the next of ``PROFILE_PADS_S`` (``_profile_padded``), ``attempts``
    times in all; then it fails, or, if not ``required`` (a number only
    printed), returns {}."""
    import torch

    fn()
    torch.cuda.synchronize()
    for i, pad in enumerate(PROFILE_PADS_S[:attempts]):
        prof, _, _ = _profile_padded(fn, pad)
        averages = prof.key_averages()
        key = _device_time_key(averages)
        times = {_kernel_name(e.key): (e.count, getattr(e, key))
                 for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(p in e.key for p in patterns)}
        if times:
            return times
        say("profile", f"profile {i + 1} of one call (idle {pad:g} s on each side) recorded "
            f"no kernel named like {patterns}")
    check(not required, f"the profiler recorded no kernel named like {patterns} in "
          f"{attempts} profiles of one call")
    return {}


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


def _gram_form(model):
    """A model whose factor knowledge (``method="svd"``) is put in Gram form."""
    from repro_torch.core import rolann

    if hasattr(model.layer_knowledge[0], "u"):
        return model._replace(layer_knowledge=tuple(
            rolann.factors_to_stats(k) for k in model.layer_knowledge))
    return model


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
# 18b. the mesh paths: one rank, a one-rank NCCL group, four gloo ranks
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_SIX = 6                          # six tenants take three of the four ranks
MESH_SIX_SEEDS = (1, 1, 2, 2, 3, 3)   # tree groups of two share a seed
MESH_SAMPLES = 255_880   # creditcard cut so its samples divide over MESH_RANKS shards
MESH_TREE_GROUPS = (2, 4, 64)   # 64 -> 32, 16, 1
HEAD_ROWS, HEAD_WIDTH = 2_048, 2_048   # qwen3-1.7b's d_model
MESH_RANK_TIMEOUT_S = 300
DATA_MESH_FITS = (("gram", "gram_eigh"), ("svd", "local_svd"), ("svd", "gram_eigh"))


def _launch_counter():
    """(zero, read) over every DAEF kernel wrapper's launch counts."""
    wrappers = {**_wrappers(), **_fleet_wrappers()}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0
            if hasattr(fn, "route_launches"):
                fn.route_launches = dict.fromkeys(fn.route_launches, 0)

    def read():
        return {name: fn.launches for name, fn in wrappers.items() if fn.launches}

    return zero, read


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _same_leaves(a, b, what):
    import torch

    from repro_torch.train import checkpoint

    la, lb = checkpoint.flatten(a), checkpoint.flatten(b)
    check(len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y.to(x.device))
        for x, y in zip(la, lb)), f"{what}: not bit-identical leaf for leaf")


def _check_fleets_close(a, b, what) -> float:
    """Two fleets of the same tenants by phase 7's merged-site rules: seeds
    and lambdas equal; each tenant's (G, M) and error pool within 1e-4 of
    their max; the encoder's S and U S² Uᵀ within 1e-4; each decoder
    layer's [W; b] within 10·κ·eps·max|[W; b]| of its G + λI.  Returns the
    worst share of the κ bar."""
    import torch

    from repro_torch.core import fleet

    eps = float(torch.finfo(torch.float32).eps)
    check(a.size == b.size, f"{what}: {a.size} tenants against {b.size}")
    for name in ("seeds", "lam_hidden", "lam_last"):
        check(torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), f"{what}: {name}")
    worst = 0.0
    for s in range(a.size):
        ma, mb = fleet.get_model(a, s), fleet.get_model(b, s)
        for i, (ka, kb) in enumerate(zip(ma.layer_knowledge, mb.layer_knowledge, strict=True)):
            d = _stats_rel(ka, kb)
            check(d <= 1e-4, f"{what}: tenant {s} layer {i + 2} (G, M) {d:.3e} (bar 1e-4)")
        d = _rel(ma.train_errors.double(), mb.train_errors.double())
        check(d <= 1e-4, f"{what}: tenant {s} error pool {d:.3e} (bar 1e-4)")
        check(_rel(ma.encoder_factors.s, mb.encoder_factors.s) <= 1e-4, f"{what}: tenant {s} S")
        d = _rel(_enc_gram(ma.encoder_factors), _enc_gram(mb.encoder_factors))
        check(d <= 1e-4, f"{what}: tenant {s} encoder U S^2 U^T {d:.3e} (bar 1e-4)")
        lams = [float(a.lam_hidden[s])] * (len(ma.layer_knowledge) - 1) + [float(a.lam_last[s])]
        for i, (k, lam) in enumerate(zip(mb.layer_knowledge, lams)):
            g = k.g.double()
            kappa = float(torch.linalg.cond(
                g + lam * torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)).max())
            wa = torch.cat([ma.weights[i + 1], ma.biases[i][None]]).double()
            wb = torch.cat([mb.weights[i + 1], mb.biases[i][None]]).double()
            err, bar = float((wa - wb).abs().max()), 10 * kappa * eps * float(wb.abs().max())
            check(err <= bar, f"{what}: tenant {s} layer {i + 2} W, b differ by {err:.3e} > "
                  f"{bar:.3e}")
            worst = max(worst, err / bar)
    return worst


def _mesh_rank_work(rank: int, mesh_dir: str) -> dict:
    """One of MESH_RANKS gloo ranks sharing the card: the tenant-sharded
    fleet fit, the tree reduces 64 -> 16 and 64 -> 1, and the data-sharded
    creditcard fit.  Returns what the rank holds, as numpy."""
    import os

    import numpy as np
    import torch

    from repro_torch.core import daef, fleet_sharded
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.train import checkpoint

    def arr(name):
        return np.load(os.path.join(mesh_dir, name + ".npy"))

    xs, seeds, xq, xte = arr("xs"), arr("seeds"), arr("xq"), arr("xte")
    k = xs.shape[0]
    base = daef.DAEFConfig(**CREDITCARD)
    zero, read = _launch_counter()
    out: dict = {}

    def put(prefix, tree):
        for i, leaf in enumerate(checkpoint.flatten(tree)):
            out[f"{prefix}/leaf{i}"] = leaf.detach().cpu().numpy()

    def plan(**kw):
        return ExecutionPlan(stats_backend="fused", **kw)

    eng = DAEFEngine(base, plan(mode="mesh", tenants=k), device="cuda:0")
    mesh = eng.mesh
    check(mesh.shape == {"tenants": MESH_RANKS} and mesh.backend == "gloo",
          f"rank {rank}: mesh {mesh}")
    eng.fit(xs, seeds=seeds)
    zero()
    fl, out["fit_ms"] = _timed(lambda: eng.fit(xs, seeds=seeds))
    out["fit_b4"] = read().get("rolann_stats_batched", 0)
    put("fit", fleet_sharded.gather_fleet(fl, mesh))

    tree = DAEFEngine(base, plan(mode="mesh", tenants=k, merge="tree"), device="cuda:0")
    f0 = tree.fit(xs, seeds=np.zeros(k, np.int32))
    r16, out["reduce16_ms"] = _timed(lambda: tree.reduce(f0, 4))
    put("reduce16", fleet_sharded.gather_fleet(r16, mesh))
    r1, out["reduce1_ms"] = _timed(lambda: tree.reduce(f0, k))
    put("reduce1", r1)

    dmesh = mesh_lib.Mesh((MESH_RANKS,), ("data",), device="cuda:0")
    deng = DAEFEngine(base, plan(mode="mesh", mesh_axes=("data",)), mesh=dmesh)
    deng.fit(xq)
    zero()
    dm, out["data_fit_ms"] = _timed(lambda: deng.fit(xq))
    out["data_fit_b1"] = read().get("rolann_stats", 0)
    out["data_threshold"] = deng.thresholds(dm).cpu().numpy()
    put("data", dm._replace(train_errors=dm.train_errors[:0]))
    out["data_test_scores"] = daef.reconstruction_error(
        deng.config, dm, xte).cpu().numpy()

    # Meshes over some of the ranks; the others are idle and
    # their calls return None.  Six tenants: the automatic tenant mesh takes
    # three ranks (the reference's largest divisor that fits), rank 3 idles.
    six = DAEFEngine(base, plan(mode="mesh", tenants=MESH_SIX, merge="tree"), device="cuda:0")
    check(six.mesh.shape == {"tenants": 3} and six.idle == (rank == 3),
          f"rank {rank}: six-tenant mesh {six.mesh}")
    zero()
    f6, out["six_fit_ms"] = _timed(lambda: six.fit(
        xs[:MESH_SIX], seeds=np.array(MESH_SIX_SEEDS, np.int32)))
    out["six_fit_b4"] = read().get("rolann_stats_batched", 0)
    r6, out["six_reduce_ms"] = _timed(lambda: six.reduce(f6, 2))
    out["six_idle"] = np.array([f6 is None, r6 is None])
    if not six.idle:
        put("six/fit", fleet_sharded.gather_fleet(f6, six.mesh))
        put("six/reduce", fleet_sharded.gather_fleet(r6, six.mesh))
    # mesh_devices=2: a data mesh over ranks 0 and 1, ranks 2 and 3 idle
    sub = DAEFEngine(base, plan(mode="mesh", mesh_axes=("data",), mesh_devices=2),
                     device="cuda:0")
    check(sub.mesh.shape == {"data": 2} and sub.idle == (rank >= 2),
          f"rank {rank}: two-rank data mesh {sub.mesh}")
    zero()
    sm, out["sub_fit_ms"] = _timed(lambda: sub.fit(xq))
    out["sub_fit_b1"] = read().get("rolann_stats", 0)
    out["sub_idle"] = np.array([sm is None])
    if not sub.idle:
        put("sub", sm._replace(train_errors=sm.train_errors[:0]))
        out["sub_test_scores"] = daef.reconstruction_error(sub.config, sm, xte).cpu().numpy()
    return out


def mesh_rank(rank: int, mesh_dir: str) -> int:
    """``python chip_smoke.py --mesh-rank RANK DIR``: one gloo rank of the
    mesh phase's part (c), its group from a ``FileStore`` in DIR, writing
    DIR/rank{RANK}.npz."""
    import os

    import numpy as np
    import torch

    from repro_torch.launch import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh_lib.init_process_group_from_file(os.path.join(mesh_dir, "store"), rank, MESH_RANKS,
                                          backend="gloo", timeout_s=MESH_RANK_TIMEOUT_S)
    try:
        out = _mesh_rank_work(rank, mesh_dir)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(mesh_dir, f"rank{rank}.npz"), **out)
    return 0


def _check_sub_meshes(cfg, ranks, rebuild, xs_d, xq, x_test, s64, plain) -> dict:
    """Meshes over some of the ranks, on the four gloo ranks sharing the
    card.  Six tenants on the automatic tenant mesh of three ranks (rank 3
    idle): the fit and a tree reduce by twos, per tenant against the
    one-process vmap plan's (bit for bit, else phase 7's fleet bar and the
    gap); a data mesh over two ranks (2 and 3 idle): test scores against the
    float64 fit (phase 6's rule) and against the four-rank data mesh's."""
    import torch

    from repro_torch.core import daef, fleet, fleet_sharded
    from repro_torch.train import checkpoint

    out = {}
    idle = [r["six_idle"].tolist() + r["sub_idle"].tolist() for r in ranks]
    check(idle == [[r == 3, r == 3, r >= 2] for r in range(MESH_RANKS)],
          f"sub-meshes: the idle ranks' returns (None: True): {idle}")
    seeds6 = torch.as_tensor(MESH_SIX_SEEDS, dtype=torch.int32, device="cuda")
    v6 = fleet._fit_fleet(cfg, xs_d[:MESH_SIX], seeds=seeds6)
    want = {"fit": v6, "reduce": fleet_sharded.fleet_merge_tree(cfg, v6, 2)}
    for name, w in want.items():
        got = rebuild(ranks[0], f"six/{name}", w)
        bits = all(torch.equal(a.cuda(), b) for a, b in zip(
            checkpoint.flatten(got), checkpoint.flatten(w), strict=True))
        share = _check_fleets_close(got, w, f"sub-mesh: six tenants on three gloo ranks, {name} vs "
                                    "the one-process vmap plan")
        gap = max(float((a.cuda().double() - b.double()).abs().max())
                  for a, b in zip(checkpoint.flatten(got), checkpoint.flatten(w), strict=True))
        out[f"six tenants {name}"] = {"bit_for_bit": bits, "max_abs_gap": gap,
                                      "kappa_share": share}
    # the same six tenants fitted as the ranks fit them, two a process
    by_rank = [fleet._fit_fleet(cfg, xs_d[2 * r:2 * r + 2], seeds=seeds6[2 * r:2 * r + 2])
               for r in range(3)]
    _same_leaves(rebuild(ranks[0], "six/fit", v6), checkpoint.unflatten(by_rank[0], [
        torch.cat(leaves) for leaves in zip(*(checkpoint.flatten(f) for f in by_rank))]),
        "sub-mesh: six tenants on three gloo ranks vs one process fitting their shards")
    out["six tenants b4 per rank"] = [int(r["six_fit_b4"]) for r in ranks]
    check(out["six tenants b4 per rank"] == [len(path_shapes(cfg))] * 3 + [0],
          f"sub-mesh: B4 launches per rank {out['six tenants b4 per rank']}")
    sub = torch.from_numpy(ranks[0]["sub_test_scores"]).double()
    d = _rel(sub, s64)
    check(d <= 2 * plain + 1e-4, f"sub-mesh: the two-rank data mesh's test scores {d:.3e} from the "
          f"float64 fit, bar 2 x {plain:.3e} + 1e-4")
    out["two-rank data mesh test scores from float64"] = d
    out["two-rank data mesh vs four-rank, test scores"] = _rel(
        sub, torch.from_numpy(ranks[0]["data_test_scores"]).double())
    out["two-rank data mesh vs daef.fit, test scores"] = _rel(sub, daef.reconstruction_error(
        cfg, daef.fit(cfg, xq), x_test).double().cpu())
    out["two-rank data mesh b1 per rank"] = [int(r["sub_fit_b1"]) for r in ranks]
    check(out["two-rank data mesh b1 per rank"] == [len(path_shapes(cfg))] * 2 + [0, 0],
          f"sub-mesh: B1 launches per rank {out['two-rank data mesh b1 per rank']}")
    out["ms per rank"] = {name: [float(r[name]) for r in ranks]
                          for name in ("six_fit_ms", "six_reduce_ms", "sub_fit_ms")}
    say("mesh", "meshes over some of the ranks: six tenants on three of the four gloo "
        "ranks (rank 3 idle, its fit and reduce None): fit "
        + ("bit for bit" if out["six tenants fit"]["bit_for_bit"] else
           f"{out['six tenants fit']['max_abs_gap']:.2e} max |gap|, kappa share "
           f"{out['six tenants fit']['kappa_share']:.3f}")
        + " the one-process vmap plan's (bit for bit the ranks' shards fitted alone), tree "
        "reduce by twos " + ("bit for bit" if out["six tenants reduce"]["bit_for_bit"] else
                             f"{out['six tenants reduce']['max_abs_gap']:.2e} max |gap|, kappa "
                             f"share {out['six tenants reduce']['kappa_share']:.3f}")
        + f"; B4 per rank {out['six tenants b4 per rank']}; a data mesh over two ranks "
        f"(ranks 2, 3 idle): test scores {d:.2e} from the float64 fit (bar "
        f"{2 * plain + 1e-4:.2e}), {out['two-rank data mesh vs four-rank, test scores']:.2e} "
        f"from the four-rank mesh's, {out['two-rank data mesh vs daef.fit, test scores']:.2e} "
        f"from daef.fit's; B1 per rank {out['two-rank data mesh b1 per rank']}; ms per rank "
        f"{out['ms per rank']}")
    return out


def phase_mesh(cfg, x_train, x_test, xte, references, fleet_data, fleet_data_d) -> dict:
    """ROADMAP item 12's DAEF part on the card.  (a) One rank in process:
    the 64-tenant fleet cell under ``mode="mesh"`` bit for bit the vmap
    plan's (fit, chunked fit, fit_stream, partial_fit, scores), the tree
    reduces 64 -> 32, 16, 1 against the sequential and pairwise ones (phase
    7's rules), the sync / async / secagg tree rounds over the creditcard
    quarters.  (b) A one-rank NCCL group: the data-mesh creditcard fit
    (gram, svd) held to the float64 fit (phase 6's rule) and timed against
    ``daef.fit``, and the DAEF head on a data mesh at qwen3-1.7b's width
    (B1's tensor-core route).  (c) Four gloo ranks sharing the card, one
    process each: the tenant-sharded fleet fit, reduce 64 -> 16 and
    64 -> 1, the data-sharded creditcard fit, held to (a) and to the
    float64 fit.  Returns the phase's numbers."""
    import dataclasses as dc
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import daef, federated, fleet
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.kernels.rolann_stats import rolann_stats
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import daef_head
    from repro_torch.privacy import PrivacySpec, secagg
    from repro_torch.train import checkpoint

    t_phase = time.perf_counter()
    base = daef.DAEFConfig(**CREDITCARD)
    zero, read = _launch_counter()
    xs, seeds_f, _, _ = fleet_data
    xs_d, tests_d = fleet_data_d
    k, _, n_tenant = xs.shape
    n_hidden = len(path_shapes(cfg))
    times, launches, out = {}, {}, {}
    plain = references["test scores"][1]   # the float32 fits' distance, phase 6

    def engine(device=None, **plan):
        return DAEFEngine(base, ExecutionPlan(stats_backend="fused", **plan), device=device)

    def run(name, fn):
        """One warm call, then the timed one with the counts set to 0."""
        fn()
        zero()
        res, times[name] = _timed(fn)
        launches[name] = read()
        return res

    # ---- (a) one rank, in process: the mesh plan is the vmap plan ----
    vm, me = engine(mode="vmap", tenants=k), engine(mode="mesh", tenants=k)
    check(me.mesh.shape == {"tenants": 1} and me.mesh.device_mesh is None
          and me.device == torch.device("cuda", 0), f"one-rank mesh {me.mesh}")
    fv = vm.fit(xs_d, seeds=seeds_f)
    fm = run("mesh fit", lambda: me.fit(xs_d, seeds=seeds_f))
    _same_leaves(fv, fm, "mesh fit vs vmap fit")
    check(launches["mesh fit"] == {"rolann_stats_batched": n_hidden},
          f"mesh fit launched {launches['mesh fit']}")
    tests64 = tests_d.repeat_interleave(2, dim=0)   # each site's test split, both its devices
    sm = run("mesh scores", lambda: me.scores(fm, tests64))
    check(torch.equal(sm, vm.scores(fv, tests64))
          and torch.equal(me.thresholds(fm), vm.thresholds(fv)), "mesh scores / thresholds")
    vc = engine(mode="vmap", tenants=k, chunk_samples=FLEET_CHUNK)
    mc = engine(mode="mesh", tenants=k, chunk_samples=FLEET_CHUNK)
    _same_leaves(vc.fit(xs_d, seeds=seeds_f),
                 run("mesh chunked fit", lambda: mc.fit(xs_d, seeds=seeds_f)),
                 "mesh chunked fit vs vmap")

    def chunks():
        return (xs[:, :, i:i + FLEET_CHUNK] for i in range(0, n_tenant, FLEET_CHUNK))

    _same_leaves(vm.fit_stream(chunks, seeds=seeds_f),
                 run("mesh fit_stream", lambda: me.fit_stream(chunks, seeds=seeds_f)),
                 "mesh fit_stream vs vmap")
    lo, hi = xs.min(axis=2, keepdims=True), xs.max(axis=2, keepdims=True)
    x01 = (xs - lo) / np.where(hi > lo, hi - lo, 1.0)   # B5's path, as phase 7's
    log_v = DAEFEngine(dc.replace(base, act_last="logsig"),
                       ExecutionPlan(stats_backend="fused", mode="vmap", tenants=k))
    log_m = DAEFEngine(dc.replace(base, act_last="logsig"),
                       ExecutionPlan(stats_backend="fused", mode="mesh", tenants=k))

    def chunks01():
        return (x01[:, :, i:i + FLEET_CHUNK] for i in range(0, n_tenant, FLEET_CHUNK))

    _same_leaves(log_v.fit_stream(chunks01, seeds=seeds_f),
                 run("mesh fit_stream logsig", lambda: log_m.fit_stream(chunks01, seeds=seeds_f)),
                 "logsig-output mesh fit_stream vs vmap")
    x_new = xs_d[..., :SERVE_NEW_BLOCK]
    upd_v = vm.partial_fit(fv, x_new)
    me.partial_fit(checkpoint.map_leaves(lambda t: t.clone(), fm), x_new)
    fm2 = checkpoint.map_leaves(lambda t: t.clone(), fm)
    zero()
    upd_m, times["mesh partial_fit"] = _timed(lambda: me.partial_fit(fm2, x_new))
    launches["mesh partial_fit"] = read()
    _same_leaves(upd_v, upd_m, "mesh partial_fit vs vmap")
    check(upd_m.model.weights[0] is fm2.model.weights[0], "partial_fit did not donate")
    say("mesh", f"one rank, {k} tenants: mode='mesh' bit-identical to the vmap plan for fit "
        f"({times['mesh fit']:.2f} ms), chunked fit ({times['mesh chunked fit']:.2f} ms), "
        f"fit_stream ({times['mesh fit_stream']:.2f} ms; logsig output "
        f"{times['mesh fit_stream logsig']:.2f} ms), partial_fit (donating, "
        f"{times['mesh partial_fit']:.2f} ms), scores ({times['mesh scores']:.2f} ms) and "
        "thresholds; launches " + ", ".join(f"{n} {launches[n]}" for n in (
            "mesh fit", "mesh chunked fit", "mesh fit_stream", "mesh fit_stream logsig",
            "mesh partial_fit")))

    # tree reduce 64 -> 32, 16, 1 against the sequential and pairwise ones
    tree = engine(mode="mesh", tenants=k, merge="tree")
    f0 = tree.fit(xs_d, seeds=np.zeros(k, np.int32))
    one_rank = {}
    for g in MESH_TREE_GROUPS:
        got = run(f"tree reduce {k} -> {k // g}", lambda g=g: tree.reduce(f0, g))
        one_rank[g] = got
        for merge in ("sequential", "pairwise"):
            other, times[f"{merge} reduce {k} -> {k // g}"] = _timed(
                lambda m=merge, g=g: engine(mode="vmap", tenants=k, merge=m).reduce(f0, g))
            out[f"tree {k}->{k // g} vs {merge}, kappa share"] = _check_fleets_close(
                got, other, f"tree reduce {k} -> {k // g} vs {merge}")
    say("mesh", "tree reduce (one rank): " + ", ".join(
        f"{k} -> {k // g} {times[f'tree reduce {k} -> {k // g}']:.2f} ms (sequential "
        f"{times[f'sequential reduce {k} -> {k // g}']:.2f}, pairwise "
        f"{times[f'pairwise reduce {k} -> {k // g}']:.2f})" for g in MESH_TREE_GROUPS)
        + "; against both by phase 7's rules, worst kappa share "
        + f"{max(v for n, v in out.items() if 'kappa' in n):.3f}")

    # the sync, async and secagg tree rounds over the creditcard quarters
    xq = np.ascontiguousarray(x_train[:, :MESH_SAMPLES])
    xq_d = torch.as_tensor(xq, device="cuda")
    q = MESH_SAMPLES // MESH_RANKS
    parts = [xq_d[:, i * q:(i + 1) * q] for i in range(MESH_RANKS)]
    sync = engine(merge="tree")
    m_tree = run("sync tree round", lambda: sync.session().round(parts))
    check(launches["sync tree round"] == {"rolann_stats_batched": n_hidden},
          f"sync tree round launched {launches['sync tree round']}")
    local = fleet._fit_fleet(cfg, torch.stack(parts))
    apart_l, apart_e = _model_stats_apart(
        m_tree, *_summed_stats([fleet.get_model(local, i) for i in range(MESH_RANKS)]))
    check(max(apart_l + [apart_e]) <= 1e-4, f"sync tree round vs the sum of its local fits: "
          f"layers {apart_l}, encoder {apart_e} (bar 1e-4)")
    # the float64 fit of the cut data: the reference of every fit here
    host_cfg = dc.replace(cfg, stats_backend="einsum")
    m64 = daef.fit(host_cfg, torch.from_numpy(xq).double(), n_partitions=N_PARTITIONS,
                   device="cpu")
    s64 = daef.reconstruction_error(host_cfg, m64, torch.from_numpy(x_test).double(),
                                    device="cpu")
    # the broker protocol: each node's decoder statistics come from its own
    # encoder, so the round approximates the centralised fit (reported); it
    # is held to the pairwise merge of its own local fits
    loc = [fleet.get_model(local, i) for i in range(MESH_RANKS)]
    m_pairs = daef.merge_models(cfg, daef.merge_models(cfg, loc[0], loc[1]),
                                daef.merge_models(cfg, loc[2], loc[3]))
    out["sync tree vs pairwise merge, kappa share"] = _check_fleets_close(
        fleet.fleet_from_models(cfg, [m_tree]), fleet.fleet_from_models(cfg, [m_pairs]),
        "sync tree round vs the pairwise merge of its local fits")
    d_tree = _rel(sync.scores(m_tree, xte).double().cpu(), s64)
    out["sync tree statistics vs local sums"] = max(apart_l + [apart_e])
    out["sync tree test scores from float64"] = d_tree
    half = q // 2
    rounds = [{s: parts[s][:, :half] for s in range(MESH_RANKS)},
              {s: parts[s][:, half:2 * half] for s in range(3)}]   # 3 fresh: one masked slot
    sessions = {m: engine(federation="async", merge=m, max_staleness=0).session()
                for m in ("tree", "sequential")}
    for r, parts_r in enumerate(rounds):
        models = {}
        for m, sess in sessions.items():
            zero()
            models[m], times[f"async {m} round {r + 1}"] = _timed(lambda: sess.round(parts_r))
            launches[f"async {m} round {r + 1}"] = read()
        apart_l, apart_e = _model_stats_apart(models["tree"], *_summed_stats([models["sequential"]]))
        check(max(apart_l + [apart_e]) <= 1e-4, f"async tree round {r + 1} vs the sequential "
              f"session: layers {apart_l}, encoder {apart_e} (bar 1e-4)")
        out[f"async tree round {r + 1} vs sequential"] = max(apart_l + [apart_e])
    check(sessions["tree"].sites == {0: 0, 1: 0, 2: 0, 3: 1}, "async staleness")
    seen = {}
    real_decode = secagg.decode

    def spy(wire, frac_bits, dtypes=None):
        seen["aggregate"] = [w.copy() for w in wire]
        return real_decode(wire, frac_bits, dtypes)

    sec_tree = engine(merge="tree", privacy=PrivacySpec(secagg=True))
    sec_pair = engine(merge="pairwise", privacy=PrivacySpec(secagg=True))
    secagg.decode = spy
    try:
        m_sec = run("secagg tree round", lambda: sec_tree.session().round(parts))
    finally:
        secagg.decode = real_decode
    states = sec_tree.session()._local_states(list(enumerate(parts)))
    frac = sec_tree.plan.privacy.frac_bits
    wires = [secagg.encode(federated.exchange_to_additive(sec_tree.config, st), frac)
             for st in states]
    check(all(np.array_equal(a, b) for a, b in
              zip(seen["aggregate"], secagg.aggregate(wires, "sequential"), strict=True)),
          "the secagg tree aggregate differs from the sequential sum of the unmasked wires")
    _same_leaves(m_sec, sec_pair.session().round(parts), "secagg tree round vs pairwise")
    say("mesh", f"tree rounds over {MESH_RANKS} creditcard quarters of {q} samples: sync "
        f"{times['sync tree round']:.2f} ms (launches {launches['sync tree round']}; statistics "
        f"vs the local fits' sum {out['sync tree statistics vs local sums']:.2e} (bar 1e-4), "
        f"the pairwise merge of its local fits at most "
        f"{out['sync tree vs pairwise merge, kappa share']:.3f} of the kappa bar; test scores "
        f"{d_tree:.2e} from the float64 centralised fit, no bar: the broker protocol "
        f"approximates it); async (4 sites, then "
        f"3 of 4 fresh: a masked slot) " + ", ".join(
            f"round {r} {times[f'async tree round {r}']:.2f} ms vs sequential "
            f"{out[f'async tree round {r} vs sequential']:.2e}" for r in (1, 2))
        + f" (bar 1e-4); secagg {times['secagg tree round']:.2f} ms, its wire sum the "
        "sequential sum bit for bit, the model the pairwise secagg round's")

    # ---- (b) a one-rank NCCL group ----
    # The svd fit by eigh of each node's float32 Gram is held to a witness
    # of its own route: the same plan on the host in float64, and in float32
    # for phase 6's "plain" distance.
    host_mesh = mesh_lib.Mesh((1,), ("data",), device="cpu")
    eigh_cfg = dc.replace(host_cfg, method="svd")
    eigh_plan = ExecutionPlan(mode="mesh", mesh_axes=("data",), local_factorization="gram_eigh")
    eigh_scores = {}
    for dt in (torch.float64, torch.float32):
        m_h = DAEFEngine(eigh_cfg, eigh_plan, mesh=host_mesh).fit(torch.from_numpy(xq).to(dt))
        eigh_scores[dt] = daef.reconstruction_error(eigh_cfg, m_h,
                                                    torch.from_numpy(x_test).to(dt), device="cpu")
    witnesses = {"gram/gram_eigh": (s64, plain), "svd/local_svd": (s64, plain),
                 "svd/gram_eigh": (eigh_scores[torch.float64].double(), max(plain, _rel(
                     eigh_scores[torch.float32].double(), eigh_scores[torch.float64])))}
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_process_group_from_file(os.path.join(tmp, "store"), 0, 1, backend="nccl",
                                              timeout_s=120)
        try:
            mesh = mesh_lib.Mesh((1,), ("data",))
            check(mesh.backend == "nccl" and mesh.device_mesh is not None, f"NCCL mesh {mesh}")
            one_device = {}
            for method, fact in DATA_MESH_FITS:
                m = f"{method}/{fact}"
                cfg_m = dc.replace(base, method=method, stats_backend="fused")
                deng = DAEFEngine(cfg_m, ExecutionPlan(mode="mesh", mesh_axes=("data",),
                                                       local_factorization=fact), mesh=mesh)
                dm = run(f"nccl data mesh fit {m}", lambda: deng.fit(xq_d))
                if method not in one_device:   # daef.fit takes no factorization
                    daef.fit(cfg_m, xq_d)
                    one_device[method], times[f"daef.fit {method}"] = _timed(
                        lambda: daef.fit(cfg_m, xq_d))
                # held against daef.fit where both fits see the same inputs: the
                # encoder's Gram and the first decoder layer's (G, M), in Gram
                # form (deeper layers differ by the solves' drift, reported)
                apart_l, apart_e = _model_stats_apart(
                    _gram_form(dm), *_summed_stats([_gram_form(one_device[method])]))
                check(max(apart_l[0], apart_e) <= 1e-4, f"NCCL data-mesh {m} fit vs daef.fit: "
                      f"encoder {apart_e:.3e}, first decoder layer {apart_l[0]:.3e} (bar 1e-4)")
                out[f"nccl data mesh {m} vs daef.fit, encoder and first layer"] = max(
                    apart_l[0], apart_e)
                out[f"nccl data mesh {m} vs daef.fit, deepest layer"] = max(apart_l)
                ref_s, plain_m = witnesses[m]
                d = _rel(daef.reconstruction_error(cfg_m, dm, xte).double().cpu(), ref_s)
                out[f"nccl data mesh {m} test scores from float64"] = d
                out[f"nccl data mesh {m} bar"] = 2 * plain_m + 1e-4
                check(d <= 2 * plain_m + 1e-4, f"NCCL data-mesh {m} fit: test scores {d:.3e} "
                      f"from the float64 fit of its route, bar 2 x {plain_m:.3e} + 1e-4")
            rng = np.random.default_rng(7)
            feats = (np.tanh(rng.normal(size=(HEAD_ROWS, 64))) @ rng.normal(size=(64, HEAD_WIDTH))
                     + 0.3 * rng.normal(size=(HEAD_ROWS, HEAD_WIDTH))).astype(np.float32)
            hcfg = dc.replace(daef_head.default_config(HEAD_WIDTH), stats_backend="fused")
            daef_head.fit_head(feats, cfg=hcfg, mesh=mesh)
            zero()
            head, times["nccl head fit"] = _timed(
                lambda: daef_head.fit_head(feats, cfg=hcfg, mesh=mesh))
            launches["nccl head fit"] = read()
            tc_routes = dict(rolann_stats.route_launches)
            check(launches["nccl head fit"] == {"rolann_stats": 1}
                  and tc_routes.get("tf32x3") == 1,
                  f"head fit on the mesh launched {launches['nccl head fit']}, routes {tc_routes}")
            plain_head = daef_head.fit_head(feats, cfg=hcfg, n_partitions=1)
            apart_l, apart_e = _model_stats_apart(head.model, *_summed_stats([plain_head.model]))
            check(max(apart_l + [apart_e]) <= 1e-4, f"mesh head vs the one-device head: layers "
                  f"{apart_l}, encoder {apart_e} (bar 1e-4)")
            out["nccl head statistics vs one-device head"] = max(apart_l + [apart_e])
        finally:
            torch.distributed.destroy_process_group()
    say("mesh", f"one-rank NCCL group, data mesh over {MESH_SAMPLES} creditcard samples: " + ", ".join(
        f"{m} fit {times[f'nccl data mesh fit {m}']:.2f} ms (launches "
        f"{launches[f'nccl data mesh fit {m}']}; vs daef.fit: encoder and first layer "
        f"{out[f'nccl data mesh {m} vs daef.fit, encoder and first layer']:.2e} (bar 1e-4), "
        f"deepest layer {out[f'nccl data mesh {m} vs daef.fit, deepest layer']:.2e}; test "
        f"scores {out[f'nccl data mesh {m} test scores from float64']:.2e} from the float64 "
        f"fit of its route, bar {out[f'nccl data mesh {m} bar']:.2e})"
        for m in (f"{a}/{b}" for a, b in DATA_MESH_FITS))
        + f"; daef.fit gram {times['daef.fit gram']:.2f} ms, svd (local SVDs) "
        f"{times['daef.fit svd']:.2f} ms; DAEF head on "
        f"{HEAD_ROWS} x {HEAD_WIDTH} features {times['nccl head fit']:.2f} ms, B1 on "
        f"{tc_routes}, statistics vs the one-device head "
        f"{out['nccl head statistics vs one-device head']:.2e} (bar 1e-4)")

    # ---- (c) four gloo ranks sharing the card ----
    with tempfile.TemporaryDirectory() as tmp:
        for name, a in (("xs", xs), ("seeds", seeds_f), ("xq", xq), ("xte", x_test)):
            np.save(os.path.join(tmp, name + ".npy"), a)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), LOCAL_RANK="0",
                   OMP_NUM_THREADS="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                                   str(r), tmp], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for r in range(MESH_RANKS)]
        try:
            errs = [p.communicate(timeout=MESH_RANK_TIMEOUT_S)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        times["four gloo ranks (wall)"] = (time.perf_counter() - t0) * 1e3
        for r, (p, err) in enumerate(zip(procs, errs, strict=True)):
            check(p.returncode == 0, f"gloo rank {r} exited {p.returncode}: {err[-2000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(MESH_RANKS)]

    def rebuild(arrays, prefix, template):
        n = sum(1 for key in arrays if key.startswith(prefix + "/leaf"))
        return checkpoint.unflatten(template, [torch.from_numpy(arrays[f"{prefix}/leaf{i}"])
                                               .cuda() for i in range(n)])

    for key in ranks[0]:
        if "/leaf" in key or key in ("data_test_scores", "data_threshold", "sub_test_scores"):
            members = [r for r in ranks if key in r]
            check(len(members) == (3 if key.startswith("six/") else 2 if "sub" in key
                                   else MESH_RANKS)
                  and all(np.array_equal(r[key], ranks[0][key]) for r in members[1:]),
                  f"gloo ranks disagree on {key}")
    # one process, the ranks' shapes: each rank's 16 tenants fitted alone
    # (the batched kernels' slice plans depend on the tenant count, so a
    # 16-tenant fit is the 64-tenant one's only to float32 drift)
    from repro_torch.core import fleet_sharded

    kl = k // MESH_RANKS

    def by_rank(seeds):
        fits = [fleet._fit_fleet(cfg, xs_d[r * kl:(r + 1) * kl], seeds=seeds[r * kl:(r + 1) * kl])
                for r in range(MESH_RANKS)]
        return checkpoint.unflatten(fits[0], [torch.cat(leaves) for leaves in zip(
            *(checkpoint.flatten(f) for f in fits))])

    f_ranks = by_rank(seeds_f)
    _same_leaves(rebuild(ranks[0], "fit", fv), f_ranks,
                 f"{MESH_RANKS} gloo ranks' fleet fit vs one process fitting their shards")
    z_ranks = by_rank(np.zeros(k, np.int32))
    for g, name in ((4, "reduce16"), (k, "reduce1")):
        want = fleet_sharded.fleet_merge_tree(cfg, z_ranks, g)
        out[f"gloo reduce {k}->{k // g} vs one process, kappa share"] = _check_fleets_close(
            rebuild(ranks[0], name, want), want,
            f"{MESH_RANKS} gloo ranks' tree reduce {k} -> {k // g} vs one process")
    d = _rel(torch.from_numpy(ranks[0]["data_test_scores"]).double(), s64)
    check(d <= 2 * plain + 1e-4, f"{MESH_RANKS} gloo ranks' data-mesh fit: test scores {d:.3e} "
          f"from the float64 fit, bar 2 x {plain:.3e} + 1e-4")
    out["gloo data mesh test scores from float64"] = d
    per_rank = {name: [float(r[name]) for r in ranks]
                for name in ("fit_ms", "reduce16_ms", "reduce1_ms", "data_fit_ms")}
    launches["gloo rank fleet fit"] = [int(r["fit_b4"]) for r in ranks]
    launches["gloo rank data fit"] = [int(r["data_fit_b1"]) for r in ranks]
    check(launches["gloo rank fleet fit"] == [n_hidden] * MESH_RANKS
          and launches["gloo rank data fit"] == [n_hidden] * MESH_RANKS,
          f"gloo ranks launched B4 {launches['gloo rank fleet fit']}, B1 "
          f"{launches['gloo rank data fit']}")
    out["gloo per-rank ms"] = per_rank
    out["sub_meshes"] = _check_sub_meshes(cfg, ranks, rebuild, xs_d, xq, x_test, s64, plain)
    say("mesh", f"{MESH_RANKS} gloo ranks on one card ({times['four gloo ranks (wall)'] / 1e3:.1f}"
        f" s wall, processes included): per-rank ms " + ", ".join(
            f"{n} {v}" for n, v in per_rank.items())
        + f"; fleet fit ({k // MESH_RANKS} tenants a rank, B4 {launches['gloo rank fleet fit']}; "
        "bit for bit the one-process fits of the ranks' shards), "
        f"reduce {k} -> {k // 4} and {k} -> 1 held to one process by phase 7's rules (worst "
        f"kappa share {max(v for n, v in out.items() if 'gloo' in n and 'kappa' in n):.3f}); "
        f"data-mesh fit over {MESH_RANKS} x {q} samples (B1 {launches['gloo rank data fit']}) "
        f"test scores {d:.2e} from the float64 fit, bar {2 * plain + 1e-4:.2e}; the ranks "
        "agree bit for bit")
    say("mesh", "NCCL across several cards stays unverified: this machine has one")
    say("mesh", f"mesh phase took {time.perf_counter() - t_phase:.1f} s")
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


# the last line of each serve CLI mode, by its first flag
CLI_OK = {"--fleet": "fleet serve OK", "--async-rounds": "async federation OK",
          "--privacy": "privacy smoke OK", "--arch": "serve OK"}


def _start_cli_runs(argvs):
    """``python -m repro_torch.launch.serve`` with each of ``argvs``, as
    processes started together (each reaches the card on its own)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return [(argv, subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *argv],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
            for argv in argvs]


def _finish_cli_runs(runs) -> dict:
    """Wait for every CLI process; each must exit 0 with its OK line last.
    Returns each run's lines by its argv."""
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
        check(proc.returncode == 0 and lines and lines[-1] == CLI_OK[argv[0]],
              f"serve CLI {name} exited {proc.returncode}, last line "
              f"{lines[-1] if lines else None!r}; stderr tail: {stderr[-2000:]}")
        out[name] = lines
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
    cli = _start_cli_runs(SERVE_CLI)
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
        cli_lines = {name: lines[-2] if len(lines) > 1 else ""
                     for name, lines in _finish_cli_runs(cli).items()}
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
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd

    return {**_wrappers(), **_fleet_wrappers(), "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd, "rglru_scan": rglru_scan,
            "ssd_chunk": ssd_chunk, "rglru_scan_bwd": rglru_scan_bwd,
            "ssd_chunk_bwd": ssd_chunk_bwd}


def _lm_zero():
    for fn in _lm_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def _lm_read(route="wgmma", **want):
    """The launch counts, checked against ``want`` (every kernel not named
    must not have run); every B7 and B8 launch must have taken ``route``
    (``"wgmma"``: the bf16 tensor-core kernels; ``"tf32x3"``: the float32
    ones, 3xTF32 on the tensor cores)."""
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


def _pairs(s, window, causal=True):
    """The (query, key) pairs the causal/window band keeps (every pair
    without the causal mask)."""
    if not causal:
        return s * s
    w = s if window is None else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _attention_work(b, s, h, hkv, d, elem, window, d_v=None, causal=True):
    """FLOPs and bytes of B7 on these inputs: Q·Kᵀ (depth d) and P·V (width
    d_v, default d) over the (query, key) pairs the causal/window band keeps
    (2 FLOPs per multiply-add), the softmax not counted; q, k, v read once,
    out and lse written once."""
    d_v = d if d_v is None else d_v
    pairs = _pairs(s, window, causal)
    flops = 2 * (d + d_v) * pairs * b * h
    nbytes = elem * (b * s * ((h + hkv) * d + hkv * d_v) + b * s * h * d_v) + 4 * b * h * s
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


def _sdpa(q, k, v, window, causal=True):
    """The one-call PyTorch yardstick of B7 (timed here only; the port never
    calls it): fused attention in [B, H, S, D], causal (or full) or with the
    band mask, GQA in the call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_mask

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if window is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
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
        # the float32 route at qwen3's train shape, the shape of the lm-mesh
        # phase's dense float32 steps (B8's "train float32" case)
        ("train float32", 2, TRAIN_S, 16, 8, 128, f32, None, True),
    ]
    _say_ptxas("flash_attention", ["flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel"])
    for label, b, s, h, hkv, d, dtype, window, timed in attn_cases:
        q, k, v = randn(b, s, h, d, dtype=dtype), randn(b, s, hkv, d, dtype=dtype), \
            randn(b, s, hkv, d, dtype=dtype)
        route = _route(dtype)
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
        if dtype == f32:
            again, again_lse = flash_attention(q, k, v, window=window)
            check(bool(torch.equal(again, out) and torch.equal(again_lse, lse)),
                  f"B7 {label}: a repeat is not bit-identical")
            bar += "; a repeat is bit-identical"
            del again, again_lse
        say("kernel", f"flash_attention {label} B={b} S={s} H={h}/{hkv} D={d} "
            f"{str(dtype)[6:]} window={window} ({route}): max|d| out {err:.3e} ({bar}), "
            f"lse {err_lse:.3e}, ok")
        if timed:
            ms = cuda_ms(lambda: flash_attention(q, k, v, window=window))
            plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, window=window))
            library_ms = cuda_ms(lambda: _sdpa(q, k, v, window))
            flops, nbytes = _attention_work(b, s, h, hkv, d, q.element_size(), window)
            bound_ms, bound_by = _bound(flops, nbytes, _peak(route))
            rows["flash_attention"].append(dict(
                shape=label, b=b, s=s, h=h, hkv=hkv, d=d, window=window, route=route,
                max_abs_err=max(err, err_lse), ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by))
            say("kernel", f"flash_attention {label}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, SDPA {str(dtype)[6:]} yardstick {library_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}, {'3xTF32, ' if route == 'tf32x3' else ''}"
                f"{flops:.3g} FLOP, {nbytes / 1e6:.1f} MB)")

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
        _lm_read(route="tf32x3", **want)
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


def lm_profile(label, run, detail=(), host_ops=True):
    """``phase_profile`` plus the device-time shares of the port's kernels
    and of cuBLAS's GEMMs; each kernel whose name holds one of ``detail``
    is listed by name with its launches and device time.  ``host_ops=False``
    traces the device only (no aten rows; a run of thousands of small ops
    then takes seconds less to read back).  Returns the profiled run's wall
    and device-busy ms and its count of kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
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
    return wall * 1e3, total / 1e3, sum(e.count for e in kernels)


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


def _attention_bwd_work(b, s, h, hkv, d, elem, window, d_v=None, causal=True):
    """FLOPs and bytes of B8 (the wrapper's function): the five products of
    the backward (Q·Kᵀ and dSᵀ·Q and dS·K at depth or width d, dO·Vᵀ and
    Pᵀ·dO at d_v, default d) over the band's (query, key) pairs, 2·(3·d +
    2·d_v) FLOPs a pair (2.5 times B7's at equal sizes); q, k, v, out and
    dO read once, lse read, dq, dk and dv written once."""
    d_v = d if d_v is None else d_v
    flops = 2 * (3 * d + 2 * d_v) * _pairs(s, window, causal) * b * h
    nbytes = elem * (b * s * h * (d + 2 * d_v) + b * s * hkv * (d + d_v)   # q, out, dO; k, v
                     + b * s * h * d + b * s * hkv * (d + d_v)) + 4 * b * h * s
    return flops, nbytes


def _sdpa_bwd(q, k, v, do, window, causal=True):
    """SDPA's backward alone (the yardstick; the port never calls SDPA): a
    function that runs autograd through one SDPA forward kept alive."""
    import torch

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = _sdpa(*leaves, window, causal)
    return lambda: torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)


def _agree_bwd(label, got, want, mags, dtype, shares=None):
    """dq, dk, dv against the plain backward, element by element: float32
    within 1e-5 of the element's term magnitude (the sum of |term| over the
    products that make it; two float32 sums of the same terms in other
    orders differ by a small multiple of eps times that); bf16 within one
    bf16 ulp of the element (2^-7·|ref|: each side rounds its float32 result
    once) plus 2e-5 of the magnitude.  The magnitude of dk and dv sums over
    the G query heads of their group, as the sums themselves do, so the
    floor holds for the group sum too.  Returns (max|d|, worst share of a
    bar); ``shares`` (a dict), if given, gets each tensor's worst share."""
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
        if shares is not None:
            shares[name] = used
        worst_err, worst_used = max(worst_err, float(d.max())), max(worst_used, used)
    return worst_err, worst_used


def _route(dtype) -> str:
    import torch

    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def _peak(route) -> float:
    """The peak rate of B7's and B8's work on a route: bf16 tensor cores, or
    float32 as three TF32 products."""
    return PEAK_BF16_FLOPS if route == "wgmma" else PEAK_TF32X3_FLOPS


def _b8_case(gen, label, b, s, h, hkv, d, dtype, *, d_v=None, window=None, causal=True,
             timed=False, repeat=False, autograd=False, tag="kernel"):
    """B8 on seeded inputs against its plain version per element
    (``_agree_bwd``), its launch counted on its route; with ``repeat`` a
    repeat must be bit-identical, with ``autograd`` (float32) it is also
    held to autograd through B7's plain forward.  ``timed``: CUDA-events
    times of the kernel, the plain version and SDPA's backward (where SDPA
    takes the shapes) beside the bound, returned as a row (else None)."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_magnitudes,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    d_v = d if d_v is None else d_v
    q, k = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype) for n in (h, hkv))
    v, do = (torch.randn((b, s, n, d_v), generator=gen, device="cuda").to(dtype)
             for n in (hkv, h))
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention(q, k, v, **kw)
    route = _route(dtype)
    before = (flash_attention_bwd.launches, flash_attention_bwd.route_launches[route])
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    check((flash_attention_bwd.launches, flash_attention_bwd.route_launches[route])
          == (before[0] + 1, before[1] + 1), f"B8 {label}: launch count or route")
    check([tuple(g.shape) for g in got] == [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d_v)],
          f"B8 {label}: shapes {[tuple(g.shape) for g in got]}")
    mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, do, **kw)
    shares = {}
    err, used = _agree_bwd(label, got, flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                           mags, dtype, shares)
    msg = (f"max|d| {err:.3e}, worst {used:.3f} of its per-element bar ("
           + ", ".join(f"{n} {u:.3f}" for n, u in shares.items()) + ")")
    if autograd:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out, _ = flash_attention_ref(*leaves, **kw)
        auto = torch.autograd.grad(ref_out, leaves, do)
        err_a, used_a = _agree_bwd(label + " vs autograd", got, auto, mags, dtype)
        msg += f"; vs autograd through B7's plain forward {err_a:.3e} ({used_a:.3f})"
        del leaves, ref_out, auto
    del mags
    if repeat:
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        check(all(torch.equal(a, g) for a, g in zip(again, got)),
              f"B8 {label}: a repeat is not bit-identical")
        msg += "; a repeat is bit-identical"
        del again
    say(tag, f"flash_attention_bwd {label} B={b} S={s} H={h}/{hkv} D={d}"
        f"{'' if d_v == d else f', D_v={d_v}'} {str(dtype)[6:]} causal={causal} "
        f"window={window} ({route}): {msg}, ok")
    if not timed:
        return None
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, **kw))
    try:
        library_ms = cuda_ms(_sdpa_bwd(q, k, v, do, window, causal))
        library = f"SDPA backward yardstick {library_ms:.4f} ms"
    except RuntimeError as e:  # SDPA refuses the shapes: say so
        library_ms, library = None, f"SDPA refused the shapes ({str(e)[:120]})"
    flops, nbytes = _attention_bwd_work(b, s, h, hkv, d, q.element_size(), window, d_v, causal)
    bound_ms, bound_by = _bound(flops, nbytes, _peak(route))
    say(tag, f"flash_attention_bwd {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{library}, bound {bound_ms:.4f} ms ({bound_by}, {flops:.4g} FLOP, "
        f"{nbytes / 1e6:.1f} MB)")
    return dict(shape=label, b=b, s=s, h=h, hkv=hkv, d=d, d_v=d_v, window=window,
                causal=causal, max_abs_err=err, bar_used=used, bar_used_each=shares, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_b8_kernels():
    """B8 against its plain version (and, in float32, against autograd
    through B7's plain forward) at the train shape, recurrentgemma's windowed
    MQA at head size 256, a ragged S at head size 64 and head size 32; a
    repeat must be bit-identical (the bf16 train shape and every float32
    case).  The train shape is timed in bf16 and float32 beside its bound,
    the plain version and SDPA's backward."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(16)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    cases = [
        ("train", 2, TRAIN_S, 16, 8, 128, bf16, None, True),
        ("train float32", 2, TRAIN_S, 16, 8, 128, f32, None, True),
        ("recurrentgemma", 2, 4_096, 16, 1, 256, bf16, 2_048, False),
        ("ragged S", 1, 1_000, 8, 2, 64, f32, None, False),
        ("ragged S bf16 window", 2, 1_000, 8, 2, 64, bf16, 300, False),
        ("head size 32", 2, 512, 8, 2, 32, f32, 77, False),
    ]
    _say_ptxas("flash_attention_bwd", ["flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel",
                                       "flash_bwd_dq_tf32x3_kernel",
                                       "flash_bwd_dkv_tf32x3_kernel"])
    for label, b, s, h, hkv, d, dtype, window, timed in cases:
        row = _b8_case(gen, label, b, s, h, hkv, d, dtype, window=window, timed=timed,
                       repeat=label == "train" or dtype == f32, autograd=dtype == f32)
        if row:
            rows.append(row)
        torch.cuda.empty_cache()
    return rows


def phase_grad_agreement():
    """qwen3-1.7b at full width cut to 2 layers, float32, 1 x 512 tokens:
    ``bundle.loss`` and the gradient of every parameter leaf on the card (B7
    twice per layer with the remat, B8 once) against the same on the host
    (their plain versions), ``_grad_agree``'s bars (float32 sums in other
    orders through two layers and a 151,936-way softmax)."""
    _grad_agree(QWEN3, 4, {"n_layers": 2}, 512, tag="agree")


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


def _loss_launches(cfg) -> dict:
    """The kernel launches of one ``bundle.loss`` and its backward, every
    checkpointed layer's forward run twice: B7 twice and B8 once an
    attention layer; B10 twice and its backward once a mamba2 layer; in the
    hybrid, a period's blocks the same (B9 and its backward for a recurrent
    block), the tail's blocks (not checkpointed) one forward and one
    backward each."""
    if cfg.family == "ssm":
        return {"ssd_chunk": 2 * cfg.n_layers, "ssd_chunk_bwd": cfg.n_layers}
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern or ("rec", "rec", "attn")
        n_periods, rem = divmod(cfg.n_layers, len(pattern))
        counts = {}
        for kind, fwd, bwd in (("rec", "rglru_scan", "rglru_scan_bwd"),
                               ("attn", "flash_attention", "flash_attention_bwd")):
            period, tail = pattern.count(kind), pattern[:rem].count(kind)
            counts[fwd] = 2 * n_periods * period + tail
            counts[bwd] = n_periods * period + tail
        return counts
    n_attn = _attn_layers(cfg)
    return {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn}


def _train_steps(name, card, b, s, changes=None, seed=0, tag="train", steps=TRAIN_STEPS,
                 lr=TRAIN_LR):
    """``name`` (cut by ``changes``) in bf16, trained for ``steps`` steps
    as ``launch/train.py`` runs it: AdamW under
    ``linear_warmup_cosine(lr, steps // 10 + 1, steps)``, weight decay
    0.01, float32 moments; ``make_train_step(microbatches=2,
    clip_norm=1.0)`` with a float32 accumulator, every layer rematerialised;
    batches of ``b`` x ``s`` tokens from ``lm_token_stream(seed=step)``
    (``_train_batch``).  Every step's global gradient norm (the step's own,
    before the clip, read by wrapping ``optim.global_norm``) and loss must be
    finite, the gradients that reach the optimiser nonzero in every leaf and
    layer, step 0's loss within 1.0 of ln V (not for the hybrid, whose
    untrained model echoes its input token) and the loss on step 0's batch
    lower after the steps; ``_loss_launches`` a microbatch (B7 twice and B8
    once an attention layer, all on ``"wgmma"``; B9/B10 and their
    backwards).  Returns (cfg, bundle, params, state, the step, the
    optimiser, the launch counts, the numbers)."""
    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.launch import steps as steps_mod

    _free()
    cfg, bundle, params = _lm_params(name, torch.bfloat16, seed=seed, **(changes or {}))
    opt = optim.adamw(optim.linear_warmup_cosine(lr, steps // 10 + 1, steps),
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
    losses, times = [], []
    _lm_zero()
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, not the initialiser's
    optim.global_norm = recorded_norm  # the train step calls it through the module
    try:
        for step in range(steps):
            batch = _train_batch(cfg, b, s, seed=step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, batch)
            losses.append(float(loss))
            times.append((time.perf_counter() - t0) * 1e3)
            check(np.isfinite(losses[-1]) and np.isfinite(norms[-1]),
                  f"{name} step {step}: loss {losses[-1]} or gradient norm {norms[-1]} not "
                  "finite")
            say(tag, f"{name} step {step}: loss {losses[-1]:.4f}, global gradient norm "
                f"{norms[-1]:.4f} (before the clip to 1.0), {times[-1]:.0f} ms")
    finally:
        optim.global_norm = global_norm
    per_step = {k: v * TRAIN_MICRO for k, v in _loss_launches(cfg).items()}
    launches = _lm_read(**{k: v * steps for k, v in per_step.items()})
    peak = torch.cuda.max_memory_allocated()
    # The hybrid's embedding (std 0.02) enters scaled by sqrt(d_model) and is
    # tied to the LM head, so an untrained model echoes its input token at a
    # logit of ~0.02 d_model (82 at 4,096): step 0's loss is ~60, not ln V,
    # as with the reference's init.
    check(cfg.family == "hybrid" or abs(losses[0] - np.log(cfg.vocab_size)) <= 1.0,
          f"{name} step 0 loss {losses[0]:.4f} is not within 1.0 of ln V = "
          f"{np.log(cfg.vocab_size):.4f}")
    with torch.no_grad():
        after = float(bundle.loss(params, _train_batch(cfg, b, s, seed=0)))
    check(after < losses[0], f"{name}: loss on step 0's batch {after:.4f} after {steps} "
          f"steps is not below {losses[0]:.4f}")
    step_ms = statistics.median(times[1:])
    positions = s + (cfg.n_patches if cfg.family == "vlm" else 0)
    tok_s = b * positions / step_ms * 1e3
    frames = f" after {cfg.encoder_seq} frames" if cfg.family == "encdec" else ""
    say(tag, f"{name} full width, {cfg.n_layers} layers, bf16, {steps} steps of {b} x "
        f"{positions} positions{frames} ({TRAIN_MICRO} microbatches): step {step_ms:.0f} ms "
        f"(median of steps 1-{steps - 1}; step 0 {times[0]:.0f} ms), {tok_s:.0f} "
        f"positions/s, peak device memory {peak / 2**30:.2f} GiB, on {card}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, step 0's batch {after:.4f}; launches {launches}")
    numbers = dict(n_layers=cfg.n_layers, b=b, positions=positions, step_ms=step_ms,
                   tokens_per_s=tok_s, peak_gib=peak / 2**30, losses=losses, loss_after=after,
                   grad_norms=norms, b7_per_step=per_step.get("flash_attention", 0),
                   b8_per_step=per_step.get("flash_attention_bwd", 0),
                   launches_per_step=per_step)
    return cfg, bundle, params, state, step_fn, opt, launches, numbers


def phase_train(card):
    """qwen3-1.7b at full width and depth, bf16: ``TRAIN_STEPS`` steps of
    ``_train_steps`` on 4 x 2,048 tokens, then one more step under the
    profiler, and the cross-entropy and one optimiser update on CUDA
    events.  Returns the launch counts of the steps and the path's
    numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.models import common

    cfg, _, params, state, step_fn, opt, launches, out = _train_steps(QWEN3, card, TRAIN_B,
                                                                      TRAIN_S)

    # What the step is made of: one more step under the profiler, and the
    # cross-entropy (forward and backward, one microbatch) and one optimiser
    # update with CUDA events.
    b = _train_batch(cfg, TRAIN_B, TRAIN_S, seed=TRAIN_STEPS)
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
    out.update(profile_wall_ms=wall * 1e3, device_busy_ms=total / 1e3,
               shares_ms={g: t / 1e3 for g, t in shares.items()}, xent_ms=xent_ms,
               optimizer_ms=opt_ms)
    return launches, out


def _per_launch(rows, shape):
    """One JSON row: the kernel's numbers per launch at its main path's shape."""
    row = next(r for r in rows if r["shape"] == shape)
    return {"max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


# ---------------------------------------------------------------------------
# 20. the paper's comparison (Tables 2 and 3, one fold): DAEF through
# stats_backend="auto" against the iterative AE on its graphed step; the
# training CLI at full width
# ---------------------------------------------------------------------------

VERDICT_SHAPE = (17, 2_048, 16)   # (m, n, o): the reference sweep's largest shape
AE_TIMED_STEPS = 200              # steps timed per dataset, graphed and eager
AE_CHECK_STEPS = 10               # eager steps held to the host's
COMPARISON_LABEL_BAR = 4          # |dtp| + |dfp| beyond twice the plain fits' own
TRAIN_CLI_STEPS, TRAIN_CLI_MICRO = 6, 2
TRAIN_CLI = ["--arch", QWEN3, "--steps", str(TRAIN_CLI_STEPS), "--batch", "4", "--seq", "2048",
             "--microbatches", str(TRAIN_CLI_MICRO), "--dtype", "bfloat16"]


def stats_verdict() -> dict:
    """einsum against fused ``stats_backend.gram_stats`` on the card at
    ``VERDICT_SHAPE``, on the reference sweep's inputs (CUDA events, median
    of 25): the measurement behind the cache's ``"cuda"`` verdict."""
    import numpy as np
    import torch

    from repro_torch.core import stats_backend

    m, n, o = VERDICT_SHAPE
    rng = np.random.default_rng(0)
    xa, fsq, fd = (torch.as_tensor(a, dtype=torch.float32, device="cuda") for a in (
        rng.normal(size=(m, n)), rng.uniform(0.05, 1.0, (o, n)), rng.normal(size=(o, n))))
    ms = {b: cuda_ms(lambda b=b: stats_backend.gram_stats(xa, fsq, fd, backend=b))
          for b in stats_backend.BACKENDS}
    return {"shape": {"m": m, "n": n, "o": o}, "einsum_ms": ms["einsum"],
            "fused_ms": ms["fused"], "preferred_backend": min(ms, key=ms.get)}


def _replica(name):
    """Fold 0 of ``name``'s replica at the reference benchmark's scale (0.1 for
    the replicas above 100,000 samples, ``table2_f1.py:78-79``)."""
    from repro_torch.data import synthetic

    scale = 0.1 if synthetic.PAPER_DATASETS[name][0] > 100_000 else 1.0
    return scale, synthetic.make_dataset(name, seed=0, scale=scale).train_test_split(0, n_folds=10)


def _ae_trainer(acfg, x_train, steps: int):
    """A fresh trainer of ``acfg`` on the card and the first ``steps`` rows
    of its batches (the epochs extended to hold them)."""
    import torch

    from repro_torch.baselines import autoencoder

    n = x_train.shape[1]
    cfg = dataclasses.replace(acfg, epochs=-(-steps // max(1, n // min(acfg.batch_size, n))))
    trainer = autoencoder._Trainer(cfg, torch.as_tensor(x_train, device="cuda"))
    return trainer, torch.as_tensor(autoencoder.batch_indices(cfg, n)[:steps], device="cuda")


def _ae_step_us(acfg, x_train, graph: bool) -> float:
    """µs a step of ``AE_TIMED_STEPS`` steps of a fresh trainer on the card
    (CUDA events): replays of the captured step, or the eager step."""
    import torch

    trainer, idx = _ae_trainer(acfg, x_train, AE_TIMED_STEPS)
    run = trainer.capture(idx) if graph else None
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for s in range(AE_TIMED_STEPS):
        run() if graph else trainer.step(idx[s])
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e3 / AE_TIMED_STEPS


def _profile_ae_graph(acfg, x_train) -> float:
    """``AE_TIMED_STEPS`` replays of the captured step under the profiler
    (after as many unprofiled): its kernels and the device's busy share."""
    trainer, idx = _ae_trainer(acfg, x_train, 2 * AE_TIMED_STEPS)
    replay = trainer.capture(idx)
    return phase_profile(f"AE graphed step x {AE_TIMED_STEPS}",
                         lambda: [replay() for _ in range(AE_TIMED_STEPS)])


def _check_ae_steps_on_host(acfg, x_train) -> float:
    """``AE_CHECK_STEPS`` eager steps on the card against the same steps of
    the host's trainer: every leaf within 1e-4 of its largest entry."""
    import torch

    from repro_torch.baselines import autoencoder

    idx = autoencoder.batch_indices(acfg, x_train.shape[1])[:AE_CHECK_STEPS]
    card = autoencoder._Trainer(acfg, torch.as_tensor(x_train, device="cuda"))
    host = autoencoder._Trainer(acfg, torch.as_tensor(x_train))
    for row in idx:
        card.step(torch.as_tensor(row, device="cuda"))
        host.step(torch.as_tensor(row))
    worst = 0.0
    for a, b in zip(card.leaves, host.leaves, strict=True):
        a, b = a.detach().cpu(), b.detach()
        err, scale = float((a - b).abs().max()), float(b.abs().max())
        check(err <= 1e-4 * scale, f"AE after {len(idx)} steps: a leaf {err:.3e} from the host's "
              f"> 1e-4 * {scale:.3e}")
        worst = max(worst, err / scale)
    return worst


def _check_creditcard_daef(cfg, x_train, x_test, y_test, model, scores):
    """The card's "auto" fit of the creditcard replica against the port's
    host fits, by phase 6's rule: no farther from the host's float64 fit
    than twice the plain float32 fits (host, card einsum), plus 1e-4; labels
    within twice the plain fits' own distance plus ``COMPARISON_LABEL_BAR``."""
    import torch

    from repro_torch.core import anomaly, daef

    plain = dataclasses.replace(cfg, stats_backend="einsum")
    host = daef.fit(plain, x_train, n_partitions=N_PARTITIONS, device="cpu")
    s_host = daef.reconstruction_error(plain, host, x_test, device="cpu")
    m64 = daef.fit(plain, torch.from_numpy(x_train).double(), n_partitions=N_PARTITIONS,
                   device="cpu")
    s64 = daef.reconstruction_error(plain, m64, torch.from_numpy(x_test).double(), device="cpu")
    card_e = daef.fit(plain, x_train, n_partitions=N_PARTITIONS)
    s_card_e = daef.reconstruction_error(plain, card_e, x_test)
    fits = {"card auto": (model.train_errors, scores), "card einsum": (card_e.train_errors,
                                                                       s_card_e),
            "host float32": (host.train_errors, s_host)}
    out = {}
    for i, (what, ref) in enumerate((("train errors", m64.train_errors), ("test scores", s64))):
        dist = {k: _rel(v[i].double().cpu(), ref) for k, v in fits.items()}
        bar = 2 * max(dist["card einsum"], dist["host float32"]) + 1e-4
        check(dist["card auto"] <= bar, f"comparison, creditcard: the card's {what} are "
              f"{dist['card auto']:.3e} from the float64 fit, bar {bar:.3e}")
        out[what] = dist
        out[f"{what} card vs host float32"] = _rel(fits["card auto"][i].cpu(), fits[
            "host float32"][i])
    metrics = {k: anomaly.evaluate(v[0].cpu(), v[1].cpu(), y_test, DAEF_ARCH["creditcard"][3],
                                   device="cpu") for k, v in fits.items()}
    apart = _labels_apart(metrics["card auto"], metrics["host float32"])
    bar = 2 * _labels_apart(metrics["card einsum"], metrics["host float32"]) + COMPARISON_LABEL_BAR
    check(apart <= bar, f"comparison, creditcard: labels {apart} apart from the host's, bar {bar}")
    out["labels apart from the host"] = (apart, bar)
    return out


def phase_comparison() -> dict:
    """Phase 20: the wiring of "auto", the paper's Tables 2 and 3 on one
    fold, and ``launch/train.py`` at full width.  Returns the numbers."""
    import numpy as np
    import torch

    from repro_torch.analysis import retrace
    from repro_torch.baselines import autoencoder
    from repro_torch.core import anomaly, daef, stats_backend
    from repro_torch.kernels import autotune
    from repro_torch.kernels.rolann_stats import rolann_stats

    t_phase = time.perf_counter()
    committed = json.loads(autotune.DEFAULT_CACHE_PATH.read_text())["platforms"]
    check("cuda" in committed, "the committed autotune cache has no 'cuda' verdict")
    autotune.clear_cache()
    resolved = stats_backend.resolve("auto", "cuda")
    want = committed["cuda"]["preferred_backend"]
    check(resolved == want, f'resolve("auto", "cuda") is {resolved!r}, the committed cache '
          f"says {want!r}")
    verdict = stats_verdict()
    say("comparison", f'"auto" on the card resolves to {resolved!r} (the committed verdict); '
        f"re-measured at (m, n, o) {VERDICT_SHAPE}: einsum {verdict['einsum_ms']:.4f} ms, fused "
        f"{verdict['fused_ms']:.4f} ms -> {verdict['preferred_backend']!r}")
    out = {"auto": resolved, "verdict": verdict, "datasets": {}}

    for name, (arch, lam_h, lam_l, rule) in DAEF_ARCH.items():
        scale, (x_train, x_test, y_test) = _replica(name)
        cfg = daef.DAEFConfig(layer_sizes=arch, lam_hidden=lam_h, lam_last=lam_l,
                              init="xavier", seed=0)  # stats_backend unset: "auto"
        daef.fit(cfg, x_train, n_partitions=N_PARTITIONS)  # warm-up
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        model = daef.fit(cfg, x_train, n_partitions=N_PARTITIONS)
        torch.cuda.synchronize()
        daef_ms = (time.perf_counter() - t0) * 1e3
        launches, routes = read_launches(), dict(rolann_stats.route_launches)
        n_hidden = len(arch) - 3
        expect = n_hidden if resolved == "fused" else 0
        check(launches == {"rolann_stats": expect, "rolann_stats_acc": 0,
                           "rolann_fused_chunk": 0},
              f"{name}: one 'auto' fit launched {launches}, expected rolann_stats {expect}")
        scores = daef.reconstruction_error(cfg, model, x_test)
        f1_d = anomaly.evaluate(model.train_errors, scores, y_test, rule).f1
        check(bool(torch.isfinite(model.train_errors).all() and torch.isfinite(scores).all()),
              f"{name}: non-finite DAEF errors")

        ae_arch, epochs = AE_ARCH[name]
        acfg = autoencoder.AEConfig(layer_sizes=ae_arch, epochs=epochs, seed=0)
        x_d = torch.as_tensor(x_train, device="cuda")
        with torch.no_grad():
            init_loss = float(autoencoder.loss_fn(acfg, [[t.cuda() for t in p] for p in
                                                         autoencoder.init_params(acfg)], x_d))
        with retrace.trace_guard(what=f"{name} AE fit") as ae_fit:
            model_a, ae_s = autoencoder.fit(acfg, x_train)
        check(ae_fit.traces == 1, f"{name}: the AE fit captured {ae_fit} (one step graph "
              "expected)")
        errs_a = autoencoder.reconstruction_error(acfg, model_a, x_test)
        f1_a = anomaly.evaluate(model_a.train_errors, errs_a, y_test, rule).f1
        final_loss = float(model_a.train_errors.mean())
        check(np.isfinite(final_loss) and final_loss < init_loss,
              f"{name}: the AE's training loss {final_loss:.5f} is not below its {init_loss:.5f} "
              "at init")
        steps = len(autoencoder.batch_indices(acfg, x_train.shape[1]))
        graph_us, eager_us = _ae_step_us(acfg, x_train, True), _ae_step_us(acfg, x_train, False)
        row = {"scale": scale, "train": x_train.shape[1], "f1_daef": f1_d, "f1_ae": f1_a,
               "daef_ms": daef_ms, "ae_s": ae_s, "ratio": ae_s * 1e3 / daef_ms,
               "ae_steps": steps, "ae_step_us_graph": graph_us, "ae_step_us_eager": eager_us,
               "b1_launches": launches["rolann_stats"],
               "b1_routes": {k: v for k, v in routes.items() if v},
               "ae_captures": ae_fit.traces,
               "ae_loss": (init_loss, final_loss)}
        if name == "creditcard":
            row["host"] = _check_creditcard_daef(cfg, x_train, x_test, y_test, model, scores)
            row["ae_host_apart"] = _check_ae_steps_on_host(acfg, x_train)
            row["ae_graph_busy"] = _profile_ae_graph(acfg, x_train)
        if name == "ionosphere":
            eager, _ = autoencoder.fit(acfg, x_train, graph=False)
            same = all(torch.equal(a, b) for a, b in zip(
                model_a.weights + model_a.biases + (model_a.train_errors,),
                eager.weights + eager.biases + (eager.train_errors,), strict=True))
            check(same, "ionosphere: the graphed AE fit is not the eager fit bit for bit")
            row["graph_is_eager"] = same
        out["datasets"][name] = row
        say("comparison", f"{name} (scale {scale}, {x_train.shape[1]} training samples): F1 DAEF "
            f"{f1_d:.4f}, AE {f1_a:.4f}; DAEF {daef_ms:.2f} ms (B1 {launches['rolann_stats']}, "
            f"routes {row['b1_routes']}), AE {ae_s:.3f} s ({steps} steps), ratio "
            f"{row['ratio']:.1f}; AE step {graph_us:.1f} us graphed, {eager_us:.1f} us eager; "
            f"AE loss {init_loss:.5f} -> {final_loss:.5f}"
            + (f"; vs the host: {row['host']}, AE after {AE_CHECK_STEPS} steps "
               f"{row['ae_host_apart']:.2e} of max|leaf| (bar 1e-4)" if "host" in row else "")
            + ("; graphed fit == eager fit, bit for bit" if "graph_is_eager" in row else ""))

    out["train_cli"] = _train_cli(TRAIN_CLI, QWEN3, TRAIN_CLI_STEPS, TRAIN_CLI_MICRO,
                                  "comparison")
    say("comparison", f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return out


ANALYSIS_SAMPLES = 128   # a tenant in the analysis phase's chunked fleet fits
ANALYSIS_CHUNKS = (32, 16)


def phase_analysis(cfg, fleet_data_d, comparison) -> dict:
    """The claims of ``repro_torch.analysis``'s guard on the card, where
    graphs capture and kernels load.  The retrace self-check
    (``python -m repro_torch.analysis retrace``'s serve): warmup captures
    one CUDA graph per tile shape it returns, the mixed ragged serve after
    it captures and loads nothing; each AE fit of phase 20 captured its
    step once; a chunked fleet fit (B6) of two creditcard tenants loads as
    many libraries at chunk 32 as at chunk 16, cold (after
    ``_build.clear_loaded``), and none warm; both donation reports of the
    self-check are effective, the streaming fold's "in-place".  Returns the
    phase's numbers."""
    import torch

    from repro_torch.analysis import retrace
    from repro_torch.analysis.__main__ import donation_reports, retrace_serve
    from repro_torch.core import fleet
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    zero, read = _launch_counter()
    out = {}
    zero()
    serve = retrace_serve("cuda")    # raises if the ragged serve captured or loaded
    out["retrace selfcheck launches"] = read()
    warm, rep = serve["warmup"], serve["serve"]
    check(warm.traces == serve["shapes"] > 0, f"warmup of {serve['shapes']} tile shapes: {warm}")
    check((rep.traces, rep.compiles) == (0, 0), f"mixed ragged serve after warmup: {rep}")
    out["warmup"] = {"shapes": serve["shapes"], "captures": warm.traces, "loads": warm.compiles}
    out["ragged serve"] = {"requests": len(serve["results"]), "captures": rep.traces,
                           "loads": rep.compiles}
    out["ae fit captures"] = {name: row["ae_captures"]
                              for name, row in comparison["datasets"].items()}
    check(set(out["ae fit captures"].values()) == {1}, f"AE fit captures {out['ae fit captures']}")

    xs2 = fleet_data_d[0][:2, :, :ANALYSIS_SAMPLES].contiguous()
    seeds2 = torch.arange(1, 3, dtype=torch.int32, device=xs2.device)
    def chunked(chunk, cold):
        if cold:
            _build.clear_loaded()
        zero()
        with retrace.trace_guard(max_traces=0, what=f"chunked fleet fit, chunk {chunk}") as r:
            fleet._fit_fleet_chunked(cfg, xs2, chunk_samples=chunk, seeds=seeds2)
        torch.cuda.synchronize()
        return {"loads": r.compiles, "libraries": sorted(set(r.traced_names)),
                "launches": read()}

    cold = {chunk: chunked(chunk, True) for chunk in ANALYSIS_CHUNKS}
    out["chunked fleet fit warm"] = chunked(ANALYSIS_CHUNKS[-1], False)
    out["chunked fleet fit cold"] = {str(c): row for c, row in cold.items()}
    loads = [row["loads"] for row in cold.values()]
    check(len(set(loads)) == 1 and loads[0] > 0, f"cold loads by chunk {cold}")
    check(out["chunked fleet fit warm"]["loads"] == 0,
          f"a warm chunked fleet fit loaded {out['chunked fleet fit warm']}")
    check(all(row["launches"].get("rolann_fused_chunk_batched", 0) > 0 for row in cold.values()),
          f"the chunked fleet fits did not launch B6: {cold}")

    reports = donation_reports("cuda")
    out["donation"] = [r.describe() for r in reports]
    check(all(r.ok is True for r in reports), "donation: " + "; ".join(out["donation"]))
    # the streaming fold writes through B3's raw pointer; its wrapper bumps the
    # accumulators' versions, so the card's fold reads as the host's: in place
    check(reports[1].kinds == ("in-place",), f"the streaming fold: {out['donation'][1]}")
    out["seconds"] = time.perf_counter() - t_phase
    say("analysis", f"warmup captured {warm.traces} CUDA graphs for {serve['shapes']} tile "
        f"shapes; the mixed ragged serve ({len(serve['results'])} requests) captured "
        f"{rep.traces} and loaded {rep.compiles} (self-check launches "
        f"{out['retrace selfcheck launches']}); AE fit captures {out['ae fit captures']}; "
        "chunked fleet fit cold loads " + ", ".join(
            f"chunk {c}: {row['loads']} {row['libraries']} (launches {row['launches']})"
            for c, row in cold.items())
        + f", warm {out['chunked fleet fit warm']['loads']}; "
        + "; ".join(out["donation"]) + f"; phase took {out['seconds']:.1f} s")
    return out


def _train_cli(argv, name, steps, micro, tag):
    """``python -m repro_torch.launch.train`` with ``argv`` in this process
    (its launches count here; the memory of earlier phases is released
    first): its step lines and its last line in the reference's formats,
    finite losses, ``_loss_launches`` a microbatch (B7 and B8 all on
    ``"wgmma"``)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import train

    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    _lm_zero()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    cli_s = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        say("train-cli", line)
    launches = _lm_read(**{k: v * steps * micro
                           for k, v in _loss_launches(registry.get(name)).items()})
    logged = [re.fullmatch(r"step +\d+  loss (\S+)  \(\d+\.\d+ s/step\)", ln)
              for ln in lines[:-1]]
    check(len(lines) == 3 and all(logged)
          and all(np.isfinite(float(m.group(1))) for m in logged)
          and re.fullmatch(r"loss \S+ -> \S+ \((NOT )?improved\)", lines[-1]) is not None,
          f"train CLI printed {lines}")
    say(tag, f"python -m repro_torch.launch.train {' '.join(argv)}: {cli_s:.1f} s in process "
        f"({free / 2**30:.1f} GiB free before), launches {launches}")
    return {"argv": argv, "lines": lines, "wall_s": cli_s, "free_gib_before": free / 2**30,
            "launches": launches}


# ---------------------------------------------------------------------------
# 21. decode: the serve CLI's LM mode at full width, decode against prefill
# (B7, B9, B10 on the card), the rings, card against host, decode speed
# ---------------------------------------------------------------------------

DECODE_B, DECODE_S = 2, 64       # (b): teacher-forced tokens against the prefill
RING_WINDOW, RING_S = 16, 48     # (c): the rings wrap three times
HOST_STEPS = 16                  # (d): decode steps card against host
SPEED_B, SPEED_PROMPT, SPEED_GEN = 4, 32, 16
PROFILE_STEPS = 10
# tests/test_models.py test_decode_consistent_with_forward: the reference's bar
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-2
# full-depth prefill launches of each model (B7 FP32, B9, B10)
DECODE_PREFILL = {QWEN3: dict(flash_attention=28), MAMBA2: dict(ssd_chunk=48),
                  RGEMMA: dict(flash_attention=12, rglru_scan=26)}


def _lm_cli_runs() -> dict:
    """(a): ``python -m repro_torch.launch.serve --arch A`` (the reference's
    defaults: batch 4, 32 prompt tokens, 16 generated) for each model, as
    processes started together; each must end in ``serve OK`` (it raises on
    non-finite logits before that line).  Returns their lines and times."""
    out, names = {}, (QWEN3, MAMBA2, RGEMMA)
    runs = _start_cli_runs([["--arch", name] for name in names])
    for name, lines in zip(names, _finish_cli_runs(runs).values(), strict=True):
        m = re.fullmatch(r"prefill (\S+)s; decode (\S+) ms/token", lines[2]) \
            if len(lines) == 4 else None
        check(m is not None, f"serve CLI --arch {name}: printed {lines}")
        out[name] = dict(lines=lines, prefill_s=float(m.group(1)),
                         decode_ms_per_token=float(m.group(2)))
    return out


def _teacher_force(bundle, params, tokens):
    """``tokens`` [B, S] stepped through ``bundle.decode`` from a zero float32
    cache: the last step's logits."""
    import torch

    b, s = tokens.shape
    cache = bundle.init_cache(b, s, torch.float32, device=tokens.device)
    logits = None
    for t in range(s):
        logits, cache = bundle.decode(params, cache, tokens[:, t:t + 1], t)
    return logits, cache


def _decode_vs_prefill(label, bundle, params, s, seed, want, prefill_bundle=None):
    """(b)/(c): decode against prefill on the same 2 x ``s`` tokens at the
    reference's bar; the prefill's launches must be ``want`` (B7 on its
    3xTF32 float32 route), the decode's none.  ``prefill_bundle`` (default ``bundle``)
    runs the prefill."""
    import torch

    from repro_torch.data import synthetic

    cfg = bundle.cfg
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, DECODE_B, seed=seed),
                             device="cuda")
    _lm_zero()
    pf = (prefill_bundle or bundle).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_launches = {k: n for k, n in _lm_read(route="tf32x3", **want).items() if n}
    _lm_zero()
    logits, cache = _teacher_force(bundle, params, tokens)
    torch.cuda.synchronize()
    _lm_read(route="tf32x3")
    got, ref = logits[:, 0].double(), pf[:, 0].double()
    d = (got - ref).abs()
    share = float((d / (DECODE_ATOL + DECODE_RTOL * ref.abs())).max())
    err, scale = float(d.max()), float(ref.abs().max())
    check(bool(got.isfinite().all()) and share <= 1.0,
          f"{label}: decode's last logits {err:.3e} from the prefill's (max|logits| "
          f"{scale:.3e}; {share:.3f} of the bar atol {DECODE_ATOL} + rtol {DECODE_RTOL})")
    say("decode", f"{label}: {DECODE_B} x {s} tokens, decode vs prefill max|d| {err:.3e} "
        f"(max|logits| {scale:.3e}), {share:.4f} of the bar (atol {DECODE_ATOL} + rtol "
        f"{DECODE_RTOL}); prefill launches {prefill_launches}, decode launches none")
    return dict(max_abs_err=err, max_abs_logits=scale, bar_used=share,
                prefill_launches=prefill_launches), cache


def _cut(cfg, params, n_layers):
    """``cfg`` and its parameters cut to ``n_layers`` (views of the full
    stacks; a hybrid keeps whole periods and as much of its tail, an MoE
    model its dense layers and the first of its MoE layers)."""
    from torch.utils import _pytree as pytree

    from repro_torch.models import rglru

    cut = dataclasses.replace(cfg, n_layers=n_layers)
    out = {k: v for k, v in params.items() if k not in ("layers", "periods", "tail")}
    if cfg.family == "moe":
        n_moe = n_layers - cfg.first_dense_layers
        out["moe_layers"] = pytree.tree_map(lambda t: t[:n_moe], params["moe_layers"])
    elif cfg.family == "hybrid":
        n_periods, tail = rglru._layout(cut)
        out["periods"] = pytree.tree_map(lambda t: t[:n_periods], params["periods"])
        out["tail"] = params["tail"][:len(tail)]
    else:
        out["layers"] = pytree.tree_map(lambda t: t[:n_layers], params["layers"])
    return cut, out


def _decode_card_vs_host(cfg, params):
    """(d): the model cut to two layers (one period), 16 decode steps on the
    card and on the host from the same weights and tokens; each step's
    logits within 1e-4 of their largest entry on the host."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data import synthetic
    from repro_torch.models import get_bundle

    cut, cut_params = _cut(cfg, params, 3 if cfg.family == "hybrid" else 2)
    bundle = get_bundle(cut)
    host = pytree.tree_map(lambda t: t.cpu(), cut_params)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, HOST_STEPS, DECODE_B, seed=17)
    card_tokens = torch.as_tensor(tokens, device="cuda")
    host_tokens = torch.as_tensor(tokens)
    caches = (bundle.init_cache(DECODE_B, HOST_STEPS, torch.float32, device="cuda"),
              bundle.init_cache(DECODE_B, HOST_STEPS, torch.float32, device="cpu"))
    worst = 0.0
    for t in range(HOST_STEPS):
        got, _ = bundle.decode(cut_params, caches[0], card_tokens[:, t:t + 1], t)
        want, _ = bundle.decode(host, caches[1], host_tokens[:, t:t + 1], t)
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(bool(got.isfinite().all()) and rel <= 1e-4,
              f"{cut.name} at {cut.n_layers} layers, decode step {t}: card {rel:.3e} of "
              "max|logits| from the host (bar 1e-4)")
    say("decode", f"{cut.name} cut to {cut.n_layers} layers: {HOST_STEPS} decode steps card vs "
        f"host, worst max|d| / max|logits| {worst:.3e} (bar 1e-4)")
    return worst


def _decode_speed(name, bundle, params, card):
    """Decode ms/token and tokens/s at B = 4 through ``serve.generate`` (after
    a warm-up run), and a profile of 10 decode steps."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.launch import serve

    cfg = bundle.cfg
    prompts = synthetic.lm_token_stream(cfg.vocab_size, SPEED_PROMPT, SPEED_B, seed=1)
    serve.generate(bundle, params, prompts[:, :2], 2)  # warm-up at B = 4
    _lm_zero()
    out = serve.generate(bundle, params, prompts, SPEED_GEN)
    _lm_read(route="tf32x3")
    check(bool(out.logits.isfinite().all()), f"{name}: generate's logits not finite")
    ms = out.decode_s / SPEED_GEN * 1e3
    tok_s = SPEED_B * SPEED_GEN / out.decode_s
    say("decode", f"{name} full width, float32, B={SPEED_B}: decode {ms:.3f} ms/token "
        f"({tok_s:.1f} tokens/s), prompt of {SPEED_PROMPT} stepped in "
        f"{out.prefill_s * 1e3:.1f} ms, on {card}")
    tokens = torch.as_tensor(prompts, device="cuda")

    def steps():
        cache = bundle.init_cache(SPEED_B, PROFILE_STEPS, torch.float32, device="cuda")
        for t in range(PROFILE_STEPS):
            bundle.decode(params, cache, tokens[:, t:t + 1], t)

    t0 = time.perf_counter()
    wall_ms, busy_ms, n_kernels = lm_profile(
        f"{name} decode, {PROFILE_STEPS} steps at B={SPEED_B}", steps, host_ops=False)
    say("decode", f"{name}: profiling {PROFILE_STEPS} steps took "
        f"{time.perf_counter() - t0:.1f} s")
    say("decode", f"{name}: {busy_ms / PROFILE_STEPS:.2f} ms of device time a step against "
        f"{ms:.2f} ms/token unprofiled ({busy_ms / PROFILE_STEPS / ms:.3f} busy); "
        f"{n_kernels / PROFILE_STEPS:.0f} kernel launches a step")
    return dict(decode_ms_per_token=ms, tokens_per_s=tok_s, prompt_ms=out.prefill_s * 1e3,
                profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms, device_ms_per_step=busy_ms / PROFILE_STEPS,
                kernels_per_step=n_kernels / PROFILE_STEPS)


def phase_decode(card) -> dict:
    """Phase 21 (see the module docstring).  Returns the phase's numbers."""
    import torch

    from repro_torch.models import get_bundle

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    say("decode", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held by earlier phases; "
        f"the three LM CLIs start")
    out = {"cli": _lm_cli_runs()}
    say("decode", f"(a) took {time.perf_counter() - t_phase:.1f} s")
    for name, seed in ((QWEN3, 21), (MAMBA2, 22), (RGEMMA, 23)):
        t_model = time.perf_counter()
        cfg, bundle, params = _lm_params(name, torch.float32, seed=seed)
        row = {}
        row["vs_prefill"], _ = _decode_vs_prefill(f"{name} (b)", bundle, params, DECODE_S,
                                                  31, DECODE_PREFILL[name])
        if name == QWEN3:
            ring = get_bundle(dataclasses.replace(cfg, sliding_window=RING_WINDOW))
            row["ring"], cache = _decode_vs_prefill(
                f"{name} sliding_window={RING_WINDOW} (c)", ring, params, RING_S, 32,
                DECODE_PREFILL[name])
            check(cache.k.shape[2] == RING_WINDOW, f"ring of {cache.k.shape[2]} slots")
        if name == RGEMMA:
            cut, cut_params = _cut(cfg, params, 5)
            ring = get_bundle(dataclasses.replace(cut, local_window=RING_WINDOW))
            row["ring"], cache = _decode_vs_prefill(
                f"{name} one period + two-block tail, local_window={RING_WINDOW} (c)", ring,
                cut_params, RING_S, 33, dict(flash_attention=1, rglru_scan=4))
            check(cache.period_attn["b2"].k.shape[2] == RING_WINDOW, "the hybrid's ring slots")
        t_host = time.perf_counter()
        row["card_vs_host"] = _decode_card_vs_host(cfg, params)
        t_speed = time.perf_counter()
        row.update(_decode_speed(name, bundle, params, card))
        out[name] = row
        say("decode", f"{name}: (b)-(c) {t_host - t_model:.1f} s, (d) {t_speed - t_host:.1f} s, "
            f"speed and profile {time.perf_counter() - t_speed:.1f} s")
        del params
        torch.cuda.empty_cache()
    say("decode", f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 22. the VLM and MoE families: internvl2-2b, qwen2-moe-a2.7b, deepseek-v2
# (MLA): B7 at (192, 128), the serve CLI, decode against prefill, card
# against host, the bf16 prefills, the DAEF head on qwen2-moe
# ---------------------------------------------------------------------------

INTERNVL, QWEN2_MOE, DSV2 = "internvl2-2b", "qwen2-moe-a2.7b", "deepseek-v2-236b"
MLA_D, MLA_DV, MLA_HEADS, MLA_S = 192, 128, 128, 4_096
FAMILY_PREFILL = {INTERNVL: (4, 3_840), QWEN2_MOE: (4, 4_096), DSV2: (1, 4_096)}
DSV2_PREFILL_LAYERS = 6      # the dense layer and 5 MoE layers, 42 GB in bf16
AGREE_S = 256                # (b): tokens card against host
MOE_DECODE_CF = 16.0         # (d): the reference's capacity factor for decode checks


def _no_drop(cfg):
    """``cfg`` with the capacity factor of the decode checks: the
    reference's 16, raised to E / top_k where that is larger, so that no
    token of a 64-token group is dropped (deepseek-v2's 160 experts, top 6:
    at 16 an expert holds 38 of 64, and the prefill drops what decode,
    one token a group, keeps)."""
    return dataclasses.replace(cfg, capacity_factor=max(MOE_DECODE_CF,
                                                        cfg.n_experts / cfg.top_k))
FAMILY_HEAD_FIT = 1_024


def _family_batch(cfg, b, s, seed, device="cuda"):
    """Seeded tokens [b, s] and, for the VLM, standard-normal patch
    embeddings [b, n_patches, d_frontend] in float32 (the reference's
    ``input_specs`` dtype)."""
    import torch

    from repro_torch.data import synthetic

    batch = {"tokens": torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, b,
                                                                 seed=seed), device=device)}
    if cfg.family == "vlm":
        gen = torch.Generator(device=device).manual_seed(seed)
        batch["patch_embeds"] = torch.randn((b, cfg.n_patches, cfg.d_frontend), generator=gen,
                                            device=device)
    return batch


def _b7_case(gen, label, b, s, h, d, dtype, *, d_v=None, causal=True, timed=False,
             tag="families"):
    """B7 (q, k and v of ``h`` heads) on seeded inputs against its plain
    version under phase 9's bars, its launch counted on its route, a repeat
    bit-identical.  ``timed``: CUDA-events times of the kernel, the plain
    version and SDPA (where SDPA takes the shapes) beside the bound,
    returned as a row (else None)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    d_v = d if d_v is None else d_v
    q, k = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    v = torch.randn((b, s, h, d_v), generator=gen, device="cuda").to(dtype)
    route = _route(dtype)
    before = flash_attention.route_launches[route]
    out, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(flash_attention.route_launches[route] == before + 1, f"B7 {label}: not on {route}")
    check(tuple(out.shape) == (b, s, h, d_v) and out.dtype == dtype,
          f"B7 {label}: out {tuple(out.shape)} {out.dtype}")
    again, again_lse = flash_attention(q, k, v, causal=causal)
    check(bool(torch.equal(again, out) and torch.equal(again_lse, lse)),
          f"B7 {label}: repeat not bit-identical")
    ref, ref_lse = flash_attention_ref(q, k, v, causal=causal)
    if route == "wgmma":
        err, used = _agree_each(f"B7 {label} out", out.float(), ref.float(),
                                2.0**-7, 2.0**-7 * 1e-2)
        bar = f"2^-7 |ref| + 2^-7 * 1e-2 per element, worst {used:.3f} of its bar"
    else:
        err, scale = _agree(f"B7 {label} out", out.float(), ref.float(), 1e-5, 1.0)
        used = err / (1e-5 * scale)
        bar = f"1e-5 * max(1, max|ref|), {used:.3f} of it"
    err_lse, _ = _agree(f"B7 {label} lse", lse, ref_lse, 1e-5)
    del ref, ref_lse, again, again_lse
    say(tag, f"flash_attention ({d}, {d_v}) causal={causal} {label} B={b} S={s} H={h} "
        f"{str(dtype)[6:]} ({route}): max|d| out {err:.3e} ({bar}), lse {err_lse:.3e}, "
        "repeat bit-identical, ok")
    if not timed:
        return None
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal), reps=5, warmup=1)
    try:
        library_ms = cuda_ms(lambda: _sdpa(q, k, v, None, causal))
        library = f"SDPA yardstick {library_ms:.4f} ms"
    except RuntimeError as e:  # SDPA refuses the shapes: say so
        library_ms, library = None, f"SDPA refused the shapes ({str(e)[:120]})"
    flops, nbytes = _attention_work(b, s, h, h, d, q.element_size(), None, d_v, causal)
    bound_ms, bound_by = _bound(flops, nbytes, _peak(route))
    say(tag, f"flash_attention ({d}, {d_v}) causal={causal} {label}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, {library}, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{flops:.4g} FLOP, {nbytes / 1e6:.1f} MB)")
    return dict(shape=label, b=b, s=s, h=h, d=d, d_v=d_v, causal=causal,
                max_abs_err=max(err, err_lse), bar_used=used, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def _mla_kernel_checks():
    """(a): B7 at MLA's head sizes against its plain version, timed at
    deepseek-v2's prefill shape.  Returns the numbers of the timed bf16 row
    and of the float32 one."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = {}
    for label, s, dtype, timed in (("deepseek-v2 prefill", MLA_S, torch.bfloat16, True),
                                   ("deepseek-v2 prefill float32", MLA_S, torch.float32, True),
                                   ("ragged S", 1_000, torch.bfloat16, False),
                                   ("ragged S float32", 1_000, torch.float32, False)):
        row = _b7_case(gen, label, 1, s, MLA_HEADS, MLA_D, dtype, d_v=MLA_DV, timed=timed)
        if row:
            rows[_route(dtype)] = row
        torch.cuda.empty_cache()
    regs = {}
    for kernel in ("flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel"):
        got = _ptxas("flash_attention", kernel).get(f"{MLA_D},{MLA_DV}")
        check(got is not None, f"no ptxas line for {kernel}<{MLA_D}, {MLA_DV}>")
        regs[kernel] = dict(registers=got[0], spill_stores=got[1], spill_loads=got[2])
        say("families", f"ptxas {kernel}<{MLA_D}, {MLA_DV}>: {got[0]} registers, spill "
            f"stores {got[1]} B, spill loads {got[2]} B")
    rows["ptxas"] = regs
    return rows


class _RouteLog:
    """Records each ``moe.route`` call's logits and dispatch while active
    (``moe_ffn`` looks ``route`` up in its module at each call)."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.orig, self.calls = moe, moe.route, []

    def __enter__(self):
        def logged(logits, top_k, cap):
            out = self.orig(logits, top_k, cap)
            self.calls.append((logits.detach().cpu(), out[0].detach().cpu()))
            return out

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.orig


def _dispatch_agree(label, card_calls, host_calls, top_k) -> str | None:
    """Each MoE layer's dispatch, card against host: ``None`` if all are
    equal; a description of the near tie if the top-k choices differ only
    where the deciding probabilities lie within 1e-6 (the caller reruns
    with the next seed); fails otherwise."""
    import torch

    check(len(card_calls) == len(host_calls) > 0, f"{label}: {len(card_calls)} routed layers "
          f"on the card, {len(host_calls)} on the host")
    for layer, ((lc, dc), (lh, dh)) in enumerate(zip(card_calls, host_calls)):
        if torch.equal(dc, dh):
            continue
        pc, ph = torch.softmax(lc.float(), -1), torch.softmax(lh.float(), -1)
        sc = torch.sort(pc, dim=-1, descending=True, stable=True)
        sh = torch.sort(ph, dim=-1, descending=True, stable=True)
        differ = (sc.indices[..., :top_k].sort(-1).values
                  != sh.indices[..., :top_k].sort(-1).values).any(-1)
        check(bool(differ.any()), f"{label} layer {layer}: dispatch differs with the same "
              "top-k choices")
        gap = torch.maximum((sc.values[..., top_k - 1] - sc.values[..., top_k]).abs(),
                            (sh.values[..., top_k - 1] - sh.values[..., top_k]).abs())
        worst = float(gap[differ].max())
        check(worst <= 1e-6, f"{label} layer {layer}: {int(differ.sum())} routing decisions "
              f"differ card vs host, deciding probabilities {worst:.3e} apart (> 1e-6)")
        return (f"layer {layer}: {int(differ.sum())} near-tied choices differ (deciding "
                f"probabilities within {worst:.3e})")
    return None


def _family_agree(cfg, bundle, params, seed):
    """(b): the cut model in float32 on the card and on the host, the same
    weights and inputs: dispatch first, then the hidden states within 1e-4
    of max|h|.  Returns the numbers, or a near-tie note (see
    ``_dispatch_agree``)."""
    import torch
    from torch.utils import _pytree as pytree

    batch = _family_batch(cfg, 1, AGREE_S, seed)
    args = [batch["tokens"]] + ([batch["patch_embeds"]] if cfg.family == "vlm" else [])
    _lm_zero()
    with _RouteLog() as card_log:
        h_card = bundle.forward(params, *args).cpu()
    _lm_read(route="tf32x3", flash_attention=cfg.n_layers)
    host = pytree.tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    with _RouteLog() as host_log:
        h_host = bundle.forward(host, *(a.cpu() for a in args))
    host_s = time.perf_counter() - t0
    del host
    tie = None
    if cfg.family == "moe":
        tie = _dispatch_agree(cfg.name, card_log.calls, host_log.calls, cfg.top_k)
        if tie:
            return tie
    err, scale = _agree(f"{cfg.name} cut to {cfg.n_layers} layers, card vs host", h_card,
                        h_host, 1e-4)
    n_tokens = h_card.shape[1]
    say("families", f"{cfg.name} cut to {cfg.n_layers} layers, 1 x {n_tokens} positions, "
        f"float32, seed {seed}: dispatch of {len(card_log.calls)} MoE layers equal card vs "
        f"host, max|d| h {err:.3e} (max|h| {scale:.3e}, {err / (1e-4 * scale):.4f} of the bar "
        f"1e-4), host forward {host_s:.1f} s, ok")
    return dict(max_abs_err=err, max_abs_h=scale, bar_used=err / (1e-4 * scale), seed=seed,
                positions=n_tokens, moe_layers_routed=len(card_log.calls))


def _agree_until_no_tie(cfg, bundle, params, seed):
    """(b) with the next seed for as long as a near tie decides a choice."""
    for attempt in range(3):
        got = _family_agree(cfg, bundle, params, seed + attempt)
        if not isinstance(got, str):
            return got
        say("families", f"{cfg.name} seed {seed + attempt}: {got}; rerun with the next seed")
    check(False, f"{cfg.name}: near ties in three seeds running")


def _family_prefill(name, cfg, bundle, params, want):
    """(c): one bf16 prefill through ``bundle.prefill`` after a warm-up:
    tokens/s (patches counted as positions), the launch counts ``want``
    (every B7 on ``"wgmma"``), finite logits [B, 1, V]."""
    import torch

    b, s = FAMILY_PREFILL[name]
    batch = _family_batch(cfg, b, s, seed=11)
    positions = s + (cfg.n_patches if cfg.family == "vlm" else 0)
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
    tok_s = b * positions / ms * 1e3
    say("families", f"{name} bf16 prefill B={b} x {positions} positions ({cfg.n_layers} "
        f"layers): {ms:.1f} ms ({tok_s:.0f} tokens/s), launches {want} (all wgmma), "
        f"logits finite; peak {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return launches, dict(ms=ms, tokens_per_s=tok_s, b=b, positions=positions,
                          n_layers=cfg.n_layers)


class _EinsumRanges:
    """While active, each ``torch.einsum`` call runs inside a profiler range
    named by its equation, so a trace attributes its kernels to it (the
    einsum's operand shapes are not recorded)."""

    def __enter__(self):
        import torch
        from torch.profiler import record_function

        self.torch, self.orig = torch, torch.einsum

        def ranged(equation, *operands):
            with record_function(f"einsum {equation}"):
                return self.orig(equation, *operands)

        torch.einsum = ranged
        return self

    def __exit__(self, *exc):
        self.torch.einsum = self.orig


# moe.moe_ffn's einsums by their equations
MOE_EINSUMS = {"bsec,bsd->becd": "dispatch einsum", "becd,edf->becf": "expert einsums",
               "becf,efd->becd": "expert einsums", "bsec,becd->bsd": "combine einsum"}


def _moe_profile(label, run, cfg, b, s):
    """One profile of an MoE prefill: device time split into B7, the expert
    einsums, the dispatch and combine einsums (by their equations) and the
    rest, beside all of cuBLAS's GEMM kernels (the einsums' among them).
    Returns the times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with _EinsumRanges(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    flat = prof.key_averages()
    key = ("self_device_time_total" if hasattr(flat[0], "self_device_time_total")
           else "self_cuda_time_total")
    incl = "device_time_total" if hasattr(flat[0], "device_time_total") else "cuda_time_total"
    # the device rows less the einsum ranges' own spans and CUPTI's "Command
    # Buffer Full" records: kernels only
    ranges = {f"einsum {eq}" for eq in MOE_EINSUMS}
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernels = [e for e in flat if e.device_type == cuda and e.key not in ranges
               and e.key != "Command Buffer Full"]
    total = sum(getattr(e, key) for e in kernels)
    gemm = sum(getattr(e, key) for e in kernels
               if any(p in e.key for p in ("gemm", "xmma", "nvjet", "cutlass")))
    b7 = sum(getattr(e, key) for e in kernels if "flash_fwd_" in e.key)
    parts = dict.fromkeys(MOE_EINSUMS.values(), 0.0)
    for e in flat:  # a range's host row: the device time of the kernels it launched
        part = MOE_EINSUMS.get(e.key.removeprefix("einsum "))
        if part is not None and e.device_type == cpu:
            parts[part] += getattr(e, incl)
    rest = total - b7 - sum(parts.values())
    shares = {"B7": b7, **parts, "all cuBLAS GEMM kernels": gemm, "rest": rest}
    say("profile", f"{label}: wall {wall * 1e3:.2f} ms, device busy {total / 1e3:.2f} ms "
        f"({100 * total / 1e6 / wall:.1f} %); device time: "
        + ", ".join(f"{k} {t / 1e3:.2f} ms ({100 * t / max(total, 1):.1f} %)"
                    for k, t in shares.items()))
    print(flat.table(sort_by=key, row_limit=12))
    return dict(wall_ms=wall * 1e3, busy_ms=total / 1e3,
                **{f"{k} ms": t / 1e3 for k, t in shares.items()})


def _family_head(cfg, bundle, params):
    """(f): the DAEF head on the bf16 backbone (see the module docstring).
    Returns the launch counts and the numbers."""
    import numpy as np
    import torch

    from repro_torch.core import anomaly
    from repro_torch.data import synthetic
    from repro_torch.kernels.rolann_stats import rolann_stats
    from repro_torch.models import daef_head

    v = cfg.vocab_size
    fit_tokens = synthetic.lm_token_stream(v, HEAD_SEQ, FAMILY_HEAD_FIT, seed=0)
    test_tokens = np.concatenate([
        synthetic.lm_token_stream(v, HEAD_SEQ, HEAD_TEST, seed=7),
        np.random.default_rng(1).integers(0, v, (HEAD_TEST, HEAD_SEQ)).astype(np.int32)])
    truth = np.concatenate([np.zeros(HEAD_TEST, np.int32), np.ones(HEAD_TEST, np.int32)])
    head_cfg = dataclasses.replace(daef_head.default_config(cfg.d_model), stats_backend="fused")
    _pooled(bundle, params, fit_tokens[:HEAD_BATCH])   # warm-up
    torch.cuda.synchronize()
    _lm_zero()
    t0 = time.perf_counter()
    feats = _pooled(bundle, params, fit_tokens)
    test_feats = _pooled(bundle, params, test_tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    head = daef_head.fit_head(feats, cfg=head_cfg)
    flags = head.flag(test_feats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_batches = -(-FAMILY_HEAD_FIT // HEAD_BATCH) + -(-2 * HEAD_TEST // HEAD_BATCH)
    launches = _lm_read(flash_attention=cfg.n_layers * n_batches, rolann_stats=1)
    check(rolann_stats.route_launches == {"tf32x3": 1, "fp32": 0, "slice": 0},
          f"the head fit's B1 launch must take the tensor-core route; "
          f"routes {rolann_stats.route_launches}")
    check(bool(feats.isfinite().all() and test_feats.isfinite().all()), "features not finite")
    met = anomaly.binary_metrics(flags, truth)
    head_h = daef_head.fit_head(feats.cpu(), cfg=head_cfg, device="cpu")
    flags_h = head_h.flag(test_feats.cpu())
    diff = int((flags.cpu() != flags_h).sum())
    check(diff <= HEAD_FLAG_BAR, f"{cfg.name} head: the card flags {diff} of {len(truth)} "
          f"samples otherwise than the host (bar {HEAD_FLAG_BAR})")
    n_tok = (FAMILY_HEAD_FIT + 2 * HEAD_TEST) * HEAD_SEQ
    tok_s = n_tok / (t1 - t0)
    say("families", f"{cfg.name} DAEF head, bf16: forward {n_tok} tokens in "
        f"{(t1 - t0) * 1e3:.1f} ms ({tok_s:.0f} tokens/s), fit + flag {(t2 - t1) * 1e3:.1f} "
        f"ms, launches {launches}; F1 {met.f1:.4f} (tp {met.tp} fp {met.fp} fn {met.fn} tn "
        f"{met.tn}); flags differ from the host head on {diff} of {len(truth)} (bar "
        f"{HEAD_FLAG_BAR})")
    return launches, dict(tokens_per_s=tok_s, forward_ms=(t1 - t0) * 1e3,
                          fit_flag_ms=(t2 - t1) * 1e3, f1=met.f1, flags_differ=diff)


def _family_cli_runs() -> dict:
    """(e): the serve CLI's LM mode at full width in float32 (the reference's
    defaults: B = 4, 32 prompt tokens, 16 generated), two processes."""
    out, names = {}, (INTERNVL, QWEN2_MOE)
    runs = _start_cli_runs([["--arch", name] for name in names])
    for name, lines in zip(names, _finish_cli_runs(runs).values(), strict=True):
        m = re.fullmatch(r"prefill (\S+)s; decode (\S+) ms/token", lines[2]) \
            if len(lines) == 4 else None
        check(m is not None, f"serve CLI --arch {name}: printed {lines}")
        out[name] = dict(lines=lines, prefill_s=float(m.group(1)),
                         decode_ms_per_token=float(m.group(2)))
        say("families", f"serve CLI --arch {name} (float32, B=4): decode "
            f"{m.group(2)} ms/token")
    return out


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_families(card) -> dict:
    """Phase 22 (see the module docstring).  Returns the phase's numbers."""
    import torch

    from repro_torch.models import get_bundle

    t_phase = time.perf_counter()
    _free()
    say("families", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held by earlier phases; "
        "the two LM CLIs start")
    out = {"cli": _family_cli_runs()}
    t_cli = time.perf_counter()
    out["b7_192_128"] = _mla_kernel_checks()
    t_kernel = time.perf_counter()
    say("families", f"(e) took {t_cli - t_phase:.1f} s, (a) {t_kernel - t_cli:.1f} s")
    launches = {}

    # internvl2-2b: (d) and (b) in float32, (c) in bf16
    t0 = time.perf_counter()
    cfg, bundle, params = _lm_params(INTERNVL, torch.float32, seed=41)
    row = {}
    row["vs_prefill"], _ = _decode_vs_prefill(
        f"{INTERNVL} (d), text-only prefill", bundle, params, DECODE_S, 31,
        dict(flash_attention=cfg.n_layers),
        prefill_bundle=get_bundle(dataclasses.replace(cfg, family="dense")))
    cut, cut_params = _cut(cfg, params, 2)
    row["card_vs_host"] = _agree_until_no_tie(cut, get_bundle(cut), cut_params, 51)
    del params, cut_params
    _free()
    cfg, bundle, params = _lm_params(INTERNVL, torch.bfloat16, seed=42)
    launches[INTERNVL], row["prefill"] = _family_prefill(
        INTERNVL, cfg, bundle, params, dict(flash_attention=cfg.n_layers))
    out[INTERNVL] = row
    del params
    _free()
    say("families", f"{INTERNVL} took {time.perf_counter() - t0:.1f} s")

    # qwen2-moe-a2.7b: (d) and (b) in float32 (57 GB), (c), the profile and
    # (f) in bf16
    t0 = time.perf_counter()
    cfg, bundle, params = _lm_params(QWEN2_MOE, torch.float32, seed=43)
    row = {}
    row["vs_prefill"], _ = _decode_vs_prefill(
        f"{QWEN2_MOE} (d), capacity_factor={_no_drop(cfg).capacity_factor:g}",
        get_bundle(_no_drop(cfg)), params, DECODE_S, 32, dict(flash_attention=cfg.n_layers))
    cut, cut_params = _cut(cfg, params, 2)
    row["card_vs_host"] = _agree_until_no_tie(cut, get_bundle(cut), cut_params, 52)
    del params, cut_params
    _free()
    cfg, bundle, params = _lm_params(QWEN2_MOE, torch.bfloat16, seed=44)
    launches[QWEN2_MOE], row["prefill"] = _family_prefill(
        QWEN2_MOE, cfg, bundle, params, dict(flash_attention=cfg.n_layers))
    b, s = FAMILY_PREFILL[QWEN2_MOE]
    batch = _family_batch(cfg, b, s, seed=11)
    row["profile"] = _moe_profile(f"{QWEN2_MOE} bf16 prefill ({b} x {s})",
                                  lambda: bundle.prefill(params, batch), cfg, b, s)
    launches["head"], row["head"] = _family_head(cfg, bundle, params)
    out[QWEN2_MOE] = row
    del params, batch
    _free()
    say("families", f"{QWEN2_MOE} took {time.perf_counter() - t0:.1f} s")

    # deepseek-v2-236b: (b) and (d) at its cut (dense + 1 MoE layer) in
    # float32, (c) at the dense layer and 5 MoE layers in bf16
    t0 = time.perf_counter()
    cfg, bundle, params = _lm_params(DSV2, torch.float32, seed=45, n_layers=2)
    row = {}
    row["card_vs_host"] = _agree_until_no_tie(cfg, bundle, params, 53)
    row["vs_prefill"], _ = _decode_vs_prefill(
        f"{DSV2} cut to {cfg.n_layers} layers (d), capacity_factor="
        f"{_no_drop(cfg).capacity_factor:.4g}", get_bundle(_no_drop(cfg)), params, DECODE_S,
        33, dict(flash_attention=cfg.n_layers))
    del params
    _free()
    cfg, bundle, params = _lm_params(DSV2, torch.bfloat16, seed=46,
                                     n_layers=DSV2_PREFILL_LAYERS)
    launches[DSV2], row["prefill"] = _family_prefill(
        DSV2, cfg, bundle, params, dict(flash_attention=cfg.n_layers))
    out[DSV2] = row
    del params
    _free()
    say("families", f"{DSV2} took {time.perf_counter() - t0:.1f} s")
    out["launches"] = launches
    say("families", f"phase 22 took {time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# 25. the registry's last two dense architectures, granite-20b and
# mistral-nemo-12b, at the registry's shapes: B7 at 32,768 tokens, B8 at a
# group of 48, card against host at a 2-layer cut, prefill_32k, decode_32k,
# long_500k and its ring, bf16 train steps, the serve CLI
# ---------------------------------------------------------------------------

GRANITE, MISTRAL = "granite-20b", "mistral-nemo-12b"
STRIPE_ROWS = 1_024              # (a): B7's plain version holds the last query rows
DENSE_CUT = 2                    # (b), (d), (e): layers of the depth cuts
DENSE_AGREE = (2, 256)           # (b): batch and tokens of the forward, card against host
                                 # (the gradients': 1 x 256, as phase 23's)
DENSE_DECODE_B = {GRANITE: 8, MISTRAL: 4}   # (d): decode_32k's batch of 128, cut
DENSE_DECODE_STEPS = 8           # (d): steps at a decode shape's last positions
DENSE_RING_PAST = 64             # (d): decode steps past the ring's last slot
DENSE_TRAIN = (4, 4)             # (e): batch (train_4k's 256 cut) and steps
# (e): AdamW's first steps move every weight by ~lr, so a projection of
# d_model 5,120-6,144 inputs shifts by ~lr * d_model * E|x|: 1.5 at the
# launcher's 3e-4 after a one-step warm-up (granite's loss 11.2 -> 34.4 on
# an H100), 0.15 at 3e-5
DENSE_TRAIN_LR = 3e-5


def _seq(shape):
    from repro_torch.configs import registry

    return registry.SHAPES[shape].seq_len


def _b7_long(gen, cfg, dtype):
    """(a): B7 on seeded q [1, 32,768, H, 128] and k, v [1, 32,768, Hkv,
    128] (prefill_32k's length, ``cfg``'s heads), causal, counted on its
    route, a repeat bit-identical.  The plain version would hold a [1, H, S,
    S] score tensor (206 GB at 48 heads), so it holds the stripe of the last
    1,024 query rows of the last two query heads (one KV group) through
    ``q_offset``: out to one bf16 ulp an element (bf16) or 1e-4 of
    max|plain| (float32), lse to 1e-5 of max|lse|.  bf16: CUDA-events times
    (median of 5 after a warm-up) of the kernel, SDPA (k and v expanded to
    the query heads) and the plain version on the stripe, beside the bound.
    Returns the row."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    s, h, hkv, d = _seq("prefill_32k"), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, s, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((1, s, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    label = f"B7 {cfg.name} 1 x {s} H={h}/{hkv} {str(dtype)[6:]}"
    route = _route(dtype)
    before = flash_attention.route_launches[route]
    out, lse = flash_attention(q, k, v)
    torch.cuda.synchronize()
    check(flash_attention.route_launches[route] == before + 1, f"{label}: not on {route}")
    check(tuple(out.shape) == (1, s, h, d) and tuple(lse.shape) == (1, h, s),
          f"{label}: out {tuple(out.shape)}, lse {tuple(lse.shape)}")
    again, again_lse = flash_attention(q, k, v)
    check(bool(torch.equal(again, out) and torch.equal(again_lse, lse)),
          f"{label}: a repeat is not bit-identical")
    del again, again_lse
    off, heads = s - STRIPE_ROWS, slice(h - 2, h)
    qs, ks, vs = q[:, off:, heads], k[:, :, hkv - 1:], v[:, :, hkv - 1:]
    ref, ref_lse = flash_attention_ref(qs, ks, vs, q_offset=off)
    got = out[:, off:, heads].float()
    if route == "wgmma":
        err, used = _agree_each(f"{label} out", got, ref.float(), 2.0**-7, 2.0**-7 * 1e-2)
        bar = f"2^-7 |ref| + 2^-7 * 1e-2 per element, worst {used:.3f} of its bar"
    else:
        err, scale = _agree(f"{label} out", got, ref.float(), 1e-4)
        used = err / (1e-4 * scale)
        bar = f"1e-4 * max|ref|, {used:.4f} of it"
    err_lse, scale_lse = _agree(f"{label} lse", lse[:, heads, off:], ref_lse, 1e-5)
    del ref, ref_lse, got
    say("dense", f"{label} ({route}): the plain version on the last {STRIPE_ROWS} rows of "
        f"heads {h - 2}-{h - 1} (KV head {hkv - 1}, q_offset {off}): max|d| out {err:.3e} "
        f"({bar}), lse {err_lse:.3e} ({err_lse / (1e-5 * scale_lse):.4f} of 1e-5 * max|lse|), "
        "repeat bit-identical, ok")
    row = dict(b=1, s=s, h=h, hkv=hkv, d=d, route=route, stripe_rows=STRIPE_ROWS, stripe_heads=2,
               max_abs_err=max(err, err_lse), bar_used=used)
    if route != "wgmma":
        return row
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps=5, warmup=1)
    plain_ms = cuda_ms(lambda: flash_attention_ref(qs, ks, vs, q_offset=off), reps=5, warmup=1)
    ke, ve = (t.repeat_interleave(h // hkv, dim=2) for t in (k, v))
    library_ms = cuda_ms(lambda: _sdpa(q, ke, ve, None), reps=5, warmup=1)
    flops, nbytes = _attention_work(1, s, h, hkv, d, q.element_size(), None)
    bound_ms, bound_by = _bound(flops, nbytes, _peak(route))
    say("dense", f"{label}: kernel {ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}, "
        f"{flops:.4g} FLOP, {nbytes / 1e6:.1f} MB; {bound_ms / ms:.3f} of it), SDPA with k and v "
        f"expanded to {h} heads {library_ms:.3f} ms, plain on the stripe {plain_ms:.3f} ms")
    row.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               plain_stripe_ms=plain_ms)
    return row


def _b8_blocks(route, b, s, h, hkv):
    """The blocks of B8's two launches: dq one a (query head, sequence, 128
    query rows) on the bf16 route (``launch_bwd`` in csrc/flash_bwd_sm90.cuh),
    64 on the float32 one (csrc/flash_attention_bwd.cu); dk/dv one a (KV
    head, sequence, 128 or 64 keys) (``launch_dkv``)."""
    tiles = -(-s // (128 if route == "wgmma" else 64))
    return h * b * tiles, hkv * b * tiles


def _b8_split(gen, label, b, s, h, hkv, d, dtype):
    """(a): one B8 call on seeded inputs under the profiler
    (``_kernel_us``): the device time of its dq kernel and of its dk/dv
    kernel beside their block counts; "not measured" (None) where five
    profiles recorded no device event of it (on an H100 the float32 call's
    profiles once recorded none three times running)."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd

    q, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = flash_attention(q, k, v)
    parts = ("flash_bwd_dq_", "flash_bwd_dkv_")
    times = _kernel_us(lambda: flash_attention_bwd(q, k, v, out, lse, do), parts,
                       required=False)
    dq_ms, dkv_ms = (sum(us for name, (_, us) in times.items() if p in name) / 1e3 or None
                     for p in parts)
    route = _route(dtype)
    dq_blocks, dkv_blocks = _b8_blocks(route, b, s, h, hkv)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shown = [f"{t:.3f} ms" if t else "not measured (no device event recorded)"
             for t in (dq_ms, dkv_ms)]
    say("dense", f"flash_attention_bwd {label} B={b} S={s} H={h}/{hkv} {str(dtype)[6:]} "
        f"({route}), one call profiled: dq kernel {shown[0]} on {dq_blocks} blocks, "
        f"dk/dv kernel {shown[1]} on {dkv_blocks} blocks ({sms} SMs; each dk/dv block "
        f"walks the {h // hkv} query heads of its KV head)")
    return dict(dq_ms=dq_ms, dkv_ms=dkv_ms, dq_blocks=dq_blocks, dkv_blocks=dkv_blocks, sms=sms)


def _dense_kernel_checks():
    """(a): B7 at 1 x 32,768 for both head layouts on both routes; B8 at
    granite's group of 48, a microbatch of (e) (2 x 4,096), on both routes
    against its plain version per element, the bf16 call timed, both split
    into their dq and dk/dv launches."""
    import torch

    from repro_torch.configs import registry

    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {"b7": {}, "b8": {}}
    for name in (GRANITE, MISTRAL):
        cfg = registry.get(name)
        out["b7"][name] = {str(dtype)[6:]: _b7_long(gen, cfg, dtype)
                           for dtype in (torch.bfloat16, torch.float32)}
        torch.cuda.empty_cache()
    cfg = registry.get(GRANITE)
    b, s = DENSE_TRAIN[0] // TRAIN_MICRO, _seq("train_4k")
    shape = (b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    for dtype in (torch.bfloat16, torch.float32):
        label = f"{GRANITE} train, group of {cfg.n_heads // cfg.n_kv_heads}"
        row = _b8_case(gen, label, *shape, dtype, timed=dtype == torch.bfloat16,
                       repeat=True, tag="dense") or {}
        torch.cuda.empty_cache()
        row.update(_b8_split(gen, label, *shape, dtype))
        out["b8"][str(dtype)[6:]] = row
        torch.cuda.empty_cache()
    return out


def _seeded_caches(bundle, b, seq_len, seed):
    """A dense model's decode cache of ``b`` x ``seq_len`` (a window's ring
    slots under a sliding window), float32, every entry drawn from a seeded
    normal in numpy and carried to the card and to the host by
    ``interop.lm_cache_from_numpy``: (card, host)."""
    import numpy as np
    import torch

    from repro_torch import interop
    from repro_torch.models import cache_specs

    spec = cache_specs(bundle, b, seq_len, torch.float32)
    rng = np.random.default_rng(seed)
    leaves = [rng.standard_normal(tuple(t.shape), dtype=np.float32) for t in (spec.k, spec.v)]
    return tuple(interop.lm_cache_from_numpy(bundle.cfg, leaves, device=dev)
                 for dev in ("cuda", "cpu"))


def _decode_at_end(label, bundle, params, host, b, seq_len, seed):
    """(d): ``DENSE_DECODE_STEPS`` decode steps at ``seq_len``'s last
    positions from one seeded cache, on the card and on the host; each
    step's logits within 1e-4 of their largest entry on the host.  Returns
    the worst ratio."""
    import torch

    from repro_torch.data import synthetic

    card_cache, host_cache = _seeded_caches(bundle, b, seq_len, seed)
    tokens = synthetic.lm_token_stream(bundle.cfg.vocab_size, DENSE_DECODE_STEPS, b, seed=seed)
    first = seq_len - DENSE_DECODE_STEPS
    worst = 0.0
    for t in range(DENSE_DECODE_STEPS):
        tok = torch.as_tensor(tokens[:, t:t + 1])
        got, _ = bundle.decode(params, card_cache, tok.cuda(), first + t)
        want, _ = bundle.decode(host, host_cache, tok, first + t)
        rel = float((got.cpu() - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        check(bool(got.isfinite().all()) and rel <= 1e-4,
              f"{label}, decode at {first + t}: card {rel:.3e} of max|logits| from the host "
              "(bar 1e-4)")
    say("dense", f"{label}: {DENSE_DECODE_STEPS} decode steps at positions {first:,}-"
        f"{seq_len - 1:,}, B={b}, from a seeded cache of {card_cache.k.shape[2]:,} slots, card "
        f"vs host, worst max|d| / max|logits| {worst:.3e} (bar 1e-4)")
    return worst


class _KVLog:
    """Records the (k, v) each prefill ``attention_block`` call returns while
    active (``transformer.layer_fwd`` looks it up in its module at each
    call)."""

    def __enter__(self):
        from repro_torch.models import attention

        self.mod, self.orig, self.kv = attention, attention.attention_block, []

        def logged(*args, **kwargs):
            out, kv = self.orig(*args, **kwargs)
            self.kv.append(kv)
            return out, kv

        attention.attention_block = logged
        return self

    def __exit__(self, *exc):
        self.mod.attention_block = self.orig


def _ring_wrap(label, ring, params):
    """(d): the ring's wrap.  1 x (4,096 + 64) seeded tokens: the ring of
    4,096 slots filled with each layer's k and v from the windowed prefill
    of the first 4,096 (slot = position), then the other 64 decoded one by
    one, each writing slot ``pos % 4,096`` from slot 0 on; their logits
    against those of the windowed prefill (B7 with ``window=4,096``) of all
    4,160 at the reference's bar.  Returns the numbers."""
    import torch

    from repro_torch.data import synthetic
    from repro_torch.models import transformer

    cfg = ring.cfg
    w = cfg.sliding_window
    s = w + DENSE_RING_PAST
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, 1, seed=35),
                             device="cuda")
    _lm_zero()
    with torch.inference_mode():
        h = ring.forward(params, tokens)
        want = transformer.logits(params, cfg, h[:, w:]).double()
        with _KVLog() as log:
            ring.forward(params, tokens[:, :w])
    _lm_read(route="tf32x3", flash_attention=2 * cfg.n_layers)
    cache = ring.init_cache(1, s, torch.float32, device="cuda")
    check(cache.k.shape[2] == w and len(log.kv) == cfg.n_layers,
          f"{label}: a ring of {cache.k.shape[2]} slots, {len(log.kv)} layers logged")
    for i, (k, v) in enumerate(log.kv):
        cache.k[i].copy_(k)
        cache.v[i].copy_(v)
    _lm_zero()
    got = []
    for t in range(w, s):
        logits, cache = ring.decode(params, cache, tokens[:, t:t + 1], t)
        got.append(logits[:, 0])
    got = torch.stack(got, 1).double()
    _lm_read(route="tf32x3")
    d = (got - want).abs()
    share = float((d / (DECODE_ATOL + DECODE_RTOL * want.abs())).max())
    check(bool(got.isfinite().all()) and share <= 1.0,
          f"{label}: the ring's decode past slot {w} is {float(d.max()):.3e} from the "
          f"windowed prefill ({share:.3f} of the bar)")
    say("dense", f"{label}: a ring of {w} slots filled from the windowed prefill of {w} "
        f"tokens, then {DENSE_RING_PAST} decode steps at positions {w}-{s - 1} (slots 0-"
        f"{DENSE_RING_PAST - 1}) against the windowed prefill of all {s} (B7 window={w}): "
        f"max|d| {float(d.max()):.3e} (max|logits| {float(want.abs().max()):.3e}), "
        f"{share:.4f} of the bar (atol {DECODE_ATOL} + rtol {DECODE_RTOL})")
    return dict(tokens=s, slots=w, max_abs_err=float(d.max()), bar_used=share)


def _dense_cut_checks(name, seed):
    """(b) and (d) at the 2-layer cut, full width, float32: the forward and
    the last-token logits card against host (1e-4 of their max); granite's
    decode against its prefill (its full-width float32 weights, 112.7 GB, do
    not fit); the decode_32k and long_500k decode steps card against host;
    the ring's wrap; then the loss and every gradient leaf of 1 x 256 tokens
    card against host (``_grad_agree``, as phase 23's)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import registry
    from repro_torch.models import get_bundle

    cfg, bundle, params = _lm_params(name, torch.float32, seed=seed, n_layers=DENSE_CUT)
    host = pytree.tree_map(lambda t: t.cpu(), params)
    out = {}
    b, s = DENSE_AGREE
    batch = _family_batch(cfg, b, s, seed)
    host_batch = {"tokens": batch["tokens"].cpu()}
    _lm_zero()
    h_card, logits_card = (bundle.forward(params, batch["tokens"]).cpu(),
                           bundle.prefill(params, batch).cpu())
    _lm_read(route="tf32x3", flash_attention=2 * cfg.n_layers)
    t0 = time.perf_counter()
    h_host, logits_host = (bundle.forward(host, host_batch["tokens"]),
                           bundle.prefill(host, host_batch))
    host_s = time.perf_counter() - t0
    (err_h, scale_h), (err_l, scale_l) = (
        _agree(f"{name} cut, hidden states card vs host", h_card, h_host, 1e-4),
        _agree(f"{name} cut, last-token logits card vs host", logits_card, logits_host, 1e-4))
    say("dense", f"{name} cut to {cfg.n_layers} layers, float32, {b} x {s} tokens, card vs host: "
        f"max|d| h {err_h:.3e} ({err_h / (1e-4 * scale_h):.4f} of 1e-4 * max|h|), last-token "
        f"logits {err_l:.3e} ({err_l / (1e-4 * scale_l):.4f} of 1e-4 * max|logits|); host "
        f"forward and prefill {host_s:.1f} s, ok")
    out["forward"] = dict(max_abs_err_h=err_h, max_abs_h=scale_h, max_abs_err_logits=err_l,
                          max_abs_logits=scale_l)
    if name == GRANITE:
        out["vs_prefill"], _ = _decode_vs_prefill(
            f"{name} cut to {cfg.n_layers} layers (d)", bundle, params, DECODE_S, seed,
            dict(flash_attention=cfg.n_layers))
    out["decode_32k"] = _decode_at_end(f"{name} cut, decode_32k", bundle, params, host, 1,
                                       _seq("decode_32k"), seed)
    ring = get_bundle(registry.for_shape(cfg, registry.SHAPES["long_500k"]))
    out["long_500k"] = _decode_at_end(f"{name} cut, long_500k (window "
                                      f"{ring.cfg.sliding_window})", ring, params, host, 1,
                                      _seq("long_500k"), seed + 1)
    out["ring_wrap"] = _ring_wrap(f"{name} cut, long_500k's ring", ring, params)
    del params, host
    _free()
    out["gradients"] = _grad_agree(name, seed + 2, {"n_layers": DENSE_CUT}, DENSE_AGREE[1],
                                   tag="dense")
    return out


def _split_profile(label, run, attempts=3):
    """One profiled run: its wall time and the device time of B7, of
    cuBLAS's GEMM kernels and of the rest.  A profile that recorded no B7
    kernel is taken again with the next of ``PROFILE_PADS_S``
    (``_profile_padded``), ``attempts`` times in all, and after that the
    split is "not measured" (None).  Returns what ``run`` returns and the
    times."""
    import torch

    for pad in PROFILE_PADS_S[:attempts]:
        prof, out, wall = _profile_padded(run, pad)
        averages = prof.key_averages()
        key = _device_time_key(averages)
        kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key != "Command Buffer Full"]
        b7 = sum(getattr(e, key) for e in kernels if "flash_fwd_" in e.key)
        if b7 > 0:
            break
    if b7 == 0:
        say("profile", f"{label}: wall {wall * 1e3:.1f} ms; device split not measured (no B7 "
            f"kernel recorded in {attempts} profiles)")
        return out, {"wall_ms": wall * 1e3, "busy_ms": None, "B7 ms": None,
                     "GEMM (cuBLAS) ms": None, "rest ms": None}
    total = sum(getattr(e, key) for e in kernels)
    gemm = sum(getattr(e, key) for e in kernels
               if any(p in e.key for p in ("gemm", "xmma", "nvjet", "cutlass")))
    parts = {"B7": b7, "GEMM (cuBLAS)": gemm, "rest": total - b7 - gemm}
    say("profile", f"{label}: wall {wall * 1e3:.1f} ms, device busy {total / 1e3:.1f} ms "
        f"({100 * total / 1e6 / wall:.1f} %); device time: "
        + ", ".join(f"{k} {t / 1e3:.1f} ms ({100 * t / max(total, 1):.1f} %)"
                    for k, t in parts.items()))
    return out, dict(wall_ms=wall * 1e3, busy_ms=total / 1e3,
                     **{f"{k} ms": t / 1e3 for k, t in parts.items()})


def _dense_prefill(name, cfg, bundle, params):
    """(c): prefill_32k at full width and depth, bf16, its batch of 32 cut to
    1: one prefill under the profiler (B7 against the GEMMs against the
    rest; a device-only trace cost 0.4 % of the wall time in a chip run,
    8,336.5 against 8,300.7 ms untraced): B7 once a layer on ``"wgmma"``,
    finite logits [1, 1, V], tokens/s, peak memory.  Returns the launches
    and numbers."""
    import torch

    s = _seq("prefill_32k")
    batch = _family_batch(cfg, 1, s, seed=12)
    torch.cuda.reset_peak_memory_stats()

    def prefill():
        _lm_zero()  # the launches of the profile taken
        return bundle.prefill(params, batch)

    logits, profile = _split_profile(f"{name} bf16 prefill 1 x {s:,}", prefill)
    ms = profile["wall_ms"]
    launches = _lm_read(flash_attention=cfg.n_layers)
    check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{name} prefill_32k logits: shape {tuple(logits.shape)} or not finite")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say("dense", f"{name} bf16 prefill_32k, B=1 (of 32) x {s:,} tokens, {cfg.n_layers} layers: "
        f"{ms:.1f} ms ({s / ms * 1e3:.0f} tokens/s), launches {launches} (all wgmma), logits "
        f"finite; peak {peak:.1f} GiB")
    return launches, dict(ms=ms, tokens_per_s=s / ms * 1e3, b=1, s=s, peak_gib=peak,
                          profile=profile)


def _dense_decode_speed(label, bundle, params, b, seq_len, seed):
    """(d): bf16 decode at full width against a cache of ``b`` x
    ``seq_len`` (a ring of the window's slots under a sliding window) filled
    from a seeded generator: one warm-up step, then ``DENSE_DECODE_STEPS``
    steps at the last positions timed on the host clock (ending in a
    synchronize); no kernel launch, finite logits.  Returns the numbers."""
    import torch

    from repro_torch.data import synthetic

    cfg = bundle.cfg
    cache = bundle.init_cache(b, seq_len, torch.bfloat16, device="cuda")
    slots = cache.k.shape[2]
    want = min(seq_len, cfg.sliding_window or seq_len)
    check(slots == want, f"{label}: init_cache({b}, {seq_len:,}) holds {slots:,} slots, "
          f"expected {want:,}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for t in (cache.k, cache.v):
        for layer in t:
            layer.normal_(generator=gen)
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, DENSE_DECODE_STEPS + 1,
                                                       b, seed=seed), device="cuda")
    first = seq_len - DENSE_DECODE_STEPS
    _lm_zero()
    bundle.decode(params, cache, tokens[:, :1], first - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DENSE_DECODE_STEPS):
        logits, cache = bundle.decode(params, cache, tokens[:, t + 1:t + 2], first + t)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DENSE_DECODE_STEPS * 1e3
    _lm_read()
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{label}: logits {tuple(logits.shape)} or not finite")
    cache_gib = 2 * cache.k.numel() * cache.k.element_size() / 2**30
    say("dense", f"{label}: bf16, B={b}, a cache of {slots:,} slots ({cache_gib:.2f} GiB) at "
        f"positions {first:,}-{seq_len - 1:,}: {ms:.2f} ms/token ({b / ms * 1e3:.1f} tokens/s), "
        "logits finite, no kernel launch")
    return dict(b=b, slots=slots, cache_gib=cache_gib, ms_per_token=ms,
                tokens_per_s=b / ms * 1e3)


def _dense_mistral_cli() -> dict:
    """(f): the serve CLI's LM mode for mistral-nemo-12b, float32, its
    defaults (B = 4, 32 prompt + 16 generated tokens), as a process."""
    lines = _finish_cli_runs(_start_cli_runs([["--arch", MISTRAL]]))[f"--arch {MISTRAL}"]
    m = re.fullmatch(r"prefill (\S+)s; decode (\S+) ms/token", lines[2]) \
        if len(lines) == 4 else None
    check(m is not None, f"serve CLI --arch {MISTRAL}: printed {lines}")
    say("dense", f"serve CLI --arch {MISTRAL} (float32, 49.0 GB of weights, B=4): decode "
        f"{m.group(2)} ms/token; --arch {GRANITE}'s float32 weights (112.7 GB) do not fit one "
        "card: its CLI runs --reduced on the host (tests/test_torch_serve_cli.py)")
    return dict(lines=lines, prefill_s=float(m.group(1)), decode_ms_per_token=float(m.group(2)))


def phase_dense_variants(card) -> dict:
    """Phase 25 (see the module docstring).  Returns the phase's numbers."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import get_bundle

    t_phase = time.perf_counter()
    _free()
    say("dense", f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held by earlier phases")
    out = {"cli": _dense_mistral_cli()}
    t_cli = time.perf_counter()
    out.update(_dense_kernel_checks())
    say("dense", f"(f) took {t_cli - t_phase:.1f} s, (a) {time.perf_counter() - t_cli:.1f} s")
    launches = {"prefill_32k": {}, "train": {}}
    for name, seed in ((GRANITE, 81), (MISTRAL, 85)):
        t0 = time.perf_counter()
        row = {}
        if name == MISTRAL:  # (d) decode against prefill at full width, float32 (49.0 GB)
            cfg, bundle, params = _lm_params(name, torch.float32, seed=seed)
            row["vs_prefill"], _ = _decode_vs_prefill(
                f"{name} (d)", bundle, params, DECODE_S, seed, dict(flash_attention=cfg.n_layers))
            del params
            _free()
        row["cut"] = _dense_cut_checks(name, seed)
        cfg, bundle, params = _lm_params(name, torch.bfloat16, seed=seed + 3)
        launches["prefill_32k"][name], row["prefill_32k"] = _dense_prefill(name, cfg, bundle,
                                                                           params)
        row["decode_32k"] = _dense_decode_speed(f"{name} decode_32k", bundle, params,
                                                DENSE_DECODE_B[name], _seq("decode_32k"), seed)
        ring = get_bundle(registry.for_shape(cfg, registry.SHAPES["long_500k"]))
        row["long_500k"] = _dense_decode_speed(
            f"{name} long_500k (window {ring.cfg.sliding_window})", ring, params,
            registry.SHAPES["long_500k"].global_batch, _seq("long_500k"), seed + 1)
        del params
        _free()
        launches["train"][name], row["train"] = _train_steps(
            name, card, DENSE_TRAIN[0], _seq("train_4k"), {"n_layers": DENSE_CUT}, seed=seed + 4,
            tag="dense", steps=DENSE_TRAIN[1], lr=DENSE_TRAIN_LR)[-2:]
        _free()
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        say("dense", f"{name} took {row['seconds']:.1f} s")
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    say("dense", f"phase 25 took {out['seconds']:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# 23. the encoder-decoder and the training of the VLM, MoE and
# encoder-decoder families: B7 and B8 without the causal mask, B8 at MLA's
# (192, 128), whisper-tiny's encode, decode and serve CLI, gradients card
# against host, bf16 train steps
# ---------------------------------------------------------------------------

WHISPER = "whisper-tiny"
ENC_B, ENC_S, ENC_H, ENC_D = 16, 1_500, 6, 64   # whisper-tiny's encoder attention
ENC_TRAIN_B = 8                                  # its backward: a microbatch of (e)'s 16
WHISPER_PREFILL = (16, 448)                      # 1,500 frames + 448 decoder tokens
MLA_BWD_B, MLA_BWD_S = 2, 2_048
# (e): (batch, text tokens, config changes) of each family's bf16 train steps;
# qwen2-moe cut to the layers that fit with its AdamW moments (~16 bytes a
# parameter), deepseek-v2 to its dense layer (one MoE layer adds 3.97e9)
FAMILY_TRAIN = {WHISPER: (16, 448, {}), INTERNVL: (4, 1_792, {}),
                QWEN2_MOE: (4, 2_048, {"n_layers": 4}), DSV2: (4, 2_048, {"n_layers": 1})}
# (d): (config changes, text tokens) of each family's gradient check
FAMILY_GRAD = {WHISPER: ({}, 64), INTERNVL: ({"n_layers": 2}, 256),
               QWEN2_MOE: ({"n_layers": 2}, 256), DSV2: ({"n_layers": 2}, 256)}
WHISPER_TRAIN_CLI = ["--arch", WHISPER, "--steps", "3", "--batch", "4", "--seq", "448",
                     "--microbatches", "2", "--dtype", "bfloat16"]


def _attn_layers(cfg) -> int:
    """Attention layers of a model: B7 launches of a forward, B8 of a backward."""
    return cfg.n_layers + (cfg.n_encoder_layers if cfg.family == "encdec" else 0)


def _encoder_fwd_checks():
    """(a): B7 with ``causal=False`` against its plain version at whisper's
    encoder shape and a ragged S, both routes, each repeat bit-identical;
    the encoder shape timed beside its bound and SDPA."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = {}
    for label, b, s, dtype, timed in (("encoder", ENC_B, ENC_S, torch.bfloat16, True),
                                      ("encoder float32", ENC_B, ENC_S, torch.float32, True),
                                      ("ragged S", 2, 1_000, torch.bfloat16, False),
                                      ("ragged S float32", 2, 1_000, torch.float32, False)):
        row = _b7_case(gen, label, b, s, ENC_H, ENC_D, dtype, causal=False, timed=timed,
                       tag="encdec")
        if row:
            rows[_route(dtype)] = row
        torch.cuda.empty_cache()
    return rows


def _new_bwd_checks():
    """(b): B8 with ``causal=False`` at whisper's encoder training shape
    (``ENC_TRAIN_B`` x 1,500) and B8 at
    MLA's (192, 128) (128 heads, causal, 2 x 2,048 and a ragged S = 1,000),
    both routes, against the plain version per element, each repeat
    bit-identical; the path shapes timed beside their bounds and SDPA's
    backward; ptxas's registers and spills of the (192, 128)
    instantiations."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(231)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {"encoder": {}, "mla": {}}
    cases = [
        ("encoder", "encoder", ENC_TRAIN_B, ENC_S, ENC_H, ENC_D, ENC_D, False, bf16, True),
        ("encoder", "encoder float32", ENC_TRAIN_B, ENC_S, ENC_H, ENC_D, ENC_D, False, f32,
         True),
        ("mla", "MLA train", MLA_BWD_B, MLA_BWD_S, MLA_HEADS, MLA_D, MLA_DV, True, bf16, True),
        ("mla", "MLA train float32", MLA_BWD_B, MLA_BWD_S, MLA_HEADS, MLA_D, MLA_DV, True, f32,
         True),
        ("mla", "MLA ragged S", 1, 1_000, MLA_HEADS, MLA_D, MLA_DV, True, bf16, False),
        ("mla", "MLA ragged S float32", 1, 1_000, MLA_HEADS, MLA_D, MLA_DV, True, f32, False),
    ]
    for group, label, b, s, h, d, d_v, causal, dtype, timed in cases:
        row = _b8_case(gen, label, b, s, h, h, d, dtype, d_v=d_v, causal=causal, timed=timed,
                       repeat=True, tag="encdec")
        if row:
            rows[group][_route(dtype)] = row
        torch.cuda.empty_cache()
    regs = {}
    for kernel, args in (("flash_bwd_dq_wgmma_kernel", "192,128"),
                         ("flash_bwd_dkv_wgmma_kernel", "192,128,1,0"),
                         ("flash_bwd_dkv_wgmma_kernel", "192,128,0,1"),
                         ("flash_bwd_dq_tf32x3_kernel", "192,128"),
                         ("flash_bwd_dkv_tf32x3_kernel", "192,128,1,0"),
                         ("flash_bwd_dkv_tf32x3_kernel", "192,128,0,1")):
        got = _ptxas("flash_attention_bwd", kernel).get(args)
        check(got is not None, f"no ptxas line for {kernel}<{args}>")
        regs[f"{kernel}<{args}>"] = dict(registers=got[0], spill_stores=got[1],
                                         spill_loads=got[2])
        say("encdec", f"ptxas {kernel}<{args}>: {got[0]} registers, spill stores {got[1]} B, "
            f"spill loads {got[2]} B")
    rows["mla"]["ptxas"] = regs
    return rows


def _frames(cfg, b, seed, dtype, device="cuda"):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, cfg.encoder_seq, cfg.d_model), generator=gen,
                       device=device).to(dtype)


def _whisper_checks(card) -> dict:
    """(c): whisper-tiny at full width and depth: the encoder states and the
    prefill's logits card against host (float32, 1e-4 of max), 2 x 64
    tokens teacher-forced through ``bundle.decode`` against the prefill at
    the reference's bar, and a bf16 prefill of 16 x (1,500 frames + 448
    tokens) after a warm-up."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.data import synthetic
    from repro_torch.models import encdec

    out = {}
    cfg, bundle, params = _lm_params(WHISPER, torch.float32, seed=61)
    frames = _frames(cfg, DECODE_B, 62, torch.float32)
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, DECODE_S, DECODE_B,
                                                       seed=63), device="cuda")
    _lm_zero()
    with torch.inference_mode():
        enc = encdec.encode(params, cfg, frames)
    pf = bundle.prefill(params, {"tokens": tokens, "frames": frames})
    torch.cuda.synchronize()
    _lm_read(route="tf32x3", flash_attention=cfg.n_encoder_layers + _attn_layers(cfg))
    host = pytree.tree_map(lambda t: t.cpu(), params)
    with torch.inference_mode():
        enc_host = encdec.encode(host, cfg, frames.cpu())
    pf_host = bundle.prefill(host, {"tokens": tokens.cpu(), "frames": frames.cpu()})
    del host
    err_enc, scale_enc = _agree("whisper encoder states card vs host", enc.cpu(), enc_host, 1e-4)
    err_pf, scale_pf = _agree("whisper prefill logits card vs host", pf.cpu(), pf_host, 1e-4)
    out["card_vs_host"] = dict(enc_max_abs_err=err_enc, enc_max_abs=scale_enc,
                               logits_max_abs_err=err_pf, logits_max_abs=scale_pf)
    say("encdec", f"{WHISPER} float32 B={DECODE_B} x ({cfg.encoder_seq} frames + {DECODE_S} "
        f"tokens): encoder states card vs host max|d| {err_enc:.3e} (max {scale_enc:.3e}, "
        f"{err_enc / (1e-4 * scale_enc):.4f} of the bar 1e-4), prefill logits {err_pf:.3e} (max "
        f"{scale_pf:.3e}, {err_pf / (1e-4 * scale_pf):.4f} of it), ok")

    _lm_zero()
    with torch.inference_mode():
        cache = encdec.init_cache(params, cfg, enc, DECODE_S, torch.float32)
    logits = None
    for t in range(DECODE_S):
        logits, cache = bundle.decode(params, cache, tokens[:, t:t + 1], t)
    torch.cuda.synchronize()
    _lm_read(route="tf32x3")
    got, ref = logits[:, 0].double(), pf[:, 0].double()
    d = (got - ref).abs()
    share = float((d / (DECODE_ATOL + DECODE_RTOL * ref.abs())).max())
    check(bool(got.isfinite().all()) and share <= 1.0,
          f"{WHISPER}: decode's last logits {float(d.max()):.3e} from the prefill's, {share:.3f} "
          "of the bar")
    out["vs_prefill"] = dict(max_abs_err=float(d.max()), max_abs_logits=float(ref.abs().max()),
                             bar_used=share)
    say("encdec", f"{WHISPER}: {DECODE_B} x {DECODE_S} tokens teacher-forced through decode vs "
        f"the prefill: max|d| {float(d.max()):.3e}, {share:.4f} of the bar (atol {DECODE_ATOL} "
        f"+ rtol {DECODE_RTOL}); decode launches none, ok")
    del params, cache, enc
    _free()

    cfg, bundle, params = _lm_params(WHISPER, torch.bfloat16, seed=64)
    b, s = WHISPER_PREFILL
    batch = {"tokens": torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, b, seed=65),
                                       device="cuda"),
             "frames": _frames(cfg, b, 66, torch.bfloat16)}
    bundle.prefill(params, batch)
    torch.cuda.synchronize()
    _lm_zero()
    t0 = time.perf_counter()
    logits = bundle.prefill(params, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _lm_read(flash_attention=_attn_layers(cfg))
    check(tuple(logits.shape) == (b, 1, cfg.vocab_size) and bool(logits.isfinite().all()),
          f"{WHISPER} bf16 prefill logits: shape {tuple(logits.shape)} or not finite")
    out["prefill"] = dict(ms=ms, b=b, frames=cfg.encoder_seq, tokens=s,
                          tokens_per_s=b * s / ms * 1e3,
                          frames_per_s=b * cfg.encoder_seq / ms * 1e3, launches=launches)
    say("encdec", f"{WHISPER} bf16 prefill B={b} x ({cfg.encoder_seq} frames + {s} tokens): "
        f"{ms:.1f} ms ({b * s / ms * 1e3:.0f} decoder tokens/s, "
        f"{b * cfg.encoder_seq / ms * 1e3:.0f} frames/s), B7 {launches['flash_attention']} "
        f"launches (all wgmma), logits finite, on {card}")
    del params, batch
    _free()
    return out


def _family_grad_batch(cfg, s, seed):
    """A gradient check's batch: 1 x ``s`` tokens (the encoder-decoder's
    after 1,500 float32 frames, the VLM's after its patches)."""
    if cfg.family == "encdec":
        import torch

        from repro_torch.data import synthetic

        tokens = synthetic.lm_token_stream(cfg.vocab_size, s, 1, seed=seed)
        return {"tokens": torch.as_tensor(tokens, device="cuda"),
                "frames": _frames(cfg, 1, seed, torch.float32)}
    return _family_batch(cfg, 1, s, seed)


def _loss_and_grads(bundle, params, batch):
    """(loss, gradients as a tree on the host, the forward's route log)."""
    import torch
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    with _RouteLog() as log:
        loss = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), pytree.tree_unflatten([g.cpu() for g in grads], spec), log


def _grad_agree(name, seed, changes, s, tag="encdec"):
    """``bundle.loss`` and every gradient leaf of ``name`` cut by
    ``changes``, float32, 1 x ``s`` tokens, card (``_loss_launches``: B7
    twice an attention layer with the remat, B8 once, FP32 route; B9/B10
    and their backward kernels) against host: MoE dispatch compared first
    (a near tie reruns with the next seed), the loss within 1e-5 of itself,
    each leaf within 1e-4 of its largest entry."""
    import torch
    from torch.utils import _pytree as pytree

    cfg, bundle, params = _lm_params(name, torch.float32, seed=seed, **changes)
    for attempt in range(3):
        batch = _family_grad_batch(cfg, s, seed + attempt)
        _lm_zero()
        t0 = time.perf_counter()
        loss_card, g_card, log_card = _loss_and_grads(bundle, params, batch)
        card_s = time.perf_counter() - t0
        launches = _lm_read(route="tf32x3", **_loss_launches(cfg))
        host = pytree.tree_map(lambda t: t.detach().cpu(), params)
        t0 = time.perf_counter()
        loss_host, g_host, log_host = _loss_and_grads(
            bundle, host, {k: v.cpu() for k, v in batch.items()})
        host_s = time.perf_counter() - t0
        del host
        tie = (_dispatch_agree(cfg.name, log_card.calls, log_host.calls, cfg.top_k)
               if cfg.family == "moe" else None)
        if tie is None:
            break
        say(tag, f"{cfg.name} gradients, seed {seed + attempt}: {tie}; rerun with the next "
            "seed")
        del g_card, g_host
    else:
        check(False, f"{cfg.name}: near ties in three seeds running")
    check(abs(loss_card - loss_host) <= 1e-5 * abs(loss_host),
          f"{cfg.name} loss: card {loss_card:.7f}, host {loss_host:.7f}")
    worst = 0.0
    for (path, gc), gh in zip(pytree.tree_flatten_with_path(g_card)[0],
                              pytree.tree_leaves(g_host)):
        scale = float(gh.abs().max())
        err = float((gc - gh).abs().max())
        leaf = pytree.keystr(path)
        check(scale > 0 and bool(gc.isfinite().all()), f"{cfg.name} gradient {leaf}: zero or "
              "not finite")
        check(err <= 1e-4 * scale, f"{cfg.name} gradient {leaf}: max|d| {err:.3e} > 1e-4 * "
              f"{scale:.3e}")
        worst = max(worst, err / scale)
    routed = len(log_card.calls)
    enc = f" + {cfg.n_encoder_layers} encoder" if cfg.family == "encdec" else ""
    say(tag, f"{cfg.name} ({cfg.n_layers} layers{enc}), float32, 1 x {s} tokens: loss card "
        f"{loss_card:.6f}, host {loss_host:.6f}; "
        f"{len(pytree.tree_leaves(g_host))} gradient leaves, worst max|d| / max|g| {worst:.2e} "
        f"(bar 1e-4); dispatch of {routed} MoE layers equal; launches {launches}; card "
        f"{card_s * 1e3:.0f} ms, host {host_s:.1f} s, ok")
    del params, g_card, g_host
    _free()
    return dict(loss_card=loss_card, loss_host=loss_host, worst_leaf_ratio=worst,
                moe_layers_routed=routed, launches=launches, seed=seed + attempt)


def _train_batch(cfg, b, s, seed):
    """(e)'s batch: seeded tokens [b, s], the VLM's float32 patches, the
    encoder-decoder's frames in bf16 (the parameters' dtype)."""
    import torch

    if cfg.family == "encdec":
        from repro_torch.data import synthetic

        tokens = synthetic.lm_token_stream(cfg.vocab_size, s, b, seed=seed)
        return {"tokens": torch.as_tensor(tokens, device="cuda"),
                "frames": _frames(cfg, b, seed, torch.bfloat16)}
    return _family_batch(cfg, b, s, seed)


def _family_train(name, card):
    """(e): ``_train_steps`` of ``name`` at its FAMILY_TRAIN shape and cut;
    the model is freed after.  Returns the launch counts and the numbers."""
    b, s, changes = FAMILY_TRAIN[name]
    *_, launches, numbers = _train_steps(name, card, b, s, changes, seed=70, tag="encdec")
    _free()
    return launches, numbers


def phase_encdec_training(card) -> dict:
    """Phase 23 (see the module docstring).  Returns the phase's numbers."""
    t_phase = time.perf_counter()
    _free()
    lines = _finish_cli_runs(_start_cli_runs([["--arch", WHISPER]]))[f"--arch {WHISPER}"]
    m = re.fullmatch(r"prefill (\S+)s; decode (\S+) ms/token", lines[2]) \
        if len(lines) == 4 else None
    check(m is not None, f"serve CLI --arch {WHISPER}: printed {lines}")
    out = {"cli": dict(lines=lines, prefill_s=float(m.group(1)),
                       decode_ms_per_token=float(m.group(2)))}
    say("encdec", f"serve CLI --arch {WHISPER} (float32, B=4): decode {m.group(2)} ms/token")
    out["b7_causal_false"] = _encoder_fwd_checks()
    out["b8"] = _new_bwd_checks()
    t_kernels = time.perf_counter()
    out[WHISPER] = _whisper_checks(card)
    t_whisper = time.perf_counter()
    out["gradients"] = {name: _grad_agree(name, seed, *FAMILY_GRAD[name]) for name, seed in
                        ((WHISPER, 71), (INTERNVL, 72), (QWEN2_MOE, 73), (DSV2, 74))}
    t_grad = time.perf_counter()
    launches, out["train"] = {}, {}
    for name in FAMILY_TRAIN:
        launches[name], out["train"][name] = _family_train(name, card)
    out["train_cli"] = _train_cli(WHISPER_TRAIN_CLI, WHISPER, 3, 2, "encdec")
    out["launches"] = launches
    say("encdec", f"the CLI, (a) and (b) took {t_kernels - t_phase:.1f} s, (c) "
        f"{t_whisper - t_kernels:.1f} s, (d) {t_grad - t_whisper:.1f} s, (e) "
        f"{time.perf_counter() - t_grad:.1f} s; phase 23 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# 24. training of the SSM and hybrid families: B10's and B9's backward
# kernels against their plain versions, gradients card against host, bf16
# train steps, the training CLI
# ---------------------------------------------------------------------------

# (c): (batch, tokens, config changes) of each family's bf16 train steps;
# recurrentgemma-9b cut to one (rec, rec, attn) period and its 2-block tail
# (~2.2e9 parameters, ~35 GB with AdamW's moments: the whole 9.4e9 does not
# fit one card)
SSM_TRAIN = {MAMBA2: (4, 2_048, {}), RGEMMA: (4, 2_048, {"n_layers": 5})}
# (b): the config changes of each family's gradient check, 1 x 512 tokens
SSM_GRAD = {MAMBA2: {"n_layers": 2}, RGEMMA: {"n_layers": 3}}
MAMBA2_TRAIN_CLI = ["--arch", MAMBA2, "--steps", "3", "--batch", "4", "--seq", "2048",
                    "--microbatches", "2", "--dtype", "bfloat16"]
# device-time groups of a profiled train step, by kernel-name fragment
SSM_PROFILE_GROUPS = {
    "B10 backward": ("bc_image_kernel", "score_pairs_kernel", "state_sums_kernel",
                     "state_passes_kernel", "keys_dx_kernel", "keys_db_kernel",
                     "queries_dc_kernel", "finish_kernel", "group_sum_kernel"),
    "B10 forward": ("bt_kernel", "chunk_state_kernel", "state_pass_kernel", "scores_kernel",
                    "chunk_out_kernel"),
    "B9 backward": ("rglru_bwd_kernel", "dlam_kernel"),
    "B9 forward": ("rglru_scan_kernel",),
    "B7": ("flash_fwd_",),
    "B8": ("flash_bwd_",),
    "GEMM (cuBLAS)": ("gemm", "xmma", "nvjet", "cutlass"),
}


def _ssd_bwd_work(b, s, h, p, g, n, chunk):
    """B10's backward: per (b·h, chunk) five [P, N] products over the chunk
    (the state contributions, E_c, D·B, Dᵀ·xdt, h_prevᵀ·dy: 5·Q·P·N
    multiply-adds), per causal (q, k) pair dy·xdt and the dxdt, dB and dC
    terms (2P + 2N) and C·B once per group (N·G / H a head), 2 FLOPs a
    multiply-add; xdt, dy, la, B, C and dh_final read once, dxdt, dla, dB
    and dC written once, float32."""
    pairs = chunk * (chunk + 1) // 2
    per_chunk = 5 * chunk * p * n + pairs * (2 * p + 2 * n) + pairs * n * g / h
    flops = 2 * per_chunk * (s // chunk) * b * h
    nbytes = 4 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * g * n + b * h * p * n)
    return flops, nbytes


def _rglru_bwd_work(b, s, w, x_elem=4, gate_elem=4):
    """B9's backward: ~20 operations an element (exp, expm1, sqrt and the
    division counted as one each); x, r, i (in their dtypes), y and dy
    (float32) read once, dx, dr and di written once in their dtypes, lam
    and dh_last read and dlam written once."""
    return (20 * b * s * w,
            (2 * x_elem + 4 * gate_elem + 8) * b * s * w + 4 * (2 * w + b * w))


def _agree_mag(label, got, want, mags, rel=1e-5):
    """|got - want| <= rel * the element's term magnitude at every element
    (sums that cancel: their float32 error follows the size of the terms,
    tests/test_torch_ssm_training.py); returns max|d| and the largest share
    of its bar that any element used."""
    d = (got.double() - want.double()).abs()
    check(bool(got.isfinite().all()), f"{label}: not finite")
    used = float((d / (rel * mags.double()).clamp_min(1e-300)).max()) if d.numel() else 0.0
    check(used <= 1.0, f"{label}: an element's |d| is {used:.3f} of its bar {rel:g} * "
          "magnitude")
    return (float(d.max()) if d.numel() else 0.0), used


def _ssd_bwd_checks(card):
    """(a) B10's backward against ``ssd_chunk_bwd_plain`` on the card:
    mamba2-780m's microbatch (2 x 2,048, 48 heads of P 64, N 128, G 1, chunk
    256) and G = 2 at a ragged S (1,000, chunk 250), both with a nonzero
    h_final cotangent; S = 1 and B = 0 without; and the microbatch at
    mamba2's initial decays (la = -a·softplus(N(0, 1)), a = linspace(1, 16,
    H): cum reaches -10³ within a chunk).  dxdt, dB, dC to the script's rule
    (1e-4 of max|plain|), dla per element to 1e-5 of its term magnitude (its
    row and column sums cancel); a repeat bit-identical; a P of 65 refused
    before any launch.  The microbatch timed beside the plain version and
    the bound, and split into its launches (profiler).  Returns its row."""
    import torch

    from repro_torch.kernels.ssd_chunk import fit_chunk, ssd_chunk_bwd, ssd_chunk_bwd_plain
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_magnitudes

    gen = torch.Generator(device="cuda").manual_seed(24)
    row = None
    for label, b, s, h, p, g, n, chunk, final in (
            ("mamba2 train", 2, 2_048, 48, 64, 1, 128, 256, True),
            ("G = 2, S = 1,000 (chunk 250)", 2, 1_000, 8, 64, 2, 128, 256, True),
            ("S = 1", 1, 1, 48, 64, 1, 128, 256, False),
            ("B = 0", 0, 256, 48, 64, 1, 128, 256, False),
            ("mamba2 train, initial decays", 2, 2_048, 48, 64, 1, 128, 256, True)):
        xdt, dy = (torch.randn((b, s, h, p), generator=gen, device="cuda") for _ in range(2))
        if "decays" in label:
            la = -torch.linspace(1.0, 16.0, h, device="cuda") * torch.nn.functional.softplus(
                torch.randn((b, s, h), generator=gen, device="cuda"))
        else:
            la = -torch.rand((b, s, h), generator=gen, device="cuda") * 0.1
        bm, cm = (torch.randn((b, s, g, n), generator=gen, device="cuda") for _ in range(2))
        dh = torch.randn((b, h, p, n), generator=gen, device="cuda") if final else None
        args = (xdt, la, bm, cm, dy, dh)
        before = ssd_chunk_bwd.launches
        got = ssd_chunk_bwd(*args, chunk=chunk)
        torch.cuda.synchronize()
        check(ssd_chunk_bwd.launches == before + (b > 0), f"B10 backward {label}: launches")
        q = fit_chunk(s, chunk)
        want = ssd_chunk_bwd_plain(*args, chunk=q)
        errs, used = [], 0.0
        for name, gt, wt in zip(("dxdt", "db", "dc"), (got[0], *got[2:]), (want[0], *want[2:])):
            check(gt.shape == wt.shape and gt.dtype == torch.float32,
                  f"B10 backward {label} {name}: shape or dtype")
            if b:
                err, scale = _agree(f"B10 backward {label} {name}", gt, wt, 1e-4)
                errs.append(err)
                used = max(used, err / (1e-4 * scale))
        mags = ssd_chunk_bwd_magnitudes(*args, chunk=q)
        err_la, used_la = _agree_mag(f"B10 backward {label} dla", got[1], want[1], mags[1])
        again = ssd_chunk_bwd(*args, chunk=chunk)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"B10 backward {label}: a repeat is not bit-identical")
        say("kernel", f"ssd_chunk_bwd {label} B={b} S={s} H={h} P={p} G={g} N={n} Q={q}"
            f"{', h_final cotangent' if final else ''}: dxdt, db, dc max|d| "
            f"{max(errs, default=0.0):.3e} ({used:.4f} of 1e-4 * max|plain|), dla max|d| "
            f"{err_la:.3e} ({used_la:.4f} of 1e-5 * its term magnitude), repeat "
            "bit-identical, ok")
        if label == "mamba2 train":
            ms = cuda_ms(lambda: ssd_chunk_bwd(*args, chunk=chunk))
            plain_ms = cuda_ms(lambda: ssd_chunk_bwd_plain(*args, chunk=q), reps=5, warmup=1)
            work = _ssd_bwd_work(b, s, h, p, g, n, q)
            fp32_ms, _ = _bound(*work)
            bound_ms, bound_by = _bound(*work, PEAK_TF32X3_FLOPS)
            times = _kernel_us(lambda: ssd_chunk_bwd(*args, chunk=chunk),
                               SSM_PROFILE_GROUPS["B10 backward"])
            split = {k: us / 1e3 for k, (_, us) in times.items()}
            row = dict(shape=label, b=b, s=s, h=h, p=p, g=g, n=n, chunk=q,
                       max_abs_err=max(*errs, err_la), ms=ms, plain_ms=plain_ms,
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                       bound_fp32_ms=fp32_ms, bar_used=max(used, used_la), launch_ms=split)
            say("kernel", f"ssd_chunk_bwd {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms at 3xTF32 ({bound_by}, {work[0]:.4g} FLOP), "
                f"{fp32_ms:.4f} ms on FP32 cores; library none (no single PyTorch call "
                f"computes the SSD scan's backward); on {card}")
            say("kernel", f"ssd_chunk_bwd {label}, device time a call by launch (profiler): "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        del args, got, want, mags, again
    before = ssd_chunk_bwd.launches
    try:
        z = torch.zeros((1, 64, 2, 65), device="cuda")
        zb = torch.zeros((1, 64, 1, 32), device="cuda")
        ssd_chunk_bwd(z, torch.zeros((1, 64, 2), device="cuda"), zb, zb, z, chunk=64)
        check(False, "B10 backward: P = 65 was not refused")
    except ValueError as e:
        check("the kernel takes" in str(e) and ssd_chunk_bwd.launches == before,
              f"B10 backward: P = 65 refused as {e!r}")
    return row


def _rglru_bwd_checks(card):
    """(a) B9's backward against ``rglru_scan_bwd_plain`` on the forward
    kernel's y, with a nonzero h_last cotangent: recurrentgemma-9b's
    microbatch (2 x 2,048 x 4,096) with bf16 x and float32 gates (the bf16
    train step's) and all in float32, a ragged S = 37 at W = 100 all bf16,
    and S = 1.  dx, dr, di in their inputs' dtypes to the script's rule
    (bf16 outputs also one bf16 ulp of the element), dlam per element to
    1e-5 of its term magnitude (a sum over batch and time that cancels); one
    launch counted on x's dtype; a repeat bit-identical.  The microbatch
    timed in both dtypes beside the plain version and the bound.  Returns
    their rows."""
    import torch

    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd, rglru_scan_bwd_plain
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_magnitudes

    gen = torch.Generator(device="cuda").manual_seed(25)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []
    for label, b, s, w, x_dtype, g_dtype, timed in (
            ("recurrentgemma train", 2, 2_048, 4_096, bf16, f32, True),
            ("recurrentgemma train float32", 2, 2_048, 4_096, f32, f32, True),
            ("S = 37, W = 100 bf16", 2, 37, 100, bf16, bf16, False),
            ("S = 1", 3, 1, 4_096, f32, f32, False)):
        x = torch.randn((b, s, w), generator=gen, device="cuda").to(x_dtype)
        r, i = (torch.sigmoid(torch.randn((b, s, w), generator=gen, device="cuda")).to(g_dtype)
                for _ in range(2))
        lam = torch.randn((w,), generator=gen, device="cuda") + 4
        y, _ = rglru_scan(x, r, i, lam)
        dy = torch.randn((b, s, w), generator=gen, device="cuda")
        dh = torch.randn((b, w), generator=gen, device="cuda")
        args = (x, r, i, lam, y, dy, dh)
        route = str(x_dtype)[6:]
        before = (rglru_scan_bwd.launches, rglru_scan_bwd.route_launches[route])
        got = rglru_scan_bwd(*args)
        torch.cuda.synchronize()
        check((rglru_scan_bwd.launches, rglru_scan_bwd.route_launches[route])
              == (before[0] + 1, before[1] + 1), f"B9 backward {label}: launches by route")
        want = rglru_scan_bwd_plain(*args)
        errs, used = [], 0.0
        for name, gt, wt in zip(("dx", "dr", "di"), got, want):
            check(gt.dtype == wt.dtype and gt.shape == wt.shape,
                  f"B9 backward {label} {name}: dtype or shape")
            if gt.dtype == bf16:
                scale = float(wt.abs().max())
                err, share = _agree_each(f"B9 backward {label} {name}", gt, wt, 2.0**-7,
                                         1e-4 * scale)
            else:
                err, scale = _agree(f"B9 backward {label} {name}", gt, wt, 1e-4)
                share = err / (1e-4 * scale)
            errs.append(err)
            used = max(used, share)
        mags = rglru_scan_bwd_magnitudes(*args)
        err_lam, used_lam = _agree_mag(f"B9 backward {label} dlam", got[3], want[3], mags[3])
        again = rglru_scan_bwd(*args)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"B9 backward {label}: a repeat is not bit-identical")
        name = f"x {route}, gates {str(g_dtype)[6:]}"
        say("kernel", f"rglru_scan_bwd {label} B={b} S={s} W={w} {name}: dx, dr, di max|d| "
            f"{max(errs):.3e} ({used:.4f} of their bars), dlam max|d| {err_lam:.3e} "
            f"({used_lam:.4f} of 1e-5 * its term magnitude), repeat bit-identical, ok")
        if timed:
            ms = cuda_ms(lambda: rglru_scan_bwd(*args))
            plain_ms = cuda_ms(lambda: rglru_scan_bwd_plain(*args), reps=5, warmup=1)
            bound_ms, bound_by = _bound(*_rglru_bwd_work(b, s, w, x.element_size(),
                                                         r.element_size()))
            rows.append(dict(shape=label, b=b, s=s, w=w, dtypes=name,
                             max_abs_err=max(*errs, err_lam), ms=ms, plain_ms=plain_ms,
                             library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                             bar_used=max(used, used_lam)))
            say("kernel", f"rglru_scan_bwd {label} ({name}): kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); library none (no "
                f"single PyTorch call computes the recurrence's backward); on {card}")
        del args, got, want, mags, again
    return rows


def _profile_train_step(name, step_fn, params, state, batch):
    """One more train step under the profiler: wall time, device-busy time
    and the device time of ``SSM_PROFILE_GROUPS``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
           else "self_cuda_time_total")
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, key) for e in kernels)
    grouped = {e.key: grp for e in kernels for grp, pats in SSM_PROFILE_GROUPS.items()
               if any(p in e.key for p in pats)}
    shares = {grp: sum(getattr(e, key) for e in kernels if grouped.get(e.key) == grp) / 1e3
              for grp in SSM_PROFILE_GROUPS}
    shares = {grp: t for grp, t in shares.items() if t}
    rest = sorted((e for e in kernels if e.key not in grouped), key=lambda e: -getattr(e, key))
    shares["the rest"] = sum(getattr(e, key) for e in rest) / 1e3
    say("profile", f"{name} train step: wall {wall * 1e3:.0f} ms, device busy "
        f"{total / 1e3:.0f} ms ({100 * total / 1e6 / wall:.1f} %); device time: "
        + ", ".join(f"{grp} {t:.1f} ms ({100 * t * 1e3 / max(total, 1):.1f} %)"
                    for grp, t in shares.items())
        + "; the rest's largest: " + ", ".join(f"{e.key[:60]} {getattr(e, key) / 1e3:.1f} ms"
                                                for e in rest[:4]))
    return dict(wall_ms=wall * 1e3, device_busy_ms=total / 1e3, shares_ms=shares,
                rest_largest_ms={e.key[:60]: getattr(e, key) / 1e3 for e in rest[:4]})


def phase_ssm_training(card) -> dict:
    """Phase 24 (see the module docstring).  Returns the phase's numbers."""
    t_phase = time.perf_counter()
    _free()
    out = {"ssd_chunk_bwd": _ssd_bwd_checks(card), "rglru_scan_bwd": _rglru_bwd_checks(card)}
    t_kernels = time.perf_counter()
    out["gradients"] = {name: _grad_agree(name, seed, SSM_GRAD[name], 512, tag="ssm")
                        for name, seed in ((MAMBA2, 81), (RGEMMA, 82))}
    t_grad = time.perf_counter()
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd

    launches, out["train"] = {}, {}
    for name, seed in ((MAMBA2, 90), (RGEMMA, 91)):
        b, s, changes = SSM_TRAIN[name]
        cfg, _, params, state, step_fn, _, launches[name], numbers = _train_steps(
            name, card, b, s, changes, seed=seed, tag="ssm")
        if cfg.family == "hybrid":
            routes = rglru_scan_bwd.route_launches
            check(routes["bfloat16"] == launches[name]["rglru_scan_bwd"],
                  f"{name}: B9 backward launches by route {routes}, expected all bf16")
        numbers["profile"] = _profile_train_step(name, step_fn, params, state,
                                                 _train_batch(cfg, b, s, seed=TRAIN_STEPS))
        out["train"][name] = numbers
        del params, state, step_fn
        _free()
    out["train_cli"] = _train_cli(MAMBA2_TRAIN_CLI, MAMBA2, 3, 2, "ssm")
    out["launches"] = launches
    say("ssm", f"(a) took {t_kernels - t_phase:.1f} s, (b) {t_grad - t_kernels:.1f} s, (c) "
        f"and (d) {time.perf_counter() - t_grad:.1f} s; phase 24 took "
        f"{time.perf_counter() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# The lm-mesh phase: the 2-D (data, model) LM training layout
# ---------------------------------------------------------------------------

STRIPE = dict(b=2, sq=512, sk=2_048, h=12, hkv=2, d=128)   # qwen2-1.5b's stripes at model 4
STRIPE_OFFSETS = (0, 512, 1_024, 1_536)


def _stripe_work(b, sq, sk, h, hkv, d, elem, offset, backward=False):
    """FLOPs and bytes of B7 (or, with ``backward``, B8) on a causal stripe
    of ``sq`` query rows at ``offset`` against ``sk`` keys: the stripe's
    own (query, key) pairs, sq·offset + sq(sq + 1)/2, at 2·2d FLOPs a pair
    (B8: 2·5d); q (B8: q, out, dO) read once, only the keys the band
    reaches (offset + sq of them) read once, out and lse (B8: dq, dk, dv)
    written once."""
    pairs = sq * offset + sq * (sq + 1) // 2
    keys = min(sk, offset + sq)
    if backward:
        flops = 2 * 5 * d * pairs * b * h
        nbytes = elem * (3 * b * sq * h * d + 2 * b * keys * hkv * d
                         + b * sq * h * d + 2 * b * sk * hkv * d) + 4 * b * h * sq
    else:
        flops = 2 * 2 * d * pairs * b * h
        nbytes = elem * (2 * b * sq * h * d + 2 * b * keys * hkv * d) + 4 * b * h * sq
    return flops, nbytes


def _sdpa_stripe(q, k, v, offset):
    """SDPA on a stripe (the yardstick; the port never calls it): the band
    as a boolean mask, since ``is_causal`` aligns a short query block to
    the first keys."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_mask

    mask = attention_mask(q.shape[1], True, None, q.device, s_k=k.shape[1], q_offset=offset)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _stripe_case(gen, dtype, offset, card) -> dict:
    """(a) of the lm-mesh phase at one offset and dtype: B7 per element
    against its plain version (bf16 within one bf16 ulp + 2^-7·1e-2, float32
    1e-5 of max(1, max|ref|); lse 1e-5), B8 per element against the plain
    backward (``_agree_bwd``), both launches on their route (in float32 a
    repeat of each bit-identical), and CUDA-events times (median of 25) of
    each beside its plain version, SDPA on the same stripe and the bound."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_magnitudes,
        flash_attention_bwd_ref,
        flash_attention_ref,
    )

    c = STRIPE
    b, sq, sk, h, hkv, d = c["b"], c["sq"], c["sk"], c["h"], c["hkv"], c["d"]
    q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    route, kw = _route(dtype), dict(q_offset=offset)
    before = (flash_attention.route_launches[route], flash_attention_bwd.route_launches[route])
    out, lse = flash_attention(q, k, v, **kw)
    got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    check((flash_attention.route_launches[route], flash_attention_bwd.route_launches[route])
          == (before[0] + 1, before[1] + 1), f"stripe at {offset}: launches not on {route}")
    label = f"stripe {sq}/{sk} at {offset} {str(dtype)[6:]}"
    ref, ref_lse = flash_attention_ref(q, k, v, **kw)
    if route == "wgmma":
        err, used = _agree_each(f"B7 {label} out", out.float(), ref.float(), 2.0**-7,
                                2.0**-7 * 1e-2)
    else:
        err, scale = _agree(f"B7 {label} out", out.float(), ref.float(), 1e-5, 1.0)
        used = err / (1e-5 * scale)
    err_lse, _ = _agree(f"B7 {label} lse", lse, ref_lse, 1e-5)
    mags = flash_attention_bwd_magnitudes(q, k, v, out, lse, do, **kw)
    err_b, used_b = _agree_bwd(label, got, flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                               mags, dtype)
    if route == "tf32x3":
        again = (*flash_attention(q, k, v, **kw), *flash_attention_bwd(q, k, v, out, lse, do, **kw))
        check(all(torch.equal(x, y) for x, y in zip(again, (out, lse, *got))),
              f"{label}: a repeat of B7 or B8 is not bit-identical")
        del again
    del ref, ref_lse, mags, got
    peak = _peak(route)
    row = {"offset": offset, "dtype": str(dtype)[6:], "route": route}
    for name, fn, plain, library, backward, e, u in (
            ("flash_attention", lambda: flash_attention(q, k, v, **kw),
             lambda: flash_attention_ref(q, k, v, **kw),
             lambda: _sdpa_stripe(q, k, v, offset), False, max(err, err_lse), used),
            ("flash_attention_bwd", lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw),
             lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, **kw), None, True,
             err_b, used_b)):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        if backward:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sd_out = _sdpa_stripe(*leaves, offset)
            library = lambda: torch.autograd.grad(sd_out, leaves, do.transpose(1, 2),  # noqa: E731
                                                  retain_graph=True)
        try:
            library_ms = cuda_ms(library)
        except RuntimeError as exc:  # SDPA refuses the shapes: say so
            say("lm-mesh", f"{name} {label}: SDPA refused the stripe ({str(exc)[:120]})")
            library_ms = None
        flops, nbytes = _stripe_work(b, sq, sk, h, hkv, d, q.element_size(), offset, backward)
        bound_ms, bound_by = _bound(flops, nbytes, peak)
        row[name] = dict(max_abs_err=e, bar_used=u, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        say("lm-mesh", f"(a) {name} {label} ({route}): max|d| {e:.3e}, {u:.3f} of its bar; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
            f"{'refused' if library_ms is None else f'{library_ms:.4f} ms'}, bound "
            f"{bound_ms:.4f} ms ({bound_by}, {flops:.4g} FLOP, {nbytes / 1e6:.1f} MB) on {card}")
    return row


def phase_stripe_kernels(card) -> list:
    """(a) of the lm-mesh phase: B7 and B8 with ``q_offset`` at qwen2-1.5b's
    stripes (q [2, 512, 12, 128] against k and v [2, 2,048, 2, 128]) at
    offsets 0, 512, 1,024 and 1,536, bf16 and float32."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(34)
    _say_ptxas("flash_attention", ["flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel"])
    rows = [_stripe_case(gen, dtype, offset, card)
            for dtype in (torch.bfloat16, torch.float32) for offset in STRIPE_OFFSETS]
    torch.cuda.empty_cache()
    return rows


LM_MESH_RANK_TIMEOUT_S = 420
LM_MESH_WORLD = 4  # the phase's gloo rank processes: the largest case's mesh
# (b) head-parallel with FSDP, (c) sequence-parallel: arch, mesh, global
# batch, sequence, steps; the one-process witness splits its batch in two
# microbatches (the ranks take one), the same mean in another grouping
LM_MESH_CASES = {
    "qwen3-1.7b 14 layers data 2 x model 2": dict(
        arch="qwen3-1.7b", changes=dict(n_layers=14), mesh=(2, 2), b=4, s=1_024, steps=2,
        witness_micro=2),
    "qwen2-1.5b 14 layers data 1 x model 4": dict(
        arch="qwen2-1.5b", changes=dict(n_layers=14), mesh=(1, 4), b=2, s=1_024, steps=1,
        witness_micro=1),
    # (e) the other families at full width, cut in depth ("changes"); "grads":
    # one loss and its gradients (AdamW's moments would not fit beside the
    # witness), no update
    "internvl2-2b 6 layers data 2 x model 2": dict(
        arch="internvl2-2b", changes=dict(n_layers=6), mesh=(2, 2), b=4, s=512, steps=1,
        witness_micro=2),
    "qwen2-moe-a2.7b 2 layers data 1 x model 4": dict(
        arch="qwen2-moe-a2.7b", changes=dict(n_layers=2), mesh=(1, 4), b=2, s=1_024, steps=2,
        witness_micro=1),
    "deepseek-v2-236b dense + 1 MoE layer data 1 x model 4": dict(
        arch="deepseek-v2-236b", changes=dict(n_layers=2), mesh=(1, 4), b=1, s=1_024, steps=1,
        witness_micro=1, grads=True),
    # at 24 layers mamba2's float32 gradients move by 1.3-1.6x the 1e-4 bar
    # when only the batch is regrouped (scripts/torch_grad_rounding.py)
    "mamba2-780m 8 layers data 2 x model 2": dict(
        arch="mamba2-780m", changes=dict(n_layers=8), mesh=(2, 2), b=4, s=1_024, steps=1,
        witness_micro=2),
    "recurrentgemma-9b one period data 1 x model 4": dict(
        arch="recurrentgemma-9b", changes=dict(n_layers=3), mesh=(1, 4), b=2, s=1_024,
        steps=2, witness_micro=1),
    "whisper-tiny data 1 x model 2": dict(
        arch="whisper-tiny", mesh=(1, 2), b=4, s=448, steps=2, witness_micro=1),
    "whisper-tiny data 1 x model 4": dict(
        arch="whisper-tiny", mesh=(1, 4), b=4, s=448, steps=2, witness_micro=1),
}
LM_MESH_LR = 1e-3
LM_MESH_SEQ = "qwen2-1.5b 14 layers data 1 x model 4"
LM_MESH_DENSE = "qwen3-1.7b 14 layers data 2 x model 2"


def _stripe_rows(numbers, kernel) -> dict:
    """The kernels line's q_offset entry of B7 or B8: (a)'s rows by route
    and offset."""
    return {f"{row['route']} at {row['offset']}": row[kernel] for row in numbers["stripes"]}


def _lm_mesh_opt(first=None):
    """AdamW that hands the gradients of its first update (the step-1
    gradients: averaged over the data ranks and clipped) to ``first``, or
    keeps a copy of them."""
    from repro_torch import optim

    base = optim.adamw(optim.linear_warmup_cosine(LM_MESH_LR, 2, 10), weight_decay=0.01,
                       eps=1e-3)
    kept = {}

    def update(grads, state, params):
        if "first" not in kept:
            kept["first"] = True
            if first:
                first(_flat(grads))
            else:
                kept["grads"] = {k: g.detach().clone() for k, g in _flat(grads).items()}
        return base.update(grads, state, params)

    return optim.Optimizer(init=base.init, update=update), kept


def _flat(tree, prefix="") -> dict:
    """{"a/b/c": leaf} of a tree of dicts and lists (the hybrid's tail
    blocks by index)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            for i, item in enumerate(v):
                out.update(_flat(item, f"{prefix}{k}/{i}/"))
        else:
            out[prefix + k] = v
    return out


def _lm_mesh_cfg(case):
    """The case's config: the registered arch at full width, cut in depth by
    the case's ``changes``."""
    from repro_torch.configs import registry

    return dataclasses.replace(registry.get(case["arch"]), **case.get("changes", {}))


def _lm_mesh_batch(cfg, case, step):
    """The step's batch on the card: the token stream and, for the vlm and
    encdec families, normal patches or frames drawn by a CUDA generator
    seeded with the step (the same bits in every process)."""
    import torch

    from repro_torch.data import synthetic

    batch = {"tokens": torch.as_tensor(synthetic.lm_token_stream(
        cfg.vocab_size, case["s"], case["b"], seed=100 + step), device="cuda")}
    extra = {"vlm": ("patch_embeds", (cfg.n_patches, cfg.d_frontend)),
             "encdec": ("frames", (cfg.encoder_seq, cfg.d_model))}.get(cfg.family)
    if extra:
        gen = torch.Generator(device="cuda").manual_seed(200 + step)
        batch[extra[0]] = torch.randn((case["b"], *extra[1]), generator=gen, device="cuda")
    return batch


def _lm_mesh_dispatches(bundle, params, batch) -> list:
    """Each MoE layer's dispatch mask (on the host) in a no-grad forward of
    ``batch``'s tokens; none for another family."""
    import numpy as np

    from repro_torch.models import moe

    if bundle.cfg.family != "moe":
        return []
    calls, route = [], moe.route

    def logged(logits, top_k, cap):
        got = route(logits, top_k, cap)
        calls.append(got[0].cpu().numpy())
        return got

    moe.route = logged
    try:
        bundle.forward(params, batch["tokens"])
    finally:
        moe.route = route
    return [np.asarray(d) for d in calls]


def _lm_mesh_grads(bundle, params, batch):
    """(loss, {path: gradient}) of one ``bundle.loss`` and its backward."""
    import torch
    from torch.utils import _pytree as pytree

    leaves, spec = pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = bundle.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), _flat(pytree.tree_unflatten(list(grads), spec))


def _mem() -> str:
    """This process's allocated and reserved memory and the card's free
    memory, in GiB."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return (f"allocated {torch.cuda.memory_allocated() / 2**30:.2f}, reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f}, card free {free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB")


def _wait_for(path, procs=(), timeout_s=LM_MESH_RANK_TIMEOUT_S) -> None:
    """Poll for the file ``path``; fail if one of ``procs`` exits first."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        for p in procs:
            check(p.poll() is None, f"lm-mesh: a rank exited {p.returncode} before {path}")
        check(time.perf_counter() - t0 < timeout_s, f"lm-mesh: no {path} in {timeout_s} s")
        time.sleep(0.05)


def _hold_to_witness(rank, kind, leaves, witness, flat_specs, mesh, worst) -> None:
    """Each of this rank's slices of ``kind`` against the witness's tensor
    (a CUDA IPC handle), within 1e-4 of the witness leaf's largest entry."""
    from repro_torch.launch import shardings

    over = []
    for path, local in leaves.items():
        fn, args = witness["handles"][kind][path]
        full = fn(*args)
        want = shardings.local_view(full, flat_specs[path], mesh)
        check(tuple(want.shape) == tuple(local.shape),
              f"rank {rank} {kind}/{path}: shape {tuple(local.shape)} vs {tuple(want.shape)}")
        err = float((local.detach() - want).abs().max())
        bar = 1e-4 * witness["scale"][kind][path]
        used = err / bar if bar > 0 else (0.0 if err == 0 else float("inf"))
        if used > 1.0:
            over.append(f"{kind}/{path}: max|d| {err:.3e} = {used:.3f} x (1e-4 x max|witness "
                        f"leaf| {witness['scale'][kind][path]:.3e})")
        if used >= worst.get(kind, (0.0, ""))[0]:
            worst[kind] = (used, path)
        del full, want
    check(not over, f"rank {rank}: {len(over)} leaves over their bar: " + "; ".join(over))


def _put(path, text) -> None:
    """Write ``text`` to ``path`` whole: a reader polling for ``path`` never
    sees it half written."""
    import os

    part = Path(f"{path}.part")
    part.write_text(text)
    os.replace(part, path)


def lm_mesh_rank(rank: int, root: str) -> int:
    """``python chip_smoke.py --lm-mesh-rank RANK ROOT``: one gloo rank of
    the lm-mesh phase, started once for all its cases.  For k = 0, 1, ...
    it waits for ROOT/go{k}: "stop" ends it; "run" runs the case in
    ROOT/case{k} (``_lm_mesh_rank_case``) where RANK is inside the case's
    mesh, frees what it held and writes ROOT/case{k}/rank{RANK}.json."""
    import gc

    import torch

    k = 0
    while True:
        go = Path(root, f"go{k}")
        _wait_for(go)
        if go.read_text() == "stop":
            return 0
        case_dir = Path(root, f"case{k}")
        case = json.loads(Path(case_dir, "case.json").read_text())
        if rank < math.prod(case["mesh"]):
            result = _lm_mesh_rank_case(rank, str(case_dir))
            # every witness tensor this rank opened is released before the
            # phase, seeing the result, frees the witness
            gc.collect()
            torch.cuda.empty_cache()
            _put(case_dir / f"rank{rank}.json", json.dumps(result))
        k += 1


def _lm_mesh_rank_case(rank: int, mesh_dir: str) -> dict:
    """One case of the lm-mesh phase's (b), (c) or (e) on gloo rank
    ``rank`` (DIR/case.json), its group from a ``FileStore`` in DIR.  It
    trains its slices and holds them to the one-process witness's tensors,
    shared from the phase's process by CUDA IPC (DIR/witness{RANK}.pkl):
    the step-1 gradients at the first update (then DIR/step1.RANK; the
    phase frees the witness's gradients and writes DIR/freed before the
    rank goes on), the parameters and moments after the last step.
    Returns its losses, times, launches, peak and shares of the bars."""
    import os
    import pickle

    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import shardings, steps
    from repro_torch.models import get_bundle, hints

    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    case = json.loads(Path(mesh_dir, "case.json").read_text())
    world = math.prod(case["mesh"])
    mesh_lib.init_process_group_from_file(os.path.join(mesh_dir, "store"), rank,
                                          world, backend="gloo",
                                          timeout_s=LM_MESH_RANK_TIMEOUT_S)
    try:
        cfg = _lm_mesh_cfg(case)
        mesh = mesh_lib.Mesh(case["mesh"], ("data", "model"), device="cuda:0")
        check(mesh.backend == "gloo" and mesh.rank == rank, f"lm-mesh rank {rank}: {mesh}")
        exchange = {"ms": 0.0, "calls": 0}
        gather_axis = mesh.gather_axis

        def timed_gather(t, axis):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = gather_axis(t, axis)
            torch.cuda.synchronize()
            exchange["ms"] += (time.perf_counter() - t0) * 1e3
            exchange["calls"] += 1
            return parts

        mesh.gather_axis = timed_gather
        bundle = get_bundle(cfg)
        with open(os.path.join(mesh_dir, f"witness{rank}.pkl"), "rb") as f:
            witness = pickle.load(f)
        worst: dict = {}
        with hints.use_mesh(mesh):
            specs = shardings.lm_param_specs(cfg, mesh)
            flat_specs = _flat(specs)
            for r in range(world):  # one full draw on the card at a time
                if r == rank:
                    params = bundle.init(0, torch.float32, device="cuda:0")
                    torch.cuda.empty_cache()
                mesh.barrier()
            say("lm-mesh", f"rank {rank} after init: {_mem()}")
            batch = _lm_mesh_batch(cfg, case, 0)
            batch = shardings.shard_tree(batch, shardings.batch_shardings(batch, mesh), mesh)
            rows, _ = mesh.index(mesh_lib.data_axes(mesh))
            for i, got in enumerate(_lm_mesh_dispatches(bundle, params, batch)):
                want = np.load(os.path.join(mesh_dir, f"dispatch{i}.npy"))
                n = got.shape[0]
                check(np.array_equal(got, want[rows * n:(rows + 1) * n]),
                      f"rank {rank}: MoE layer {i}'s dispatch differs from the witness's")

            def first(grads):
                say("lm-mesh", f"rank {rank} at the first update: {_mem()}")
                _hold_to_witness(rank, "grads", grads, witness, flat_specs, mesh, worst)
                Path(mesh_dir, f"step1.{rank}").touch()
                _wait_for(Path(mesh_dir, "freed"))

            opt, _ = _lm_mesh_opt(first)
            state = None if case.get("grads") else opt.init(params)
            step_fn = steps.make_train_step(bundle, opt, microbatches=1, clip_norm=1.0)
            torch.cuda.reset_peak_memory_stats()
            _lm_zero()
            losses, step_ms, exchange_ms = [], [], []
            for i in range(case["steps"]):
                batch = _lm_mesh_batch(cfg, case, i)
                batch = shardings.shard_tree(batch, shardings.batch_shardings(batch, mesh), mesh)
                exchange["ms"] = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if case.get("grads"):  # one loss and its gradients, no update
                    loss, grads = _lm_mesh_grads(bundle, params, batch)
                    params = None  # room for the comparison's temporaries
                else:
                    params, state, loss = step_fn(params, state, batch)
                losses.append(float(loss))
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                exchange_ms.append(exchange["ms"])
            launches = _lm_read("tf32x3", **{k: v * case["steps"]
                                           for k, v in _loss_launches(cfg).items()})
            peak_gb = torch.cuda.max_memory_allocated() / 2**30
            if case.get("grads"):
                torch.cuda.empty_cache()
                first(grads)
                del grads
        if not case.get("grads"):
            for kind, tree in (("params", params), ("mu", state.mu), ("nu", state.nu)):
                _hold_to_witness(rank, kind, _flat(tree), witness, flat_specs, mesh, worst)
        result = dict(losses=losses, step_ms=step_ms, exchange_ms=exchange_ms,
                      exchange_calls=exchange["calls"], launches=launches,
                      peak_gb=peak_gb, worst=worst)
    finally:
        torch.distributed.destroy_process_group()
    return result


def _start_lm_mesh_ranks(root) -> dict:
    """The lm-mesh phase's ``LM_MESH_WORLD`` gloo rank processes
    (``lm_mesh_rank``), started once for all its cases, each logging to
    ROOT/rank{R}.log."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), LOCAL_RANK="0",
               OMP_NUM_THREADS="2", PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    logs = [open(Path(root, f"rank{r}.log"), "w+") for r in range(LM_MESH_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--lm-mesh-rank",
                               str(r), str(root)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True)
             for r in range(LM_MESH_WORLD)]
    return {"root": root, "procs": procs, "logs": logs, "cases": 0, "said": 0}


def _lm_mesh_tails(pool) -> list[str]:
    """Each rank's log so far."""
    out = []
    for log in pool["logs"]:
        log.flush()
        log.seek(0)
        out.append(log.read())
    return out


def _lm_mesh_say_rank0(pool) -> None:
    """Print rank 0's ``[lm-mesh]`` lines that are not printed yet."""
    lines = _lm_mesh_tails(pool)[0].splitlines()
    for line in lines[pool["said"]:]:
        if line.startswith("[lm-mesh]"):
            print(line, flush=True)
    pool["said"] = len(lines)


def _stop_lm_mesh_ranks(pool, ok: bool) -> None:
    """Tell the ranks to end and wait for them (``ok``: each must exit 0),
    or, after a failure, kill them; close their logs."""
    procs = pool["procs"]
    try:
        if ok:
            _put(Path(pool["root"], f"go{pool['cases']}"), "stop")
            for p in procs:
                p.wait(timeout=LM_MESH_RANK_TIMEOUT_S)
            errs = _lm_mesh_tails(pool)
            for r, (p, err) in enumerate(zip(procs, errs, strict=True)):
                check(p.returncode == 0, f"lm-mesh: gloo rank {r} exited {p.returncode}: "
                      f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in pool["logs"]:
            log.close()


def _lm_mesh_case(name, case, card, pool) -> dict:
    """(b), (c) or (e) of the lm-mesh phase: the one-process witness on the
    card (the MoE dispatch masks of a forward first), then the first
    ``world`` of the phase's gloo ranks (``_start_lm_mesh_ranks``) sharing
    it, each holding its dispatch masks to the witness's bit for bit, its
    slices of the step-1 gradients and of the parameters and Adam moments
    after the last step (a ``grads`` case: of one loss's gradients) to the
    witness's within 1e-4 of the leaf's largest entry, and its loss to the
    witness's at ``TOLS``."""
    import pickle

    import numpy as np
    import torch
    from torch.multiprocessing.reductions import reduce_tensor

    from repro_torch.launch import steps
    from repro_torch.models import get_bundle

    cfg = _lm_mesh_cfg(case)
    world = math.prod(case["mesh"])
    bundle = get_bundle(cfg)
    params = bundle.init(0, torch.float32, device="cuda")
    dispatches = _lm_mesh_dispatches(bundle, params, _lm_mesh_batch(cfg, case, 0))
    opt, kept = _lm_mesh_opt()
    state = None if case.get("grads") else opt.init(params)
    step_fn = steps.make_train_step(bundle, opt, microbatches=case["witness_micro"],
                                    clip_norm=1.0)
    _lm_zero()
    w_losses, w_ms = [], []
    for i in range(case["steps"]):
        batch = _lm_mesh_batch(cfg, case, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if case.get("grads"):
            loss, kept["grads"] = _lm_mesh_grads(bundle, params, batch)
        else:
            params, state, loss = step_fn(params, state, batch)
        w_losses.append(float(loss))
        torch.cuda.synchronize()
        w_ms.append((time.perf_counter() - t0) * 1e3)
    _lm_zero()
    if case.get("grads"):
        witness = {"grads": kept.pop("grads")}
        params = None  # the ranks hold their own slices
    else:
        witness = {"grads": kept.pop("grads"), "params": _flat(params),
                   "mu": _flat(state.mu), "nu": _flat(state.nu)}
    torch.cuda.empty_cache()
    with torch.no_grad():
        scale = {kind: {p: float(torch.linalg.vector_norm(t, float("inf")))
                        for p, t in leaves.items()} for kind, leaves in witness.items()}
    torch.cuda.synchronize()
    say("lm-mesh", f"{name}: the witness holds its tensors: {_mem()}")
    k = pool["cases"]
    pool["cases"] += 1
    case_dir = Path(pool["root"], f"case{k}")
    case_dir.mkdir()
    Path(case_dir, "case.json").write_text(json.dumps(case))
    for i, d in enumerate(dispatches):
        np.save(case_dir / f"dispatch{i}.npy", d)
    for r in range(world):
        # one handle a tensor and rank: each carries the reference count
        # its one receiver releases, so the blocks free once all are done
        handles = {kind: {p: reduce_tensor(t.detach()) for p, t in leaves.items()}
                   for kind, leaves in witness.items()}
        with open(case_dir / f"witness{r}.pkl", "wb") as f:
            pickle.dump({"handles": handles, "scale": scale}, f)
    del handles
    procs = pool["procs"]
    t0 = time.perf_counter()
    _put(Path(pool["root"], f"go{k}"), "run")
    try:
        # the ranks hold their step-1 gradients to the witness's, which
        # are then freed to make room for the ranks' later steps
        for r in range(world):
            _wait_for(case_dir / f"step1.{r}", procs)
        del witness["grads"]
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        Path(case_dir, "freed").touch()
        for r in range(world):
            _wait_for(case_dir / f"rank{r}.json", procs)
    except SmokeFailure as e:
        raise SmokeFailure(f"{e}; rank logs: " + " | ".join(
            f"rank {r}: {t[-1500:]}" for r, t in enumerate(_lm_mesh_tails(pool)))) from e
    wall_s = time.perf_counter() - t0
    _lm_mesh_say_rank0(pool)
    ranks = [json.loads(Path(case_dir, f"rank{r}.json").read_text()) for r in range(world)]
    del witness, params, state, kept
    torch.cuda.ipc_collect()  # the blocks the ranks mapped, freed once they have exited
    _free()
    say("lm-mesh", f"{name}: the witness freed: {_mem()}")
    for r in ranks[1:]:
        check(r["losses"] == ranks[0]["losses"], f"lm-mesh {name}: ranks' losses differ")
    for got, want in zip(ranks[0]["losses"], w_losses, strict=True):
        check(abs(got - want) <= 1e-4 + 1e-4 * abs(want),
              f"lm-mesh {name}: loss {got} vs the one-process witness's {want}")
    step_ms = max(r["step_ms"][-1] for r in ranks)
    exchange_ms = max(r["exchange_ms"][-1] for r in ranks)
    worst = {kind: max(r["worst"][kind][0] for r in ranks) for kind in ranks[0]["worst"]}
    out = dict(arch=case["arch"], changes=case.get("changes", {}), mesh=case["mesh"],
               grads_only=bool(case.get("grads")), moe_layers_dispatch_identical=len(dispatches),
               batch=[case["b"], case["s"]], steps=case["steps"],
               losses=ranks[0]["losses"], witness_losses=w_losses,
               step_ms=[max(r["step_ms"][i] for r in ranks) for i in range(case["steps"])],
               exchange_ms=[max(r["exchange_ms"][i] for r in ranks)
                            for i in range(case["steps"])],
               exchange_share=exchange_ms / step_ms,
               exchange_calls=ranks[0]["exchange_calls"], witness_step_ms=w_ms,
               launches_per_rank=ranks[0]["launches"], peak_gb_per_rank=max(
                   r["peak_gb"] for r in ranks), worst_share_of_bar=worst, ranks_wall_s=wall_s)
    say("lm-mesh", f"{name}: {world} gloo ranks, loss {ranks[0]['losses']} vs the witness's "
        f"{w_losses}; last step {step_ms:.0f} ms, {exchange_ms:.0f} ms of it in staged "
        f"exchanges ({100 * exchange_ms / step_ms:.1f} %); witness {w_ms[-1]:.0f} ms a step; "
        f"B7/B8 a rank {ranks[0]['launches']}; worst share of the 1e-4 bar {worst}; peak "
        f"{out['peak_gb_per_rank']:.1f} GiB a rank; ranks' wall {wall_s:.1f} s on {card}")
    return out


def _lm_mesh_cli(card) -> dict:
    """(d) ``launch/train.py --model-parallel 2`` on one card: the error
    that names the card count."""
    import os

    import torch

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", QWEN3, "--reduced",
         "--steps", "1", "--model-parallel", "2"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    n = torch.cuda.device_count()
    want = f"{n} present"
    check(proc.returncode != 0 and "--model-parallel 2 on the card needs" in proc.stderr
          and want in proc.stderr,
          f"train.py --model-parallel 2 on {n} card(s): exit {proc.returncode}, "
          f"stderr {proc.stderr[-1000:]!r}")
    line = proc.stderr.strip().splitlines()[-1]
    say("lm-mesh", f"(d) train.py --model-parallel 2 on {n} card: exit {proc.returncode}, "
        f"{line!r}, ok")
    return {"exit": proc.returncode, "message": line}


def phase_lm_mesh(card) -> dict:
    """The lm-mesh phase (see the module docstring): (a) B7 and B8 with
    ``q_offset`` at qwen2-1.5b's stripes, (b) qwen3-1.7b at full width on
    four gloo ranks at data 2 x model 2, (c) qwen2-1.5b's sequence-parallel
    route at data 1 x model 4, (e) one case of each other family, (d) the
    CLI on one card.  (b), (c) and (e) share one set of rank processes."""
    import tempfile

    import torch

    t0 = time.perf_counter()
    say("lm-mesh", f"at the start: {_mem()}")
    out = {"card": card, "stripes": phase_stripe_kernels(card)}
    t_a = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        pool = _start_lm_mesh_ranks(root)
        ok = False
        try:
            for name, case in LM_MESH_CASES.items():
                out[name] = _lm_mesh_case(name, case, card, pool)
                torch.cuda.empty_cache()
            ok = True
        finally:
            _stop_lm_mesh_ranks(pool, ok)
    t_bc = time.perf_counter()
    out["cli"] = _lm_mesh_cli(card)
    say("lm-mesh", f"(a) took {t_a - t0:.1f} s, (b), (c) and (e) {t_bc - t_a:.1f} s, (d) "
        f"{time.perf_counter() - t_bc:.1f} s on {card}")
    return out


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
        mesh_numbers = phase_mesh(cfg, x_train, x_test, xte, references, fleet_data,
                                  fleet_data_d)
        _free()
        lm_mesh_numbers = phase_lm_mesh(card)
        comparison_numbers = phase_comparison()
        analysis_numbers = phase_analysis(cfg, fleet_data_d, comparison_numbers)
        decode_numbers = phase_decode(card)
        family_numbers = phase_families(card)
        dense_numbers = phase_dense_variants(card)
        encdec_numbers = phase_encdec_training(card)
        ssm_numbers = phase_ssm_training(card)
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
            # A data mesh over two of four gloo ranks, each rank's
            # launches in one fit (the idle ranks': 0).
            "two_rank_data_mesh_launches_per_rank":
                mesh_numbers["sub_meshes"]["two-rank data mesh b1 per rank"],
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
            # Six tenants on three of four gloo ranks, each
            # working rank's launches in one fit (the idle rank's: 0).
            "six_tenants_on_three_ranks_launches_per_rank":
                mesh_numbers["sub_meshes"]["six tenants b4 per rank"],
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
            # The analysis phase's flatness check: two tenants of 128
            # samples, one cold fit at each chunk width.
            "analysis_chunk_flatness_launches": {
                c: row["launches"].get("rolann_fused_chunk_batched", 0)
                for c, row in analysis_numbers["chunked fleet fit cold"].items()},
        },
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_fwd_sm90.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:77",
            "launches": lm_launches["head"]["flash_attention"],
            # Per launch at the head path's shape (64 x 256, 16/8 heads of 128, bf16).
            **_per_launch(lm_rows["flash_attention"], "head path"),
            # The (192, 128) instantiations at deepseek-v2's prefill shape
            # (1 x 4,096, 128 heads): one launch a layer of its bf16 prefill.
            "mla_192_128": {"launches": family_numbers["launches"][DSV2]["flash_attention"],
                            **family_numbers["b7_192_128"]},
            # causal=False at whisper-tiny's encoder shape (16 x 1,500, 6 heads of
            # 64); whisper_launches: one bf16 whisper prefill, all of its launches
            # (4 encoder layers without the causal mask, 4 causal decoder layers).
            "encoder_causal_false": {
                "whisper_launches":
                    encdec_numbers[WHISPER]["prefill"]["launches"]["flash_attention"],
                **encdec_numbers["b7_causal_false"]},
            # With q_offset (the sequence-parallel stripes): per launch at
            # qwen2-1.5b's stripes, bf16 and float32; lm_mesh_launches: a rank's
            # in one step of the lm-mesh phase's (c) (14 layers, forward and remat).
            "q_offset": {"lm_mesh_launches": lm_mesh_numbers[LM_MESH_SEQ]["launches_per_rank"][
                "flash_attention"], **_stripe_rows(lm_mesh_numbers, "flash_attention")},
            # granite-20b (48 query heads over one KV head) and mistral-nemo-12b
            # (32 over 8) at 1 x 32,768 on both routes, the plain version on
            # a stripe; prefill_32k_launches: one bf16 prefill_32k of each.
            "dense_variants": {
                "prefill_32k_launches": {name: n["flash_attention"] for name, n in
                                         dense_numbers["launches"]["prefill_32k"].items()},
                "s32768": dense_numbers["b7"]},
            # The float32 route (3xTF32 wgmma), per launch at qwen3's train
            # shape (2 x 2,048, 16/8 heads of 128, float32); lm_mesh_launches:
            # a rank's over the two steps of the lm-mesh phase's (b) (14
            # layers, forward and remat).
            "float32_tf32x3": {
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                "lm_mesh_launches": lm_mesh_numbers[LM_MESH_DENSE]["launches_per_rank"][
                    "flash_attention"],
                **_per_launch(lm_rows["flash_attention"], "train float32")},
        },
        {
            "name": "flash_attention_bwd",
            "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_bwd_sm90.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:212",
            "launches": train_launches["flash_attention_bwd"],
            # Per launch at the train shape (2 x 2,048, 16/8 heads of 128, bf16).
            **_per_launch(b8_rows, "train"),
            # MLA's (192, 128), 2 x 2,048, 128 heads, causal; launches: deepseek-v2's
            # 10 bf16 train steps at its dense layer.
            "mla_192_128": {"launches": encdec_numbers["launches"][DSV2]["flash_attention_bwd"],
                            **encdec_numbers["b8"]["mla"]},
            # causal=False at whisper-tiny's encoder training shape (a microbatch,
            # 8 x 1,500); whisper_launches: all of whisper-tiny's 10 bf16 train
            # steps (4 encoder layers without the causal mask and 4 causal decoder
            # layers, 2 microbatches).
            "encoder_causal_false": {
                "whisper_launches": encdec_numbers["launches"][WHISPER]["flash_attention_bwd"],
                **encdec_numbers["b8"]["encoder"]},
            "launches_per_train_step": {name: row["b8_per_step"]
                                        for name, row in encdec_numbers["train"].items()},
            # With q_offset (the sequence-parallel stripes): per launch at
            # qwen2-1.5b's stripes, bf16 and float32; lm_mesh_launches: a rank's
            # in one step of the lm-mesh phase's (c) (14 layers).
            "q_offset": {"lm_mesh_launches": lm_mesh_numbers[LM_MESH_SEQ]["launches_per_rank"][
                "flash_attention_bwd"], **_stripe_rows(lm_mesh_numbers, "flash_attention_bwd")},
            # granite-20b's group of 48 (2 x 4,096, one KV head) on both routes,
            # with its dq and dk/dv launches' device times and blocks;
            # launches_per_train_step: the 2-layer cuts' bf16 steps.
            "dense_variants": {
                "group_48": dense_numbers["b8"],
                "launches_per_train_step": {name: dense_numbers[name]["train"]["b8_per_step"]
                                            for name in (GRANITE, MISTRAL)}},
            # The float32 route (3xTF32 wgmma), per call at the train shape in
            # float32; lm_mesh_launches: a rank's over the two steps of (b).
            "float32_tf32x3": {
                "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
                "lm_mesh_launches": lm_mesh_numbers[LM_MESH_DENSE]["launches_per_rank"][
                    "flash_attention_bwd"],
                **_per_launch(b8_rows, "train float32")},
        },
        {
            "name": "rglru_scan",
            "route": "cuda",
            "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan/kernel.py:56",
            "launches": lm_launches[RGEMMA]["rglru_scan"],
            # Per launch at recurrentgemma-9b's prefill shape (2 x 4,096 x 4,096).
            **_per_launch(lm_rows["rglru_scan"], "recurrentgemma prefill"),
            # Its backward (no TPU counterpart: the reference differentiates
            # plain XLA), per launch at a microbatch of the bf16 train steps
            # (2 x 2,048 x 4,096, bf16 x, float32 gates); launches: the 10
            # steps of recurrentgemma-9b cut to 5 layers.
            "backward": {
                "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan_bwd.cu",
                "design": "staged: a chain warp per 32 lanes walks g backwards, "
                          "worker warps stage dy, y, x, r, i by cp.async and form the rest",
                "launches": ssm_numbers["launches"][RGEMMA]["rglru_scan_bwd"],
                "launches_per_train_step":
                    ssm_numbers["train"][RGEMMA]["launches_per_step"]["rglru_scan_bwd"],
                **_per_launch(ssm_numbers["rglru_scan_bwd"], "recurrentgemma train")},
        },
        {
            "name": "ssd_chunk",
            "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_chunk/kernel.py:76",
            "launches": lm_launches[MAMBA2]["ssd_chunk"],
            # Per launch at mamba2-780m's prefill shape (4 x 4,096, 48 heads).
            **_per_launch(lm_rows["ssd_chunk"], "mamba2 prefill"),
            # Its backward (no TPU counterpart: the reference differentiates
            # plain XLA), per launch at a microbatch of the bf16 train steps
            # (2 x 2,048, 48 heads); launches: mamba2-780m's 10 steps at full depth.
            "backward": {
                "source": "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk_bwd.cu",
                "design": "3xTF32 wgmma: C·Bᵀ once per group, nine launches, each "
                          "tile's product in a fresh accumulator, no atomics",
                "launches": ssm_numbers["launches"][MAMBA2]["ssd_chunk_bwd"],
                "launches_per_train_step":
                    ssm_numbers["train"][MAMBA2]["launches_per_step"]["ssd_chunk_bwd"],
                **_per_launch([ssm_numbers["ssd_chunk_bwd"]], "mamba2 train")},
        },
    ]
    print(json.dumps({"analysis": analysis_numbers}))
    print(json.dumps({"lm_mesh": lm_mesh_numbers}))
    print(json.dumps({"mesh": mesh_numbers}))
    print(json.dumps({"ssm_training": ssm_numbers}))
    print(json.dumps({"encdec_training": encdec_numbers}))
    print(json.dumps({"dense_variants": dense_numbers}))
    print(json.dumps({"families": family_numbers}))
    print(json.dumps({"decode": decode_numbers}))
    print(json.dumps({"comparison": comparison_numbers}))
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
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--lm-mesh-rank"]:
        sys.exit(lm_mesh_rank(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
