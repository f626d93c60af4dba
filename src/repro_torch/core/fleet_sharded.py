"""Mesh-sharded DAEF fleet: K tenant models split across D ranks
(counterpart of ``repro/core/fleet_sharded.py``).

The reference shards a fleet's leading tenant axis over a ``"tenants"``
mesh axis; one controller sees the global arrays.  The port runs one
process per device (``launch.mesh``): rank d of a D-rank tenant mesh keeps
tenants ``[d·K/D, (d+1)·K/D)`` as plain tensors in a ``DAEFFleet`` of K/D
tenants on its device, fits, scores and updates them with the fleet's
batched kernels (B4, B5, B6 on the fused backend), and never exchanges
data with another rank.  :func:`shard_fleet` cuts a global fleet into this
rank's shard, :func:`gather_fleet` rebuilds the global fleet in tenant
order (tests, checkpoints).  Batches (``[K, ...]`` host arrays) are passed
whole to every rank and each rank uploads only its slice
(:func:`shard_batch`), so no device holds another rank's tenants.

The one cross-rank operation is federation.  :func:`fleet_merge_tree`
reduces adjacent groups of ``group_size`` tenants (a power of two):

* groups inside a rank reduce by log2 rounds of strided slices of the
  rank's block (``leaf[0::2]``, ``leaf[1::2]``) and batched pairwise
  knowledge merges;
* groups that span ranks reduce by a butterfly: in cross round r rank d
  swaps its state with rank ``d ^ 2^r`` (one flat buffer through
  ``batch_isend_irecv``) and both merge, the rank with ``d & 2^r == 0``
  putting its own state first, so the order is the sequential left-to-right
  one;
* the weights are re-solved once, at the root (``daef._model_from_knowledge``).

After the cross rounds every rank of a group holds the group's model.
Group g's model is the one on the group's first rank, ``g·2^c``: the ranks
gather the groups' models in rank order and keep every ``2^c``-th, the
reference's ``_every_nth``, so every rank returns the whole K/group_size
result (it no longer tiles the mesh).  With local rounds only, the result
stays sharded: rank d holds its K/(D·group_size) merged tenants.

:func:`merge_state_tree` is the same butterfly over masked, stacked
exchange states (the async session's partial participation);
:func:`merge_wire_tree` the secagg wires' butterfly in uint64 on the host.

Differences from the reference, on purpose:
  * fleets passed with a D-rank mesh are this rank's shard; a fleet passed
    without a mesh is this rank's whole fleet and reduces on a one-rank
    mesh (the reference picks the largest all-device mesh: with one
    device, the same);
  * ``_replicated`` and the jit caches have no torch meaning.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import daef, dsvd, fleet, rolann
from repro_torch.device import as_tensor
from repro_torch.launch import mesh as mesh_lib

TENANT_AXIS = mesh_lib.TENANT_AXIS


# ---------------------------------------------------------------------------
# Mesh + placement helpers
# ---------------------------------------------------------------------------

def tenant_mesh(n_devices: int | None = None, *, device=None) -> mesh_lib.Mesh:
    """A 1-D mesh over ``n_devices`` ranks (default: all) named
    ``"tenants"``, this rank on ``device`` (``None``: ``cuda:{LOCAL_RANK}``)."""
    avail = mesh_lib.world_size()
    n = avail if n_devices is None else n_devices
    if not 1 <= n <= avail:
        raise ValueError(f"need 1 <= n_devices <= {avail}, got {n}")
    return mesh_lib.Mesh((n,), (TENANT_AXIS,), device=device)


def _devices(mesh) -> int:
    return mesh.shape[TENANT_AXIS]


def _check_divisible(k: int, mesh, what: str) -> None:
    d = _devices(mesh)
    if k % d:
        raise ValueError(
            f"{what}: tenant count {k} must divide evenly over the "
            f"{d}-device '{TENANT_AXIS}' mesh axis (pad the fleet or "
            f"resize the mesh)"
        )


def _rank_slice(k: int, mesh) -> slice:
    """The tenants of a K-tenant batch that this rank holds."""
    local = k // _devices(mesh)
    d = mesh.coordinate(TENANT_AXIS)
    return slice(d * local, (d + 1) * local)


def shard_fleet(fl: fleet.DAEFFleet, mesh) -> fleet.DAEFFleet:
    """This rank's shard of a global fleet: every leaf's K/D tenant slice,
    on the rank's device (a one-rank mesh keeps the leaves' values)."""
    _check_divisible(fl.size, mesh, "shard_fleet")
    sl = _rank_slice(fl.size, mesh)
    return fleet._tree_map(lambda leaf: leaf[sl].to(mesh.device).contiguous(), fl)


def _flat(leaves: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([leaf.reshape(-1) for leaf in leaves])


def _unflat(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, at = [], 0
    for leaf in like:
        out.append(flat[at:at + leaf.numel()].view(leaf.shape))
        at += leaf.numel()
    return out


def _rebuild(tree, leaves: list[torch.Tensor]):
    it = iter(leaves)
    return fleet._tree_map(lambda _: next(it), tree)


def gather_fleet(fl: fleet.DAEFFleet, mesh) -> fleet.DAEFFleet:
    """The global fleet from every rank's shard, in tenant order (one
    ``all_gather`` per leaf dtype).  A one-rank mesh returns ``fl``."""
    if mesh.device_mesh is None:
        return fl
    leaves = fleet._tree_leaves(fl)
    out: list = [None] * len(leaves)
    for dtype in dict.fromkeys(leaf.dtype for leaf in leaves):
        idx = [i for i, leaf in enumerate(leaves) if leaf.dtype == dtype]
        like = [leaves[i] for i in idx]
        parts = mesh.gather_axis(_flat(like), TENANT_AXIS)
        per_rank = [_unflat(p, like) for p in parts]
        for j, i in enumerate(idx):
            out[i] = torch.cat([r[j] for r in per_rank])
    return _rebuild(fl, out)


def shard_batch(xs, mesh) -> torch.Tensor:
    """This rank's slice of a ``[K, ...]`` tenant batch (host array or
    tensor), on the rank's device: only the slice is uploaded."""
    shape = getattr(xs, "shape", None)
    if shape is None:
        xs = np.asarray(xs)
    _check_divisible(xs.shape[0], mesh, "shard_batch")
    return as_tensor(xs[_rank_slice(xs.shape[0], mesh)], mesh.device).contiguous()


def _shard_vector(v, k: int, mesh, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                           device=mesh.device).to(dtype)[_rank_slice(k, mesh)]


# ---------------------------------------------------------------------------
# Sharded fit / scores / partial_fit — each rank's tenants, the fleet kernels
# ---------------------------------------------------------------------------

def _fit_sharded(
    config: daef.DAEFConfig,
    xs,
    mesh,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    n_partitions: int = 1,
    chunk_samples: int | None = None,
) -> fleet.DAEFFleet:
    """The batched fleet fit of this rank's K/D tenants — the engine's
    mode="mesh" fit path (`sharded_fleet_fit` is its deprecation shim).

    ``xs`` [K, m0, n] is the global batch (every rank passes the same); the
    per-tenant hyperparameters broadcast over K and are sliced with it.
    With ``chunk_samples`` the fit streams each rank's tenants in chunks
    (B6 on the fused backend).  Returns this rank's shard.
    """
    dev = mesh.device
    config = config.resolved(dev)
    seeds, lam_hidden, lam_last = fleet._prepare_fit(
        config, xs, seeds, lam_hidden, lam_last, dev
    )
    sl = _rank_slice(xs.shape[0], mesh)
    x_local = shard_batch(xs, mesh)
    seeds, lam_hidden, lam_last = seeds[sl], lam_hidden[sl], lam_last[sl]
    if chunk_samples is not None:
        return fleet._fit_fleet_chunked(
            config, x_local, chunk_samples=chunk_samples, seeds=seeds,
            lam_hidden=lam_hidden, lam_last=lam_last, device=dev,
        )
    return fleet._fit_fleet(
        config, x_local, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last,
        n_partitions=n_partitions, device=dev,
    )


def _fit_sharded_stream(
    config: daef.DAEFConfig,
    batches,
    mesh,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    tenants: int | None = None,
) -> fleet.DAEFFleet:
    """Host-streaming fleet fit of this rank's tenants: every ``[K, m0,
    chunk]`` chunk is checked whole and only the rank's K/D slice of it is
    uploaded, so no device ever holds the fleet's full sample axis or
    another rank's tenants."""

    def place(a):
        _check_divisible(a.shape[0], mesh, "shard_batch")
        return a[_rank_slice(a.shape[0], mesh)]

    return fleet._fit_fleet_stream(
        config, batches, seeds=seeds, lam_hidden=lam_hidden,
        lam_last=lam_last, tenants=tenants, device=mesh.device, place=place,
    )


def sharded_fleet_fit(
    config: daef.DAEFConfig,
    xs,
    mesh,
    *,
    seeds=None,
    lam_hidden=None,
    lam_last=None,
    n_partitions: int = 1,
) -> fleet.DAEFFleet:
    """DEPRECATED — use ``DAEFEngine(config, ExecutionPlan(mode="mesh",
    tenants=K), mesh=mesh).fit(xs, ...)`` (`repro_torch.engine`).  Thin
    shim, identical behavior."""
    from repro_torch import engine as _engine

    _engine.deprecation.warn_once(
        "fleet_sharded.sharded_fleet_fit",
        "DAEFEngine(config, ExecutionPlan(mode='mesh', tenants=K), "
        "mesh=mesh).fit(xs, ...)",
    )
    if getattr(xs, "ndim", None) != 3:
        raise ValueError(
            f"fleet data must be [K, m0, n], got {getattr(xs, 'shape', None)}"
        )
    eng = _engine.DAEFEngine(
        config, _engine.ExecutionPlan(mode="mesh", tenants=int(xs.shape[0])),
        mesh=mesh,
    )
    return eng.fit(xs, seeds=seeds, lam_hidden=lam_hidden, lam_last=lam_last,
                   n_partitions=n_partitions)


def sharded_fleet_scores(
    config: daef.DAEFConfig,
    fl: fleet.DAEFFleet,
    xs,
    n_valid=None,
    *,
    mesh,
) -> torch.Tensor:
    """Per-sample anomaly scores of this rank's tenants, [K/D, n].

    ``xs`` is the global ``[K, m0, n]`` batch (a freshly padded serving
    batch may be a host ndarray); only the rank's slice is uploaded.
    Padding columns (j >= n_valid[k]) come back NaN exactly as in
    `fleet.fleet_scores`.
    """
    k = xs.shape[0]
    x_local = shard_batch(xs, mesh)
    if n_valid is not None:
        n_valid = _shard_vector(n_valid, k, mesh, torch.int64)
    return fleet.fleet_scores(config, fl, x_local, n_valid=n_valid, device=mesh.device)


def sharded_fleet_predict(
    config: daef.DAEFConfig, fl: fleet.DAEFFleet, xs, *, mesh
) -> torch.Tensor:
    """Reconstruct this rank's slice of a tenant batch, [K/D, m0, n]."""
    return fleet.fleet_predict(config, fl, shard_batch(xs, mesh), device=mesh.device)


def _donate(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """``new``'s values in ``old``'s storage where shapes allow (the
    reference's donated buffers), else ``new``."""
    if old.shape == new.shape and old.dtype == new.dtype and old.device == new.device:
        return old.copy_(new)
    return new


def sharded_fleet_partial_fit(
    config: daef.DAEFConfig, fl: fleet.DAEFFleet, xs_new, *, mesh,
    chunk_samples: int | None = None,
) -> fleet.DAEFFleet:
    """Incremental update for this rank's tenants, DONATING.

    ``xs_new`` is the global ``[K, m0, n_new]`` block.  The rank fits its
    slice, merges it into its shard (one batched merge and re-solve, the
    vmap plan's), and writes the merged values into the shard's own
    fixed-shape leaves (weights, biases, encoder factors, knowledge), so
    steady-state incremental serving holds one fleet, not two.  The input
    fleet's leaves hold the updated model afterwards; ``train_errors``
    grows and is a new tensor.
    """
    d = _devices(mesh)
    if xs_new.shape[0] != fl.size * d:
        raise ValueError(f"update batch has {xs_new.shape[0]} tenants, fleet {fl.size * d}")
    dev = mesh.device
    config = config.resolved(dev)
    if chunk_samples is not None:
        daef._require_gram(config, "chunked sharded partial_fit")
    x_local = shard_batch(xs_new, mesh)
    if chunk_samples is not None:
        update = fleet._fit_fleet_chunked(
            config, x_local, chunk_samples=chunk_samples, seeds=fl.seeds,
            lam_hidden=fl.lam_hidden, lam_last=fl.lam_last, device=dev,
        )
    else:
        update = fleet._fit_fleet(
            config, x_local, seeds=fl.seeds, lam_hidden=fl.lam_hidden,
            lam_last=fl.lam_last, device=dev,
        )
    merged = fleet.fleet_merge(config, fl, update)
    model = _rebuild(fl.model, [
        _donate(old, new) for old, new in zip(fleet._tree_leaves(fl.model),
                                              fleet._tree_leaves(merged.model),
                                              strict=True)
    ])
    return fleet.DAEFFleet(model=model, seeds=fl.seeds, lam_hidden=fl.lam_hidden,
                           lam_last=fl.lam_last)


# ---------------------------------------------------------------------------
# Cross-rank tree-reduce federation
# ---------------------------------------------------------------------------

def _merge_pair_knowledge(config: daef.DAEFConfig):
    """Pairwise merge on (enc factors, knowledge), batched over a leading
    axis — the fixed-shape part of the exchanged state."""
    merge = rolann.merge_stats if config.method == "gram" else rolann.merge_factors

    def pair(a, b):
        enc = dsvd.merge_pair(a[0], b[0])
        knw = tuple(merge(ka, kb) for ka, kb in zip(a[1], b[1], strict=True))
        return enc, knw

    return pair


def _merge_pair_state(config: daef.DAEFConfig):
    """Pairwise merge on the exchanged state (enc factors, knowledge,
    errors) — `daef.merge_knowledge` on the tuple the reduction threads."""
    pair_k = _merge_pair_knowledge(config)

    def pair(a, b):
        enc, knw = pair_k((a[0], a[1]), (b[0], b[1]))
        return enc, knw, torch.cat([a[2], b[2]], dim=-1)

    return pair


def _strided(tree, start: int):
    return fleet._tree_map(lambda leaf: leaf[start::2], tree)


def _butterfly(state, pair, mesh, local_rounds: int, cross_rounds: int):
    """Local strided rounds, then the cross-rank butterfly: in round r this
    rank swaps its state with rank ``d ^ 2^r`` (one flat buffer) and the
    lower rank's state merges first."""
    for _ in range(local_rounds):
        state = pair(_strided(state, 0), _strided(state, 1))
    me = mesh.coordinate(TENANT_AXIS) if cross_rounds else 0
    for r in range(cross_rounds):
        shift = 1 << r
        leaves = fleet._tree_leaves(state)
        if len({leaf.dtype for leaf in leaves}) != 1:
            raise ValueError("fleet_merge_tree: the exchanged state mixes dtypes")
        other = _rebuild(state, _unflat(mesh.exchange(_flat(leaves), me ^ shift), leaves))
        state = pair(state, other) if (me & shift) == 0 else pair(other, state)
    return state


def _every_nth(tree, stride: int):
    """Strided dedup of group-replicated leaves."""
    return fleet._tree_map(lambda leaf: leaf[::stride], tree)


def _one_rank_mesh(device) -> mesh_lib.Mesh:
    return mesh_lib.Mesh((1,), (TENANT_AXIS,), device=device)


def fleet_merge_tree(
    config: daef.DAEFConfig,
    fl: fleet.DAEFFleet,
    group_size: int,
    *,
    mesh=None,
) -> fleet.DAEFFleet:
    """Tree-reduce K site models into K/group_size logical models.

    Adjacent blocks of ``group_size`` tenants (a power of two) are federated
    nodes of one logical model: they must share a seed and lambdas, and they
    merge in left-to-right order, so the result matches the sequential
    ``functools.reduce(daef.merge_models, group)`` up to float error — with
    log2(group_size) merge depth and ONE weight solve.

    ``fl`` is this rank's shard of a fleet sharded over ``mesh`` (K = D ·
    fl.size); without a mesh, this rank's whole fleet on a one-rank mesh.
    Constraints (the reference's): K % D == 0 and the per-rank tenant count
    must divide, or be divisible by, group_size.  All violations raise
    ``ValueError`` on every rank before any exchange.  Returns this rank's
    shard of the result with local rounds only; with cross rounds the whole
    K/group_size result on every rank (see the module docstring).
    """
    if group_size < 1 or (group_size & (group_size - 1)):
        raise ValueError(
            f"fleet_merge_tree: group_size must be a positive power of two "
            f"(the butterfly exchanges partner d ^ 2^r each round), got "
            f"{group_size} — pad each group to the next power of two with "
            "zero-masked slots and reduce via merge_state_tree, or use "
            "DAEFEngine.reduce with merge='sequential' (any group size)"
        )
    if mesh is None:
        mesh = _one_rank_mesh(fl.seeds.device)
    d = mesh.shape.get(TENANT_AXIS, 1)
    k = fl.size * d
    if k % group_size:
        raise ValueError(
            f"fleet_merge_tree: group_size {group_size} must divide the "
            f"fleet size {k}"
        )
    # the groups' seeds and lambdas, every rank's: each rank raises alike
    head = fleet.DAEFFleet((), fl.seeds, fl.lam_hidden, fl.lam_last)
    if TENANT_AXIS in mesh.shape:
        head = gather_fleet(head, mesh)
    fleet._validate_groups(head, group_size)
    if group_size == 1:
        return fl
    if TENANT_AXIS not in mesh.shape:
        raise ValueError(f"mesh has no '{TENANT_AXIS}' axis: {mesh.axis_names}")
    _check_divisible(k, mesh, "fleet_merge_tree")
    local_k = fl.size
    if group_size <= local_k:
        if local_k % group_size:
            raise ValueError(
                f"per-shard tenant count {local_k} not divisible by "
                f"group_size {group_size}"
            )
        local_rounds, cross_rounds = group_size.bit_length() - 1, 0
    else:
        if group_size % local_k or local_k & (local_k - 1):
            raise ValueError(
                f"group_size {group_size} spans shards but per-shard tenant "
                f"count {local_k} is not a power-of-two divisor of it"
            )
        local_rounds = local_k.bit_length() - 1
        cross_rounds = (group_size // local_k).bit_length() - 1

    m = fl.model
    state = (m.encoder_factors, m.layer_knowledge, m.train_errors)
    state = _butterfly(state, _merge_pair_state(config), mesh, local_rounds, cross_rounds)
    stride = 1 << local_rounds
    seeds, lam_hidden, lam_last = fl.seeds[::stride], fl.lam_hidden[::stride], fl.lam_last[::stride]
    model = daef._model_from_knowledge(
        config, *state[:2], fleet._tenant_keys(config, seeds), lam_hidden, lam_last, state[2]
    )
    merged = fleet.DAEFFleet(model=model, seeds=seeds, lam_hidden=lam_hidden,
                             lam_last=lam_last)
    if cross_rounds:
        # Every rank of a group holds the group's model; keep the one of the
        # group's first rank, on every rank.
        merged = _every_nth(gather_fleet(merged, mesh), 1 << cross_rounds)
    return merged


# ---------------------------------------------------------------------------
# Masked subset tree-reduce — partial participation on the same butterfly
# ---------------------------------------------------------------------------

def merge_state_tree(
    config: daef.DAEFConfig,
    enc: dsvd.SvdFactors,
    knowledge: tuple,
    mask,
    *,
    mesh=None,
) -> tuple[dsvd.SvdFactors, tuple]:
    """Tree-reduce a stacked batch of federated states over a SUBSET mask.

    ``enc`` / ``knowledge`` carry a leading slot axis of S stacked site
    states (S a power of two — pad with arbitrary slots and zero their mask
    entries); every rank passes the same S slots and reduces its S/D of
    them, then the ranks run the butterfly.  ``mask`` ([S] in {0, 1})
    selects who participates: masked slots are scaled to the merge identity
    (`rolann.mask_knowledge` / zeroed encoder singular values) BEFORE the
    reduction, so excluded sites ride along as no-ops.

    Requires ``method="gram"``.  Raises ``ValueError`` on a non-power-of-two
    S or an all-zero mask (the reference's errors, word for word).  Returns
    the merged ``(enc_factors, knowledge)`` with the slot axis reduced
    away, the same on every rank.  The caller re-solves weights once from
    the result (`daef._model_from_knowledge`).
    """
    config = config.resolved(enc.u.device)
    if config.method != "gram":
        raise ValueError(
            "merge_state_tree: masked tree reduction stacks site states into "
            "one fixed-shape batch, but method='svd' factor knowledge is "
            "rank-ragged across sites — use the host reduce "
            "(federated.merge_exchange_states) or method='gram'"
        )
    s_count = int(enc.u.shape[0])
    if s_count < 1 or (s_count & (s_count - 1)):
        raise ValueError(
            f"merge_state_tree: slot count must be a positive power of two "
            f"(the butterfly exchanges partner d ^ 2^r each round), got "
            f"{s_count} — pad the batch with zero-masked slots"
        )
    mask = mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor) else np.asarray(mask)
    if mask.shape != (s_count,):
        raise ValueError(
            f"merge_state_tree: mask must be [{s_count}] (one entry per "
            f"slot), got shape {mask.shape}"
        )
    if not mask.any():
        raise ValueError(
            "merge_state_tree: all slots masked out — nothing to merge "
            "(an async refresh with no fresh sites keeps the previous model)"
        )

    w = torch.as_tensor(mask, dtype=enc.u.dtype, device=enc.u.device)
    enc = dsvd.SvdFactors(u=enc.u, s=enc.s * w[:, None])
    knowledge = tuple(rolann.mask_knowledge(k, w) for k in knowledge)

    if mesh is None:
        mesh = _one_rank_mesh(enc.u.device)
    if TENANT_AXIS not in mesh.shape:
        raise ValueError(f"mesh has no '{TENANT_AXIS}' axis: {mesh.axis_names}")
    d = mesh.shape[TENANT_AXIS]
    if s_count % d:
        raise ValueError(
            f"merge_state_tree: slot count {s_count} must divide evenly over "
            f"the {d}-device '{TENANT_AXIS}' mesh axis"
        )
    local = s_count // d
    if local & (local - 1) or d & (d - 1):
        raise ValueError(
            f"merge_state_tree: per-device slot count {local} and device "
            f"count {d} must both be powers of two"
        )
    sl = _rank_slice(s_count, mesh)
    state = fleet._tree_map(lambda leaf: leaf[sl].to(mesh.device), (enc, knowledge))
    state = _butterfly(state, _merge_pair_knowledge(config), mesh,
                       local.bit_length() - 1, d.bit_length() - 1)
    # The root state is replicated across the remaining slot axis; keep one.
    return fleet._tree_map(lambda leaf: leaf[0], state)


def merge_wire_tree(wires: list) -> list:
    """The butterfly reduction over secagg FIXED-POINT wires, on the host.

    Secure-aggregation wires (`repro_torch.privacy.secagg`) are lists of
    uint64 leaves whose arithmetic is mod 2^64, so the tree strategy for
    masked exchanges runs the SAME distance-doubling partner pairing as the
    state butterfly (slot d pairs with d ^ 2^r each round) in numpy.
    Modular addition is associative and commutative, so the result is
    bit-identical to a sequential fold.

    Non-power-of-two wire counts are padded with zero wires (the additive
    identity — the wire-level analogue of `merge_state_tree`'s masked
    slots).
    """
    if not wires:
        raise ValueError("merge_wire_tree: empty wire list")
    n = len(wires)
    size = 1 << max(0, n - 1).bit_length() if n > 1 else 1
    zeros = [np.zeros_like(np.asarray(leaf, np.uint64)) for leaf in wires[0]]
    slots = [
        [np.asarray(leaf, np.uint64) for leaf in w] for w in wires
    ] + [zeros] * (size - n)
    dist = 1
    while dist < size:
        slots = [
            [a + b for a, b in zip(slots[k], slots[k ^ dist], strict=True)]
            for k in range(size)
        ]
        dist *= 2
    return slots[0]
