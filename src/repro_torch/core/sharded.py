"""DAEF on a device mesh: federated node == data-parallel shard
(counterpart of ``repro/core/sharded.py``).

The paper's broker protocol on a mesh: every rank along the data axes
holds one partition X^p of the samples, ``x[:, p·n/D:(p+1)·n/D]``, and
plays one federated node.  The aggregation collective depends on the
representation:

* ``method="gram"`` — a sum of (G, M) per layer (and of the encoder Gram)
  over the data axes: an ``all_gather`` and a sum in rank order
  (``launch.mesh.Mesh.psum``), so gloo and NCCL add in the same order and
  repeats are bit-identical;
* ``method="svd"`` — an ``all_gather`` of the local U·S blocks along their
  columns, in rank order, followed by the merge SVD at every node (the
  paper's broker "send to all").

Every rank ends with the same weights; the per-sample train errors stay
with their shard (rank p holds its samples' errors, in sample order).  The
layer loop is a Python loop: DAEF is non-iterative and shallow.  Each
rank's statistics are the one-tenant ones (B1 on the fused backend).

The reference's ``_replicated`` only satisfies shard_map's VMA check and
has no counterpart.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core import daef, dsvd, elm_ae, fleet_sharded, rolann
from repro_torch.device import as_tensor


def _shard_bounds(n: int, mesh, axes) -> tuple[int, int]:
    for ax in axes:
        if ax not in mesh.shape:
            raise ValueError(f"mesh {mesh.shape} has no data axis {ax!r}")
    idx, count = mesh.index(axes)
    if n % count:
        raise ValueError(
            f"data mesh: {n} samples do not divide evenly over the {count} "
            f"shards of the data axes {tuple(axes)}"
        )
    per = n // count
    return idx * per, (idx + 1) * per


def shard_samples(x, mesh, axes) -> torch.Tensor:
    """This rank's partition of the samples of ``x`` [m0, n] (host array or
    tensor), on the rank's device: only the slice is uploaded."""
    lo, hi = _shard_bounds(x.shape[-1], mesh, axes)
    return as_tensor(x[..., lo:hi], mesh.device).contiguous()


def _gather_merge_svd(us: torch.Tensor, mesh, axes) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather the local U·S blocks [..., m, r] along their columns in rank
    order and re-SVD: the merged (u, s) truncated to m columns — the mesh
    version of Eq. (2)/(8), signs canonical as the host merge's."""
    gathered = mesh.gather(us, axes, dim=us.ndim - 1)
    u, s = dsvd.left_svd(gathered)
    m = us.shape[-2]
    return dsvd.canonicalize_signs(u[..., :m]), s[..., :m]


def _merge(local, use_gram: bool, mesh, axes):
    if use_gram:
        leaves = [local.g, local.m]   # one buffer a gather
        return rolann.RolannStats(*fleet_sharded._unflat(
            mesh.psum(fleet_sharded._flat(leaves), axes), leaves))
    u, s = _gather_merge_svd(local.u * local.s[..., None, :], mesh, axes)
    return rolann.RolannFactors(u=u, s=s, m=mesh.psum(local.m, axes))


def fit_on_mesh(
    config: daef.DAEFConfig,
    x,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
    local_factorization: str = "gram_eigh",
) -> daef.DAEFModel:
    """DEPRECATED — use ``DAEFEngine(config, ExecutionPlan(mode="mesh",
    mesh_axes=data_axes, local_factorization=...), mesh=mesh).fit(x)``
    (`repro_torch.engine`).  Thin shim, identical behavior."""
    from repro_torch import engine as _engine

    _engine.deprecation.warn_once(
        "sharded.fit_on_mesh",
        "DAEFEngine(config, ExecutionPlan(mode='mesh', mesh_axes=data_axes), "
        "mesh=mesh).fit(x)",
    )
    eng = _engine.DAEFEngine(
        config,
        _engine.ExecutionPlan(
            mode="mesh", mesh_axes=tuple(data_axes),
            local_factorization=local_factorization,
        ),
        mesh=mesh,
    )
    return eng.fit(x)


def _fit_on_mesh(
    config: daef.DAEFConfig,
    x,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
    local_factorization: str = "gram_eigh",
) -> daef.DAEFModel:
    """Fit DAEF with the sample axis sharded over ``data_axes`` of ``mesh``
    (the engine's data-sharded mode="mesh" path; `fit_on_mesh` is its
    deprecation shim).

    x: [m0, n], the same on every rank; n must divide evenly over the
    product of the data axes.  Returns a DAEFModel whose weights are the
    same on every rank and whose train_errors are this rank's samples'.
    """
    axes = tuple(data_axes)
    xp = shard_samples(x, mesh, axes)
    config = config.resolved(xp.device)
    f_hl, f_ll = daef._acts(config)
    keys = config.layer_keys()
    sizes = config.layer_sizes
    use_gram = config.method == "gram"
    backend = config.stats_backend

    # ---------------- encoder ----------------
    if use_gram:
        enc = dsvd.gram_to_factors(mesh.psum(xp @ xp.T, axes))
    else:
        # Local factors: eigh of the local Gram (default) carries the same
        # U·S message as the paper's direct SVD without its O(m·n_local)
        # right-factor workspace.
        f = (dsvd.gram_to_factors(dsvd.gram(xp)) if local_factorization == "gram_eigh"
             else dsvd.local_svd(xp))
        enc = dsvd.SvdFactors(*_gather_merge_svd(f.u * f.s[None, :], mesh, axes))
    w_enc = enc.u[:, : config.latent_dim]
    h = f_hl.fn(w_enc.T @ xp)

    weights = [w_enc]
    biases: list[torch.Tensor] = []
    knowledge: list = []

    # ---------------- decoder hidden layers ----------------
    for li in range(2, len(sizes) - 1):
        local = elm_ae.layer_knowledge_from_partition(
            keys[li], h, sizes[li], f_hl, init=config.init, method=config.method,
            factorization=local_factorization, backend=backend,
        )
        merged = _merge(local, use_gram, mesh, axes)
        w, b = elm_ae.layer_from_knowledge(
            merged, keys[li], sizes[li - 1], sizes[li], config.lam_hidden, f_hl,
            init=config.init, aux_bias=config.aux_bias, dtype=xp.dtype,
            gram_solver=config.gram_solver,
        )
        weights.append(w)
        biases.append(b)
        knowledge.append(merged)
        h = f_hl.fn(w.T @ h + b[:, None])

    # ---------------- last layer ----------------
    if use_gram:
        local = rolann.compute_stats(h, xp, f_ll, backend=backend)
    elif local_factorization == "gram_eigh":
        local = rolann.compute_factors_via_gram(h, xp, f_ll, backend=backend)
    else:
        local = rolann.compute_factors(h, xp, f_ll)
    merged = _merge(local, use_gram, mesh, axes)
    w_ll, b_ll = rolann.solve(merged, config.lam_last, gram_solver=config.gram_solver)
    weights.append(w_ll)
    biases.append(b_ll)
    knowledge.append(merged)

    recon = f_ll.fn(w_ll.T @ h + b_ll[:, None])
    return daef.DAEFModel(
        weights=tuple(weights),
        biases=tuple(biases),
        encoder_factors=enc,
        layer_knowledge=tuple(knowledge),
        train_errors=torch.mean((recon - xp) ** 2, dim=0),
    )


def predict_on_mesh(
    config: daef.DAEFConfig,
    model: daef.DAEFModel,
    x,
    mesh,
    *,
    data_axes: Sequence[str] = ("data",),
) -> torch.Tensor:
    """Reconstruction of this rank's samples of ``x`` [m0, n]: [m0, n/D]."""
    return daef.predict(config, model, shard_samples(x, mesh, tuple(data_axes)),
                        device=mesh.device)


def gather_samples(t: torch.Tensor, mesh, data_axes: Sequence[str] = ("data",)) -> torch.Tensor:
    """Every rank's per-sample values (train errors, scores) along the last
    axis, in sample order."""
    axes = [a for a in mesh.axis_names if a in tuple(data_axes)]
    # innermost axis first: the shards of a pod join before the pods do
    return mesh.gather(t, axes[::-1], dim=t.ndim - 1)
