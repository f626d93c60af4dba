"""ROLANN — Regularized One-Layer Neural Network (Fontenla-Romero et al. 2021).

Counterpart of ``repro/core/rolann.py``.  Closed-form training of a
one-layer network ``y = f(W^T x + b)`` by minimizing the MSE measured
*before* the activation; for each output neuron j

    (G_j + lam I) w_j = M_j,   G_j = Xa F_j² Xaᵀ,   M_j = Xa (f'² ∘ d̄_j)

with ``Xa`` the input augmented with a row of ones (bias).  Two
representations of the same knowledge:

* **Gram** ``(G, M)`` (:class:`RolannStats`): merging is a plain sum;
* **Factors** ``(U, S, M)`` (:class:`RolannFactors`), the paper's:
  ``U, S = SVD(Xa F_j)`` (:func:`compute_factors`), merged by the SVD of
  ``[U_a S_a | U_b S_b]`` (Eq. 8, :func:`merge_factors`) plus ``M_a + M_b``
  (Eq. 9).  ``G = U S² Uᵀ`` links the two (:func:`stats_to_factors`,
  :func:`factors_to_stats`); only ``U S² Uᵀ`` and ``M`` enter the weights.

Data matrices are ``[features, samples]``; targets ``[outputs, samples]``.

The streaming fit folds chunks through :func:`init_stats` and
:func:`accumulate_stats` (in place); :func:`merge_stats` sums two Gram-form
contributions.  A tenant fleet computes and folds every tenant's statistics
at once through :func:`compute_stats_batched` and
:func:`accumulate_stats_batched` (leading tenant axis [K] on every tensor,
``init_stats(tenants=K)``), and :func:`solve` takes the batch with one
lambda per tenant.  The factor functions work on leading batch axes too (a
fleet's [K]): :func:`compute_factors_batched` factors every tenant's layer,
and the merges and :func:`factors_to_stats` act on the trailing axes.

The SVDs keep only U and S (``dsvd.left_svd``: the SVD of the R of a QR
of the tall transpose), so the right factors of an [m, n] matrix with n
in the hundreds of thousands are never formed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import activations, dsvd, stats_backend
from repro_torch.device import resolve_device


class RolannFactors(NamedTuple):
    """Factor-form knowledge (U, S, M); ``out`` axis absent when F is shared.

      u: [out, m, r]   s: [out, r]   m: [out, m]
    """

    u: torch.Tensor
    s: torch.Tensor
    m: torch.Tensor

    @property
    def shared_f(self) -> bool:
        return self.u.ndim == 2


class RolannStats(NamedTuple):
    """Gram-form incremental knowledge (G, M); ``G = U S^2 U^T``.

      g: [out, m, m] (or [m, m] when F is shared)
      m: [out, m]
    """

    g: torch.Tensor
    m: torch.Tensor

    @property
    def shared_f(self) -> bool:
        return self.g.ndim == 2


def _augment(x: torch.Tensor) -> torch.Tensor:
    """Append the bias row of ones: [m, n] -> [m+1, n]."""
    return torch.cat([x, torch.ones((1, x.shape[1]), dtype=x.dtype, device=x.device)])


def _targets(
    d: torch.Tensor, act: activations.Activation
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (dbar, fprime) per output/sample for targets d [out, n]."""
    d = act.clip_to_range(d)
    dbar = act.inv(d)
    fprime = act.deriv(dbar)
    return dbar, fprime


def compute_stats(
    x: torch.Tensor, d: torch.Tensor, act: activations.Activation, *,
    backend: str | None = None,
) -> RolannStats:
    """Gram-form statistics for inputs x [m, n] and targets d [out, n].

    ``backend`` selects the per-output Gram producer (``stats_backend``).  A
    linear activation shares one Gram across outputs: a single matmul.
    """
    act = activations.get(act.name, invertible_required=True)
    xa = _augment(x)  # [m+1, n]
    dbar, fp = _targets(d, act)
    fsq = fp * fp
    if act.name == "linear":
        m_vec = torch.einsum("in,on->oi", xa, fsq * dbar)
        return RolannStats(g=xa @ xa.T, m=m_vec)
    g, m_vec = stats_backend.gram_stats(xa, fsq, fsq * dbar, backend=backend)
    return RolannStats(g=g, m=m_vec)


def init_stats(
    n_inputs: int, n_outputs: int, act: activations.Activation,
    dtype: torch.dtype = torch.float32, *, device=None, tenants: int | None = None,
) -> RolannStats:
    """Zero Gram-form accumulators on ``device`` (``None``: the card) for a
    streamed fit over inputs [n_inputs, ·] and targets [n_outputs, ·] — the
    identity of :func:`merge_stats`.  A linear activation shares one Gram
    across outputs (see :func:`compute_stats`).  ``tenants=K`` puts a leading
    tenant axis on both (a fleet's accumulators)."""
    dev = resolve_device(device)
    m_aug = n_inputs + 1  # bias row
    lead = () if tenants is None else (tenants,)
    shape = (m_aug, m_aug) if act.name == "linear" else (n_outputs, m_aug, m_aug)
    return RolannStats(g=torch.zeros((*lead, *shape), dtype=dtype, device=dev),
                       m=torch.zeros((*lead, n_outputs, m_aug), dtype=dtype, device=dev))


def accumulate_stats(
    stats: RolannStats,
    x: torch.Tensor,
    d: torch.Tensor,
    act: activations.Activation,
    *,
    weights: torch.Tensor | None = None,
    backend: str | None = None,
) -> RolannStats:
    """Fold one sample chunk into running Gram-form statistics, **in place**.

    Mathematically ``merge_stats(stats, compute_stats(x, d, act))`` — the
    paper's Eq. 6-7 statistics are additive over sample blocks — computed as
    one fold that adds into ``stats.g`` and ``stats.m`` and returns
    ``stats`` (the reference donated the running stats instead).  A
    non-linear activation folds through ``stats_backend.gram_stats_acc``
    (the B2 kernel on the fused backend); the linear one shares one Gram,
    ``xw @ xa.T``.

    ``weights`` ([n] in {0, 1}) masks padded sample columns: a zero weight
    removes the column's contribution to both G and M exactly, so ragged
    chunks can be padded to a fixed shape without biasing the statistics.
    The order is the reference's: clip, inv, deriv, fsq, fd, then the mask.
    """
    act = activations.get(act.name, invertible_required=True)
    xa = _augment(x)  # [m+1, n]
    dbar, fp = _targets(d, act)
    fsq = fp * fp
    fd = fsq * dbar
    if weights is not None:
        w = weights.to(xa.dtype)
        fsq = fsq * w[None, :]
        fd = fd * w[None, :]
    if act.name == "linear":
        # Shared F: fp == 1, so masking must hit the Gram's columns directly.
        xw = xa if weights is None else xa * w[None, :]
        stats.g.add_(xw @ xa.T)
        stats.m.add_(torch.einsum("in,on->oi", xa, fd))
        return stats
    stats_backend.gram_stats_acc(stats.g, stats.m, xa, fsq, fd, backend=backend)
    return stats


def _augment_batched(x: torch.Tensor) -> torch.Tensor:
    """Append the bias row of ones to every tenant: [K, m, n] -> [K, m+1, n]."""
    ones = torch.ones((x.shape[0], 1, x.shape[2]), dtype=x.dtype, device=x.device)
    return torch.cat([x, ones], dim=1)


def compute_stats_batched(
    x: torch.Tensor, d: torch.Tensor, act: activations.Activation, *,
    backend: str | None = None,
) -> RolannStats:
    """:func:`compute_stats` for every tenant at once: x [K, m, n], d
    [K, out, n] -> G [K, out, m+1, m+1] (one launch of the B4 kernel on the
    fused backend), or the shared Gram [K, m+1, m+1] of a linear layer."""
    act = activations.get(act.name, invertible_required=True)
    xa = _augment_batched(x)  # [K, m+1, n]
    dbar, fp = _targets(d, act)
    fsq = fp * fp
    if act.name == "linear":
        m_vec = torch.einsum("kin,kon->koi", xa, fsq * dbar)
        return RolannStats(g=xa @ xa.transpose(-1, -2), m=m_vec)
    g, m_vec = stats_backend.gram_stats_batched(xa, fsq, fsq * dbar, backend=backend)
    return RolannStats(g=g, m=m_vec)


def compute_factors_batched(
    x: torch.Tensor, d: torch.Tensor, act: activations.Activation
) -> RolannFactors:
    """:func:`compute_factors` for every tenant at once: x [K, m, n], d
    [K, out, n] -> u [K, out, m+1, r], s [K, out, r], m [K, out, m+1] (no out
    axis on u and s for a linear activation); batched QRs and SVDs."""
    act = activations.get(act.name, invertible_required=True)
    return _factors(_augment_batched(x), d, act)


def accumulate_stats_batched(
    stats: RolannStats,
    x: torch.Tensor,
    d: torch.Tensor,
    act: activations.Activation,
    *,
    weights: torch.Tensor | None = None,
    backend: str | None = None,
) -> RolannStats:
    """:func:`accumulate_stats` for every tenant at once, **in place**:
    x [K, m, n], d [K, out, n] folded into accumulators with a leading [K]
    (one launch of the B5 kernel on the fused backend for a non-linear
    activation).  ``weights`` [K, n] masks each tenant's padded columns."""
    act = activations.get(act.name, invertible_required=True)
    xa = _augment_batched(x)
    dbar, fp = _targets(d, act)
    fsq = fp * fp
    fd = fsq * dbar
    if weights is not None:
        w = weights.to(xa.dtype)[:, None, :]
        fsq = fsq * w
        fd = fd * w
    if act.name == "linear":
        xw = xa if weights is None else xa * w
        stats.g.add_(xw @ xa.transpose(-1, -2))
        stats.m.add_(torch.einsum("kin,kon->koi", xa, fd))
        return stats
    stats_backend.gram_stats_acc_batched(stats.g, stats.m, xa, fsq, fd, backend=backend)
    return stats


def _factors(xa: torch.Tensor, d: torch.Tensor, act: activations.Activation) -> RolannFactors:
    """Factor-form statistics of augmented inputs xa [..., m, n] and targets
    d [..., out, n] (leading axes batched): per output j the SVD of
    ``Xa diag(f'_j)``, one shared SVD of ``Xa`` for a linear activation."""
    dbar, fp = _targets(d, act)
    m_vec = torch.einsum("...in,...on->...oi", xa, fp * fp * dbar)
    if act.name == "linear":
        u, s = dsvd.left_svd(xa)
    else:
        u, s = dsvd.left_svd(xa.unsqueeze(-3) * fp.unsqueeze(-2))  # [..., out, m, n]
    return RolannFactors(u=u, s=s, m=m_vec)


def compute_factors(
    x: torch.Tensor, d: torch.Tensor, act: activations.Activation
) -> RolannFactors:
    """Paper-faithful statistics via the SVD of Xa F (Eq. 6-7) for inputs
    x [m, n] and targets d [out, n]: u [out, m+1, r], s [out, r] (no out
    axis for a linear activation, whose F is shared), m [out, m+1], with
    r = min(m+1, n)."""
    act = activations.get(act.name, invertible_required=True)
    return _factors(_augment(x), d, act)


def compute_factors_via_gram(
    x: torch.Tensor, d: torch.Tensor, act: activations.Activation, *,
    backend: str | None = None,
) -> RolannFactors:
    """Paper-protocol factors (U, S, M) from the local Gram by eigh: the
    same U S² Uᵀ as :func:`compute_factors`, with no [m, n_local] SVD.  On
    the fused backend the Gram is the B1 kernel's."""
    return stats_to_factors(compute_stats(x, d, act, backend=backend))


def factors_to_stats(f: RolannFactors) -> RolannStats:
    """Gram form of factor knowledge: G = U S² Uᵀ (leading axes batched)."""
    g = (f.u * (f.s * f.s).unsqueeze(-2)) @ f.u.transpose(-1, -2)
    return RolannStats(g=g, m=f.m)


def merge_stats(a: RolannStats, b: RolannStats) -> RolannStats:
    """Gram-form merge: a plain sum (new tensors; ``a`` and ``b`` are kept)."""
    return RolannStats(g=a.g + b.g, m=a.m + b.m)


def mask_knowledge(knowledge, w):
    """Scale a knowledge contribution by ``w`` (in {0, 1}).

    ``w = 0`` turns the contribution into the merge identity of either
    representation: zeroed (G, M) adds nothing to a Gram sum, and zeroed
    singular values make the factor columns vanish from the concatenated
    SVD (Eq. 8) while M drops out of Eq. 9.  ``w`` broadcasts from the left:
    a scalar masks one contribution, a leading [S] vector a stacked batch of
    S contributions.
    """

    def scale(leaf):
        wt = torch.as_tensor(w, dtype=leaf.dtype, device=leaf.device)
        return leaf * wt.reshape(wt.shape + (1,) * (leaf.ndim - wt.ndim))

    if isinstance(knowledge, RolannStats):
        return RolannStats(g=scale(knowledge.g), m=scale(knowledge.m))
    return RolannFactors(u=knowledge.u, s=scale(knowledge.s), m=scale(knowledge.m))


def merge_factors(a: RolannFactors, b: RolannFactors) -> RolannFactors:
    """The paper's Eq. 8-9: the SVD of the concatenated weighted factors
    ``[U_a S_a | U_b S_b]``, truncated to rank m (the row dimension, exact:
    the concatenation has rank <= m), and ``M_a + M_b``.  Leading axes (the
    outputs, a fleet's tenants) are batched."""
    return merge_factors_list([a, b])


def merge_factors_list(items: list[RolannFactors]) -> RolannFactors:
    """Merge P partitions as the paper does at the aggregator node: one SVD
    of the whole concatenation [U^1 S^1 | ... | U^P S^P]."""
    if not items:
        raise ValueError("empty factor list")
    if len({f.shared_f for f in items}) != 1:
        raise ValueError("cannot merge shared-F with per-output factors")
    cat = torch.cat([f.u * f.s.unsqueeze(-2) for f in items], dim=-1)
    u, s = dsvd.left_svd(cat)
    m_dim = cat.shape[-2]
    m = sum(f.m for f in items[1:]) + items[0].m
    return RolannFactors(u=u[..., :m_dim], s=s[..., :m_dim], m=m)


def stats_to_factors(stats: RolannStats) -> RolannFactors:
    """Convert Gram form to factor form via eigh (G = U S^2 U^T), in the
    SVD's descending order.

    On the card a float32 G is decomposed in float64 and the result rounded
    back.  At the creditcard fit's layer Grams (condition numbers 3e6–1e10)
    cuSOLVER's float32 eigh left the eigenvalues 2–3x and the smallest ones
    up to 9x farther from float64's than LAPACK's float32 eigh on the host,
    which put the fit by ``local_factorization="gram_eigh"`` 0.131 from its
    float64 fit against 8.3e-3 on the host; at these sizes float64 costs the
    card no more time (PERF.md, PR 33)."""
    g = stats.g
    if g.is_cuda and g.dtype == torch.float32:
        evals, evecs = (t.to(g.dtype) for t in torch.linalg.eigh(g.double()))
    else:
        evals, evecs = torch.linalg.eigh(g)
    evals = torch.clamp(evals, min=0.0)
    u = torch.flip(evecs, dims=(-1,))
    s = torch.sqrt(torch.flip(evals, dims=(-1,)))
    return RolannFactors(u=u, s=s, m=stats.m)


GRAM_SOLVERS = ("chol", "auto", "eigh")


def _lam(lam, knowledge_leaf: torch.Tensor, trailing: int):
    """``lam`` as it broadcasts against ``knowledge_leaf``: a Python number
    as it is; a per-tenant tensor [K] (a fleet's) with ``trailing`` unit
    axes behind it."""
    if isinstance(lam, torch.Tensor) and lam.ndim:
        return lam.to(knowledge_leaf.dtype).reshape(*lam.shape, *(1,) * trailing)
    return lam


def _solve_factors(knowledge: RolannFactors, lam, shared_f: bool) -> torch.Tensor:
    """Factor-form augmented weights: w_aug[:, j] = U (S^2+lam)^-1 U^T m_j.
    Leading tenant axes pass through; ``lam`` may be one per tenant."""
    u, s, m = knowledge
    if shared_f:
        proj = u.transpose(-1, -2) @ m.transpose(-1, -2)  # [..., r, out]
        return u @ (proj / (s * s + _lam(lam, s, 1))[..., :, None])  # [..., m, out]
    proj = torch.einsum("...oir,...oi->...or", u, m)
    w = torch.einsum("...oir,...or->...oi", u, proj / (s * s + _lam(lam, s, 2)))
    return w.transpose(-1, -2)  # [..., m, out]


def _solve_stats_chol(stats: RolannStats, lam, shared_f: bool) -> torch.Tensor:
    """Gram-form augmented weights by Cholesky: (G + lam I) w_j = m_j.
    Leading tenant axes pass through; ``lam`` may be one per tenant [K].

    Where ``G + lam I`` is not positive definite the weights are NaN, as the
    reference's ``jnp.linalg.cholesky`` makes them (``torch.linalg.cholesky``
    would raise instead); in a fleet, only that tenant's (or output's).
    """
    m_dim = stats.m.shape[-1]
    eye = torch.eye(m_dim, dtype=stats.g.dtype, device=stats.g.device)
    lam_b = _lam(lam, stats.g, 2 if shared_f else 3)
    chol, info = torch.linalg.cholesky_ex(stats.g + lam_b * eye)
    if shared_f:
        w = torch.cholesky_solve(stats.m.transpose(-1, -2), chol)  # [..., m, out]
        return torch.where((info == 0)[..., None, None], w, torch.nan)
    w = torch.cholesky_solve(stats.m.unsqueeze(-1), chol).squeeze(-1)  # [..., out, m]
    return torch.where((info == 0)[..., None], w, torch.nan).transpose(-1, -2)  # [..., m, out]


def solve(
    knowledge: RolannStats | RolannFactors, lam, *, gram_solver: str = "chol",
    shared_f: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (W [m_in, out], b [out]) from accumulated knowledge (Eq. 10).

    ``gram_solver`` selects the route for Gram knowledge:

    * ``"chol"`` (default) — direct Cholesky solve;
    * ``"eigh"``           — eigh of G, then the factor solve;
    * ``"auto"``           — Cholesky, redone by the eigh route where a
                             factorization failed or the solution is not
                             finite (one host sync to decide; in a fleet,
                             per tenant, as the reference's vmapped
                             ``lax.cond`` selects).

    Factor-form knowledge always uses the factor solve.

    A fleet's knowledge carries a leading tenant axis [K] on every leaf, and
    ``lam`` may then be a [K] tensor; W and b come back [K, m_in, out] and
    [K, out].  The layer's kind cannot be read from the leaves' rank then (a
    fleet's shared Gram [K, m, m] has the rank of one tenant's per-output G),
    so a fleet passes ``shared_f``; ``None`` reads it from one tenant's
    knowledge (``knowledge.shared_f``).
    """
    if gram_solver not in GRAM_SOLVERS:
        raise ValueError(
            f"unknown gram_solver {gram_solver!r}: choose from {GRAM_SOLVERS}"
        )
    shared = knowledge.shared_f if shared_f is None else shared_f
    if isinstance(knowledge, RolannStats) and gram_solver != "eigh":
        w_aug = _solve_stats_chol(knowledge, lam, shared)
        if gram_solver == "auto":
            finite = torch.isfinite(w_aug).all(dim=-1).all(dim=-1)  # per tenant
            if not bool(finite.all()):
                w_fac = _solve_factors(stats_to_factors(knowledge), lam, shared)
                w_aug = torch.where(finite[..., None, None], w_aug, w_fac)
        return w_aug[..., :-1, :], w_aug[..., -1, :]
    if isinstance(knowledge, RolannStats):
        knowledge = stats_to_factors(knowledge)
    w_aug = _solve_factors(knowledge, lam, shared)
    return w_aug[..., :-1, :], w_aug[..., -1, :]


def fit(
    x: torch.Tensor,
    d: torch.Tensor,
    act: activations.Activation,
    lam: float,
    *,
    method: str = "gram",
    backend: str | None = None,
    gram_solver: str = "chol",
) -> tuple[torch.Tensor, torch.Tensor, RolannStats | RolannFactors]:
    """One-shot ROLANN fit.  Returns (W, b, knowledge).

    method: "gram" (sufficient statistics, solved by ``gram_solver``) or
    "svd" (the paper's factors, solved by the factor solve).
    backend: Gram-stats producer for the "gram" method (stats_backend).
    """
    if method == "gram":
        knowledge: RolannStats | RolannFactors = compute_stats(x, d, act, backend=backend)
    elif method == "svd":
        knowledge = compute_factors(x, d, act)
    else:
        raise ValueError(f"unknown ROLANN method {method!r}")
    w, b = solve(knowledge, lam, gram_solver=gram_solver)
    return w, b, knowledge


def predict(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: activations.Activation
) -> torch.Tensor:
    """Apply the trained one-layer network: f(W^T x + b)."""
    return act.fn(w.T @ x + b[:, None])
