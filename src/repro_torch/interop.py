"""Carry DAEF models, fleets and LM parameters between the JAX package and
the port as numpy leaves.

A model crosses as the list of its leaves in ``jax.tree.flatten`` order of
the reference ``DAEFModel``:

    weights[0..L-1], biases[0..L-2], encoder_factors.u, encoder_factors.s,
    then each layer's knowledge, then train_errors

with ``L = len(config.layer_sizes) - 1``; a layer's knowledge is (g, m)
for the gram method and (u, s, m) for the svd method (``config.method``
says which).  A fleet crosses the same way as
the leaves of ``jax.tree.flatten(DAEFFleet)``: the model's leaves, each with
a leading [K], then ``seeds`` (int32), ``lam_hidden`` and ``lam_last``.
Neither side needs the other's framework: the JAX side flattens with
``jax.tree.flatten`` and converts each leaf with ``numpy.asarray``; this
module does the rest.

LM parameters cross as the reference's own nested tree (dicts and lists) of
numpy arrays, ``jax.tree.map(numpy.asarray, params)``, and
:func:`lm_params_from_numpy` maps it leaf for leaf onto the port's
parameter tree, which has the same structure: the same keys, each leaf a
tensor of the same shape and dtype.  Weights keep the reference's ``[in,
out]`` orientation (the port computes ``x @ w`` as the reference does);
layer stacks keep their leading axis (``layers`` [L, ...] of the dense, VLM
and SSM families, the MoE family's ``dense_layers`` [first_dense_layers,
...] and ``moe_layers`` [L - first_dense_layers, ...], the
encoder-decoder's ``enc_layers`` [n_encoder_layers, ...] and ``dec_layers``
[L, ...], ``periods``
[n_periods, ...] of the hybrid, whose remainder blocks stay the list
``tail``); the VLM's ``projector`` crosses as it is.

A site's published exchange state — the triple ``(encoder factors,
per-layer knowledge, train errors)`` a federation session keeps per site —
crosses as the leaves of ``jax.tree.flatten(state)``: ``u``, ``s``, each
layer's knowledge, the errors (:func:`exchange_state_from_numpy`,
:func:`exchange_state_to_numpy`).

An LM decode cache crosses as the leaves of ``jax.tree.flatten(cache)`` of
the reference's ``KVCache``, ``MoECaches`` (of ``KVCache`` or ``MLACache``
stacks), ``Mamba2Cache``, ``RGCache`` or ``EncDecCache`` (the self K and V,
then the cross pair) as numpy arrays (an ``RGCache``
flattens its period dicts in sorted key order, then the tail's states one
by one; a ``None`` field, ``MoECaches.dense`` of a model without dense
layers, has no leaves, as ``jax.tree.flatten`` skips it):
:func:`lm_cache_from_numpy` rebuilds the port's cache of the same
NamedTuples from them, :func:`lm_cache_to_numpy` gives them back in that
order.

An Adam state crosses as its three fields (step, mu, nu), each converted
with ``jax.tree.map(numpy.asarray, ...)`` on the JAX side; mu and nu have
the parameters' tree (:func:`adam_state_from_numpy`,
:func:`adam_state_to_numpy`), so both packages can start a train step from
the same optimiser state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import dsvd, rolann
from repro_torch.core.daef import DAEFConfig, DAEFModel
from repro_torch.core.fleet import DAEFFleet, _tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models import api, rglru
from repro_torch.optim import AdamState


def _knowledge_type(config: DAEFConfig):
    return rolann.RolannStats if config.method == "gram" else rolann.RolannFactors


def _n_leaves(config: DAEFConfig) -> int:
    n_layers = len(config.layer_sizes) - 1
    per_layer = len(_knowledge_type(config)._fields)
    return n_layers + (n_layers - 1) + 2 + per_layer * (n_layers - 1) + 1


def model_from_numpy(config: DAEFConfig, leaves, *, device=None) -> DAEFModel:
    """The port's ``DAEFModel`` on ``device`` from reference leaves."""
    leaves = list(leaves)
    if len(leaves) != _n_leaves(config):
        raise ValueError(
            f"expected {_n_leaves(config)} leaves for layer_sizes "
            f"{config.layer_sizes}, got {len(leaves)}"
        )
    dev = resolve_device(device)
    it = iter(torch.as_tensor(np.array(leaf), device=dev) for leaf in leaves)
    n_layers = len(config.layer_sizes) - 1
    weights = tuple(next(it) for _ in range(n_layers))
    biases = tuple(next(it) for _ in range(n_layers - 1))
    enc = dsvd.SvdFactors(u=next(it), s=next(it))
    kind = _knowledge_type(config)
    knowledge = tuple(
        kind(*(next(it) for _ in kind._fields)) for _ in range(n_layers - 1)
    )
    return DAEFModel(weights=weights, biases=biases, encoder_factors=enc,
                     layer_knowledge=knowledge, train_errors=next(it))


def model_to_numpy(model: DAEFModel) -> list[np.ndarray]:
    """The model's leaves as numpy arrays, in ``jax.tree.flatten`` order."""
    leaves = [*model.weights, *model.biases, *model.encoder_factors]
    for k in model.layer_knowledge:
        leaves.extend(k)
    leaves.append(model.train_errors)
    return [t.detach().cpu().numpy() for t in leaves]


def fleet_from_numpy(config: DAEFConfig, leaves, *, device=None) -> DAEFFleet:
    """The port's ``DAEFFleet`` on ``device`` from reference fleet leaves."""
    leaves = list(leaves)
    want = _n_leaves(config) + 3
    if len(leaves) != want:
        raise ValueError(
            f"expected {want} leaves for a fleet of layer_sizes "
            f"{config.layer_sizes}, got {len(leaves)}"
        )
    model = model_from_numpy(config, leaves[:-3], device=device)
    dev = resolve_device(device)
    seeds, lam_hidden, lam_last = (torch.as_tensor(np.array(leaf), device=dev)
                                   for leaf in leaves[-3:])
    return DAEFFleet(model=model, seeds=seeds.to(torch.int32), lam_hidden=lam_hidden,
                     lam_last=lam_last)


def fleet_to_numpy(fleet: DAEFFleet) -> list[np.ndarray]:
    """The fleet's leaves as numpy arrays, in ``jax.tree.flatten`` order."""
    return [t.detach().cpu().numpy() for t in _tree_leaves(fleet)]


def exchange_state_from_numpy(config: DAEFConfig, leaves, *, device=None) -> tuple:
    """A site's exchange state ``(SvdFactors, knowledge tuple, errors)`` on
    ``device`` from the reference's leaves (see the module docstring); the
    error pool stays a numpy array, as a session keeps it on the host."""
    leaves = list(leaves)
    kind = _knowledge_type(config)
    n_hidden = len(config.layer_sizes) - 2
    want = 2 + len(kind._fields) * n_hidden + 1
    if len(leaves) != want:
        raise ValueError(
            f"expected {want} leaves for an exchange state of layer_sizes "
            f"{config.layer_sizes}, got {len(leaves)}"
        )
    dev = resolve_device(device)
    it = iter(torch.as_tensor(np.array(leaf), device=dev) for leaf in leaves[:-1])
    enc = dsvd.SvdFactors(u=next(it), s=next(it))
    knowledge = tuple(kind(*(next(it) for _ in kind._fields)) for _ in range(n_hidden))
    return enc, knowledge, np.array(leaves[-1])


def exchange_state_to_numpy(state) -> list[np.ndarray]:
    """An exchange state's leaves as numpy arrays, in ``jax.tree.flatten``
    order."""
    enc, knowledge, errors = state
    leaves = [*enc]
    for k in knowledge:
        leaves.extend(k)
    out = [t.detach().cpu().numpy() for t in leaves]
    if isinstance(errors, torch.Tensor):
        errors = errors.detach().cpu().numpy()
    return out + [np.asarray(errors)]


def _tree_to_torch(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, dev) for v in tree]
    return torch.as_tensor(np.array(tree), device=dev)


def _leading(tree) -> set[int]:
    if isinstance(tree, dict):
        return set().union(*(_leading(v) for v in tree.values()))
    return {tree.shape[0]}


def lm_params_from_numpy(cfg: ArchConfig, tree, *, device=None) -> dict:
    """The port's parameters of ``cfg``'s LM on ``device`` from the
    reference's parameter tree of numpy arrays (see the module docstring).

    Raises:
        ValueError: a layer stack's leading axis does not match ``cfg``.
    """
    params = _tree_to_torch(tree, resolve_device(device))
    stacked = {"moe": (("moe_layers", cfg.n_layers - cfg.first_dense_layers),
                       ("dense_layers", cfg.first_dense_layers)),
               "encdec": (("enc_layers", cfg.n_encoder_layers), ("dec_layers", cfg.n_layers))}
    if cfg.family in stacked:
        for key, n in stacked[cfg.family]:
            stacks = _leading(params[key]) if key in params else {0}
            if stacks != {n}:
                raise ValueError(f"{cfg.name}: {key} stacks of {sorted(stacks)}, expected {n}")
        return params
    if cfg.family == "hybrid":
        n_periods, tail = rglru._layout(cfg)
        stacks, want = _leading(params["periods"]), {n_periods}
        if len(params["tail"]) != len(tail):
            raise ValueError(f"{cfg.name}: {len(params['tail'])} tail blocks, "
                             f"expected {len(tail)}")
    else:
        stacks, want = _leading(params["layers"]), {cfg.n_layers}
    if stacks != want:
        raise ValueError(f"{cfg.name}: layer stacks of {sorted(stacks)}, expected {want}")
    return params


def _cache_leaves(tree) -> list:
    """The leaves of a cache tree in ``jax.tree.flatten`` order: NamedTuple
    fields and tuple items in order, dict values by sorted key; ``None``
    has none."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _cache_leaves(tree[k])]
    return [leaf for item in tree for leaf in _cache_leaves(item)]


def _cache_fill(template, leaves):
    """``template``'s tree with its leaves taken in order from ``leaves``."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if isinstance(template, dict):
        filled = {k: _cache_fill(template[k], leaves) for k in sorted(template)}
        return {k: filled[k] for k in template}
    items = [_cache_fill(item, leaves) for item in template]
    return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)


def _cache_template(cfg: ArchConfig, batch: int = 1, seq_len: int = 1):
    """``cfg``'s cache tree as meta tensors."""
    return api.cache_specs(api.get_bundle(cfg), batch, seq_len, torch.float32)


def lm_cache_from_numpy(cfg: ArchConfig, tree, *, device=None):
    """The port's decode cache of ``cfg``'s LM on ``device`` from the
    reference's cache leaves (see the module docstring); each leaf keeps
    its dtype.

    Raises:
        ValueError: the leaves do not fit ``cfg``'s cache: their count, or a
            leaf's rank or one of its sizes that no batch size or sequence
            length changes (layer stacks, heads, widths, a ring's window).
    """
    dev = resolve_device(device)
    template = _cache_template(cfg)
    small, large = _cache_leaves(template), _cache_leaves(_cache_template(cfg, 2, 2))
    leaves = [np.asarray(leaf) for leaf in tree]
    if len(leaves) != len(small):
        raise ValueError(f"{cfg.name}: {len(leaves)} cache leaves, expected {len(small)}")
    for i, (leaf, a, b) in enumerate(zip(leaves, small, large)):
        # a size that is the same in both templates is fixed by cfg
        if leaf.ndim != a.ndim or any(n == m != got for n, m, got in
                                      zip(a.shape, b.shape, leaf.shape)):
            raise ValueError(f"{cfg.name}: cache leaf {i} has shape {leaf.shape}, expected "
                             f"rank {a.ndim} like {tuple(b.shape)} (batch 2, length 2)")
    tensors = iter([torch.as_tensor(np.array(leaf), device=dev) for leaf in leaves])
    return _cache_fill(template, tensors)


def lm_cache_to_numpy(cfg: ArchConfig, cache) -> list[np.ndarray]:
    """The leaves of the port's decode cache of ``cfg``'s LM as numpy
    arrays, in the reference's ``jax.tree.flatten`` order."""
    leaves = _cache_leaves(cache)
    n_want = len(_cache_leaves(_cache_template(cfg)))
    if len(leaves) != n_want:
        raise ValueError(f"{cfg.name}: {len(leaves)} cache leaves, expected {n_want}")
    return [t.detach().cpu().numpy() for t in leaves]


def adam_state_from_numpy(state, *, device=None) -> AdamState:
    """The port's ``AdamState`` on ``device`` from the reference's (step, mu,
    nu) as numpy trees."""
    step, mu, nu = state
    dev = resolve_device(device)
    return AdamState(step=torch.as_tensor(np.array(step), device=dev).to(torch.int32),
                     mu=_tree_to_torch(mu, dev), nu=_tree_to_torch(nu, dev))


def adam_state_to_numpy(state: AdamState) -> tuple:
    """(step, mu, nu) as numpy trees, in the port's tree structure."""
    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        return t.detach().cpu().numpy()

    return tree(state.step), tree(state.mu), tree(state.nu)
