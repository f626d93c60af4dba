"""Carry DAEF models between the JAX package and the port as numpy leaves.

A model crosses as the list of its leaves in ``jax.tree.flatten`` order of
the reference ``DAEFModel`` (gram method):

    weights[0..L-1], biases[0..L-2], encoder_factors.u, encoder_factors.s,
    then (g, m) of each layer's knowledge, then train_errors

with ``L = len(config.layer_sizes) - 1``.  A fleet crosses the same way as
the leaves of ``jax.tree.flatten(DAEFFleet)``: the model's leaves, each with
a leading [K], then ``seeds`` (int32), ``lam_hidden`` and ``lam_last``.
Neither side needs the other's framework: the JAX side flattens with
``jax.tree.flatten`` and converts each leaf with ``numpy.asarray``; this
module does the rest.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import dsvd, rolann
from repro_torch.core.daef import DAEFConfig, DAEFModel
from repro_torch.core.fleet import DAEFFleet, _tree_leaves
from repro_torch.device import resolve_device


def _n_leaves(config: DAEFConfig) -> int:
    n_layers = len(config.layer_sizes) - 1
    return n_layers + (n_layers - 1) + 2 + 2 * (n_layers - 1) + 1


def model_from_numpy(config: DAEFConfig, leaves, *, device=None) -> DAEFModel:
    """The port's ``DAEFModel`` on ``device`` from reference leaves."""
    if config.method != "gram":
        raise NotImplementedError(
            "only gram-method models cross so far (factor knowledge waits "
            "for ROADMAP queue A item 4)"
        )
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
    knowledge = tuple(
        rolann.RolannStats(g=next(it), m=next(it)) for _ in range(n_layers - 1)
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
