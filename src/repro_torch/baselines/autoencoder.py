"""Iterative deep autoencoder — the paper's comparison baseline ("AE").

Counterpart of ``repro/baselines/autoencoder.py``: a symmetric MLP
autoencoder trained with Adam on MSE by backprop, as the paper's Table 5
baseline (architectures like [9, 7, 5, 7, 9], 30-100 epochs), against which
DAEF's F1 parity and training-time ratio are claimed.

Data convention matches the core: X is [features, samples].  The batches
are the reference's (``pipeline.batches(x, bs, axis=1, seed=config.seed)``,
``n // bs`` steps an epoch), and the weights start from the reference's
Glorot-uniform draws, bit for bit (``core/threefry``).

On the card the training set is uploaded once and every step gathers its
columns by the batch's indices.  The step — forward, ``torch.autograd.grad``
and Adam — is captured once per fit as one CUDA graph and replayed: eager,
it would dispatch some hundred small kernels a step, and the timed loop
would measure Python dispatch rather than the algorithm (the reference
jits its step).  The eager step is the host's path and the graph's
yardstick (``fit(..., graph=False)``); both run the same operations, so on
one card they give the same bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.analysis import retrace
from repro_torch.core import activations, threefry
from repro_torch.data import pipeline
from repro_torch.device import as_tensor, resolve_device

# Warm-up steps before the capture (run on the real state, which is then
# restored): they let cuBLAS and the allocator set up outside the graph.
_WARMUP_STEPS = 3


@dataclasses.dataclass(frozen=True)
class AEConfig:
    layer_sizes: tuple[int, ...]      # e.g. (9, 7, 5, 3, 5, 7, 9)
    act_hidden: str = "logsig"
    lr: float = 1e-3
    epochs: int = 100
    batch_size: int = 128
    seed: int = 0

    def __post_init__(self):
        if self.layer_sizes[0] != self.layer_sizes[-1]:
            raise ValueError("autoencoder must reconstruct its input")


class AEModel(NamedTuple):
    weights: tuple[torch.Tensor, ...]
    biases: tuple[torch.Tensor, ...]
    train_errors: torch.Tensor


def init_params(config: AEConfig) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Glorot-uniform weights [m_i, m_{i+1}] drawn on the host from
    ``PRNGKey(config.seed)``, one split per layer (the reference's
    ``jax.random`` bits); zero biases.  float32."""
    key = threefry.PRNGKey(config.seed)
    weights, biases = [], []
    sizes = config.layer_sizes
    for i in range(len(sizes) - 1):
        key, sub = threefry.split(key)
        limit = float(np.sqrt(6.0 / (sizes[i] + sizes[i + 1])))
        weights.append(threefry.uniform(sub, (sizes[i], sizes[i + 1]), torch.float32,
                                        -limit, limit))
        biases.append(torch.zeros((sizes[i + 1],), dtype=torch.float32))
    return weights, biases


def forward(config: AEConfig, params, x: torch.Tensor) -> torch.Tensor:
    weights, biases = params
    act = activations.get(config.act_hidden)
    h = x
    for i, (w, b) in enumerate(zip(weights, biases, strict=True)):
        z = w.T @ h + b[:, None]
        h = z if i == len(weights) - 1 else act.fn(z)  # linear output layer
    return h


def loss_fn(config: AEConfig, params, x: torch.Tensor) -> torch.Tensor:
    return torch.mean((forward(config, params, x) - x) ** 2)


class _Trainer:
    """One fit's parameters, Adam state and step on the device of ``x``.

    The parameters are views of one flat buffer, weights then biases (the
    reference's leaf order), so Adam updates them as one leaf: its
    arithmetic is elementwise, so that is the same per-leaf update in ~20
    kernels instead of ~20 a leaf.  Every tensor a step writes (the flat
    parameters, the moments, Adam's step counter) is updated in place, so a
    captured step replays against the same storage.
    """

    def __init__(self, config: AEConfig, x: torch.Tensor):
        self.config, self.x = config, x
        weights, biases = init_params(config)
        leaves = weights + biases
        self.flat = torch.cat([t.reshape(-1) for t in leaves]).to(x.device)
        views, at = [], 0
        for t in leaves:
            view = self.flat[at:at + t.numel()].view(t.shape)
            views.append(view.requires_grad_(True))
            at += t.numel()
        self.leaves = views
        self.params = (views[:len(weights)], views[len(weights):])
        self.opt = optim.adam(config.lr)
        self.state = self.opt.init(self.flat)

    def step(self, idx: torch.Tensor) -> None:
        """One Adam step on the columns ``idx`` of the training set."""
        loss = loss_fn(self.config, self.params, self.x.index_select(1, idx))
        grads = torch.autograd.grad(loss, self.leaves)
        updates, state = self.opt.update(torch.cat([g.reshape(-1) for g in grads]),
                                         self.state, self.flat)
        optim.apply_updates(self.flat, updates)
        self.state.step.copy_(state.step)

    def _buffers(self) -> list[torch.Tensor]:
        return [self.flat, self.state.mu, self.state.nu, self.state.step]

    def capture(self, idx_all: torch.Tensor):
        """The step as one CUDA graph that takes row ``t`` of ``idx_all``
        [steps, bs] and counts ``t`` on the card; returns its replay.  The
        warm-up steps before the capture leave the state as it was."""
        counter = torch.zeros((1,), dtype=torch.int64, device=self.x.device)

        def body():
            self.step(idx_all.index_select(0, counter).view(-1))
            counter.add_(1)

        saved = [t.clone() for t in self._buffers()]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                body()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self._buffers() + [counter], saved + [torch.zeros_like(counter)],
                            strict=True):
                t.copy_(s)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        retrace.record(retrace.GRAPH_CAPTURE_EVENT, "autoencoder._Trainer.step")
        return graph.replay

    def model(self) -> AEModel:
        with torch.no_grad():
            weights, biases = (tuple(t.detach() for t in p) for p in self.params)
            recon = forward(self.config, (weights, biases), self.x)
            train_errors = torch.mean((recon - self.x) ** 2, dim=0)
        return AEModel(weights=weights, biases=biases, train_errors=train_errors)


def batch_indices(config: AEConfig, n: int) -> np.ndarray:
    """The fit's batches as column indices [epochs * steps_per_epoch, bs]:
    ``pipeline.batches`` over the sample indices, so row s indexes exactly
    the reference's batch s."""
    bs = min(config.batch_size, n)
    steps = config.epochs * max(1, n // bs)
    it = pipeline.batches(np.arange(n)[None, :], bs, axis=1, seed=config.seed)
    return np.stack([next(it)[0] for _ in range(steps)]) if steps else np.zeros((0, bs), np.int64)


def fit(config: AEConfig, x, *, device=None, graph: bool | None = None
        ) -> tuple[AEModel, float]:
    """Train with Adam on ``device`` (``None``: the card); returns (model,
    wall_seconds).

    ``graph`` — replay the step as one CUDA graph: the default on the card;
    ``False`` runs the eager step there.  The host runs the eager step.
    The timed window holds what the reference's does (the data's upload,
    the batches, the step's capture and every step) and ends in a
    synchronize on the card.
    """
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True captures a CUDA graph; device {dev} is not a card")
    # Wall-clock is this baseline's contract (the paper's Table 3 compares
    # gradient-AE training time against DAEF), not incidental logging.
    t0 = time.perf_counter()  # repro-lint: disable=RPR006
    x = as_tensor(x, dev, torch.float32)
    trainer = _Trainer(config, x)
    idx_all = torch.as_tensor(batch_indices(config, x.shape[1]), device=dev)
    if graph:
        replay = trainer.capture(idx_all)
        for _ in range(idx_all.shape[0]):
            replay()
        torch.cuda.synchronize(dev)
    else:
        for idx in idx_all:
            trainer.step(idx)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0  # repro-lint: disable=RPR006
    return trainer.model(), wall


def reconstruction_error(config: AEConfig, model: AEModel, x, *, device=None) -> torch.Tensor:
    """Per-sample reconstruction MSE [n] of ``x`` [m0, n], on ``device``
    (``None``: the card), where the model must lie."""
    dev = resolve_device(device)
    have = model.weights[0].device
    if have.type != dev.type or (dev.index is not None and have != dev):
        raise ValueError(f"model lies on {have} but device={dev} was asked for")
    x = as_tensor(x, have, model.weights[0].dtype)
    with torch.no_grad():
        recon = forward(config, (list(model.weights), list(model.biases)), x)
        return torch.mean((recon - x) ** 2, dim=0)
