"""Host-side data pipeline: batching and token streams (counterpart of
``repro/data/pipeline.py``).

Deterministic numpy batching with per-epoch shuffling: the same arguments
give the same arrays as the reference, batch for batch.  The reference's
``shard_batch`` places a host batch on a device mesh; meshes wait for
ROADMAP queue A item 12.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

MESH_ITEM = "ROADMAP queue A item 12"


def batches(
    x: np.ndarray,
    batch_size: int,
    *,
    axis: int = 1,
    seed: int = 0,
    epochs: int | None = None,
    drop_remainder: bool = True,
) -> Iterator[np.ndarray]:
    """Shuffled mini-batches along ``axis`` (column-major like the core):
    one ``default_rng(seed).permutation`` per epoch, the ragged tail dropped
    unless ``drop_remainder`` is False; ``epochs=None`` runs forever."""
    n = x.shape[axis]
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        idx = rng.permutation(n)
        stop = (n // batch_size) * batch_size if drop_remainder else n
        for lo in range(0, stop, batch_size):
            take = idx[lo : lo + batch_size]
            yield np.take(x, take, axis=axis)
        epoch += 1


def token_batches(
    sampler: Callable[[int], np.ndarray],
    steps: int,
) -> Iterator[np.ndarray]:
    """LM batches from a seeded sampler(step) -> [batch, seq] int32."""
    for step in range(steps):
        yield sampler(step)


def shard_batch(batch, mesh, spec):
    """Raises: placing a batch on a device mesh waits for the mesh paths."""
    raise NotImplementedError(
        f"shard_batch places a batch on a device mesh, which is not ported to "
        f"repro_torch yet ({MESH_ITEM})"
    )
