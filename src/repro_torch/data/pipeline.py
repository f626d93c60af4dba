"""Host-side data pipeline: batching and token streams (counterpart of
``repro/data/pipeline.py``).

Deterministic numpy batching with per-epoch shuffling: the same arguments
give the same arrays as the reference, batch for batch.  :func:`shard_batch`
places a host batch on a device mesh (``launch.mesh``): this rank's slice
along the named axes, on its device.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.device import as_tensor


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


def _rank_part(a, mesh, spec):
    """The block of ``a`` this rank holds under ``spec``: per dimension
    None (whole), an axis name, or a tuple of them (flattened in mesh order,
    as a ``PartitionSpec`` entry)."""
    index = []
    for dim, entry in enumerate(tuple(spec)):
        if entry is None:
            index.append(slice(None))
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        i, count = mesh.index(axes)
        n = a.shape[dim]
        if n % count:
            raise ValueError(f"shard_batch: dimension {dim} of size {n} does not "
                             f"divide over the {count} shards of {axes}")
        index.append(slice(i * n // count, (i + 1) * n // count))
    return a[tuple(index)]


def shard_batch(batch, mesh, spec):
    """Place a host batch (an array, or a dict / list / tuple of them) onto
    the mesh: each leaf's block under ``spec`` (the reference's
    ``PartitionSpec`` as a tuple: per dimension None, an axis name or a
    tuple of names), on this rank's device.  Only the block is uploaded;
    the dtype is kept."""
    def place(a):
        a = a if isinstance(a, torch.Tensor) else np.asarray(a)
        part = _rank_part(a, mesh, spec)
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return as_tensor(part, mesh.device, part.dtype).contiguous()

    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, spec) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, spec) for v in batch)
    return place(batch)
