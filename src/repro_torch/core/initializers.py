"""Weight initializers for the DAEF auxiliary networks (paper §4.2, §6).

Counterpart of ``repro/core/initializers.py``.  Every federated node must
generate the *same* stage-1 weights, so each initializer is a pure function
of a key, drawn with :mod:`repro_torch.core.threefry` to give the bits
``jax.random`` gives.  The draws are float32 on the host.  A key batch
[K, 2] draws K matrices [K, *shape] in one call, as ``jax.vmap`` of the
same initializer does.
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry


def xavier(
    key: torch.Tensor, shape: tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Glorot uniform: U(-sqrt(6/(fan_in+fan_out)), +)."""
    fan_in, fan_out = shape
    limit = torch.sqrt(torch.tensor(6.0 / (fan_in + fan_out), dtype=torch.float32))
    return threefry.uniform(key, shape, dtype, -limit, limit)


def random_normal(
    key: torch.Tensor, shape: tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    return threefry.normal(key, shape, dtype)


def orthogonal(
    key: torch.Tensor, shape: tuple[int, int], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Orthogonal columns (QR of a Gaussian), scaled to unit gain; a key
    batch takes one batched QR."""
    rows, cols = shape
    big = max(rows, cols)
    a = threefry.normal(key, (big, min(rows, cols)))
    q, r = torch.linalg.qr(a)
    # Sign-fix for determinism across LAPACK implementations.
    q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
    q = q[..., :rows, :cols] if rows >= cols else q[..., :cols, :rows].transpose(-1, -2)
    return q.to(dtype)


_REGISTRY = {
    "xavier": xavier,
    "random": random_normal,
    "orthogonal": orthogonal,
}


def get(name: str):
    try:
        return _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown initializer {name!r}; have {sorted(_REGISTRY)}") from e
