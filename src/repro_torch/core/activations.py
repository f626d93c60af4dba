"""Neural activation functions with derivative and inverse.

Counterpart of ``repro/core/activations.py``.  ROLANN minimizes the MSE
*before* the activation: given targets ``d`` in the activation's output range
it needs the inverse ``d_bar = f^{-1}(d)`` and the derivative ``f'`` at
``d_bar``, so each activation bundles ``(fn, deriv, inv)``.  Targets are
clipped into the open range with ``_EPS`` because the inverse of a saturating
activation diverges at the boundary.

The formulas are written exactly as the reference writes them (``logsig`` as
``1 / (1 + exp(-z))``, not ``torch.sigmoid``) so both round alike.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Activation:
    """An activation together with its derivative and inverse."""

    name: str
    fn: Callable[[torch.Tensor], torch.Tensor]
    deriv: Callable[[torch.Tensor], torch.Tensor]  # f'(z) of the pre-activation z
    inv: Callable[[torch.Tensor], torch.Tensor]    # f^{-1}(y), y inside the range
    # Open output range (lo, hi); None means unbounded on that side.
    range: tuple[float | None, float | None] = (None, None)

    def clip_to_range(self, y: torch.Tensor) -> torch.Tensor:
        lo, hi = self.range
        if lo is None and hi is None:
            return y
        lo_v = None if lo is None else lo + _EPS
        hi_v = None if hi is None else hi - _EPS
        return torch.clamp(y, lo_v, hi_v)


def _identity(z: torch.Tensor) -> torch.Tensor:
    return z


def _ones_like(z: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(z)


linear = Activation(
    name="linear", fn=_identity, deriv=_ones_like, inv=_identity,
    range=(None, None),
)


def _logsig(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-z))


def _logsig_deriv(z: torch.Tensor) -> torch.Tensor:
    s = _logsig(z)
    return s * (1.0 - s)


def _logit(y: torch.Tensor) -> torch.Tensor:
    return torch.log(y) - torch.log1p(-y)


logsig = Activation(
    name="logsig", fn=_logsig, deriv=_logsig_deriv, inv=_logit,
    range=(0.0, 1.0),
)


def _tanh_deriv(z: torch.Tensor) -> torch.Tensor:
    t = torch.tanh(z)
    return 1.0 - t * t


tanh = Activation(
    name="tanh", fn=torch.tanh, deriv=_tanh_deriv, inv=torch.atanh,
    range=(-1.0, 1.0),
)


# ``relu`` has no inverse; it is provided for the iterative AE baseline only.
def _relu(z: torch.Tensor) -> torch.Tensor:
    return torch.clamp(z, min=0.0)


def _relu_deriv(z: torch.Tensor) -> torch.Tensor:
    return (z > 0).to(z.dtype)


relu = Activation(
    name="relu", fn=_relu, deriv=_relu_deriv,
    inv=_identity,  # placeholder; never used by ROLANN (see get())
    range=(0.0, None),
)

_INVERTIBLE = {"linear", "logsig", "tanh"}
_REGISTRY = {a.name: a for a in (linear, logsig, tanh, relu)}


def get(name: str, *, invertible_required: bool = False) -> Activation:
    """Look up an activation by name.

    ``invertible_required=True`` restricts to activations usable by ROLANN
    (which needs ``f^{-1}``).
    """
    try:
        act = _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown activation {name!r}; have {sorted(_REGISTRY)}") from e
    if invertible_required and name not in _INVERTIBLE:
        raise ValueError(
            f"activation {name!r} has no inverse and cannot be used with ROLANN; "
            f"choose one of {sorted(_INVERTIBLE)}"
        )
    return act
