"""repro_torch.core.activations against repro.core.activations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.core import activations as jact
from repro_torch.core import activations as tact

NAMES = ["linear", "logsig", "tanh"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(scale=3.0, size=(4, 64)).astype(np.float32)
    y = rng.uniform(-1.2, 1.2, size=(4, 64)).astype(np.float32)
    return z, y


@pytest.mark.parametrize("name", NAMES)
def test_fn_and_deriv(name):
    z, _ = _inputs()
    ta, ja = tact.get(name), jact.get(name)
    assert_close(ta.fn(torch.from_numpy(z)), ja.fn(jnp.asarray(z)))
    assert_close(ta.deriv(torch.from_numpy(z)), ja.deriv(jnp.asarray(z)))


@pytest.mark.parametrize("name", NAMES)
def test_clip_then_inverse(name):
    """The ROLANN target transform: clip into the open range, then invert
    (``_EPS`` = 1e-6 keeps the inverse finite at the boundary)."""
    _, y = _inputs(1)
    if name == "logsig":
        y = (y + 1.2) / 2.4  # spread over [0, 1] and its boundaries
    ta, ja = tact.get(name), jact.get(name)
    tc = ta.clip_to_range(torch.from_numpy(y))
    jc = ja.clip_to_range(jnp.asarray(y))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_close(ta.inv(tc), ja.inv(jc))
    assert bool(torch.isfinite(ta.inv(tc)).all())


def test_ranges_and_eps_match():
    assert tact._EPS == jact._EPS == 1e-6
    for name in NAMES:
        assert tact.get(name).range == jact.get(name).range


def test_get_unknown_raises():
    with pytest.raises(KeyError, match="unknown activation"):
        tact.get("softplus")
    assert tact.get("tanh", invertible_required=True) is tact.tanh
