"""The port's optimisers (``repro_torch.optim``) against ``repro.optim``, on
the CPU.

The same parameter tree (nested dicts) and the same gradients, drawn from a
seed with numpy, go through both packages for five steps: Adam, AdamW with
weight decay under the warm-up/cosine schedule, SGD with plain and Nesterov
momentum, and bf16 parameters with float32 moments.  Parameters and states
are compared after every step; the schedules, ``global_norm`` and
``clip_by_global_norm`` on their own.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) for float32 values: the
same float32 operations in the same order, up to the last bit of XLA's and
torch's pow, sqrt and cos.  bf16 parameters: one bf16 ulp of each element
(2^-8·|p|, each side rounds p + u to bf16 once and the two sums may straddle
a rounding boundary).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, to_np

from repro import optim as joptim
from repro_torch import optim

SHAPES = {"w": (8, 6), "b": (6,), "block": {"x": (3, 4), "y": (5,)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (scale * rng.normal(size=shapes)).astype(np.float32)


def _to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(dtype), tree)


def _compare(got, want, what, bf16=False):
    def one(path, w, g):
        name = f"{what}{jax.tree_util.keystr(path)}"
        if bf16:
            w32 = np.asarray(jnp.asarray(w, jnp.float32))
            g32 = to_np(g.float())
            assert np.all(np.abs(g32 - w32) <= 2.0**-8 * np.abs(w32) + 1e-30), name
        else:
            assert_close(g, w, what=name)

    jax.tree_util.tree_map_with_path(one, want, got)


CASES = {
    "adam": (lambda m: m.adam(1e-2), False),
    "adamw-decay-schedule": (lambda m: m.adamw(m.linear_warmup_cosine(3e-2, 2, 5),
                                               weight_decay=0.1), False),
    "sgd-momentum": (lambda m: m.sgd(m.cosine_decay(0.1, 4), momentum=0.9), False),
    "sgd-nesterov": (lambda m: m.sgd(0.05, momentum=0.5, nesterov=True), False),
    "sgd-plain": (lambda m: m.sgd(0.05), False),
    "adamw-bf16-params": (lambda m: m.adamw(1e-2, weight_decay=0.01), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_steps_match_reference(case):
    make, bf16 = CASES[case]
    rng = np.random.default_rng(len(case))
    p0 = _tree(rng, SHAPES)
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdtype), p0)
    tparams = _to_torch(p0, tdtype)
    jopt, topt = make(joptim), make(optim)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    for step in range(5):
        grads = _tree(rng, SHAPES, scale=0.5)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdtype), grads)
        jupd, jstate = jopt.update(jg, jstate, jparams)
        jparams = joptim.apply_updates(jparams, jupd)
        tupd, tstate = topt.update(_to_torch(grads, tdtype), tstate, tparams)
        tparams = optim.apply_updates(tparams, tupd)
        assert jax.tree.map(lambda t: t.dtype, tupd) == jax.tree.map(
            lambda a: getattr(torch, str(a.dtype)), jupd)
        _compare(tparams, jparams, f"{case} step {step} params", bf16=bf16)
        assert int(tstate.step) == int(jstate.step) == step + 1
        moments = [tstate.mu, tstate.nu] if hasattr(tstate, "mu") else [tstate.momentum]
        jmoments = [jstate.mu, jstate.nu] if hasattr(jstate, "mu") else [jstate.momentum]
        for t, j in zip(moments, jmoments):
            if j is None:
                assert t is None
            else:
                _compare(t, j, f"{case} step {step} state")


def test_schedules_match_reference():
    scheds = [(m.constant(0.3), m.cosine_decay(0.1, 7, alpha=0.2),
               m.linear_warmup_cosine(3e-4, 3, 11), m.linear_warmup_cosine(1.0, 0, 4))
              for m in (optim, joptim)]
    for step in range(13):
        for t, j in zip(*scheds):
            got = t(torch.tensor(float(step)))
            assert got.dtype == torch.float32 and got.ndim == 0
            assert_close(got, j(jnp.float32(step)), what=f"step {step}")


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng, SHAPES, scale=2.0)
    ttree, jtree = _to_torch(tree), jax.tree.map(jnp.asarray, tree)
    assert_close(optim.global_norm(ttree), joptim.global_norm(jtree), what="global norm")
    for max_norm in (1.0, 1e3):
        clipped, norm = optim.clip_by_global_norm(ttree, max_norm)
        jclipped, jnorm = joptim.clip_by_global_norm(jtree, max_norm)
        assert_close(norm, jnorm, what="norm")
        _compare(clipped, jclipped, f"clipped to {max_norm}")
    half = {"g": torch.ones(4, dtype=torch.bfloat16)}
    clipped, _ = optim.clip_by_global_norm(half, 1.0)
    jclipped, _ = joptim.clip_by_global_norm({"g": jnp.ones(4, jnp.bfloat16)}, 1.0)
    assert clipped["g"].dtype == torch.float32 and jclipped["g"].dtype == jnp.float32
    assert_close(clipped["g"], jclipped["g"], what="bf16 leaf")
