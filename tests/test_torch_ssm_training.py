"""Training of the SSM (mamba2) and hybrid (recurrentgemma) families against
the JAX package, on the CPU.

* The plain backwards of the SSD chunk scan (B10) and the RG-LRU scan (B9),
  ``ssd_chunk_bwd_plain`` and ``rglru_scan_bwd_plain``, against
  ``torch.autograd`` of their plain forwards (float64) and against
  ``jax.vjp`` of the reference's ``mamba2.ssd_chunked`` and ``rglru.rg_lru``
  (the functions its ``lm_loss`` differentiates; it has no Pallas
  backward): several groups, ragged S, nonzero final-state cotangents, bf16
  x with float32 gates, and ``rg_lru``'s 1e-12 clamp active.
* ``torch.autograd.gradcheck`` of the autograd Functions ``SSDChunk`` and
  ``RGLRUScan`` in float64.
* The magnitude models behind the card's per-element bars on dla and dlam
  (``chip_smoke.py`` phase 24, ``tests/test_torch_cuda.py``): a float32
  backward against the float64 one stays within 1e-5 of each element's
  term magnitude.
* ``bundle.loss`` and every gradient leaf of the reduced mamba2-780m and of
  recurrentgemma-9b cut to one period and its 2-block tail (window 16)
  against ``jax.value_and_grad`` of the reference's ``lm_loss``, and one
  two-microbatch ``make_train_step`` step against the reference's, on
  parameters carried over with ``interop.lm_params_from_numpy``.

On CPU tensors the wrappers run the plain versions; the CUDA kernels are
held to those on the card.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) for the scans' gradients,
whose inputs here are O(1) and whose outputs are O(1)–O(10); bf16 gradients
(dx of a bf16 x) add one bf16 rounding of the value (rtol 2^-8).  Gradient
leaves of the models per leaf to |d| <= 1e-4·max|ref leaf| + 1e-4·|ref|,
and the train step's updates plus one float32 ulp of each parameter, as in
``tests/test_torch_training.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import EPS32, TOLS, assert_close, to_np

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import get_bundle as jget_bundle
from repro.models import mamba2 as jmamba2
from repro.models import rglru as jrglru
from repro_torch import interop, optim
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd_plain, rglru_scan_ref
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_magnitudes
from repro_torch.kernels.ssd_chunk import (
    fit_chunk,
    ssd_chunk,
    ssd_chunk_bwd_plain,
    ssd_chunk_plain,
)
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_magnitudes
from repro_torch.launch import steps
from repro_torch.models import get_bundle

F64 = TOLS["float64"]


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _sigmoid(z):
    return (1 / (1 + np.exp(-z))).astype(np.float32)


def _jvjp(fn, inputs, cotangents):
    """The reference's outputs and ``jax.vjp`` of ``fn`` at ``inputs`` for
    ``cotangents`` (None: zeros), under one ``jax.jit`` (eager, its scans
    dispatch op by op)."""
    def run(args, cts):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(tuple(jnp.zeros_like(o) if c is None else c
                              for o, c in zip(out, cts)))

    return jax.jit(run)(tuple(map(jnp.asarray, inputs)),
                        tuple(None if c is None else jnp.asarray(c) for c in cotangents))


def _grads64(fn, inputs, cotangents):
    """torch.autograd of ``fn`` in float64 at ``inputs`` for ``cotangents``
    (None: that output carries none)."""
    leaves = [torch.from_numpy(x).double().requires_grad_() for x in inputs]
    outs = fn(*leaves)
    total = sum((o * torch.from_numpy(c).double()).sum()
                for o, c in zip(outs, cotangents) if c is not None)
    return torch.autograd.grad(total, leaves)


# ---- B10: the SSD chunk scan ----

SSD_CASES = {  # id: (B, S, H, P, G, N, chunk, h_final cotangent)
    "one group": (2, 64, 4, 8, 1, 16, 16, False),
    "three groups, h_final": (2, 48, 6, 8, 3, 16, 16, True),
    "ragged S, h_final": (1, 30, 4, 8, 2, 8, 8, True),       # chunk 6
}


def _ssd_inputs(case, seed):
    b, s, h, p, g, n, chunk, final = SSD_CASES[case]
    rng = np.random.default_rng(seed)
    x, bm, cm = _normal(rng, b, s, h, p), _normal(rng, b, s, g, n), _normal(rng, b, s, g, n)
    dt = np.log1p(np.exp(_normal(rng, b, s, h) - 1)).astype(np.float32)   # softplus'd
    a = rng.uniform(0.5, 2.0, size=h).astype(np.float32)
    dy = _normal(rng, b, s, h, p)
    dh = _normal(rng, b, h, p, n) if final else None
    return (x, dt, a, bm, cm), dy, dh, fit_chunk(s, chunk)


@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_backward_matches_autograd_and_reference(case):
    (x, dt, a, bm, cm), dy, dh, q = _ssd_inputs(case, seed=len(case))
    xdt, la = x * dt[..., None], -a[None, None, :] * dt

    # float64: the plain backward against autograd of the plain forward
    want = _grads64(lambda *t: ssd_chunk_plain(*t, q), (xdt, la, bm, cm), (dy, dh))
    got = ssd_chunk_bwd_plain(*(torch.from_numpy(t).double() for t in (xdt, la, bm, cm)),
                              torch.from_numpy(dy).double(),
                              None if dh is None else torch.from_numpy(dh).double(), chunk=q)
    for name, g, w in zip(("dxdt", "dla", "db", "dc"), got, want):
        assert_close(g, w, what=f"{name} vs autograd", **F64)

    # float32: the model's route (x·dt, -a·dt through the autograd Function)
    # against jax.vjp of the reference's ssd_chunked
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, dt, a, bm, cm)]
    tx, tdt, ta, tb, tc = leaves
    y, h_final = ssd_chunk(tx * tdt[..., None], -ta[None, None, :] * tdt, tb, tc, chunk=q)
    total = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        total = total + (h_final * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(total, leaves)
    (jy, jh), jgrads = _jvjp(lambda *t: jmamba2.ssd_chunked(*t, q), (x, dt, a, bm, cm),
                             (dy, dh))
    assert_close(y, jy, what="y")
    assert_close(h_final, jh, what="h_final")
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, jgrads):
        assert_close(g, w, what=f"{name} vs jax.vjp of ssd_chunked")


# ---- B9: the RG-LRU scan ----

RGLRU_CASES = {  # id: (B, S, W, h_last cotangent, clamp active, x in bf16)
    "plain": (2, 24, 16, False, False, False),
    "ragged S, h_last": (1, 33, 8, True, False, False),
    "clamp active, h_last": (2, 16, 8, True, True, False),
    "bf16 x, float32 gates": (2, 20, 16, True, False, True),
}


def _rglru_inputs(case, seed):
    b, s, w, final, clamp, bf16 = RGLRU_CASES[case]
    rng = np.random.default_rng(seed)
    x = _normal(rng, b, s, w)
    if bf16:  # values a bf16 x holds, as float32
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    r, i = _sigmoid(_normal(rng, b, s, w)), _sigmoid(_normal(rng, b, s, w))
    if clamp:  # r = 0: a = 1 and -expm1(2 log a) = 0, below the 1e-12 clamp
        r[:, ::3, ::2] = 0.0
    lam = (_normal(rng, w) + 4).astype(np.float32)
    dy = _normal(rng, b, s, w)
    dh = _normal(rng, b, w) if final else None
    return (x, r, i, lam), dy, dh, bf16


@pytest.mark.parametrize("case", sorted(RGLRU_CASES))
def test_rglru_backward_matches_autograd_and_reference(case):
    (x, r, i, lam), dy, dh, bf16 = _rglru_inputs(case, seed=len(case))

    # float64: the plain backward against autograd of the plain forward
    want = _grads64(rglru_scan_ref, (x, r, i, lam), (dy, dh))
    t64 = [torch.from_numpy(t).double() for t in (x, r, i, lam)]
    y64, _ = rglru_scan_ref(*t64)
    got = rglru_scan_bwd_plain(*t64, y64, torch.from_numpy(dy).double(),
                               None if dh is None else torch.from_numpy(dh).double())
    for name, g, w in zip(("dx", "dr", "di", "dlam"), got, want):
        assert_close(g, w, what=f"{name} vs autograd", **F64)

    # the autograd Function (bf16 x where the case has it) against jax.vjp of
    # the reference's rg_lru on the float32 values
    tx = torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)
    leaves = [tx.requires_grad_()] + [torch.from_numpy(t).requires_grad_() for t in (r, i, lam)]
    y, h_last = rglru_scan(*leaves)
    total = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        total = total + (h_last * torch.from_numpy(dh)).sum()
    got = torch.autograd.grad(total, leaves)
    (jy, _), jgrads = _jvjp(jrglru.rg_lru, (x, r, i, lam), (dy, dh))
    assert_close(y, jy, what="y")
    assert got[0].dtype == tx.dtype and all(g.dtype == torch.float32 for g in got[1:])
    for name, g, w in zip(("dx", "dr", "di", "dlam"), got, jgrads):
        tol = dict(atol=1e-4, rtol=2.0**-8) if g.dtype == torch.bfloat16 else {}
        assert_close(g.float(), w, what=f"{name} vs jax.vjp of rg_lru", **tol)


def test_functions_pass_gradcheck():
    """Both autograd Functions in float64, both outputs, with several groups
    and a ragged S (chunk 5 of 10) for the scan."""
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * scale + shift
                ).requires_grad_()

    xdt, la = leaf(2, 10, 4, 3), -leaf(2, 10, 4, scale=0.1, shift=0.3).abs()
    la = la.detach().requires_grad_()
    b, c = leaf(2, 10, 2, 5), leaf(2, 10, 2, 5)
    assert torch.autograd.gradcheck(lambda *t: ssd_chunk(*t, chunk=7), (xdt, la, b, c))
    x, lam = leaf(2, 9, 5), leaf(5, shift=4.0)
    r, i = (torch.sigmoid(leaf(2, 9, 5)).detach().requires_grad_() for _ in range(2))
    assert torch.autograd.gradcheck(rglru_scan, (x, r, i, lam))


def test_backward_magnitudes_bound_float32_reordering():
    """The CPU model of the card's per-element bars on dla and dlam: the
    float32 plain backward, whose sums run in another order than the
    float64 one, stays within 1e-5 of each element's term magnitude
    (measured: ~1e-7), although dla's row and column sums of M and dlam's
    sum over batch and time cancel."""
    gen = torch.Generator().manual_seed(1)
    xdt, b, c = (torch.randn(s, generator=gen) for s in ((2, 256, 4, 16), (2, 256, 2, 32),
                                                          (2, 256, 2, 32)))
    la = -torch.rand((2, 256, 4), generator=gen) * 0.1
    dy, dh = torch.randn((2, 256, 4, 16), generator=gen), torch.randn((2, 4, 16, 32),
                                                                      generator=gen)
    args = (xdt, la, b, c, dy, dh)
    got = ssd_chunk_bwd_plain(*args, chunk=64)[1]
    want = ssd_chunk_bwd_plain(*(t.double() for t in args), chunk=64)[1]
    mags = ssd_chunk_bwd_magnitudes(*args, chunk=64)[1]
    assert bool(((got.double() - want).abs() <= 1e-5 * mags.double()).all())

    x, dy = torch.randn((2, 300, 64), generator=gen), torch.randn((2, 300, 64), generator=gen)
    r, i = (torch.sigmoid(torch.randn((2, 300, 64), generator=gen)) for _ in range(2))
    lam, dh = torch.randn(64, generator=gen) + 4, torch.randn((2, 64), generator=gen)
    y, _ = rglru_scan_ref(x, r, i, lam)
    args = (x, r, i, lam, y, dy, dh)
    got = rglru_scan_bwd_plain(*args)[3]
    want = rglru_scan_bwd_plain(*(t.double() for t in args))[3]
    mags = rglru_scan_bwd_magnitudes(*args)[3]
    assert bool(((got.double() - want).abs() <= 1e-5 * mags.double()).all())


def test_ssd_backward_dla_holds_at_mamba2_decays():
    """At mamba2's initial decays (la = -a·softplus(z), a = linspace(1, 16,
    H): cum reaches -10³ within a chunk) a diagonal term of M or S_k is up to
    ~1e8 times the prefix of the terms before it.  The float32 plain
    backward sums those exclusive prefixes from the left, so its dla stays
    within 1e-5 of each element's term magnitude of the float64 one; an
    inclusive sum minus its last term lost the prefix, and dla and its
    magnitude came out 0 where they are not."""
    gen = torch.Generator().manual_seed(3)
    h = 48
    xdt, dy = (torch.randn((1, 512, h, 16), generator=gen) for _ in range(2))
    la = -torch.linspace(1.0, 16.0, h) * torch.nn.functional.softplus(
        torch.randn((1, 512, h), generator=gen))
    b, c = (torch.randn((1, 512, 1, 32), generator=gen) for _ in range(2))
    dh = torch.randn((1, h, 16, 32), generator=gen)
    args = (xdt, la, b, c, dy, dh)
    assert float(la.double().reshape(1, 2, 256, h).cumsum(2).min()) < -1e3
    got = ssd_chunk_bwd_plain(*args, chunk=256)[1]
    want = ssd_chunk_bwd_plain(*(t.double() for t in args), chunk=256)[1]
    mags = ssd_chunk_bwd_magnitudes(*args, chunk=256)[1]
    assert int((mags == 0).sum()) == h   # the first step of the first chunk: no terms
    assert bool(((got.double() - want).abs() <= 1e-5 * mags.double()).all())


# ---- the families ----

FAMILIES = {"mamba2-780m": {}, "recurrentgemma-9b": {"n_layers": 5, "local_window": 16}}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """A reduced family (recurrentgemma cut to one period and its 2-block
    tail, window 16): the reference's bundle and params (numpy), and a
    batch of 4 x 64 tokens."""
    name = request.param
    changes = FAMILIES[name]
    jcfg = dataclasses.replace(jregistry.get(name).reduced(), **changes)
    cfg = dataclasses.replace(registry.get(name).reduced(), **changes)
    jb = jget_bundle(jcfg)
    jp = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 64, 4, seed=1)
    return dict(cfg=cfg, jb=jb, jp=jp, tokens=tokens)


def _assert_leaf_close(got, want, what):
    """|d| <= 1e-4·max|want| + 1e-4·|want| (the module docstring's bar)."""
    got, want = to_np(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


def test_loss_and_every_gradient_leaf_match_reference(family):
    cfg, tokens = family["cfg"], family["tokens"]
    jval, jgrads = jax.jit(jax.value_and_grad(family["jb"].loss))(
        jax.tree.map(jnp.asarray, family["jp"]), {"tokens": jnp.asarray(tokens)})
    params = interop.lm_params_from_numpy(cfg, family["jp"], device="cpu")
    leaves, _ = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_bundle(cfg).loss(params, {"tokens": tokens})
    assert loss.dtype == torch.float32 and loss.ndim == 0
    grads = torch.autograd.grad(loss, leaves)
    assert_close(loss, jval, what="loss")
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(want) == len(grads)
    for (path, jg), g in zip(want, grads):
        what = f"{cfg.name} {jax.tree_util.keystr(path)}"
        assert tuple(g.shape) == jg.shape and float(np.abs(np.asarray(jg)).max()) > 0, what
        _assert_leaf_close(g, jg, what=what)


def test_train_step_matches_reference(family):
    """One step in two microbatches from the same parameters and AdamW state
    (eps = 1e-3, as tests/test_torch_training.py explains)."""
    cfg, tokens = family["cfg"], family["tokens"]
    jopt = joptim.adamw(joptim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    jparams = jax.tree.map(jnp.asarray, family["jp"])
    jstate = jopt.init(jparams)
    jstep = jsteps.make_train_step(family["jb"], jopt, microbatches=2, clip_norm=1.0)
    jp2, js2, jloss = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})

    opt = optim.adamw(optim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    params = interop.lm_params_from_numpy(cfg, family["jp"], device="cpu")
    state = interop.adam_state_from_numpy(jax.tree.map(np.asarray, tuple(jstate)), device="cpu")
    step = steps.make_train_step(get_bundle(cfg), opt, microbatches=2, clip_norm=1.0)
    params, state, loss = step(params, state, {"tokens": tokens})
    assert loss.grad_fn is None
    assert_close(loss, jloss, what="loss")
    assert int(state.step) == int(js2.step) == 1
    _, tmu, tnu = interop.adam_state_to_numpy(state)
    got = {"params": jax.tree.map(np.asarray, jax.tree.map(to_np, params)), "mu": tmu, "nu": tnu}
    before = family["jp"]

    def check(path, want, have, old):
        what = f"{cfg.name} {jax.tree_util.keystr(path)}"
        if path[0].key == "params":
            assert_close(have, want, what=what)
            # the update, to the leaf bar plus one float32 rounding of p + u on each side
            d_have, d_want = np.float64(have) - old, np.float64(want) - old
            bar = 1e-4 * np.abs(d_want).max() + 1e-4 * np.abs(d_want) + 2 * EPS32 * np.abs(old)
            assert np.all(np.abs(d_have - d_want) <= bar), what + " update"
        else:
            _assert_leaf_close(have, want, what)

    want = {"params": jax.tree.map(np.asarray, jp2), "mu": jax.tree.map(np.asarray, js2.mu),
            "nu": jax.tree.map(np.asarray, js2.nu)}
    old = {"params": before, "mu": before, "nu": before}
    jax.tree_util.tree_map_with_path(check, want, got, old)
