"""The port's training path against the JAX package, on the CPU.

* The attention backward: ``flash_attention_bwd_ref`` (B8's plain version)
  and the autograd ``FlashAttention`` Function, against ``jax.vjp`` of the
  reference's Pallas ``flash_attention`` (interpret mode, S = 64 in blocks
  of 32, as ``tests/test_kernels.py`` runs it) and of the model's
  ``attend_full``; causal, windowed, GQA and MQA at head sizes 32 and 64.
* ``chunked_softmax_xent`` and its gradients, at S a multiple of the chunk
  and not.
* ``bundle.loss`` and the gradient of every parameter leaf of the reduced
  qwen3 against ``jax.value_and_grad`` of the reference's ``lm_loss``, on
  parameters carried over with ``interop.lm_params_from_numpy``.
* One ``make_train_step`` step (microbatches 1 and 2, ``clip_norm`` 1.0,
  AdamW with a warm-up/cosine schedule) against the reference's, from the
  same parameters and optimiser state.
* The guards: B7's and B8's launches reached with grad needed raise; B9
  and B10 under grad go through their autograd Functions
  (tests/test_torch_ssm_training.py holds their backwards to the
  reference's).

On CPU tensors the wrappers run the kernels' plain versions; the kernels
themselves are held to those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) for values of order one
(attention gradients, the xent and its gradients, losses, parameters).
Gradient leaves of the model and the optimiser's moments are small (1e-5
to 1e-2), so they are held per leaf to |d| <= 1e-4·max|ref leaf| +
1e-4·|ref|: float32 sums in other orders (XLA against torch's CPU kernels,
an online softmax against a direct one) through two layers, a few hundred
float32 ulps of each leaf's largest entry at most.  The train step's
updates (params after minus before) are held the same way, plus one
float32 ulp of each parameter (each side rounds p + u once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import EPS32, assert_close, to_np

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as jflash
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import common as jcommon
from repro.models import get_bundle as jget_bundle
from repro_torch import interop, optim
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import _forward
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
from repro_torch.launch import steps
from repro_torch.models import common, get_bundle

QWEN3 = "qwen3-1.7b"


def _inputs(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32) for shape in
                 ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d)))


def _assert_leaf_close(got, want, what):
    """|d| <= 1e-4·max|want| + 1e-4·|want| (the module docstring's bar)."""
    got, want = to_np(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("h,hkv,d,window", [(4, 2, 32, None), (4, 1, 64, 24), (2, 2, 32, 40)],
                         ids=["gqa-d32", "mqa-d64-window", "mha-d32-window"])
def test_attention_backward_matches_reference(h, hkv, d, window):
    """The plain backward and the Function's gradients against jax.vjp of
    the Pallas kernel pair (interpret mode) and of ``attend_full``."""
    q, k, v, do = _inputs(2, 64, h, hkv, d, seed=h * 10 + hkv + d)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, window=window)
    assert out.grad_fn is not None and lse.grad_fn is None
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        plain = flash_attention_bwd_ref(tq, tk, tv, out, lse, torch.from_numpy(do),
                                        window=window)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, window=window, block_q=32,
                                             block_k=32), jq, jk, jv)
    _, vjp_full = jax.vjp(lambda a, b_, c: jattention.attend_full(a, b_, c, window=window),
                          jq, jk, jv)
    for name, g, p, jg, jf in zip("qkv", grads, plain, vjp(jdo), vjp_full(jdo)):
        assert g.shape == p.shape == jg.shape and g.dtype == torch.float32
        assert_close(p, jg, what=f"d{name}: plain vs the Pallas backward")
        assert_close(p, jf, what=f"d{name}: plain vs attend_full's vjp")
        assert_close(g, p, what=f"d{name}: the Function vs the plain backward")


def test_function_matches_autograd_through_the_plain_forward():
    """On the CPU the Function (plain forward, plain backward) gives the
    gradients of autograd through ``flash_attention_ref``, at a ragged S."""
    q, k, v, do = _inputs(1, 37, 4, 2, 16, seed=9)
    for window in (None, 5):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out, _ = flash_attention(*leaves, window=window)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
        leaves2 = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out2, _ = flash_attention_ref(*leaves2, window=window)
        want = torch.autograd.grad(out2, leaves2, torch.from_numpy(do))
        for g, w in zip(got, want):
            assert_close(g, w, what=f"window {window}")


def test_kernel_launches_refuse_grad():
    """B7 and B8, and B9's and B10's backwards, reached with grad needed
    raise, rather than return tensors with no grad_fn (on the card that
    would cut the graph silently).  B9 and B10 under grad return outputs
    with a ``grad_fn`` (their autograd Functions); without grad, none."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 2, 16, seed=0))
    qg = q.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no grad_fn"):
        _forward(qg, k, v, True, None)
    out, lse = flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no grad_fn"):
        flash_attention_bwd(qg, k, v, out, lse, do)
    with torch.no_grad():
        assert _forward(qg, k, v, True, None)[0].grad_fn is None
    x = torch.rand(1, 6, 4, requires_grad=True)
    y, h_last = rglru_scan(x, torch.rand(1, 6, 4), torch.rand(1, 6, 4), torch.rand(4))
    assert type(y.grad_fn).__name__ == "RGLRUScanBackward" and h_last.grad_fn is not None
    xdt = torch.rand(1, 8, 2, 4, requires_grad=True)
    y, h_final = ssd_chunk(xdt, -torch.rand(1, 8, 2), torch.rand(1, 8, 1, 4),
                           torch.rand(1, 8, 1, 4), chunk=4)
    assert type(y.grad_fn).__name__ == "SSDChunkBackward" and h_final.grad_fn is not None
    with torch.no_grad():
        y, _ = rglru_scan(x, torch.rand(1, 6, 4), torch.rand(1, 6, 4), torch.rand(4))
        assert y.grad_fn is None
        y, _ = ssd_chunk(xdt, -torch.rand(1, 8, 2), torch.rand(1, 8, 1, 4),
                         torch.rand(1, 8, 1, 4), chunk=4)
        assert y.grad_fn is None
    with pytest.raises(RuntimeError, match="no grad_fn"):
        rglru_scan_bwd(x, torch.rand(1, 6, 4), torch.rand(1, 6, 4), torch.rand(4),
                       torch.rand(1, 6, 4), torch.rand(1, 6, 4))
    with pytest.raises(RuntimeError, match="no grad_fn"):
        ssd_chunk_bwd(xdt, -torch.rand(1, 8, 2), torch.rand(1, 8, 1, 4), torch.rand(1, 8, 1, 4),
                      torch.rand(1, 8, 2, 4), chunk=4)


@pytest.mark.parametrize("s,chunk,transpose", [(24, 8, True), (30, 8, False), (7, 1024, True)])
def test_chunked_softmax_xent_matches_reference(s, chunk, transpose):
    """Value and gradients (h, w); S = 30 with chunk 8 takes the reference's
    rule (3 chunks of 10); masked positions carry no loss."""
    rng = np.random.default_rng(s)
    v, d = 100, 32
    h = rng.normal(size=(2, s, d)).astype(np.float32)
    w = (0.1 * rng.normal(size=(v, d) if transpose else (d, v))).astype(np.float32)
    labels = rng.integers(0, v, size=(2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.8).astype(np.float32)

    def jloss(h_, w_):
        return jcommon.chunked_softmax_xent(h_, jnp.asarray(labels), jnp.asarray(mask), w_,
                                            chunk=chunk, transpose=transpose)

    jval, (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    val = common.chunked_softmax_xent(th, torch.from_numpy(labels), torch.from_numpy(mask), tw,
                                      chunk=chunk, transpose=transpose)
    gh, gw = torch.autograd.grad(val, (th, tw))
    assert val.dtype == torch.float32 and val.ndim == 0
    assert_close(val, jval, what="xent")
    assert_close(gh, jgh, what="d xent / d h")
    assert_close(gw, jgw, what="d xent / d w")
    with pytest.raises(ValueError, match="not divisible"):  # 25 = 3 chunks of 8, plus 1
        common.chunked_softmax_xent(torch.zeros(2, 25, d), torch.zeros(2, 25, dtype=torch.int32),
                                    torch.ones(2, 25), tw, chunk=8, transpose=transpose)


@pytest.fixture(scope="module")
def qwen3():
    """The reduced qwen3: the reference's bundle and params (numpy), and a
    batch of 4 x 48 tokens."""
    jcfg, cfg = jregistry.get(QWEN3).reduced(), registry.get(QWEN3).reduced()
    jb = jget_bundle(jcfg)
    jp = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 48, 4, seed=1)
    return dict(cfg=cfg, jb=jb, jp=jp, tokens=tokens)


def _port_params(qwen3):
    return interop.lm_params_from_numpy(qwen3["cfg"], qwen3["jp"], device="cpu")


def test_loss_and_every_gradient_leaf_match_reference(qwen3):
    cfg, tokens = qwen3["cfg"], qwen3["tokens"]
    jval, jgrads = jax.value_and_grad(qwen3["jb"].loss)(
        jax.tree.map(jnp.asarray, qwen3["jp"]), {"tokens": jnp.asarray(tokens)})
    params = _port_params(qwen3)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_bundle(cfg).loss(params, {"tokens": tokens})
    grads = torch.utils._pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)), spec)
    assert_close(loss, jval, what="loss")
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    n = 0

    def check(path, jg):
        nonlocal n
        g = grads
        for key in path:
            g = g[key.key]
        assert float(np.abs(jg).max()) > 0
        _assert_leaf_close(g, jg, what=jax.tree_util.keystr(path))
        n += 1

    jax.tree_util.tree_map_with_path(check, jgrads)
    assert n == len(leaves)


def _reference_opt(steps_total):
    return joptim.adamw(joptim.linear_warmup_cosine(1e-3, 2, steps_total), weight_decay=0.01,
                        eps=1e-3)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(qwen3, microbatches):
    """One step from the same parameters and AdamW state.  eps = 1e-3, near
    the gradients' own size, keeps each update a smooth function of its
    gradient (at eps = 1e-8 a first Adam step is ±lr wherever g != 0, and a
    gradient that float32 order error leaves within noise of 0 could flip
    sign)."""
    cfg, tokens = qwen3["cfg"], qwen3["tokens"]
    jopt = _reference_opt(10)
    jparams = jax.tree.map(jnp.asarray, qwen3["jp"])
    jstate = jopt.init(jparams)
    jstep = jsteps.make_train_step(qwen3["jb"], jopt, microbatches=microbatches, clip_norm=1.0)
    jp2, js2, jloss = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})

    opt = optim.adamw(optim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    params = _port_params(qwen3)
    state = interop.adam_state_from_numpy(jax.tree.map(np.asarray, tuple(jstate)), device="cpu")
    step = steps.make_train_step(get_bundle(cfg), opt, microbatches=microbatches, clip_norm=1.0)
    params, state, loss = step(params, state, {"tokens": tokens})
    assert loss.grad_fn is None
    assert_close(loss, jloss, what="loss")
    assert int(state.step) == int(js2.step) == 1
    tstep, tmu, tnu = interop.adam_state_to_numpy(state)
    got = {"params": jax.tree.map(np.asarray, jax.tree.map(to_np, params)), "mu": tmu, "nu": tnu}
    before = qwen3["jp"]

    def check(path, want, have, old):
        what = jax.tree_util.keystr(path)
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


def test_bundle_loss_family_rules_and_input_specs():
    """ssm and hybrid losses train (item 16 is done): a graph whose forward
    and prefill stay out of autograd; make_decode_step's step is
    bundle.decode; prefill, forward and decode stay out of autograd;
    input_specs mirrors the reference."""
    for name in ("mamba2-780m", "recurrentgemma-9b"):
        small = registry.get(name).reduced()
        b = get_bundle(small, chunked_attn=False)
        params = b.init(0, device="cpu")
        for p in torch.utils._pytree.tree_leaves(params):
            p.requires_grad_(True)
        tokens = synthetic.lm_token_stream(small.vocab_size, 16, 2, seed=0)
        assert b.loss(params, {"tokens": tokens}).grad_fn is not None
        assert b.forward(params, tokens).grad_fn is None
        assert b.prefill(params, {"tokens": tokens}).grad_fn is None
    cfg = registry.get(QWEN3).reduced()
    bundle = get_bundle(cfg)
    params = bundle.init(0, device="cpu")
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_(True)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 16, 2, seed=0)
    assert bundle.forward(params, tokens).grad_fn is None
    assert bundle.prefill(params, {"tokens": tokens}).grad_fn is None
    assert bundle.loss(params, {"tokens": tokens}).grad_fn is not None
    token = torch.as_tensor(tokens[:, :1])
    caches = [bundle.init_cache(2, 4, torch.float32, device="cpu") for _ in range(2)]
    got, got_cache = steps.make_decode_step(bundle)(params, caches[0], token, 0)
    want, want_cache = bundle.decode(params, caches[1], token, 0)
    assert got.grad_fn is None and torch.equal(got, want)
    assert torch.equal(got_cache.k, want_cache.k) and torch.equal(got_cache.v, want_cache.v)
    assert torch.equal(steps.make_prefill_step(bundle)(params, {"tokens": tokens}),
                       bundle.prefill(params, {"tokens": tokens}))
    shape = registry.SHAPES["train_4k"]
    jspecs = jget_bundle(jregistry.get(QWEN3)).input_specs(
        jregistry.SHAPES["train_4k"])
    specs = bundle.input_specs(shape)
    assert specs.keys() == jspecs.keys()
    for key, spec in specs.items():
        assert spec.device.type == "meta"
        assert tuple(spec.shape) == jspecs[key].shape
        assert str(spec.dtype)[6:] == str(jspecs[key].dtype)
