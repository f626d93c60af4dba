"""The registry's last two dense architectures, granite-20b and
mistral-nemo-12b, in the port against the JAX package, on the CPU.

``ArchConfig.reduced()`` drops what sets these two apart, so each runs as a
small config that keeps its quirk:

* granite-shaped: 8 query heads over one KV head (multi-query attention, a
  group of 8), head size 32;
* mistral-shaped: 4 query heads of 48 over 2 KV heads, so the query width
  192 is not d_model 256, and RoPE's theta 1e6.

The reference initialises each; its parameters cross to the port with
``interop.lm_params_from_numpy`` and its caches with
``interop.lm_cache_from_numpy``, and the same seeded inputs go through both:
hidden states and prefill logits, the loss and every gradient leaf, one
``make_train_step`` AdamW step, decode at positions 63 and 524,287, the
``long_500k`` shape's sliding-window ring (the window cut to 16) across its
wrap near position 524,287, and a bf16 forward.  RoPE's inverse frequencies
of every registry architecture equal the constants the reference's jitted
paths fold them into, bit for bit, and ``apply_rope`` agrees up to position
524,287 (the decode cases at 524,287 fail without that: one ulp of a
frequency moves a logit by ~3e-3 there).  The full configurations'
parameter counts equal the reference's.  On CPU tensors the port's
attention runs B7's and B8's plain versions.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) for values of order one;
gradient leaves, optimiser moments and updates per leaf to 1e-4 of the
leaf's largest entry plus 1e-4 of each entry (tests/test_torch_training.py
says why); the bf16 forward as ``test_bf16_hidden_states_match_reference``
in tests/test_torch_models.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import EPS32, assert_close, to_np

from repro import optim as joptim
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import common as jcommon
from repro.models import get_bundle as jget_bundle
from repro.models import transformer as jtransformer
from repro_torch import interop, optim
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.models import common, get_bundle

VARIANTS = {  # id: (arch, changes to its reduced config)
    "granite": ("granite-20b", dict(n_heads=8, n_kv_heads=1, head_dim=32)),
    "mistral": ("mistral-nemo-12b", dict(n_heads=4, n_kv_heads=2, head_dim=48)),
}
B, S = 2, 64
RING_WINDOW, RING_STEPS = 16, 24
LONG_POS = registry.SHAPES["long_500k"].seq_len - 1   # 524,287: long_500k's last position


def _cfgs(name, changes):
    return (dataclasses.replace(jregistry.get(name).reduced(), **changes),
            dataclasses.replace(registry.get(name).reduced(), **changes))


def _assert_leaf_close(got, want, what):
    """|d| <= 1e-4·max|want| + 1e-4·|want| (the module docstring's bar)."""
    got, want = to_np(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    """Both configs, the reference's bundle and parameters (numpy), the
    port's copy, seeded tokens [B, S] and the reference's hidden states and
    prefill logits."""
    jcfg, cfg = _cfgs(*VARIANTS[request.param])
    jb = jget_bundle(jcfg, chunked_attn=False)
    jp = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, S, B, seed=3)
    jparams = jax.tree.map(jnp.asarray, jp)
    jh = jtransformer.forward(jparams, jcfg, jnp.asarray(tokens), remat=False)
    jl = jb.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    return dict(cfg=cfg, jcfg=jcfg, jb=jb, jp=jp, tokens=tokens, jh=np.asarray(jh),
                jl=np.asarray(jl),
                tp=interop.lm_params_from_numpy(cfg, jp, device="cpu"))


def test_configs_keep_their_quirks(variant):
    cfg = variant["cfg"]
    if cfg.name.startswith("granite"):
        assert (cfg.n_heads, cfg.n_kv_heads) == (8, 1)
    else:
        assert cfg.n_heads * cfg.head_dim == 192 != cfg.d_model and cfg.rope_theta == 1e6
    assert variant["tp"]["layers"]["attn"]["wq"].shape == (2, 256, cfg.n_heads * cfg.head_dim)


@pytest.mark.parametrize("name,n_params", [("granite-20b", 28_167_493_632),
                                           ("mistral-nemo-12b", 12_247_782_400)])
def test_full_config_parameter_count_matches_reference(name, n_params):
    """The full configs as the registry holds them (granite-20b with the
    defaults ``mlp="swiglu"`` and ``tie_embeddings=False``: 28.17e9, not the
    published ~20e9): the port's meta parameters against the reference's
    ``eval_shape``, leaf for leaf."""
    tree = get_bundle(registry.get(name)).init(0, device="meta")
    jtree = jax.eval_shape(jget_bundle(jregistry.get(name)).init, jax.random.PRNGKey(0))
    shapes = [tuple(t.shape) for t in jax.tree.leaves(tree)]
    assert shapes == [j.shape for j in jax.tree.leaves(jtree)]
    assert sum(int(np.prod(s)) for s in shapes) == n_params


def test_bf16_init_draws_a_stacked_leaf_one_layer_at_a_time():
    """``dense_init`` draws a stacked leaf in another dtype than float32 one
    layer's slice at a time (granite-20b's bf16 init on one 80 GB card needs
    it: each [52, 6,144, 24,576] MLP stack drawn whole in float32 would take
    31.4 GB beside the leaves drawn before it): no float32 tensor larger
    than one slice is made, and slice i is the i-th float32 draw, cast.
    float32 is drawn whole, as before."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class LargestFloat32(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.dtype == torch.float32:
                    self.numel = max(self.numel, t.numel())
            return out

    shape, lead = (64, 96), (5,)
    with LargestFloat32() as seen:
        got = common.dense_init(torch.Generator().manual_seed(3), shape, torch.bfloat16,
                                lead=lead)
    assert got.dtype == torch.bfloat16 and seen.numel == 64 * 96
    gen, std = torch.Generator().manual_seed(3), 64**-0.5
    for part in got:
        want = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                           generator=gen).mul_(std)
        assert torch.equal(part, want.to(torch.bfloat16))
    whole = torch.nn.init.trunc_normal_(torch.empty((*lead, *shape)), 0.0, 1.0, -2.0, 2.0,
                                        generator=torch.Generator().manual_seed(3)).mul_(std)
    assert torch.equal(common.dense_init(torch.Generator().manual_seed(3), shape,
                                         torch.float32, lead=lead), whole)
    cfg = dataclasses.replace(registry.get("granite-20b").reduced(), n_layers=4)
    with LargestFloat32() as seen:
        params = get_bundle(cfg).init(0, torch.bfloat16, device="cpu")
    w = params["layers"]["mlp"]["w_gate"]
    assert w.shape[0] == 4 and seen.numel == max(w[0].numel(), cfg.vocab_size * cfg.d_model)


def test_rope_frequencies_match_the_jitted_reference_bit_for_bit():
    """Every registry architecture's (head size, theta), and the reduced
    variants', against the constants of the reference's expression under
    ``jax.jit`` (its decode, prefill and train steps run jitted): one ulp of
    a frequency moves the angle at position 524,287 by up to 0.03 rad."""
    pairs = {(c.head_dim, c.rope_theta) for c in registry.ARCHS.values()}
    pairs |= {(32, 1e4), (48, 1e6)}
    for head_dim, theta in sorted(pairs):
        want = jax.jit(lambda h=head_dim, t=theta: jcommon.rope_frequencies(h, t))()
        np.testing.assert_array_equal(common.rope_frequencies(head_dim, theta).numpy(),
                                      np.asarray(want),
                                      err_msg=f"head size {head_dim}, theta {theta:g}")


@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (32, 1e4)])
def test_apply_rope_at_long_positions_matches_the_jitted_reference(head_dim, theta):
    """mistral-nemo's full head size and theta, and the granite-shaped
    variant's, at positions up to 524,287: within a few float32 ulps of the
    jitted reference (sin and cos of an angle of ~5e5 rad, each side's
    own)."""
    x = np.random.default_rng(5).normal(size=(2, 8, 4, head_dim)).astype(np.float32)
    pos = np.array([0, 63, 4_095, 32_767, 131_071, 524_280, 524_286, LONG_POS])
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jax.jit(lambda a, p: jcommon.apply_rope(a, p, theta))(jnp.asarray(x),
                                                                 jnp.asarray(pos))
    assert_close(got, want, what="apply_rope", atol=2e-6, rtol=0)


def test_hidden_states_and_prefill_logits_match(variant):
    bundle = get_bundle(variant["cfg"])
    h = bundle.forward(variant["tp"], variant["tokens"])
    assert h.dtype == torch.float32 and h.shape == variant["jh"].shape
    assert_close(h, variant["jh"], what="hidden states")
    logits = bundle.prefill(variant["tp"], {"tokens": variant["tokens"]})
    assert tuple(logits.shape) == (B, 1, variant["cfg"].vocab_size)
    assert_close(logits, variant["jl"], what="last-token logits")


def test_bf16_hidden_states_match_reference(variant):
    """tests/test_torch_models.py's bar: 4 bf16 ulps of max|h| a layer, and
    no farther from the reference's float32 states than twice the
    reference's own bf16 states are."""
    cfg, tokens = variant["cfg"], variant["tokens"]
    jp16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variant["jp"])
    jh16 = jtransformer.forward(jp16, variant["jcfg"], jnp.asarray(tokens), remat=False)
    jh16 = np.asarray(jh16.astype(jnp.float32))
    tp16 = jax.tree.map(lambda t: t.to(torch.bfloat16), variant["tp"])
    h = get_bundle(cfg).forward(tp16, tokens)
    assert h.dtype == torch.bfloat16
    h = h.float().numpy()
    assert float(np.abs(h - jh16).max()) <= 4 * 2.0**-7 * float(np.abs(jh16).max()) * cfg.n_layers
    assert np.abs(h - variant["jh"]).max() <= 2 * np.abs(jh16 - variant["jh"]).max()


def test_loss_and_every_gradient_leaf_match_reference(variant):
    cfg, tokens = variant["cfg"], variant["tokens"]
    jval, jgrads = jax.value_and_grad(variant["jb"].loss)(
        jax.tree.map(jnp.asarray, variant["jp"]), {"tokens": jnp.asarray(tokens)})
    params = interop.lm_params_from_numpy(cfg, variant["jp"], device="cpu")
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_bundle(cfg).loss(params, {"tokens": tokens})
    grads = torch.utils._pytree.tree_unflatten(list(torch.autograd.grad(loss, leaves)), spec)
    assert_close(loss, jval, what="loss")
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    seen = []

    def check(path, jg):
        g = grads
        for key in path:
            g = g[key.key]
        assert float(np.abs(jg).max()) > 0
        _assert_leaf_close(g, jg, what=jax.tree_util.keystr(path))
        seen.append(path)

    jax.tree_util.tree_map_with_path(check, jgrads)
    assert len(seen) == len(leaves)


def test_train_step_matches_reference(variant):
    """One AdamW step over two microbatches from the same parameters and
    state (tests/test_torch_training.py's: eps = 1e-3 keeps each update a
    smooth function of its gradient); the updates to the leaf bar plus one
    float32 rounding of p + u on each side."""
    cfg, tokens = variant["cfg"], variant["tokens"]
    jopt = joptim.adamw(joptim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    jparams = jax.tree.map(jnp.asarray, variant["jp"])
    jstate = jopt.init(jparams)
    jstep = jsteps.make_train_step(jget_bundle(variant["jcfg"]), jopt, microbatches=2,
                                   clip_norm=1.0)
    jp2, js2, jloss = jstep(jparams, jstate, {"tokens": jnp.asarray(tokens)})

    opt = optim.adamw(optim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
    params = interop.lm_params_from_numpy(cfg, variant["jp"], device="cpu")
    state = interop.adam_state_from_numpy(jax.tree.map(np.asarray, tuple(jstate)), device="cpu")
    step = steps.make_train_step(get_bundle(cfg), opt, microbatches=2, clip_norm=1.0)
    params, state, loss = step(params, state, {"tokens": tokens})
    assert_close(loss, jloss, what="loss")
    assert int(state.step) == int(js2.step) == 1
    _, tmu, tnu = interop.adam_state_to_numpy(state)
    got = {"params": jax.tree.map(to_np, params), "mu": tmu, "nu": tnu}
    want = {"params": jax.tree.map(np.asarray, jp2), "mu": jax.tree.map(np.asarray, js2.mu),
            "nu": jax.tree.map(np.asarray, js2.nu)}
    before = variant["jp"]

    def check(path, want_leaf, have, old):
        what = jax.tree_util.keystr(path)
        if path[0].key != "params":
            _assert_leaf_close(have, want_leaf, what)
            return
        d_have, d_want = np.float64(have) - old, np.float64(want_leaf) - old
        bar = 1e-4 * np.abs(d_want).max() + 1e-4 * np.abs(d_want) + 2 * EPS32 * np.abs(old)
        assert np.all(np.abs(d_have - d_want) <= bar), what + " update"

    jax.tree_util.tree_map_with_path(check, want, got,
                                     {"params": before, "mu": before, "nu": before})


def _seeded_cache(jb, batch, seq_len, seed):
    """The reference's zero cache of ``batch`` x ``seq_len`` with every leaf
    drawn from a seeded normal (numpy, float32)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree.flatten(jb.init_cache(batch, seq_len, jnp.float32))
    return jax.tree.unflatten(tree, [rng.standard_normal(leaf.shape, dtype=np.float32)
                                     for leaf in leaves])


@pytest.mark.parametrize("pos", [63, LONG_POS])
def test_decode_at_positions_matches_reference(variant, pos):
    """One step into a seeded 64-slot cache at position 63 (the last slot)
    and at 524,287 (RoPE's angles near their largest; the write lands in
    the last slot, as ``dynamic_update_slice`` clamps it): logits and every
    cache leaf."""
    cfg, jb = variant["cfg"], variant["jb"]
    jcache = _seeded_cache(jb, B, 64, seed=pos)
    cache = interop.lm_cache_from_numpy(cfg, [np.asarray(x) for x in jax.tree.leaves(jcache)],
                                        device="cpu")
    token = variant["tokens"][:, 5:6]
    want, jcache = jax.jit(jb.decode)(jax.tree.map(jnp.asarray, variant["jp"]), jcache,
                                      jnp.asarray(token), jnp.asarray(pos))
    got, cache = get_bundle(cfg).decode(variant["tp"], cache, token, pos)
    assert_close(got, want, what=f"logits at {pos}")
    for i, (g, w) in enumerate(zip(interop.lm_cache_to_numpy(cfg, cache),
                                   jax.tree.leaves(jcache), strict=True)):
        assert_close(g, w, what=f"cache leaf {i} at {pos}")


def test_long_500k_ring_matches_reference_across_its_wrap(variant):
    """``for_shape(cfg, long_500k)`` (the sliding-window variant) with the
    window cut to 16: ``init_cache(B, 524,288)`` holds 16 ring slots, as the
    reference's does; then 24 steps from a seeded ring at positions
    524,264-524,287, the write slot wrapping at 524,272: each step's logits
    and ring against the reference's jitted decode."""
    shape = registry.SHAPES["long_500k"]
    long_cfg = registry.for_shape(variant["cfg"], shape)
    jlong = jregistry.for_shape(variant["jcfg"], jregistry.SHAPES["long_500k"])
    assert long_cfg.sliding_window == jlong.sliding_window == registry.LONG_CTX_WINDOW
    cfg = dataclasses.replace(long_cfg, sliding_window=RING_WINDOW)
    jb = jget_bundle(dataclasses.replace(jlong, sliding_window=RING_WINDOW), chunked_attn=False)
    bundle = get_bundle(cfg)
    zero = bundle.init_cache(B, shape.seq_len, torch.float32, device="cpu")
    assert zero.k.shape == (cfg.n_layers, B, RING_WINDOW, cfg.n_kv_heads, cfg.head_dim)
    assert jax.eval_shape(lambda: jb.init_cache(B, shape.seq_len, jnp.float32)).k.shape \
        == tuple(zero.k.shape)
    jcache = _seeded_cache(jb, B, shape.seq_len, seed=11)
    cache = interop.lm_cache_from_numpy(cfg, [np.asarray(x) for x in jax.tree.leaves(jcache)],
                                        device="cpu")
    jparams, decode = jax.tree.map(jnp.asarray, variant["jp"]), jax.jit(jb.decode)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, RING_STEPS, B, seed=4)
    for t in range(RING_STEPS):
        pos = LONG_POS - RING_STEPS + 1 + t
        want, jcache = decode(jparams, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(pos))
        got, cache = bundle.decode(variant["tp"], cache, tokens[:, t:t + 1], pos)
        assert_close(got, want, what=f"logits at {pos}")
        for i, (g, w) in enumerate(zip(interop.lm_cache_to_numpy(cfg, cache),
                                       jax.tree.leaves(jcache), strict=True)):
            assert_close(g, w, what=f"ring leaf {i} at {pos}")
