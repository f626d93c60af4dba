"""The port's VLM and MoE families (internvl2-2b, qwen2-moe-a2.7b,
deepseek-v2-236b with MLA) against the JAX package, on the CPU.

Each reduced configuration (``ArchConfig.reduced()``) is initialised by the
reference; its parameters cross with ``interop.lm_params_from_numpy`` and its
caches with ``interop.lm_cache_from_numpy``, and the same numpy inputs from
a seed go through both packages:

* routing (``moe.route``): the dispatch mask equal bit for bit, combine
  weights and the aux loss within 1e-6, with capacities that drop tokens
  and with exactly tied router logits (the reference's ``lax.top_k`` puts
  the lower expert first; the port's stable sort does too);
* ``moe_ffn`` with and without the shared expert, over two capacity groups;
* ``mla_block``'s prefill against the reference's ``chunked=False`` and
  ``chunked=True`` routes (both ``q_lora_rank`` forms), and its absorbed
  decode step by step with the latent cache;
* ``vlm.project`` and the decoder's forward with the projected prefix;
* each bundle's prefill and its decode, step by step, with the logits and
  every cache leaf held to the reference's jitted ``bundle.decode``
  (qwen2-moe also with ``sliding_window=8`` over 20 tokens: the ring wraps);
* the parameter and cache interop (``MoECaches(dense=None)`` included);
* B7's plain version at a v head size other than q's and k's (MLA's case)
  against the reference's ``attend_full`` and ``attend_chunked``, the
  tensor-core kernel's arithmetic at MLA's (192, 128) within the card's
  bars, and B8's plain version at (192, 128) against autograd.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) but where a test states
1e-6 (routing: float32 softmaxes of the same logits, a few ulps on values
below 1).  Both sides compute in float32 with other summation orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _flash_emulation as emulation
from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.models import attention as jattention
from repro.models import get_bundle as jget_bundle
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import moe_lm as jmoe_lm
from repro.models import transformer as jtransformer
from repro.models import vlm as jvlm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd, ops
from repro_torch.models import cache_specs, get_bundle, mla, moe, moe_lm, vlm

B = 2
ROUTE_TOL = dict(atol=1e-6, rtol=0)
VLM, QMOE, DSV2 = "internvl2-2b", "qwen2-moe-a2.7b", "deepseek-v2-236b"


def _cfgs(name, **changes):
    return (dataclasses.replace(jregistry.get(name).reduced(), **changes),
            dataclasses.replace(registry.get(name).reduced(), **changes))


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _leaves(jtree) -> list[np.ndarray]:
    return [np.asarray(leaf) for leaf in jax.tree.flatten(jtree)[0]]


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Routing and the MoE FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s,e,k,cap,ties,drops", [
    (2, 64, 8, 2, 40, False, False),    # room for every choice
    (2, 64, 8, 2, 5, False, True),      # most choices past capacity: dropped
    (3, 33, 60, 4, 3, False, None),     # qwen2-moe's experts and top-k
    (1, 256, 160, 6, 12, False, None),  # deepseek-v2's, at its full-width capacity
    (2, 48, 8, 3, 6, True, None),       # logits on a grid of 4 values: exact ties
], ids=["roomy", "dropping", "qwen2-moe", "deepseek-v2", "ties"])
def test_route_matches_reference(b, s, e, k, cap, ties, drops):
    logits = _normal((b, s, e), seed=s + e, scale=2.0)
    if ties:
        logits = np.round(logits / 2.0).astype(np.float32)
    jd, jc, ja = jmoe.route(jnp.asarray(logits), k, cap)
    d, c, a = moe.route(torch.from_numpy(logits), k, cap)
    assert d.dtype == c.dtype == a.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert_close(c, jc, what="combine", **ROUTE_TOL)
    assert_close(a, ja, what="aux", **ROUTE_TOL)
    if drops is not None:  # the capacity dropped choices (the same ones), or none
        assert (float(d.sum()) < b * s * k) is drops


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "routed only"])
def test_moe_ffn_matches_reference(shared):
    """qwen2-moe reduced (4 experts, top-2), S = 300: two capacity groups of
    150 tokens."""
    jcfg, cfg = _cfgs(QMOE, n_shared_experts=1 if shared else 0)
    jp = jmoe.init_moe_ffn(jax.random.PRNGKey(3), jcfg, jnp.float32)
    assert ("shared" in jp) is shared
    x = _normal((B, 300, cfg.d_model), seed=4)
    jy, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_ffn(_torch_tree(jp), cfg, torch.from_numpy(x))
    assert_close(y, jy, what="moe_ffn y")
    assert_close(aux, jaux, what="moe_ffn aux", **ROUTE_TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[64, 0], ids=["q_lora", "dense q"])
def mla_case(request):
    jcfg, cfg = _cfgs(DSV2, q_lora_rank=request.param)
    jp = jmla.init_mla(jax.random.PRNGKey(5), jcfg, jnp.float32)
    assert ("w_dq" in jp) is bool(request.param)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=_torch_tree(jp),
                x=_normal((B, 40, cfg.d_model), seed=6))


@pytest.mark.parametrize("chunked", [False, True])
def test_mla_prefill_matches_reference(mla_case, chunked):
    c = mla_case
    jout, (jc, jk) = jmla.mla_block(c["jp"], c["jcfg"], jnp.asarray(c["x"]), chunked=chunked)
    out, (ckv, kpe) = mla.mla_block(c["tp"], c["cfg"], torch.from_numpy(c["x"]))
    assert_close(out, jout, what=f"mla prefill vs chunked={chunked}")
    assert_close(ckv, jc, what="c_kv")
    assert_close(kpe, jk, what="k_pe")


def test_mla_absorbed_decode_matches_reference(mla_case):
    """Ten steps of the absorbed decode from a zero latent cache of 12
    slots: each step's output and both cache leaves; the position is an int
    on odd steps and a 0-d tensor on even ones."""
    c = mla_case
    cfg, jcfg = c["cfg"], c["jcfg"]
    shapes = ((B, 12, cfg.kv_lora_rank), (B, 12, cfg.qk_rope_head_dim))
    jcache = jmla.MLACache(*(jnp.zeros(s, jnp.float32) for s in shapes))
    cache = mla.MLACache(*(torch.zeros(s) for s in shapes))
    step = jax.jit(lambda p, x, cache, pos: jmla.mla_block(p, jcfg, x, cache=cache,
                                                           cache_pos=pos))
    for t in range(10):
        x = c["x"][:, t:t + 1]
        jout, jcache = step(c["jp"], jnp.asarray(x), jcache, jnp.asarray(t))
        out, got = mla.mla_block(c["tp"], cfg, torch.from_numpy(x), cache=cache,
                                 cache_pos=t if t % 2 else torch.tensor(t))
        assert got is cache
        assert_close(out, jout, what=f"mla decode step {t}")
        assert_close(cache.c_kv, jcache.c_kv, what=f"step {t} c_kv")
        assert_close(cache.k_pe, jcache.k_pe, what=f"step {t} k_pe")


# ---------------------------------------------------------------------------
# The VLM's projector and prefix
# ---------------------------------------------------------------------------

def test_vlm_project_and_prefix_forward_match_reference():
    jcfg, cfg = _cfgs(VLM)
    jp = jvlm.init_params(jax.random.PRNGKey(7), jcfg)
    tp = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    patches = _normal((B, cfg.n_patches, cfg.d_frontend), seed=8)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 16, B, seed=9)
    jprefix = jvlm.project(jp, jnp.asarray(patches))
    prefix = vlm.project(tp, torch.from_numpy(patches))
    assert_close(prefix, jprefix, what="project")
    jh = jtransformer.forward(jp, jcfg, jnp.asarray(tokens), prefix_embeds=jprefix, remat=False)
    h = vlm.forward(tp, cfg, torch.from_numpy(tokens).long(),
                    patch_embeds=torch.from_numpy(patches), remat=False)
    assert tuple(h.shape) == (B, cfg.n_patches + 16, cfg.d_model)
    assert_close(h, jh, what="forward with the prefix")
    bundle = get_bundle(cfg)
    assert_close(bundle.forward(tp, tokens, patches), jh, what="bundle.forward with patches")
    jtext = jtransformer.forward(jp, jcfg, jnp.asarray(tokens), remat=False)
    assert_close(bundle.forward(tp, tokens), jtext, what="bundle.forward, text alone")


# ---------------------------------------------------------------------------
# Bundles: prefill, and decode step by step with every cache leaf
# ---------------------------------------------------------------------------

BUNDLE_CASES = {  # id: (arch, config changes, prefill length, decode steps)
    "internvl2": (VLM, {}, 24, 10),
    "qwen2-moe": (QMOE, {}, 24, 10),
    "qwen2-moe ring": (QMOE, {"sliding_window": 8}, 24, 20),
    "deepseek-v2": (DSV2, {}, 24, 10),
}


@pytest.fixture(scope="module", params=sorted(BUNDLE_CASES))
def bundle_case(request):
    name, changes, s, steps = BUNDLE_CASES[request.param]
    jcfg, cfg = _cfgs(name, **changes)
    jb = jget_bundle(jcfg, chunked_attn=False)
    jp = jb.init(jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, cfg=cfg, jb=jb, jp=jp, s=s, steps=steps,
                tp=interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                                device="cpu"),
                tokens=synthetic.lm_token_stream(cfg.vocab_size, max(s, steps), B, seed=3))


def test_bundle_prefill_matches_reference(bundle_case):
    c = bundle_case
    cfg, tokens = c["cfg"], c["tokens"][:, :c["s"]]
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _normal((B, cfg.n_patches, cfg.d_frontend), seed=10)
    bundle = get_bundle(cfg)
    want = c["jb"].prefill(c["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    logits = bundle.prefill(c["tp"], batch)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert_close(logits, want, what=f"{cfg.name} prefill logits")
    if cfg.family == "moe":
        jh, jaux = jmoe_lm.forward(c["jp"], c["jcfg"], jnp.asarray(tokens), remat=False)
        h, aux = moe_lm.forward(c["tp"], cfg, torch.from_numpy(tokens).long())
        assert_close(h, jh, what="hidden states")
        assert_close(aux, jaux, what="aux loss", **ROUTE_TOL)
        assert_close(bundle.forward(c["tp"], tokens), jh, what="bundle.forward")


def _check_cache(cfg, cache, want, what):
    got = interop.lm_cache_to_numpy(cfg, cache)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        assert_close(g, w, what=f"{what}: cache leaf {i}")


def test_bundle_decode_matches_reference_per_step(bundle_case):
    """The port's decode from the reference's zero cache (carried across),
    every step's logits and cache leaves held to the reference's jitted
    ``bundle.decode``; the port updates the cache in place."""
    c = bundle_case
    cfg, steps, tokens = c["cfg"], c["steps"], c["tokens"]
    decode = jax.jit(c["jb"].decode)
    jcache = c["jb"].init_cache(B, steps, jnp.float32)
    bundle = get_bundle(cfg)
    cache = interop.lm_cache_from_numpy(cfg, _leaves(jcache), device="cpu")
    for t in range(steps):
        jlogits, jcache = decode(c["jp"], jcache, jnp.asarray(tokens[:, t:t + 1]),
                                 jnp.asarray(t))
        logits, out = bundle.decode(c["tp"], cache, tokens[:, t:t + 1],
                                    t if t % 2 else torch.tensor(t))
        assert out is cache
        assert_close(logits, jlogits, what=f"{cfg.name} step {t} logits")
        _check_cache(cfg, cache, _leaves(jcache), f"{cfg.name} step {t}")
    if cfg.sliding_window:
        assert cache.moe.k.shape[2] == cfg.sliding_window < steps  # the ring wrapped


# ---------------------------------------------------------------------------
# Interop and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dense", [1, 0], ids=["dense prefix", "no dense layers"])
def test_param_and_cache_interop_round_trip(n_dense):
    """deepseek-v2 reduced with and without its dense first layer: the
    parameter stacks are checked, the cache (``MoECaches(dense=None)``
    without dense layers) round-trips leaf for leaf, and ``cache_specs``
    gives the reference's ``eval_shape`` tree."""
    jcfg, cfg = _cfgs(DSV2, first_dense_layers=n_dense)
    jb = jget_bundle(jcfg)
    tree = jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(1)))
    params = interop.lm_params_from_numpy(cfg, tree, device="cpu")
    assert ("dense_layers" in params) is bool(n_dense)
    assert params["moe_layers"]["moe"]["router"].shape == (cfg.n_layers - n_dense,
                                                           cfg.d_model, cfg.n_experts)
    for key, changes in (("moe_layers", {"n_layers": 3}),
                         ("dense_layers", {"first_dense_layers": 1 - n_dense,
                                           "n_layers": cfg.n_layers + 1 - 2 * n_dense})):
        with pytest.raises(ValueError, match=key):
            interop.lm_params_from_numpy(dataclasses.replace(cfg, **changes), tree,
                                         device="cpu")
    rng = np.random.default_rng(2)
    leaves = [rng.normal(size=leaf.shape).astype(np.float32)
              for leaf in _leaves(jb.init_cache(B, 6, jnp.float32))]
    cache = interop.lm_cache_from_numpy(cfg, leaves, device="cpu")
    assert isinstance(cache, moe_lm.MoECaches) and isinstance(cache.moe, mla.MLACache)
    assert (cache.dense is None) is (n_dense == 0)
    for a, b in zip(interop.lm_cache_to_numpy(cfg, cache), leaves, strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cache leaves"):
        interop.lm_cache_from_numpy(cfg, leaves[:-1], device="cpu")
    specs = cache_specs(get_bundle(cfg), B, 6, torch.bfloat16)
    want = jax.eval_shape(lambda: jb.init_cache(B, 6, jnp.bfloat16))
    got_leaves, want_leaves = interop._cache_leaves(specs), jax.tree.flatten(want)[0]
    assert [tuple(t.shape) for t in got_leaves] == [w.shape for w in want_leaves]
    assert all(t.dtype == torch.bfloat16 and t.device.type == "meta" for t in got_leaves)


def test_vlm_input_specs_give_patches_except_for_decode():
    cfg = registry.get(VLM)
    bundle = get_bundle(cfg)
    prefill = bundle.input_specs(registry.SHAPES["prefill_32k"])
    assert tuple(prefill["patch_embeds"].shape) == (
        registry.SHAPES["prefill_32k"].global_batch, cfg.n_patches, cfg.d_frontend)
    decode = bundle.input_specs(registry.SHAPES["decode_32k"])
    assert set(decode) == {"tokens"}
    assert set(get_bundle(registry.get(QMOE)).input_specs(registry.SHAPES["prefill_32k"])) \
        == {"tokens"}


# ---------------------------------------------------------------------------
# B7 at a value head size of its own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("hkv", [4, 2])
def test_plain_attention_with_own_value_size_matches_reference(hkv, window):
    """q and k of head size 48 (MLA reduced: 32 nope + 16 rope), v of 32."""
    q, k = _normal((B, 64, 4, 48), seed=11), _normal((B, 64, hkv, 48), seed=12)
    v = _normal((B, 64, hkv, 32), seed=13)
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    assert tuple(out.shape) == (B, 64, 4, 32) and tuple(lse.shape) == (B, 4, 64)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert_close(out, jattention.attend_full(jq, jk, jv, window=window), what="attend_full")
    assert_close(out, jattention.attend_chunked(jq, jk, jv, window=window, q_block=16,
                                                kv_block=16), what="attend_chunked")


def test_tensor_core_forward_model_at_mla_head_sizes():
    """B7's bf16 arithmetic at (D, D_v) = (192, 128), ragged S: every output
    element within one bf16 ulp and lse within 1e-5, the card's bars."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, 100, 2, 192), (1, 100, 2, 192), (1, 100, 2, 128)))
    out_share, lse_share = emulation.forward_share(q, k, v, None, split=True)
    assert out_share <= 1.0 and lse_share <= 1.0, (out_share, lse_share)
    assert (192, 128) in ops.HEAD_DIM_PAIRS and (192, 192) not in ops.HEAD_DIM_PAIRS


def test_backward_refuses_unequal_head_sizes():
    """B8 at MLA's head sizes (ROADMAP item 14, done): the plain backward at
    q/k 192 and v 128 (dq, dk 192 wide, dv 128) and the autograd Function
    through it give the gradients of autograd through the plain forward,
    causal and not, GQA, at a ragged S (TOLS)."""
    rng = np.random.default_rng(5)
    q, k = (torch.from_numpy(rng.normal(size=(2, 37, n, 192)).astype(np.float32))
            for n in (4, 2))
    v = torch.from_numpy(rng.normal(size=(2, 37, 2, 128)).astype(np.float32))
    do = torch.from_numpy(rng.normal(size=(2, 37, 4, 128)).astype(np.float32))
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref, _ = ops.flash_attention_ref(*leaves, causal=causal)
        want = torch.autograd.grad(ref, leaves, do)
        out, lse = flash_attention(q, k, v, causal=causal)
        plain = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn_out, _ = ops.FlashAttention.apply(*leaves, causal, None)
        via_fn = torch.autograd.grad(fn_out, leaves, do)
        for name, w, p, f in zip(("dq", "dk", "dv"), want, plain, via_fn):
            assert p.shape == w.shape and p.shape[-1] == (128 if name == "dv" else 192)
            assert_close(p, w, what=f"{name} causal={causal}: plain vs autograd")
            assert_close(f, w, what=f"{name} causal={causal}: Function vs autograd")
