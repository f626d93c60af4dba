"""The port's LM backbones (dense, SSM, hybrid) against the JAX package, on
the CPU.

Each reduced configuration (``ArchConfig.reduced()``) is initialised by the
reference; its parameters cross to the port with
``interop.lm_params_from_numpy``, and the same tokens from
``lm_token_stream`` go through both: the final hidden states and the prefill
logits are compared.  The hybrid runs at S = 96, longer than its reduced
local window of 64, so the window's mask is live.  On CPU tensors the port's
attention, RG-LRU and SSD layers run their kernels' plain versions.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4).  Both sides compute in
float32 with other summation orders (XLA against torch's CPU kernels, an
[S, S] softmax against the reference's blocked one, a sequential RG-LRU
against an associative scan); on O(1) normalised hidden states that is a
few float32 ulps per layer.  The bf16 comparison states its own bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.models import common as jcommon
from repro.models import get_bundle as jget_bundle
from repro.models import mamba2 as jmamba2
from repro.models import rglru as jrglru
from repro.models import transformer as jtransformer
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.models import common, get_bundle, mamba2

ARCHS = {"qwen3-1.7b": 48, "mamba2-780m": 64, "recurrentgemma-9b": 96, "granite-20b": 48,
         "mistral-nemo-12b": 48}
_JMOD = {"dense": jtransformer, "ssm": jmamba2, "hybrid": jrglru}



@pytest.fixture(scope="module", params=sorted(ARCHS))
def arch(request):
    """Reduced config, reference params, tokens, the reference's hidden
    states and prefill logits, and the port's params."""
    name, s = request.param, ARCHS[request.param]
    jcfg, cfg = jregistry.get(name).reduced(), registry.get(name).reduced()
    jb = jget_bundle(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, s, 2, seed=3)
    jh = _JMOD[jcfg.family].forward(jp, jcfg, jnp.asarray(tokens), remat=False)
    jl = jb.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tp = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dict(cfg=cfg, jcfg=jcfg, jp=jp, tp=tp, tokens=tokens, jh=np.asarray(jh),
                jl=np.asarray(jl))


def test_hidden_states_match(arch):
    h = get_bundle(arch["cfg"]).forward(arch["tp"], arch["tokens"])
    assert h.dtype == torch.float32 and h.shape == arch["jh"].shape
    assert_close(h, arch["jh"], what=f"{arch['cfg'].name} hidden states")


def test_prefill_logits_match(arch):
    logits = get_bundle(arch["cfg"]).prefill(arch["tp"], {"tokens": arch["tokens"]})
    assert tuple(logits.shape) == (2, 1, arch["cfg"].vocab_size)
    assert_close(logits, arch["jl"], what=f"{arch['cfg'].name} last-token logits")


def test_bf16_hidden_states_match_reference(arch):
    """Both packages in bf16 on the same parameters (the reference's, rounded
    to bf16 on each side).  The routes round at other places: the reference's
    ``attend_full`` rounds the probabilities to bf16 before P·V, the port's
    attention keeps them in float32; XLA and torch round the norms, RoPE and
    products to bf16 in other orders.  Bar: 4 bf16 ulps of max|h| per layer,
    4·2^-7·max|h|·n_layers (measured: 1.5, 3.8 and 1.7 such ulps in all for
    qwen3, mamba2 and recurrentgemma); and the port's bf16 states lie no
    farther from the reference's float32 states than twice the reference's
    own bf16 states do (measured: 0.95–1.1 times)."""
    cfg, tokens = arch["cfg"], arch["tokens"]
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), arch["jp"])
    jh16 = _JMOD[cfg.family].forward(jp16, arch["jcfg"], jnp.asarray(tokens), remat=False)
    jh16 = np.asarray(jh16.astype(jnp.float32))
    tp16 = jax.tree.map(lambda t: t.to(torch.bfloat16), arch["tp"])
    h = get_bundle(cfg).forward(tp16, tokens)
    assert h.dtype == torch.bfloat16
    h = h.float().numpy()
    bar = 4 * 2.0**-7 * float(np.abs(jh16).max()) * cfg.n_layers
    assert float(np.abs(h - jh16).max()) <= bar
    assert np.abs(h - arch["jh"]).max() <= 2 * np.abs(jh16 - arch["jh"]).max()


def test_init_matches_reference_layout(arch):
    """The port's own init has the reference's tree: keys, shapes, dtypes;
    and the deterministic leaves equal the reference's."""
    cfg = arch["cfg"]
    tp = get_bundle(cfg).init(0, device="cpu")
    jleaves, jtree = jax.tree.flatten(arch["jp"])
    tleaves, ttree = jax.tree.flatten(tp)
    assert ttree == jtree
    for t, j in zip(tleaves, jleaves, strict=True):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
    if cfg.family == "ssm":
        lay, jlay = tp["layers"], arch["jp"]["layers"]
        assert torch.equal(lay["dt_bias"], torch.zeros_like(lay["dt_bias"]))
        assert torch.equal(lay["d_skip"], torch.ones_like(lay["d_skip"]))
        # XLA folds jnp.log(jnp.linspace(...)) into a constant that can sit
        # one float32 ulp from the correctly rounded value the port stores.
        ulps = np.abs(lay["a_log"].numpy().view(np.int32)
                      - np.asarray(jlay["a_log"]).view(np.int32))
        assert ulps.max() <= 1
    if cfg.family == "hybrid":
        rec = tp["periods"]["b0"]
        assert torch.equal(rec["lam"], torch.full_like(rec["lam"], 4.0))
        assert torch.equal(rec["b_r"], torch.zeros_like(rec["b_r"]))
    emb = tp["embed"]["table"]
    assert abs(float(emb.std()) - 0.02) < 2e-3


@pytest.mark.parametrize("args", [(512, 64, 4, 0), (151936, 40, 3, 7), (50280, 9, 2, 1)])
def test_lm_token_stream_is_bit_identical(args):
    np.testing.assert_array_equal(synthetic.lm_token_stream(*args),
                                  jsynthetic.lm_token_stream(*args))
    assert synthetic.lm_token_stream(*args).dtype == np.int32


def test_common_components_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    assert_close(common.rmsnorm({"scale": torch.from_numpy(scale)}, tx),
                 jcommon.rmsnorm({"scale": jnp.asarray(scale)}, jx), what="rmsnorm")
    lp = {"scale": scale, "bias": scale[::-1].copy()}
    assert_close(common.layernorm({k: torch.from_numpy(v) for k, v in lp.items()}, tx),
                 jcommon.layernorm({k: jnp.asarray(v) for k, v in lp.items()}, jx),
                 what="layernorm")
    pos = np.arange(12)
    assert_close(common.apply_rope(tx, torch.from_numpy(pos), 1e6),
                 jcommon.apply_rope(jx, jnp.asarray(pos), 1e6), what="rope")
    for kind in ("swiglu", "geglu", "gelu_mlp"):
        jp = jcommon.init_mlp(jax.random.PRNGKey(1), kind, 32, 48, jnp.float32)
        tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
        assert_close(common.mlp(tp, kind, tx), jcommon.mlp(jp, kind, jx), what=kind)


def test_causal_conv_matches():
    rng = np.random.default_rng(4)
    w, b, x = (rng.normal(size=s).astype(np.float32) for s in ((4, 24), (24,), (2, 10, 24)))
    assert_close(mamba2._causal_conv(*map(torch.from_numpy, (w, b, x))),
                 jmamba2._causal_conv(*map(jnp.asarray, (w, b, x))), what="causal conv")


def test_params_from_numpy_checks_the_layout():
    cfg = registry.get("qwen3-1.7b").reduced()
    tree = jax.tree.map(np.asarray, jget_bundle(jregistry.get("qwen3-1.7b").reduced())
                        .init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="layer stacks"):
        interop.lm_params_from_numpy(dataclasses.replace(cfg, n_layers=3), tree, device="cpu")


@pytest.mark.parametrize("name", ["internvl2-2b", "qwen2-moe-a2.7b", "whisper-tiny"])
def test_families_not_ported_raise(name):
    """ROADMAP item 14 is done for these families: the bundle builds at full
    size, and ``loss`` of the reduced model on the host is a float32 scalar
    within 1.0 of ln V whose graph reaches every parameter leaf
    (tests/test_torch_lm_training.py holds loss and gradients to the
    reference's).  The VLM's batch carries ``patch_embeds``, the
    encoder-decoder's ``frames``."""
    cfg = registry.get(name)
    assert get_bundle(cfg).cfg is cfg
    small = cfg.reduced()
    bundle = get_bundle(small)
    params = bundle.init(0, device="cpu")
    leaves = torch.utils._pytree.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(0)
    batch = {"tokens": synthetic.lm_token_stream(small.vocab_size, 16, 2, seed=0)}
    for key, spec in bundle.input_specs(registry.InputShape("t", 16, 2, "train")).items():
        if key != "tokens":
            batch[key] = rng.normal(size=tuple(spec.shape)).astype(np.float32)
    loss = bundle.loss(params, batch)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    assert abs(float(loss.detach()) - np.log(small.vocab_size)) < 1.0
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(g.isfinite().all()) for g in grads)


def test_training_and_decode_wait_and_init_defaults_to_the_card(monkeypatch):
    """Training no longer waits for the ssm and hybrid families (ROADMAP
    item 16 is done): the reduced models' loss on the host is a finite
    float32 scalar within 1.0 of ln V whose graph reaches every parameter
    leaf (tests/test_torch_ssm_training.py holds loss and gradients to the
    reference's).  Decode no longer waits: the bundle's ``init_cache`` and
    ``decode`` run on the host (tests/test_torch_decode.py holds them to the
    reference).  ``init`` and ``init_cache`` default to the card and raise
    without one."""
    b = get_bundle(registry.get("qwen3-1.7b").reduced())
    for n in ("mamba2-780m", "recurrentgemma-9b"):
        small = registry.get(n).reduced()
        bundle = get_bundle(small)
        params = bundle.init(0, device="cpu")
        leaves = torch.utils._pytree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tokens = synthetic.lm_token_stream(small.vocab_size, 32, 2, seed=0)
        loss = bundle.loss(params, {"tokens": tokens})
        assert loss.dtype == torch.float32 and loss.ndim == 0
        assert abs(float(loss.detach()) - np.log(small.vocab_size)) < 1.0
        grads = torch.autograd.grad(loss, leaves)
        assert all(bool(g.isfinite().all()) and bool(g.abs().max() > 0) for g in grads)
    params = b.init(0, device="cpu")
    cache = b.init_cache(2, 4, torch.float32, device="cpu")
    logits, out = b.decode(params, cache, np.zeros((2, 1), np.int32), 0)
    assert out is cache and tuple(logits.shape) == (2, 1, b.cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(cache.k[:, :, 0].abs().sum() > 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        b.init(0)
    with pytest.raises(RuntimeError, match="none is present"):
        b.init_cache(2, 4, torch.float32)
