"""Training of the VLM, MoE and encoder-decoder families against the JAX
package, on the CPU, and the attention routes their training adds.

* B7's and B8's plain versions without the causal mask (whisper's encoder)
  against ``jax.vjp`` of the reference's Pallas ``flash_attention``
  (interpret mode) and of the model's ``attend_full(causal=False)``; B8's
  plain version at MLA's head sizes, q/k 192 and v 128, against ``jax.vjp``
  of ``attend_full``; the autograd Function through both.
* The tensor-core kernels' arithmetic (``tests/_flash_emulation.py``) at
  these routes, within the bars the card holds the kernels to.
* ``bundle.loss`` and the gradient of every parameter leaf of the reduced
  internvl2-2b (patch prefix), qwen2-moe-a2.7b, deepseek-v2-236b (MLA: its
  backward is B8 at unequal head sizes) and whisper-tiny against
  ``jax.value_and_grad`` of the reference's ``lm_loss``, on parameters
  carried over with ``interop.lm_params_from_numpy``.  The MoE models'
  dispatch masks are compared bit for bit first: routing is discontinuous,
  so the gradients are only comparable where the choices are the same.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4) for values of order one
(attention outputs and gradients, losses); gradient leaves of the models
per leaf to |d| <= 1e-4·max|ref leaf| + 1e-4·|ref|, as in
``tests/test_torch_training.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _flash_emulation as emulation
from _torch_parity import assert_close, to_np

from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattention
from repro.models import get_bundle as jget_bundle
from repro.models import moe as jmoe
from repro.models import moe_lm as jmoe_lm
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.models import get_bundle, moe

B, S = 2, 16
FAMILIES = ["internvl2-2b", "qwen2-moe-a2.7b", "deepseek-v2-236b", "whisper-tiny"]


def _normal(shape, rng):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("h,hkv,d", [(4, 2, 32), (2, 2, 64)], ids=["gqa-d32", "mha-d64"])
def test_attention_without_the_causal_mask_matches_reference(h, hkv, d):
    """Forward and backward with ``causal=False`` against the Pallas kernel
    pair (interpret mode, S = 64 in blocks of 32) and ``attend_full``."""
    rng = np.random.default_rng(h + d)
    q, k, v, do = (_normal((2, 64, n, d), rng) for n in (h, hkv, hkv, h))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=False)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        plain = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out.detach(), lse,
                                    torch.from_numpy(do), causal=False)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jout, vjp = jax.vjp(lambda a, b_, c: jflash(a, b_, c, causal=False, block_q=32,
                                                block_k=32), jq, jk, jv)
    jfull, vjp_full = jax.vjp(lambda a, b_, c: jattention.attend_full(a, b_, c, causal=False),
                              jq, jk, jv)
    assert_close(out, jout, what="out vs the Pallas forward")
    assert_close(out, jfull, what="out vs attend_full")
    for name, g, p, jg, jf in zip("qkv", grads, plain, vjp(jdo), vjp_full(jdo)):
        assert_close(p, jg, what=f"d{name}: plain vs the Pallas backward")
        assert_close(p, jf, what=f"d{name}: plain vs attend_full's vjp")
        assert_close(g, p, what=f"d{name}: the Function vs the plain backward")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_backward_at_mla_head_sizes_matches_reference(causal):
    """q/k 192, v 128 (dq and dk 192 wide, dv 128), GQA, a ragged S: the
    plain backward and the Function against ``jax.vjp`` of ``attend_full``."""
    rng = np.random.default_rng(7)
    q, k = _normal((2, 40, 4, 192), rng), _normal((2, 40, 2, 192), rng)
    v, do = _normal((2, 40, 2, 128), rng), _normal((2, 40, 4, 128), rng)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        plain = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), out.detach(), lse,
                                    torch.from_numpy(do), causal=causal)
    jout, vjp = jax.vjp(lambda a, b_, c: jattention.attend_full(a, b_, c, causal=causal),
                        *map(jnp.asarray, (q, k, v)))
    assert_close(out, jout, what="out vs attend_full")
    for name, g, p, jg in zip("qkv", grads, plain, vjp(jnp.asarray(do))):
        assert p.shape == jg.shape
        assert_close(p, jg, what=f"d{name}: plain vs attend_full's vjp")
        assert_close(g, p, what=f"d{name}: the Function vs the plain backward")


@pytest.mark.parametrize("s,h,hkv,d,d_v,causal", emulation.NEW_CASES)
def test_tensor_core_model_at_the_new_routes(s, h, hkv, d, d_v, causal):
    """The bf16 kernels' arithmetic (hi + lo P and dS) at whisper's
    encoder route and MLA's head sizes, within the card's bars: the forward
    one bf16 ulp of each output, lse 1e-5; the backward one bf16 ulp plus
    2e-5 of each element's term magnitude."""
    q, k, v, do = emulation.inputs(s, h, hkv, d, seed=s + d, d_v=d_v)
    out_share, lse_share = emulation.forward_share(q, k, v, None, True, causal)
    assert out_share <= 1.0 and lse_share <= 1.0, (out_share, lse_share)
    assert emulation.backward_share(q, k, v, do, None, True, causal) <= 1.0


def _batch(cfg, seed) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": synthetic.lm_token_stream(cfg.vocab_size, S, B, seed=seed)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _normal((B, cfg.n_patches, cfg.d_frontend), rng)
    if cfg.family == "encdec":
        batch["frames"] = _normal((B, cfg.encoder_seq, cfg.d_model), rng)
    return batch


def _dispatches(jcfg, cfg, jparams, params, tokens, monkeypatch):
    """Each MoE layer's dispatch mask from both packages' forwards on the
    same tokens (the reference's through ``jax.debug.callback``)."""
    jcalls, calls = [], []
    jroute, route = jmoe.route, moe.route

    def jlogged(logits, top_k, cap):
        out = jroute(logits, top_k, cap)
        jax.debug.callback(lambda d: jcalls.append(np.asarray(d)), out[0])
        return out

    def logged(logits, top_k, cap):
        out = route(logits, top_k, cap)
        calls.append(out[0].numpy())
        return out

    monkeypatch.setattr(jmoe, "route", jlogged)
    monkeypatch.setattr(moe, "route", logged)
    jax.block_until_ready(jax.jit(lambda p, t: jmoe_lm.forward(p, jcfg, t, remat=False))(
        jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        get_bundle(cfg).forward(params, tokens)
    return jcalls, calls


def _assert_leaf_close(got, want, what):
    """|d| <= 1e-4·max|want| + 1e-4·|want| (the module docstring's bar)."""
    got, want = to_np(got), np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_leaf_match_reference(name, monkeypatch):
    jcfg, cfg = jregistry.get(name).reduced(), registry.get(name).reduced()
    jb = jget_bundle(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    params = interop.lm_params_from_numpy(cfg, tree, device="cpu")
    batch = _batch(cfg, seed=3)
    if cfg.family == "moe":
        jcalls, calls = _dispatches(jcfg, cfg, jp, params, batch["tokens"], monkeypatch)
        assert len(calls) == len(jcalls) == cfg.n_layers - cfg.first_dense_layers
        for i, (d, jd) in enumerate(zip(calls, jcalls)):
            np.testing.assert_array_equal(d, jd, err_msg=f"layer {i} dispatch")
    jval, jgrads = jax.jit(jax.value_and_grad(jb.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves, _ = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_bundle(cfg).loss(params, batch)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    grads = torch.autograd.grad(loss, leaves)
    assert_close(loss, jval, what="loss")
    assert abs(float(loss.detach()) - np.log(cfg.vocab_size)) < 1.0
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(want) == len(grads)
    for (path, jg), g in zip(want, grads):
        assert tuple(g.shape) == jg.shape
        assert float(np.abs(np.asarray(jg)).max()) > 0, jax.tree_util.keystr(path)
        _assert_leaf_close(g, jg, what=f"{name} {jax.tree_util.keystr(path)}")


def test_moe_model_cut_to_its_dense_layers_matches_reference():
    """deepseek-v2 cut to its dense layer (``n_layers = first_dense_layers``,
    ``chip_smoke.py``'s train cut): the port's parameters have no MoE stack
    (its empty leaves would take no gradient); on the reference's weights
    (its empty stack left out) the loss and every gradient leaf match."""
    changes = {"n_layers": 1}
    jcfg = dataclasses.replace(jregistry.get("deepseek-v2-236b").reduced(), **changes)
    cfg = dataclasses.replace(registry.get("deepseek-v2-236b").reduced(), **changes)
    assert "moe_layers" not in get_bundle(cfg).init(0, device="cpu")
    jb = jget_bundle(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, seed=4)
    jval, jgrads = jax.jit(jax.value_and_grad(jb.loss))(
        jp, {"tokens": jnp.asarray(batch["tokens"])})
    tree = {k: v for k, v in jax.tree.map(np.asarray, jp).items() if k != "moe_layers"}
    params = interop.lm_params_from_numpy(cfg, tree, device="cpu")
    leaves, _ = torch.utils._pytree.tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = get_bundle(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert_close(loss, jval, what="loss")
    want = [(path, g) for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]
            if path[0].key != "moe_layers"]
    assert len(want) == len(grads)
    for (path, jg), g in zip(want, grads):
        _assert_leaf_close(g, jg, what=jax.tree_util.keystr(path))
