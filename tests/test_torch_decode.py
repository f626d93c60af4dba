"""The port's decode (KV, SSM and RG-LRU caches) against the JAX package, on
the CPU.

* Attention: ``decode_attend``, ``update_cache`` and the cached
  ``attention_block`` at the shapes of the reference's
  ``test_decode_matches_prefill`` and ``test_ring_cache_decode_window_semantics``
  (tests/test_attention.py), the reference's parameters carried across.
* Backbones: each reduced configuration is initialised by the reference; its
  parameters cross with ``interop.lm_params_from_numpy`` and its zero cache
  with ``interop.lm_cache_from_numpy``.  The same tokens go through the
  reference's jitted ``bundle.decode`` and the port's, step by step: the
  logits and every cache leaf are compared after each step.  The cases are
  reduced qwen3-1.7b, the same with ``sliding_window=8`` over 20 tokens (the
  ring wraps), reduced mamba2-780m, and recurrentgemma-9b reduced with
  ``n_layers=5`` (one period and a two-block tail) and ``local_window=8``
  over 20 tokens (the ring wraps).  A reference cache taken mid-sequence
  continues in the port to the same logits; ``cache_specs`` gives the tree,
  shapes and dtypes of the reference's ``eval_shape``; the port's decode
  meets its own prefill at the reference's bar (atol 2e-3, rtol 1e-2,
  tests/test_models.py ``test_decode_consistent_with_forward``).

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4).  Both sides compute in
float32 with other summation orders (XLA against torch's CPU kernels), a
few float32 ulps per step on O(1) logits and states.  The decode position
alternates between a Python int and a 0-d tensor.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.configs.base import ArchConfig as JArchConfig
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import get_bundle as jget_bundle
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.data import synthetic
from repro_torch.models import attention as attn
from repro_torch.models import cache_specs, get_bundle

B = 2
CASES = {  # id: (arch, config changes, decode steps)
    "qwen3": ("qwen3-1.7b", {}, 12),
    "qwen3 ring": ("qwen3-1.7b", {"sliding_window": 8}, 20),
    "mamba2": ("mamba2-780m", {}, 12),
    "recurrentgemma tail ring": ("recurrentgemma-9b", {"n_layers": 5, "local_window": 8}, 20),
}


def _cfgs(name, changes):
    return (dataclasses.replace(jregistry.get(name).reduced(), **changes),
            dataclasses.replace(registry.get(name).reduced(), **changes))


def _pos(t: int):
    """The position as a Python int on odd steps, a 0-d tensor on even ones."""
    return t if t % 2 else torch.tensor(t)


def _leaves(jtree) -> list[np.ndarray]:
    return [np.asarray(leaf) for leaf in jax.tree.flatten(jtree)[0]]


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """The reference's decode of one case: its parameters, the tokens, and
    after every step the logits and the cache leaves (numpy)."""
    name, changes, s = CASES[request.param]
    jcfg, cfg = _cfgs(name, changes)
    jb = jget_bundle(jcfg, chunked_attn=False)
    jp = jb.init(jax.random.PRNGKey(0))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, s, B, seed=3)
    decode = jax.jit(jb.decode)
    jcache = jb.init_cache(B, s, jnp.float32)
    caches, logits = [_leaves(jcache)], []
    for t in range(s):
        lg, jcache = decode(jp, jcache, jnp.asarray(tokens[:, t:t + 1]), jnp.asarray(t))
        logits.append(np.asarray(lg))
        caches.append(_leaves(jcache))
    return dict(cfg=cfg, s=s, tokens=tokens, logits=logits, caches=caches,
                params=interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                                    device="cpu"))


def _check_cache(cfg, cache, want, what):
    got = interop.lm_cache_to_numpy(cfg, cache)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i)
        assert_close(g, w, what=f"{what}: cache leaf {i}")


def _decode_from(run, start: int):
    """The port's decode from the reference's cache after ``start`` steps to
    the end, each step's logits and cache held to the reference's."""
    cfg, tokens = run["cfg"], run["tokens"]
    bundle = get_bundle(cfg)
    cache = interop.lm_cache_from_numpy(cfg, run["caches"][start], device="cpu")
    for t in range(start, run["s"]):
        logits, out = bundle.decode(run["params"], cache, tokens[:, t:t + 1], _pos(t))
        assert out is cache and tuple(logits.shape) == (B, 1, cfg.vocab_size)
        what = f"{cfg.name} step {t}"
        assert_close(logits, run["logits"][t], what=what + " logits")
        _check_cache(cfg, cache, run["caches"][t + 1], what)


def test_decode_step_matches_reference_per_step(run):
    _decode_from(run, 0)


def test_mid_sequence_reference_cache_continues(run):
    """The reference's cache after half the tokens, carried into the port,
    continues to the reference's logits and caches."""
    _decode_from(run, run["s"] // 2)


def test_decode_matches_own_prefill(run):
    """Teacher-forced decode's last logits against the port's prefill of the
    same tokens (B7, B9 and B10's plain versions here), at the reference's
    own bar."""
    cfg, tokens = run["cfg"], run["tokens"]
    bundle = get_bundle(cfg)
    cache = bundle.init_cache(B, run["s"], torch.float32, device="cpu")
    for t in range(run["s"]):
        logits, cache = bundle.decode(run["params"], cache, tokens[:, t:t + 1], t)
    want = bundle.prefill(run["params"], {"tokens": tokens})
    np.testing.assert_allclose(logits[:, 0].numpy(), want[:, 0].numpy(), atol=2e-3, rtol=1e-2)


def _describe(tree):
    """Containers by type name and field, leaves as (shape, dtype name)."""
    if hasattr(tree, "shape"):
        return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")
    if isinstance(tree, dict):
        return {k: _describe(v) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    items = [_describe(v) for v in tree]
    return (type(tree).__name__, fields, items) if fields else items


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_specs_match_reference_eval_shape(case, dtype):
    name, changes, s = CASES[case]
    jcfg, cfg = _cfgs(name, changes)
    want = japi.cache_specs(jget_bundle(jcfg), 3, s, getattr(jnp, dtype))
    got = cache_specs(get_bundle(cfg), 3, s, getattr(torch, dtype))
    assert all(t.device.type == "meta" for t in interop._cache_leaves(got))
    assert _describe(got) == _describe(want)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _attention(seed, **kw):
    """The reference's attention parameters of a one-layer config, both
    packages' configs, and the port's copy of the parameters."""
    jcfg, cfg = JArchConfig(**kw), ArchConfig(**kw)
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, tp


def _kv(k, v):
    return attn.KVCache(torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v)))


def test_cached_attention_block_matches_reference():
    """test_decode_matches_prefill's shapes: 31 tokens of the prefill's k, v
    in a 32-slot cache, token 31 decoded: output and cache against the
    reference's; the output against the port's own prefill (the
    reference's bar, 1e-5); an int and a 0-d tensor position agree."""
    jcfg, cfg, jp, tp = _attention(0, name="t", family="dense", citation="", n_layers=1,
                                   d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                   vocab_size=64, qk_norm=True, qkv_bias=True)
    x = np.random.default_rng(1).normal(size=(2, 32, 64)).astype(np.float32)
    out_pf, (kc, vc) = attn.attention_block(tp, cfg, torch.from_numpy(x))
    jout_pf, (jkc, jvc) = jattn.attention_block(jp, jcfg, jnp.asarray(x))
    assert_close(out_pf, jout_pf, what="prefill")
    k0, v0 = np.zeros((2, 32, 2, 16), np.float32), np.zeros((2, 32, 2, 16), np.float32)
    k0[:, :31], v0[:, :31] = np.asarray(jkc)[:, :31], np.asarray(jvc)[:, :31]
    jout, jcache = jattn.attention_block(jp, jcfg, jnp.asarray(x[:, 31:]),
                                         cache=jattn.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
                                         cache_pos=jnp.asarray(31))
    outs = []
    for pos in (31, torch.tensor(31)):
        cache = _kv(k0, v0)
        out, new = attn.attention_block(tp, cfg, torch.from_numpy(x[:, 31:]), cache=cache,
                                        cache_pos=pos)
        assert new is cache
        assert_close(out, jout, what="decode output")
        assert_close(new.k, jcache.k, what="cache k")
        assert_close(new.v, jcache.v, what="cache v")
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0][:, 0].numpy(), out_pf[:, 31].numpy(), atol=1e-5)


def test_decode_attend_and_update_cache_match_reference():
    """``decode_attend`` with and without a window; ``update_cache`` in place,
    its start placed as ``dynamic_update_slice`` places it (a negative one
    counts from the end, then it is clamped into the cache)."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 1, 6, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 24, 3, 32)).astype(np.float32) for _ in range(2))
    for pos, window in ((20, None), (20, 8), (0, None), (23, 5)):
        got = attn.decode_attend(*map(torch.from_numpy, (q, k, v)), torch.tensor(pos),
                                 window=window)
        want = jattn.decode_attend(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                                   window=window)
        assert_close(got, want, what=f"decode_attend pos {pos} window {window}")
    k_new, v_new = (rng.normal(size=(2, 1, 3, 32)).astype(np.float32) for _ in range(2))
    for pos in (5, 23, 40, torch.tensor(40), -3, torch.tensor(-30)):
        cache = _kv(k, v)
        out = attn.update_cache(cache, torch.from_numpy(k_new), torch.from_numpy(v_new), pos)
        jpos = jnp.asarray(int(pos))
        want = jattn.update_cache(jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                                  jnp.asarray(k_new), jnp.asarray(v_new), jpos)
        assert out is cache
        np.testing.assert_array_equal(cache.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(cache.v.numpy(), np.asarray(want.v))


def test_ring_cache_decode_matches_reference():
    """test_ring_cache_decode_window_semantics' shapes: 24 tokens through an
    8-slot ring (write slot pos % 8, no window), each step's output and ring
    against the reference's; the whole against the port's own windowed
    prefill at the reference's bar (1e-4)."""
    jcfg, cfg, jp, tp = _attention(0, name="t", family="dense", citation="", n_layers=1,
                                   d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                                   vocab_size=64, sliding_window=8)
    s, win = 24, 8
    x = np.random.default_rng(1).normal(size=(1, s, 32)).astype(np.float32)
    ref, _ = attn.attention_block(tp, cfg, torch.from_numpy(x), window=win)
    zeros = np.zeros((1, win, 1, 16), np.float32)
    cache, jcache = _kv(zeros, zeros), jattn.KVCache(jnp.asarray(zeros), jnp.asarray(zeros))
    outs = []
    for t in range(s):
        o, cache = attn.attention_block(tp, cfg, torch.from_numpy(x[:, t:t + 1]), cache=cache,
                                        cache_pos=_pos(t), write_slot=_pos(t % win))
        jo, jcache = jattn.attention_block(jp, jcfg, jnp.asarray(x[:, t:t + 1]), cache=jcache,
                                           cache_pos=jnp.asarray(t),
                                           write_slot=jnp.asarray(t % win))
        assert_close(o, jo, what=f"step {t}")
        assert_close(cache.k, jcache.k, what=f"step {t} ring k")
        assert_close(cache.v, jcache.v, what=f"step {t} ring v")
        outs.append(o[:, 0])
    np.testing.assert_allclose(torch.stack(outs, dim=1).numpy(), ref.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Cache interop
# ---------------------------------------------------------------------------

def test_cache_interop_checks_the_layout():
    """Leaves round-trip; a wrong count, layer stack or ring width raises;
    whisper's encoder-decoder cache round-trips too, and a wrong encoder
    length raises."""
    jcfg, cfg = _cfgs("recurrentgemma-9b", {"n_layers": 5, "local_window": 8})
    leaves = _leaves(jget_bundle(jcfg).init_cache(2, 6, jnp.float32))
    cache = interop.lm_cache_from_numpy(cfg, leaves, device="cpu")
    for a, b in zip(interop.lm_cache_to_numpy(cfg, cache), leaves, strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cache leaves"):
        interop.lm_cache_from_numpy(cfg, leaves[:-1], device="cpu")
    ring = dataclasses.replace(cfg, local_window=16)
    with pytest.raises(ValueError, match="cache leaf 4"):
        interop.lm_cache_from_numpy(ring, leaves, device="cpu")
    qcfg = registry.get("qwen3-1.7b").reduced()
    kv = _leaves(jget_bundle(jregistry.get("qwen3-1.7b").reduced()).init_cache(1, 4, jnp.float32))
    with pytest.raises(ValueError, match="cache leaf 0"):
        interop.lm_cache_from_numpy(dataclasses.replace(qcfg, n_layers=3), kv, device="cpu")
    # whisper's EncDecCache (self K, V, then the cross pair) round-trips
    wcfg = registry.get("whisper-tiny").reduced()
    jw = jregistry.get("whisper-tiny").reduced()
    jspecs = jax.tree.flatten(japi.cache_specs(jget_bundle(jw), 2, 6, jnp.float32))[0]
    rng = np.random.default_rng(3)
    wleaves = [rng.normal(size=spec.shape).astype(np.float32) for spec in jspecs]
    wcache = interop.lm_cache_from_numpy(wcfg, wleaves, device="cpu")
    assert tuple(wcache.cross_kv[0].shape) == (wcfg.n_layers, 2, wcfg.encoder_seq,
                                               wcfg.n_heads, wcfg.head_dim)
    for a, b in zip(interop.lm_cache_to_numpy(wcfg, wcache), wleaves, strict=True):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="cache leaf 2"):
        interop.lm_cache_from_numpy(dataclasses.replace(wcfg, encoder_seq=16), wleaves,
                                    device="cpu")
