"""The port's encoder-decoder (whisper-tiny) against the JAX package, on the
CPU.

The reduced configuration (``ArchConfig.reduced()``: 2 + 2 layers, d 256, 4
heads, 32 encoder frames) is initialised by the reference; its parameters
cross with ``interop.lm_params_from_numpy`` and its caches with
``interop.lm_cache_from_numpy``, and the same numpy frames and tokens from a
seed go through both packages:

* ``common.sinusoidal_positions`` at whisper's 1,500 x 384 and smaller;
* ``encode`` (B7 with ``causal=False``: its plain version on the CPU),
  ``decode_train`` and the bundle's ``prefill`` and ``forward``;
* ``init_cache`` (the cross K/V of the encoder's states) and ``decode_step``
  over 8 steps, the logits and every cache leaf at each step, the port
  updating the cache in place;
* the parameter and cache interop, ``cache_specs`` and ``input_specs``, and
  the bundle's ``init_cache``, which raises as the reference's does;
* ``serve.generate`` against the reference's serve loop for the
  encoder-decoder.

The gradients of the loss are in ``tests/test_torch_lm_training.py``.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4), but the positions: they
are held within 1e-6, and sit within one float32 ulp of 1 (6e-8) of the
reference's (the power is rounded as XLA rounds it; torch's and XLA's sin
and cos differ by that ulp).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import get_bundle as jget_bundle
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.core import threefry
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.models import cache_specs, common, encdec, get_bundle

WHISPER = "whisper-tiny"
B, S, STEPS = 2, 16, 8


@pytest.fixture(scope="module")
def whisper():
    """The reduced whisper: both configs, the reference's bundle and params
    (jnp), the port's params, seeded frames and tokens."""
    jcfg, cfg = jregistry.get(WHISPER).reduced(), registry.get(WHISPER).reduced()
    jb = jget_bundle(jcfg)
    jp = jb.init(jax.random.PRNGKey(0))
    tp = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    frames = np.random.default_rng(1).normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, S, B, seed=2)
    return dict(jcfg=jcfg, cfg=cfg, jb=jb, jp=jp, tp=tp, frames=frames, tokens=tokens)


@pytest.mark.parametrize("seq,d", [(1_500, 384), (448, 384), (32, 256), (7, 6)])
def test_sinusoidal_positions_match_reference(seq, d):
    got = common.sinusoidal_positions(seq, d)
    want = np.asarray(jcommon.sinusoidal_positions(seq, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_encode_and_decode_train_match_reference(whisper):
    w = whisper
    jenc = jencdec.encode(w["jp"], w["jcfg"], jnp.asarray(w["frames"]))
    jh = jencdec.decode_train(w["jp"], w["jcfg"], jenc, jnp.asarray(w["tokens"]))
    with torch.no_grad():
        enc = encdec.encode(w["tp"], w["cfg"], torch.from_numpy(w["frames"]))
        h = encdec.decode_train(w["tp"], w["cfg"], enc, torch.from_numpy(w["tokens"]).long())
    assert tuple(enc.shape) == (B, w["cfg"].encoder_seq, w["cfg"].d_model)
    assert_close(enc, jenc, what="encoder states")
    assert_close(h, jh, what="decoder hidden states")
    forward = get_bundle(w["cfg"]).forward(w["tp"], w["tokens"], w["frames"])
    assert forward.grad_fn is None
    assert_close(forward, jh, what="bundle.forward")


def test_prefill_matches_reference(whisper):
    w = whisper
    batch = {"tokens": w["tokens"], "frames": w["frames"]}
    want = w["jb"].prefill(w["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    got = get_bundle(w["cfg"]).prefill(w["tp"], batch)
    assert tuple(got.shape) == (B, 1, w["cfg"].vocab_size)
    assert_close(got, want, what="prefill logits")


def _leaves(tree):
    return [np.asarray(leaf) for leaf in jax.tree.flatten(tree)[0]]


def test_init_cache_and_decode_steps_match_reference(whisper):
    """The cross K/V of the encoder's states, then 8 decode steps against
    the reference's jitted ``decode_step``: logits and every cache leaf per
    step; the port's cache, built by ``init_cache`` and also carried across
    from the reference's, is updated in place."""
    w = whisper
    cfg, jcfg = w["cfg"], w["jcfg"]
    jenc = jencdec.encode(w["jp"], jcfg, jnp.asarray(w["frames"]))
    jcache = jencdec.init_cache(w["jp"], jcfg, jenc, STEPS, jnp.float32)
    with torch.no_grad():
        enc = encdec.encode(w["tp"], cfg, torch.from_numpy(w["frames"]))
    cache = encdec.init_cache(w["tp"], cfg, enc, STEPS, torch.float32)
    assert isinstance(cache, encdec.EncDecCache)
    for i, (g, want) in enumerate(zip(interop.lm_cache_to_numpy(cfg, cache), _leaves(jcache),
                                      strict=True)):
        assert g.shape == want.shape and g.dtype == want.dtype
        assert_close(g, want, what=f"initial cache leaf {i}")
    carried = interop.lm_cache_from_numpy(cfg, _leaves(jcache), device="cpu")
    decode = jax.jit(w["jb"].decode)
    bundle = get_bundle(cfg)
    for t in range(STEPS):
        tok = w["tokens"][:, t:t + 1]
        jlogits, jcache = decode(w["jp"], jcache, jnp.asarray(tok), jnp.asarray(t))
        logits, out = bundle.decode(w["tp"], cache, tok, t if t % 2 else torch.tensor(t))
        assert out is cache
        logits_c, _ = bundle.decode(w["tp"], carried, tok, t)
        assert_close(logits, jlogits, what=f"step {t} logits")
        assert_close(logits_c, jlogits, what=f"step {t} logits, carried cache")
        for i, (g, want) in enumerate(zip(interop.lm_cache_to_numpy(cfg, cache),
                                          _leaves(jcache), strict=True)):
            assert_close(g, want, what=f"step {t} cache leaf {i}")


def test_interop_specs_and_the_bundles_cache(whisper):
    """The encoder and decoder stacks are checked; ``cache_specs`` gives the
    reference's tree; ``input_specs`` carries frames except for a decode
    shape; the bundle's ``init_cache`` raises as the reference's does."""
    w = whisper
    cfg = w["cfg"]
    tree = jax.tree.map(np.asarray, w["jp"])
    for key, changes in (("enc_layers", {"n_encoder_layers": 3}), ("dec_layers", {"n_layers": 3})):
        with pytest.raises(ValueError, match=key):
            interop.lm_params_from_numpy(dataclasses.replace(cfg, **changes), tree, device="cpu")
    bundle = get_bundle(cfg)
    with pytest.raises(NotImplementedError, match="needs params"):
        bundle.init_cache(B, 8, torch.float32, device="cpu")
    got = interop._cache_leaves(cache_specs(bundle, B, 8, torch.bfloat16))
    want = jax.tree.flatten(japi.cache_specs(w["jb"], B, 8, jnp.bfloat16))[0]
    assert [tuple(t.shape) for t in got] == [s.shape for s in want]
    assert all(t.dtype == torch.bfloat16 and t.device.type == "meta" for t in got)
    full = get_bundle(registry.get(WHISPER))
    jfull = jget_bundle(jregistry.get(WHISPER))
    for name in ("train_4k", "decode_32k"):
        specs = full.input_specs(registry.SHAPES[name], torch.bfloat16)
        jspecs = jfull.input_specs(jregistry.SHAPES[name], jnp.bfloat16)
        assert specs.keys() == jspecs.keys()
        for key, spec in specs.items():
            assert tuple(spec.shape) == jspecs[key].shape
            assert str(spec.dtype)[6:] == str(jspecs[key].dtype)
    params = bundle.init(0, device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda t: 0, params)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, tree))
    for (path, t), a in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(tree), strict=True):
        assert tuple(t.shape) == a.shape, jax.tree_util.keystr(path)


def test_generate_gives_the_reference_loops_tokens(whisper):
    """The serve loop on the reference's weights with the CLI's frames
    (PRNGKey(2), bit for bit): the reference's ``repro/launch/serve.py``
    loop's greedy tokens, and its last logits within TOLS."""
    w = whisper
    cfg, jcfg = w["cfg"], w["jcfg"]
    prompts = synthetic.lm_token_stream(cfg.vocab_size, 6, B, seed=1)
    frames = jax.random.normal(jax.random.PRNGKey(2), (B, cfg.encoder_seq, cfg.d_model))
    gen = 5
    jenc = jencdec.encode(w["jp"], jcfg, frames)
    jcache = jencdec.init_cache(w["jp"], jcfg, jenc, 6 + gen, jnp.float32)
    decode = jax.jit(w["jb"].decode)
    for t in range(6):
        jlogits, jcache = decode(w["jp"], jcache, jnp.asarray(prompts[:, t:t + 1]),
                                 jnp.asarray(t))
    want = []
    tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    for t in range(6, 6 + gen):
        want.append(np.asarray(tok))
        jlogits, jcache = decode(w["jp"], jcache, tok, jnp.asarray(t))
        tok = jnp.argmax(jlogits[:, -1:], axis=-1).astype(jnp.int32)
    out = serve.generate(get_bundle(cfg), w["tp"], prompts, gen,
                         threefry.normal(threefry.PRNGKey(2),
                                         (B, cfg.encoder_seq, cfg.d_model)))
    np.testing.assert_array_equal(out.tokens.numpy(), np.concatenate(want, axis=1))
    assert_close(out.logits, jlogits, what="last logits")
    with pytest.raises(ValueError, match="needs frames"):
        serve.generate(get_bundle(cfg), w["tp"], prompts, gen)



def test_float32_frames_against_bf16_parameters(whisper):
    """Float32 frames against bf16 parameters: as in the reference, the
    encoder runs in float32 on the exactly widened weights (held to TOLS),
    and the decoder refuses the float32 states (the reference's scan carry
    would change type)."""
    w = whisper
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), w["jp"])
    tp16 = jax.tree.map(lambda t: t.to(torch.bfloat16), w["tp"])
    jenc = jencdec.encode(jp16, w["jcfg"], jnp.asarray(w["frames"]))
    with torch.no_grad():
        enc = encdec.encode(tp16, w["cfg"], torch.from_numpy(w["frames"]))
    assert jenc.dtype == jnp.float32 and enc.dtype == torch.float32
    assert_close(enc, jenc, what="encoder states, bf16 parameters")
    with pytest.raises(TypeError):
        jencdec.decode_train(jp16, w["jcfg"], jenc, jnp.asarray(w["tokens"]))
    with pytest.raises(TypeError, match="encode torch.bfloat16 frames"):
        encdec.decode_train(tp16, w["cfg"], enc, torch.from_numpy(w["tokens"]).long())
