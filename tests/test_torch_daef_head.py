"""The DAEF head on LM hidden states against the JAX package, on the CPU.

First the head alone: the same standardised-feature input goes through the
reference's ``daef_head.fit_head`` and the port's, then ``score`` and
``flag`` on test features; the fitted model is held to
``tests/test_torch_daef.py``'s bars (``assert_models_match``: ``TOLS`` for
the encoder and hidden layers, the per-layer (G, M) as sums, the last
layer's W and b at 10·κ·eps·max|[W; b]|), the statistics and scores to
``TOLS``.  Then the whole slice: a reduced qwen3 backbone (the port's
weights, carried to the reference) -> ``pooled_features`` -> ``fit_head`` -> ``flag``
against the reference's, on "normal" (``lm_token_stream``) and uniform-random
OOD sequences, as ``examples/llm_feature_anomaly.py`` runs it.

Labels: a score within ``TOLS`` of the threshold could fall either way, so
the test first checks that no reference score sits in that band; then the
flags must agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match

from repro.configs import registry as jregistry
from repro.models import daef_head as jhead
from repro.models import transformer as jtransformer
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.models import daef_head, get_bundle

D, N_FIT, N_TEST = 64, 320, 96


def _features(n, seed, shift=0.0):
    """Correlated features [n, D] like pooled hidden states: a low-rank
    signal plus noise, with an offset for the OOD rows."""
    rng = np.random.default_rng(seed)
    mix = np.random.default_rng(99).normal(size=(12, D))
    z = np.tanh(rng.normal(size=(n, 12)) + shift)
    return (z @ mix + 0.2 * rng.normal(size=(n, D)) + 3.0).astype(np.float32)


def _assert_flags_match(th, jh, feats):
    scores, jscores = th.score(feats), jh.score(jnp.asarray(feats))
    assert_close(scores, jscores, what="scores")
    thr = float(jh.threshold)
    band = 1e-4 + 1e-4 * abs(thr)
    assert not np.any(np.abs(np.asarray(jscores) - thr) <= band)
    np.testing.assert_array_equal(th.flag(feats).numpy(), np.asarray(jh.flag(jnp.asarray(feats))))


@pytest.mark.parametrize("d", [2048, 96])
def test_default_config_matches_reference(d):
    """The head's default DAEF config is the reference's, field for field
    (``stats_backend`` None: the environment, then ``auto``, decide)."""
    got, want = daef_head.default_config(d), jhead.default_config(d)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.stats_backend is None


def test_head_matches_reference():
    """The reference's default head against the port's with the fused
    stats backend asked for, as ``chip_smoke.py`` asks for it (on the CPU
    the fused backend runs B1's plain version)."""
    fit = _features(N_FIT, seed=0)
    jh = jhead.fit_head(jnp.asarray(fit))
    fused = dataclasses.replace(daef_head.default_config(D), stats_backend="fused")
    th = daef_head.fit_head(fit, cfg=fused, device="cpu")
    assert th.cfg.layer_sizes == jh.cfg.layer_sizes == (D, D // 8, D // 4, D)
    assert th.cfg.stats_backend == "fused"
    assert_close(th.mean, jh.mean, what="mean")
    assert_close(th.std, jh.std, what="std")
    assert_models_match(jh.model, th.model, jh.cfg.lam_last)
    assert_close(th.threshold, jh.threshold, what="q90 threshold")
    test = np.concatenate([_features(N_TEST, seed=1), _features(N_TEST, seed=2, shift=1.5)])
    _assert_flags_match(th, jh, test)
    assert th.flag(test)[N_TEST:].float().mean() > th.flag(test)[:N_TEST].float().mean()


def test_head_waits_for_the_mesh_and_defaults_to_the_card(monkeypatch):
    """The on-mesh head fit runs (ROADMAP item 12's DAEF part is ported): on
    a one-rank data mesh it matches the reference's on its one-device mesh
    (the reference's call under ``jax.jit``: its eager shard_map compiles op
    by op), flags included; without a card the default device raises."""
    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch import mesh as tmesh

    fit = _features(N_FIT, seed=0)
    th = daef_head.fit_head(fit, mesh=tmesh.make_host_mesh(device="cpu"))
    jmesh = make_host_mesh()

    def head(f):
        h = jhead.fit_head(f, mesh=jmesh)
        return h.model, h.threshold, h.mean, h.std

    jmodel, jthr, jmean, jstd = jax.jit(head)(jnp.asarray(fit))
    assert_models_match(jmodel, th.model, th.cfg.lam_last)
    assert_close(th.threshold, jthr, what="q90 threshold")
    jh = jhead.DAEFHead(cfg=jhead.default_config(D), model=jmodel, mean=jmean, std=jstd,
                        threshold=jthr)
    _assert_flags_match(th, jh, np.concatenate([_features(N_TEST, seed=1),
                                                _features(N_TEST, seed=2, shift=1.5)]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        daef_head.fit_head(fit)


def test_slice_backbone_to_flags_matches_reference():
    """Reduced qwen3 -> pooled features -> DAEF head -> flags, both packages."""
    name, s = "qwen3-1.7b", 16
    jcfg, cfg = jregistry.get(name).reduced(), registry.get(name).reduced()
    tp = get_bundle(cfg).init(0, device="cpu")  # the port's weights, carried to JAX
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    forward = get_bundle(cfg).forward
    normal = synthetic.lm_token_stream(cfg.vocab_size, s, 320, seed=0)
    test = np.concatenate([synthetic.lm_token_stream(cfg.vocab_size, s, 48, seed=7),
                           np.random.default_rng(1).integers(0, cfg.vocab_size, (48, s))])

    def jforward(tokens):
        return jtransformer.forward(jp, jcfg, jnp.asarray(tokens), remat=False)

    feats = daef_head.pooled_features(lambda t: forward(tp, t), normal)
    jfeats = jhead.pooled_features(jforward, normal)
    assert feats.dtype == torch.float32 and tuple(feats.shape) == (320, cfg.d_model)
    assert_close(feats, jfeats, what="pooled features")
    th = daef_head.fit_head(feats, device="cpu")
    jh = jhead.fit_head(jnp.asarray(jfeats))
    assert_close(th.threshold, jh.threshold, what="threshold")
    test_feats = daef_head.pooled_features(lambda t: forward(tp, t), test)
    jtest_feats = jhead.pooled_features(jforward, test)
    assert_close(test_feats, jtest_feats, what="test features")
    assert_close(th.score(test_feats), jh.score(jnp.asarray(jtest_feats)), what="scores")
    thr = float(jh.threshold)
    jscores = np.asarray(jh.score(jnp.asarray(jtest_feats)))
    assert not np.any(np.abs(jscores - thr) <= 1e-4 + 1e-4 * abs(thr))
    np.testing.assert_array_equal(th.flag(test_feats).numpy(),
                                  np.asarray(jh.flag(jnp.asarray(jtest_feats))))


def test_pooled_features_keep_the_backbones_dtype():
    """A bf16 backbone (reduced qwen3, 2 layers) gives bf16-rounded means,
    as the reference's ``np.asarray(h.mean(axis=1))``, returned in float32.
    Both packages run the same bf16 parameters; their hidden states differ
    by the bar of ``test_torch_models.py::test_bf16_hidden_states_match_reference``
    (4·2^-7·max|h| per layer), and a mean of those differences plus one bf16
    rounding of each side's mean (2^-7·|mean|) bounds the features."""
    name, s = "qwen3-1.7b", 32
    jcfg, cfg = jregistry.get(name).reduced(), registry.get(name).reduced()
    tp = jax.tree.map(lambda t: t.to(torch.bfloat16), get_bundle(cfg).init(0, device="cpu"))
    jp = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), tp)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, s, 8, seed=4)
    forward = get_bundle(cfg).forward
    feats = daef_head.pooled_features(lambda t: forward(tp, t), tokens)
    h = forward(tp, tokens)
    jh = jtransformer.forward(jp, jcfg, jnp.asarray(tokens), remat=False)
    jfeats = np.asarray(jhead.pooled_features(lambda t: jh, tokens), dtype=np.float32)
    assert feats.dtype == torch.float32 and feats.grad_fn is None and not feats.is_inference()
    assert torch.equal(feats, h.mean(dim=1).float())  # the mean taken in bf16
    assert torch.equal(feats, feats.bfloat16().float())
    max_h = float(np.abs(np.asarray(jh, dtype=np.float32)).max())
    bar = 4 * 2.0**-7 * max_h * cfg.n_layers + 2.0**-7 * np.abs(jfeats)
    assert np.all(np.abs(feats.numpy() - jfeats) <= bar)
