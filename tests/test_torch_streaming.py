"""repro_torch's streaming fits against repro.core.daef's.

The same numpy data go through ``repro.core.daef.fit_chunked`` /
``fit_stream`` and their ``repro_torch`` counterparts on the CPU.  The
reference runs on its einsum backend (its fused backend interprets Pallas
on the CPU, too slow for tier-1); the port runs both of its backends, the
fused one through the kernels' plain versions.  Models are compared with
``assert_models_match``: ``TOLS`` for weights, biases, singular values and
train errors, sums over samples at 1e-4 × their largest entry, the encoder
as U S² Uᵀ and the last layer at the κ-scaled bound that
tests/test_torch_daef.py states.

Covered: chunk widths that divide n, that do not (a padded, masked tail),
``== n`` and ``> n``; list, one-shot generator and per-pass callable
sources; the reference's errors for bad streams; ``gram_solver``; a float64
fit staying float64; a logistic last layer; the in-place accumulators.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_models_match, lowrank_data

from repro.core import daef as jdaef
from repro_torch.core import daef as tdaef

# test_torch_daef.py's configuration: two hidden decoder layers, so a pass
# runs the chunks through weights solved in the passes before it.  (A
# narrower 7-3-5-6-7 net on 48 samples is no test: its last layer is nearly
# degenerate, max|W| ~ 2e-3, and the reference's own one-shot and chunked
# fits differ there by more than the bar.)
M0, LATENT, N = 10, 4, 240
LAYERS = (M0, LATENT, 6, 8, M0)
BACKENDS = ["einsum", "fused"]


def _kw(**kw):
    return dict(dict(layer_sizes=LAYERS, lam_hidden=0.7, lam_last=0.9), **kw)


@functools.lru_cache(maxsize=None)
def _data(n: int, seed: int, unit: bool = False) -> np.ndarray:
    x = lowrank_data(M0, LATENT, n, seed)
    if unit:  # rescaled into [0, 1] per feature, targets for a logistic output
        lo, hi = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
        x = ((x - lo) / (hi - lo)).astype(np.float32)
    x.flags.writeable = False
    return x


def _chunks(x, width):
    return [x[:, i:i + width] for i in range(0, x.shape[1], width)]


@functools.lru_cache(maxsize=None)
def _reference_chunked(chunk: int, seed: int, unit: bool = False, **kw):
    cfg = jdaef.DAEFConfig(**_kw(stats_backend="einsum", **kw))
    return jdaef.fit_chunked(cfg, jnp.asarray(_data(N, seed, unit)), chunk_samples=chunk)


@pytest.mark.parametrize("chunk", [60, 70, N, N + 10])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_chunked_matches_reference(backend, chunk):
    """Chunk widths that divide n, that do not (ragged tail padded and
    masked), == n and > n."""
    x = _data(N, seed=0)
    tm = tdaef.fit_chunked(tdaef.DAEFConfig(**_kw(stats_backend=backend)), x,
                           chunk_samples=chunk, device="cpu")
    assert tuple(tm.train_errors.shape) == (N,)
    assert_models_match(_reference_chunked(chunk, 0), tm, 0.9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_chunked_equals_the_ports_one_shot_fit(backend):
    x = _data(229, seed=1)
    cfg = tdaef.DAEFConfig(**_kw(stats_backend=backend))
    one_shot = tdaef.fit(cfg, x, device="cpu")
    chunked = tdaef.fit_chunked(cfg, x, chunk_samples=50, device="cpu")
    for got, want in zip(chunked.weights[:-1], one_shot.weights[:-1]):
        assert_close(got, want)
    assert_close(chunked.train_errors, one_shot.train_errors)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_stream_source_kinds(backend):
    """Lists, one-shot generators and per-pass callables all agree with the
    reference; a generator is snapshotted (multi-pass safe)."""
    n = 236
    x = _data(n, seed=2)
    jm = jdaef.fit_stream(jdaef.DAEFConfig(**_kw(stats_backend="einsum")), _chunks(x, 64))
    cfg = tdaef.DAEFConfig(**_kw(stats_backend=backend))
    calls = []

    def as_callable():
        calls.append(1)
        return iter(_chunks(x, 64))

    for src, what in ((_chunks(x, 64), "list"), (iter(_chunks(x, 64)), "generator"),
                      (as_callable, "callable")):
        tm = tdaef.fit_stream(cfg, src, device="cpu")
        assert tuple(tm.train_errors.shape) == (n,), what
        assert_models_match(jm, tm, 0.9)
    # one pass per layer: the encoder, 2 hidden decoder layers, the last
    # layer, then the errors
    assert len(calls) == len(LAYERS)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fit_stream_ragged_tail_and_tensor_chunks(backend):
    """A narrower last chunk (3 x 64 + 37) is padded and masked exactly;
    torch chunks are taken as they are."""
    n = 229
    x = _data(n, seed=3)
    jm = jdaef.fit_stream(jdaef.DAEFConfig(**_kw(stats_backend="einsum")), _chunks(x, 64))
    cfg = tdaef.DAEFConfig(**_kw(stats_backend=backend))
    for src in (_chunks(x, 64), [torch.from_numpy(np.array(c)) for c in _chunks(x, 64)]):
        tm = tdaef.fit_stream(cfg, src, device="cpu")
        assert tuple(tm.train_errors.shape) == (n,)
        assert_models_match(jm, tm, 0.9)


def test_bad_streams_raise_the_reference_errors():
    x = np.array(_data(N, seed=4))
    jcfg, tcfg = jdaef.DAEFConfig(**_kw()), tdaef.DAEFConfig(**_kw())
    bad = {
        "empty chunk stream": lambda d, c: d.fit_stream(c, []),
        "mid-stream": lambda d, c: d.fit_stream(c, [x[:, :16], x[:, 16:24], x[:, 24:40]]),
        "wider final": lambda d, c: d.fit_stream(c, [x[:, :16], x[:, 16:48]]),
        "does not match": lambda d, c: d.fit_stream(c, [x[:3, :16]]),
        "gram": lambda d, c: d.fit_stream(dataclasses.replace(c, method="svd"), [x[:, :16]]),
        "chunk_samples": lambda d, c: d.fit_chunked(c, x, chunk_samples=0),
        "input dim": lambda d, c: d.fit_chunked(c, x[:5], chunk_samples=8),
    }
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match) as jerr:
            call(jdaef, jcfg)
        with pytest.raises(ValueError, match=match) as terr:
            call(_OnCpu, tcfg)
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="gram"):
        tdaef.fit_chunked(dataclasses.replace(tcfg, method="svd"), x, chunk_samples=16,
                          device="cpu")
    with pytest.raises(ValueError, match="chunk_samples"):
        tdaef.fit_chunked(tcfg, x, chunk_samples=2.5, device="cpu")
    with pytest.raises(ValueError, match="no samples"):
        tdaef.fit_chunked(tcfg, x[:, :0], chunk_samples=8, device="cpu")


class _OnCpu:
    """The port's streaming entry points, asked for the CPU."""

    @staticmethod
    def fit_stream(cfg, batches):
        return tdaef.fit_stream(cfg, batches, device="cpu")

    @staticmethod
    def fit_chunked(cfg, x, *, chunk_samples):
        return tdaef.fit_chunked(cfg, x, chunk_samples=chunk_samples, device="cpu")


@pytest.mark.parametrize("solver", ["eigh", "auto"])
def test_gram_solver_threads_through(solver):
    x = _data(N, seed=5)
    jcfg = jdaef.DAEFConfig(**_kw(stats_backend="einsum", gram_solver=solver))
    tcfg = tdaef.DAEFConfig(**_kw(stats_backend="fused", gram_solver=solver))
    jm = jdaef.fit_chunked(jcfg, jnp.asarray(x), chunk_samples=70)
    assert_models_match(jm, tdaef.fit_chunked(tcfg, x, chunk_samples=70, device="cpu"), 0.9)
    assert_models_match(jm, tdaef.fit_stream(tcfg, _chunks(x, 70), device="cpu"), 0.9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_act_last_logsig(backend):
    """A logistic last layer folds per-output statistics (the B2 route on
    the fused backend) against targets in [0, 1].  The rescaled data is not
    centred, so the encoder's S is held as S² (see assert_models_match)."""
    x = _data(N, seed=6, unit=True)
    tm = tdaef.fit_chunked(tdaef.DAEFConfig(**_kw(act_last="logsig", stats_backend=backend)),
                           x, chunk_samples=70, device="cpu")
    assert tuple(tm.layer_knowledge[-1].g.shape) == (M0, LAYERS[-2] + 1, LAYERS[-2] + 1)
    assert_models_match(_reference_chunked(70, 6, True, act_last="logsig"), tm, 0.9,
                        s_as_sum=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_tanh_hidden_layers(backend):
    x = _data(N, seed=7)
    tm = tdaef.fit_chunked(tdaef.DAEFConfig(**_kw(act_hidden="tanh", stats_backend=backend)),
                           x, chunk_samples=70, device="cpu")
    assert_models_match(_reference_chunked(70, 7, act_hidden="tanh"), tm, 0.9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_float64_streamed_fit_stays_float64(backend):
    """float64 tensors in, float64 model out; on the einsum backend the fold
    is float64 throughout and equals the one-shot float64 fit to float64
    rounding amplified by the solves, on the fused backend it is summed in
    float32 (the kernels' contract) and equals the float32 fit."""
    x64 = torch.from_numpy(np.array(_data(N, seed=8))).double()
    cfg = tdaef.DAEFConfig(**_kw(stats_backend=backend))
    m = tdaef.fit_chunked(cfg, x64, chunk_samples=70, device="cpu")
    s = tdaef.fit_stream(cfg, list(x64.split(70, dim=1)), device="cpu")
    for model in (m, s):
        assert all(w.dtype == torch.float64 for w in model.weights)
        assert all(k.g.dtype == torch.float64 for k in model.layer_knowledge)
        assert model.train_errors.dtype == torch.float64
    np.testing.assert_allclose(s.train_errors.numpy(), m.train_errors.numpy(), rtol=1e-9)
    ref = tdaef.fit(cfg, x64, device="cpu").train_errors.numpy()
    if backend == "einsum":
        np.testing.assert_allclose(m.train_errors.numpy(), ref, rtol=1e-9, atol=1e-12)
    else:
        assert_close(m.train_errors, ref)


def test_accumulators_are_updated_in_place(monkeypatch):
    """Each decoder pass folds every chunk into ONE pair of accumulators:
    the statistics the model returns are the tensors init_stats made."""
    from repro_torch.core import rolann

    made = []
    init = rolann.init_stats

    def spy(*args, **kwargs):
        made.append(init(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(rolann, "init_stats", spy)
    cfg = tdaef.DAEFConfig(**_kw(stats_backend="fused"))
    model = tdaef.fit_chunked(cfg, _data(N, seed=9), chunk_samples=70, device="cpu")
    assert len(made) == len(model.layer_knowledge)
    for k, s in zip(model.layer_knowledge, made):
        assert k.g is s.g and k.m is s.m and k.g.any()


def test_chunk_mask_is_shared_per_width_and_count():
    a = tdaef._chunk_mask(16, 16, torch.device("cpu"))
    assert a is tdaef._chunk_mask(16, 16, torch.device("cpu"))
    tail = tdaef._chunk_mask(16, 13, torch.device("cpu"))
    assert tail.tolist() == [1.0] * 13 + [0.0] * 3 and a.dtype == torch.float32
