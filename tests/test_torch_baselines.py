"""repro_torch's iterative AE baseline, its batches and ``relu`` against
the reference (``repro.baselines.autoencoder``, ``repro.data.pipeline``,
``repro.core.activations``).

* ``relu`` and its derivative at ``TOLS``; it has no inverse, so ROLANN's
  lookup refuses it with the reference's error.
* ``pipeline.batches`` and ``token_batches`` yield the reference's arrays,
  exactly, over axis, seed, epochs and ``drop_remainder``.
* ``init_params`` is bit-identical to the reference's ``jax.random`` draws
  for every AE architecture of the paper's Table 5.
* ``forward`` and ``loss_fn`` at ``TOLS``; a fit of a few epochs on the
  ionosphere replica (203 samples, batch 64) leaves every parameter within
  1e-4 of the leaf's largest entry of the reference's fit (float32 sums in
  other orders, through Adam's steps), its train and test errors at
  ``TOLS``.
* The paper's claim on the port alone (``tests/test_system.py``'s
  ``test_daef_vs_iterative_ae_claims``, fewer epochs): DAEF's F1 within
  0.15 of the AE's.  No timing is asserted here.
"""
import importlib.util
import itertools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32, assert_close, to_np

from repro.baselines import autoencoder as jae
from repro.core import activations as jact
from repro.data import pipeline as jpipe
from repro_torch.baselines import autoencoder as tae
from repro_torch.core import activations as tact
from repro_torch.core import anomaly, daef
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic

IONO_AE = (33, 25, 20, 15, 20, 25, 33)
ROOT = Path(__file__).resolve().parent.parent


def _load(rel: str):
    """A script of the repo (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(f"_{Path(rel).stem}", ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _load("chip_smoke.py")


@pytest.fixture(scope="module")
def iono():
    return synthetic.make_dataset("ionosphere").train_test_split(0)


def test_relu_and_its_derivative():
    z = np.random.default_rng(0).normal(scale=3.0, size=(4, 64)).astype(np.float32)
    z[0, :3] = 0.0
    ta, ja = tact.get("relu"), jact.get("relu")
    assert ta.range == ja.range == (0.0, None)
    assert_close(ta.fn(torch.from_numpy(z)), ja.fn(jnp.asarray(z)))
    assert_close(ta.deriv(torch.from_numpy(z)), ja.deriv(jnp.asarray(z)))
    with pytest.raises(ValueError) as ours:
        tact.get("relu", invertible_required=True)
    with pytest.raises(ValueError) as ref:
        jact.get("relu", invertible_required=True)
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="no inverse"):
        daef.fit(daef.DAEFConfig(layer_sizes=(4, 2, 4), act_hidden="relu"),
                 np.ones((4, 8), np.float32), device="cpu")


@pytest.mark.parametrize("axis,n,bs,seed,epochs,drop", [
    (1, 50, 8, 0, 3, True), (1, 50, 8, 3, 2, False), (0, 37, 5, 7, 2, True),
    (0, 16, 16, 1, 1, False), (1, 9, 4, 2, None, True),
])
def test_batches_are_the_references(axis, n, bs, seed, epochs, drop):
    x = np.random.default_rng(seed).normal(size=(n, 3) if axis == 0 else (3, n))
    kw = dict(axis=axis, seed=seed, epochs=epochs, drop_remainder=drop)
    take = 13 if epochs is None else None
    ours = list(itertools.islice(tpipe.batches(x, bs, **kw), take))
    ref = list(itertools.islice(jpipe.batches(x, bs, **kw), take))
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_token_batches_and_shard_batch():
    def sampler(step):
        return synthetic.lm_token_stream(97, 16, 2, seed=step)

    for a, b in zip(tpipe.token_batches(sampler, 4), jpipe.token_batches(sampler, 4),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # item 12's DAEF part is ported: a one-rank mesh places the batch whole,
    # as the reference's one-device mesh does
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_host_mesh
    from repro_torch.launch import mesh as tmesh

    batch = {"tokens": np.arange(8, dtype=np.int32).reshape(2, 4)}
    got = tpipe.shard_batch(batch, tmesh.make_host_mesh(device="cpu"), ("data", None))
    want = jpipe.shard_batch(batch, make_host_mesh(), P("data", None))
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


@pytest.mark.parametrize("name", sorted(chip_smoke.AE_ARCH))
@pytest.mark.parametrize("seed", [0, 2])
def test_init_params_bit_identical(name, seed):
    sizes = chip_smoke.AE_ARCH[name][0]
    tw, tb = tae.init_params(tae.AEConfig(layer_sizes=sizes, seed=seed))
    jw, jb = jae.init_params(jae.AEConfig(layer_sizes=sizes, seed=seed))
    for t, j in zip(tw + tb, jw + jb, strict=True):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("act", ["logsig", "relu"])
def test_forward_and_loss(act):
    x = np.random.default_rng(1).normal(size=(IONO_AE[0], 40)).astype(np.float32)
    tcfg, jcfg = (m.AEConfig(layer_sizes=IONO_AE, act_hidden=act) for m in (tae, jae))
    tp, jp = tae.init_params(tcfg), jae.init_params(jcfg)
    assert_close(tae.forward(tcfg, tp, torch.from_numpy(x)), jae.forward(jcfg, jp, jnp.asarray(x)))
    assert_close(tae.loss_fn(tcfg, tp, torch.from_numpy(x)), jae.loss_fn(jcfg, jp, jnp.asarray(x)))


def test_fit_matches_the_reference(iono):
    x_train, x_test, _ = iono
    assert x_train.shape == (33, 203)
    tcfg, jcfg = (m.AEConfig(layer_sizes=IONO_AE, epochs=5, batch_size=64) for m in (tae, jae))
    tm, t_wall = tae.fit(tcfg, x_train, device="cpu")
    jm, _ = jae.fit(jcfg, x_train)
    assert t_wall > 0
    for t, j in zip(tm.weights + tm.biases, jm.weights + jm.biases, strict=True):
        j = np.asarray(j)
        assert not t.requires_grad and t.shape == j.shape
        np.testing.assert_allclose(to_np(t), j, rtol=0, atol=1e-4 * np.abs(j).max())
    assert_close(tm.train_errors, jm.train_errors)
    assert_close(tae.reconstruction_error(tcfg, tm, x_test, device="cpu"),
                 jae.reconstruction_error(jcfg, jm, jnp.asarray(x_test)))


def test_batch_indices_index_the_references_batches(iono):
    x_train = iono[0]
    cfg = tae.AEConfig(layer_sizes=IONO_AE, epochs=3, batch_size=64)
    idx = tae.batch_indices(cfg, x_train.shape[1])
    assert idx.shape == (9, 64)  # 3 epochs of 203 // 64 steps
    ref = jpipe.batches(x_train, 64, axis=1, seed=cfg.seed)
    for row in idx:
        np.testing.assert_array_equal(x_train[:, row], next(ref))


def test_config_error_and_device_policy(iono, monkeypatch):
    for m in (tae, jae):
        with pytest.raises(ValueError, match="reconstruct its input"):
            m.AEConfig(layer_sizes=(4, 2, 3))
    cfg = tae.AEConfig(layer_sizes=(33, 8, 33), epochs=1)
    with pytest.raises(ValueError, match="not a card"):
        tae.fit(cfg, iono[0], device="cpu", graph=True)
    model, _ = tae.fit(cfg, iono[0], device="cpu")
    with pytest.raises(ValueError, match="model lies on cpu"):
        tae.reconstruction_error(cfg, model, iono[1], device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="none is present"):
        tae.fit(cfg, iono[0])


def test_daef_vs_iterative_ae_claims(iono):
    """F1 parity of the paper's claim, on the port: DAEF (Table 5's
    ionosphere row) within 0.15 of the iterative AE."""
    x_train, x_test, y_test = iono
    name, lam_h, lam_l, rule = "ionosphere", *chip_smoke.DAEF_ARCH["ionosphere"][1:]
    cfg_d = daef.DAEFConfig(layer_sizes=chip_smoke.DAEF_ARCH[name][0], lam_hidden=lam_h,
                            lam_last=lam_l)
    model_d = daef.fit(cfg_d, x_train, device="cpu")
    errs_d = daef.reconstruction_error(cfg_d, model_d, x_test, device="cpu")
    f1_d = anomaly.evaluate(model_d.train_errors, errs_d, y_test, rule, device="cpu").f1
    cfg_a = tae.AEConfig(layer_sizes=chip_smoke.AE_ARCH[name][0], epochs=20, seed=0)
    model_a, _ = tae.fit(cfg_a, x_train, device="cpu")
    errs_a = tae.reconstruction_error(cfg_a, model_a, x_test, device="cpu")
    f1_a = anomaly.evaluate(model_a.train_errors, errs_a, y_test, rule, device="cpu").f1
    assert f1_d > 0.55, f1_d
    assert f1_d > f1_a - 0.15, (f1_d, f1_a)


def test_table5_architectures_are_the_benchmarks():
    """chip_smoke's copy of the reference benchmark's Table 5 rows (it may not
    import that script, which imports jax) against the script's own."""
    table2 = _load("benchmarks/table2_f1.py")
    assert chip_smoke.DAEF_ARCH == table2.DAEF_ARCH
    assert chip_smoke.AE_ARCH == table2.AE_ARCH
    assert F32 == dict(atol=1e-4, rtol=1e-4)
