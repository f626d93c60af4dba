"""repro_torch.core.threefry / initializers / elm_ae.stage1 against jax.random.

Keys and random bits must be bit-exact; floating draws are held to TOLS
(in practice uniform draws are exact and normal draws differ in the last
bit for about one value in a hundred, where XLA's log1p rounds otherwise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import F32, assert_close

from repro.core import daef as jdaef
from repro.core import elm_ae as jelm
from repro.core import initializers as jinit
from repro_torch.core import daef as tdaef
from repro_torch.core import elm_ae as telm
from repro_torch.core import initializers as tinit
from repro_torch.core import threefry

SEEDS = [0, 1, 42, 123456, 2**31 - 1]
SHAPES = [(3,), (4, 5), (28, 27), (2, 3, 4)]


def _jkey(seed):
    return np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_and_split_are_bit_exact(seed):
    key = threefry.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _jkey(seed))
    for num in (1, 2, 5, 7):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), num))
        np.testing.assert_array_equal(threefry.split(key, num).numpy(),
                                      want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_are_bit_exact(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32)
    got = threefry.random_bits(threefry.PRNGKey(seed), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_normal_draws(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    u = threefry.uniform(tk, shape, torch.float32, -0.3, 0.7)
    assert u.dtype == torch.float32 and tuple(u.shape) == shape
    assert_close(u, jax.random.uniform(jk, shape, jnp.float32, -0.3, 0.7))
    z = threefry.normal(tk, shape)
    assert z.dtype == torch.float32
    assert_close(z, jax.random.normal(jk, shape, jnp.float32))


def test_split_keys_of_a_split_key_chain():
    """Keys derived twice over (the fit's layer key, then stage-1's split)."""
    keys = tdaef.layer_keys_from_seed(7, 6)
    jkeys = jdaef.layer_keys_from_seed(7, 6)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    for tk, jk in zip(keys, jkeys):
        np.testing.assert_array_equal(threefry.split(tk).numpy(),
                                      np.asarray(jax.random.split(jk)).astype(np.int64))


@pytest.mark.parametrize("name", ["xavier", "random", "orthogonal"])
@pytest.mark.parametrize("shape", [(5, 3), (3, 5), (28, 27), (15, 18)])
def test_initializers(name, shape):
    jk = jax.random.PRNGKey(3)
    got = tinit.get(name)(threefry.PRNGKey(3), shape)
    want = jinit.get(name)(jk, shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    assert_close(got, want)


@pytest.mark.parametrize("init", ["xavier", "random", "orthogonal"])
@pytest.mark.parametrize("dims", [(15, 18), (24, 27), (4, 8)])
def test_stage1_weights_match(init, dims):
    """W_c1 and b_c1 of every stage-1 projection the creditcard fit draws."""
    cfg_keys = jdaef.layer_keys_from_seed(0, 7)
    tkeys = tdaef.layer_keys_from_seed(0, 7)
    for li in range(2, 6):
        jw, jb = jelm.stage1(cfg_keys[li], *dims, init)
        tw, tb = telm.stage1(tkeys[li], *dims, init, device="cpu")
        assert_close(tw, jw, what=f"W_c1 layer {li}", **F32)
        assert_close(tb, jb, what=f"b_c1 layer {li}", **F32)


def test_unknown_initializer_raises():
    with pytest.raises(KeyError, match="unknown initializer"):
        tinit.get("lecun")


# A fleet's key batch: one call for every tenant, bit for bit the keys and
# draws jax.vmap of the same calls gives (normal draws at TOLS, as above),
# and tenant by tenant the one-key results.  -3 checks the int32 seed's
# key words (no high word, the low word its two's complement).
FLEET_SEEDS = np.array([0, 0, 5, 2**31 - 1, -3], np.int32)


def _fleet_keys():
    jk = jax.vmap(jax.random.PRNGKey)(jnp.asarray(FLEET_SEEDS))
    return jk, threefry.prng_keys(torch.from_numpy(FLEET_SEEDS))


@pytest.mark.parametrize("shape", [(4, 5), (2, 3, 4)])
def test_key_batches_are_bit_exact(shape):
    jk, tk = _fleet_keys()
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for num in (2, 7):
        want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
        got = threefry.split(tk, num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    bits = threefry.random_bits(tk, shape)
    want = jax.vmap(lambda k: jax.random.bits(k, shape, jnp.uint32))(jk)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want).astype(np.int64))
    u = threefry.uniform(tk, shape, torch.float32, -0.3, 0.7)
    want = jax.vmap(lambda k: jax.random.uniform(k, shape, jnp.float32, -0.3, 0.7))(jk)
    np.testing.assert_array_equal(u.numpy(), np.asarray(want))
    z = threefry.normal(tk, shape)
    assert_close(z, jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(jk))
    for i in range(len(FLEET_SEEDS)):
        assert torch.equal(bits[i], threefry.random_bits(tk[i], shape))
        assert torch.equal(u[i], threefry.uniform(tk[i], shape, torch.float32, -0.3, 0.7))
        assert torch.equal(z[i], threefry.normal(tk[i], shape))


def test_fleet_layer_keys_are_bit_exact():
    keys = tdaef.layer_keys_from_seed(torch.from_numpy(FLEET_SEEDS), 7)
    want = jax.vmap(lambda s: jdaef.layer_keys_from_seed(s, 7))(jnp.asarray(FLEET_SEEDS))
    assert tuple(keys.shape) == (len(FLEET_SEEDS), 7, 2)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))
    np.testing.assert_array_equal(keys[2].numpy(), tdaef.layer_keys_from_seed(5, 7).numpy())


@pytest.mark.parametrize("init", ["xavier", "random", "orthogonal"])
@pytest.mark.parametrize("dims", [(15, 18), (5, 3)])
def test_stage1_batched_draws(init, dims):
    """One draw for every tenant of a layer: per tenant bit-identical to
    stage1 of its key, and the reference's jax.vmap(elm_ae.stage1) values
    (xavier bit for bit; normal-based draws at TOLS, see the module
    docstring)."""
    keys = tdaef.layer_keys_from_seed(torch.from_numpy(FLEET_SEEDS), 7)[:, 3]
    jkeys = jax.vmap(lambda s: jdaef.layer_keys_from_seed(s, 7))(jnp.asarray(FLEET_SEEDS))[:, 3]
    w, b = telm.stage1_batched(keys, *dims, init, device="cpu")
    assert tuple(w.shape) == (len(FLEET_SEEDS), *dims) and tuple(b.shape) == (len(FLEET_SEEDS), dims[1])
    jw, jb = jax.vmap(lambda k: jelm.stage1(k, *dims, init))(jkeys)
    if init == "xavier":
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert_close(w, jw, **F32)
    assert_close(b, jb, **F32)
    for i in range(len(FLEET_SEEDS)):
        w1, b1 = telm.stage1(keys[i], *dims, init, device="cpu")
        assert torch.equal(w[i], w1) and torch.equal(b[i], b1)
    w2, _ = telm.stage1_batched(keys, *dims, init, device="cpu")  # a refit reuses the draw
    assert torch.equal(w2, w) and w2 is not w


def test_stage1_defaults_to_the_card(monkeypatch):
    """stage1 and stage1_batched take device=None, the card: with no card
    they raise resolve_device's error, as every entry point does; with
    device="cpu" they give the reference's draw."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = tdaef.layer_keys_from_seed(torch.from_numpy(FLEET_SEEDS), 7)[:, 3]
    with pytest.raises(RuntimeError, match="runs on the CUDA card by default"):
        telm.stage1(keys[0], 5, 3, "xavier")
    with pytest.raises(RuntimeError, match="runs on the CUDA card by default"):
        telm.stage1_batched(keys, 5, 3, "xavier")
    jkey = jax.vmap(lambda s: jdaef.layer_keys_from_seed(s, 7))(jnp.asarray(FLEET_SEEDS))[0, 3]
    w, b = telm.stage1(keys[0], 5, 3, "xavier", device="cpu")
    jw, jb = jelm.stage1(jkey, 5, 3, "xavier")
    assert w.device.type == "cpu" and b.device.type == "cpu"
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert_close(b, jb, **F32)
