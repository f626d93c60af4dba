"""The tenant-batched statistics (B4, B5, B6) and the batched ROLANN pieces
against the reference.

* The B4/B5/B6 wrappers (plain path on the CPU) and their plain versions,
  against the JAX wrappers ``rolann_stats_batched`` /
  ``rolann_stats_acc_batched`` / ``rolann_fused_chunk_batched`` (Pallas
  kernels in interpret mode, as tests/test_kernels.py runs them) and the JAX
  einsum routes, at k = 3 with ragged n and masks holding zeros.
* Their contract: float32 sums, the promoted dtype out, in-place
  accumulators returned as passed, no launch at n = 0 or k = 0, and the
  checks that refuse what the kernels do not take.
* ``stats_backend.gram_stats_batched`` / ``gram_stats_acc_batched`` /
  ``fused_chunk_acc_batched`` on both backends; ``rolann`` batched stats
  and ``solve`` with one lambda per tenant; ``elm_ae`` batched layers —
  each against the reference's ``jax.vmap`` of the one-tenant function.

Sums over samples are compared at ``assert_sum_close`` (atol 1e-4 × the
leaf's largest entry, rtol 1e-4); everything else at ``TOLS``.  The CUDA
kernels run only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close

from repro.core import activations as jact
from repro.core import elm_ae as jelm
from repro.core import rolann as jrol
from repro.core import stats_backend as jsb
from repro.kernels.rolann_stats import rolann_fused_chunk_batched as jax_fused_batched
from repro.kernels.rolann_stats import rolann_stats_acc_batched as jax_acc_batched
from repro.kernels.rolann_stats import rolann_stats_batched as jax_stats_batched
from repro_torch.core import activations as tact
from repro_torch.core import daef as tdaef
from repro_torch.core import elm_ae as telm
from repro_torch.core import rolann as trol
from repro_torch.core import stats_backend as tsb
from repro_torch.kernels.rolann_stats import (
    rolann_fused_chunk,
    rolann_fused_chunk_batched,
    rolann_fused_chunk_batched_plain,
    rolann_stats,
    rolann_stats_acc,
    rolann_stats_acc_batched,
    rolann_stats_acc_batched_plain,
    rolann_stats_batched,
    rolann_stats_batched_plain,
)

T = torch.from_numpy
K = 3


def _stats_inputs(k, m, o, n, seed):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(0.0, 1.0, size=(k, m, n)).astype(np.float32)
    fsq = rng.uniform(0.0, 0.25, size=(k, o, n)).astype(np.float32)
    fd = (fsq * rng.normal(size=(k, o, n))).astype(np.float32)
    fsq[:, :, n - n // 4:] = 0.0  # a masked, padded tail
    fd[:, :, n - n // 4:] = 0.0
    return xa, fsq, fd


def _running(k, o, m, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(k, o, m, m)) * 10.0
    g = ((a + np.swapaxes(a, -1, -2)) / 2).astype(np.float32)
    return g, rng.normal(size=(k, o, m)).astype(np.float32)


def _fused_inputs(k, m_l, m_c1, n, act, seed):
    """Every tenant's own chunk, stage-1 encoder and mask (zeros inside and
    a masked tail of a different length per tenant)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(k, m_l, n))))
    if act == "tanh":
        h = 2.0 * h - 1.0
    h[:, 0, :4] = [0.0, 1.0, -1.0, 0.5]  # saturated targets get clipped
    w = rng.normal(size=(k, m_l, m_c1)) * np.sqrt(2.0 / (m_l + m_c1))
    b = rng.normal(size=(k, m_c1))
    mask = (rng.uniform(size=(k, n)) >= 0.2).astype(np.float32)
    for t in range(k):
        mask[t, n - (t + 1) * n // 7:] = 0.0
    return tuple(a.astype(np.float32) for a in (h, w, b, mask))


# (m, o, n): a hidden layer of the creditcard path at a small n, and a layer
# wider than one 32-row G tile with n a multiple of nothing.
STATS_SHAPES = [(28, 29, 300), (37, 3, 129)]


@pytest.mark.parametrize("m,o,n", STATS_SHAPES)
def test_stats_batched_matches_jax_kernel_and_ref(m, o, n):
    xa, fsq, fd = _stats_inputs(K, m, o, n, seed=m + n)
    before = rolann_stats_batched.launches
    g, mv = rolann_stats_batched(T(xa), T(fsq), T(fd))
    assert rolann_stats_batched.launches == before  # the CPU path launches nothing
    assert tuple(g.shape) == (K, o, m, m) and g.dtype == torch.float32
    gj, mj = jax_stats_batched(jnp.asarray(xa), jnp.asarray(fsq), jnp.asarray(fd),
                               block_n=128, interpret=True)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")
    gr = np.einsum("kin,kon,kjn->koij", xa, fsq, xa, dtype=np.float64)
    assert_sum_close(g, gr, what="G vs ref")
    assert_sum_close(mv, np.einsum("kin,kon->koi", xa, fd, dtype=np.float64), what="M vs ref")
    for t in range(K):  # each tenant's slice is B1's result for that tenant
        g1, m1 = rolann_stats(T(xa[t]), T(fsq[t]), T(fd[t]))
        assert_sum_close(g[t], g1)
        assert_sum_close(mv[t], m1)


@pytest.mark.parametrize("m,o,n", STATS_SHAPES)
def test_stats_acc_batched_matches_jax_kernel_and_ref(m, o, n):
    xa, fsq, fd = _stats_inputs(K, m, o, n, seed=m * n)
    g0, m0 = _running(K, o, m, seed=o)
    g, mv = T(g0.copy()), T(m0.copy())
    before = rolann_stats_acc_batched.launches
    out = rolann_stats_acc_batched(g, mv, T(xa), T(fsq), T(fd))
    assert out[0] is g and out[1] is mv
    assert rolann_stats_acc_batched.launches == before
    args = [jnp.asarray(a) for a in (g0, m0, xa, fsq, fd)]
    gj, mj = jax_acc_batched(*args, block_n=128, interpret=True)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")
    for t in range(K):
        g1, m1 = rolann_stats_acc(T(g0[t].copy()), T(m0[t].copy()), T(xa[t]), T(fsq[t]),
                                  T(fd[t]))
        assert_sum_close(g[t], g1)
        assert_sum_close(mv[t], m1)


# (m_l, m_c1, n, act): the creditcard path's first hidden layer, and a layer
# whose xa spans two G tiles (m_c1 > 32).
FUSED_SHAPES = [(15, 18, 300, "logsig"), (4, 40, 129, "tanh")]


@pytest.mark.parametrize("m_l,m_c1,n,act", FUSED_SHAPES)
def test_fused_chunk_batched_matches_jax_kernel_and_einsum(m_l, m_c1, n, act):
    h, w, b, mask = _fused_inputs(K, m_l, m_c1, n, act, seed=m_l + n)
    g0, m0 = _running(K, m_l, m_c1 + 1, seed=m_c1)
    g, mv = T(g0.copy()), T(m0.copy())
    before = rolann_fused_chunk_batched.launches
    out = rolann_fused_chunk_batched(g, mv, T(h), T(w), T(b), T(mask), act_name=act)
    assert out[0] is g and out[1] is mv
    assert rolann_fused_chunk_batched.launches == before
    args = [jnp.asarray(a) for a in (g0, m0, h, w, b, mask)]
    gj, mj = jax_fused_batched(*args, act_name=act, block_n=128, interpret=True)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")
    ge, me = jsb.fused_chunk_acc_batched(*args, act=act, backend="einsum")
    assert_sum_close(g, ge, what="G vs the JAX einsum route")
    assert_sum_close(mv, me, what="M vs the JAX einsum route")
    for t in range(K):  # each tenant folds with its own encoder and mask
        g1, m1 = rolann_fused_chunk(T(g0[t].copy()), T(m0[t].copy()), T(h[t]), T(w[t]),
                                    T(b[t]), T(mask[t]), act_name=act)
        assert_sum_close(g[t], g1)
        assert_sum_close(mv[t], m1)


def test_plain_versions_equal_the_wrappers_on_the_cpu():
    xa, fsq, fd = (T(a) for a in _stats_inputs(2, 9, 4, 100, seed=5))
    a = rolann_stats_batched(xa, fsq, fd)
    b = rolann_stats_batched_plain(xa, fsq, fd)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    g0, m0 = (T(x) for x in _running(2, 4, 9, seed=5))
    a = rolann_stats_acc_batched(g0.clone(), m0.clone(), xa, fsq, fd)
    b = rolann_stats_acc_batched_plain(g0.clone(), m0.clone(), xa, fsq, fd)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h, w, bias, mask = (T(x) for x in _fused_inputs(2, 4, 8, 100, "tanh", seed=5))
    a = rolann_fused_chunk_batched(g0.clone(), m0.clone(), h, w, bias, mask, act_name="tanh")
    b = rolann_fused_chunk_batched_plain(g0.clone(), m0.clone(), h, w, bias, mask, "tanh")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["stats", "acc", "fused"])
def test_batched_dtype_contract(kernel, dtype):
    """B4 returns the promoted input dtype; B5 and B6 keep the accumulators'
    dtype, in place.  All sum in float32 (float64 is therefore not
    float64-exact) and round once into the output: the result is the
    float32 computation on the same values, rounded to the dtype."""
    if kernel == "stats":
        xa, fsq, fd = (T(a).to(dtype) for a in _stats_inputs(2, 12, 5, 256, seed=1))
        got = rolann_stats_batched(xa, fsq, fd)
        want = rolann_stats_batched(xa.float(), fsq.float(), fd.float())
        mixed = rolann_stats_batched(xa, fsq.float(), fd.float())
        assert mixed[0].dtype == torch.promote_types(dtype, torch.float32)
    else:
        g0, m0 = (T(a).to(dtype) for a in _running(2, 5, 12, seed=1))
        if kernel == "acc":
            xa, fsq, fd = (T(a) for a in _stats_inputs(2, 12, 5, 256, seed=1))
            fold = lambda g, mv: rolann_stats_acc_batched(g, mv, xa, fsq, fd)  # noqa: E731
        else:
            h, w, b, mask = (T(a) for a in _fused_inputs(2, 5, 11, 256, "logsig", seed=1))
            fold = lambda g, mv: rolann_fused_chunk_batched(  # noqa: E731
                g, mv, h, w, b, mask, act_name="logsig")
        want = fold(g0.float(), m0.float())
        g, mv = g0.clone(), m0.clone()
        got = fold(g, mv)
        assert got[0] is g and got[1] is mv
    for got_t, want_t in zip(got, want):
        assert got_t.dtype == dtype
        assert torch.equal(got_t, want_t.to(dtype))


def test_empty_batches_change_nothing():
    g, mv = rolann_stats_batched(torch.ones(2, 5, 0), torch.ones(2, 3, 0), torch.ones(2, 3, 0))
    assert tuple(g.shape) == (2, 3, 5, 5) and not g.any() and not mv.any()
    g, mv = rolann_stats_batched(torch.ones(0, 5, 7), torch.ones(0, 3, 7), torch.ones(0, 3, 7))
    assert tuple(g.shape) == (0, 3, 5, 5)
    g0, m0 = (T(a) for a in _running(2, 3, 5, seed=2))
    g, mv = g0.clone(), m0.clone()
    z = torch.zeros(2, 5, 0)
    assert rolann_stats_acc_batched(g, mv, z, z[:, :3], z[:, :3])[0] is g
    out = rolann_fused_chunk_batched(g, mv, torch.zeros(2, 3, 0), torch.zeros(2, 3, 4),
                                     torch.zeros(2, 4), torch.zeros(2, 0), act_name="tanh")
    assert out[0] is g and out[1] is mv
    assert torch.equal(g, g0) and torch.equal(mv, m0)


def test_batched_wrappers_reject_what_the_kernels_do_not_take():
    xa, fsq, fd = (T(a) for a in _stats_inputs(2, 6, 2, 64, seed=0))
    g, mv = (T(a) for a in _running(2, 2, 6, seed=0))
    with pytest.raises(ValueError, match="must be 3-D"):
        rolann_stats_batched(xa[0], fsq[0], fd[0])
    with pytest.raises(ValueError, match=r"expected xa \[k, m, n\]"):
        rolann_stats_batched(xa, fsq[:1].contiguous(), fd[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):  # one tenant's column slice
        rolann_stats_batched(xa[:, :, :32], fsq[:, :, :32], fd[:, :, :32])
    with pytest.raises(ValueError, match="expected accumulators"):
        rolann_stats_acc_batched(g[:1].contiguous(), mv[:1].contiguous(), xa, fsq, fd)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rolann_stats_acc_batched(g.to("meta"), mv.to("meta"), xa.to("meta"),
                                 fsq.to("meta"), fd.to("meta"))
    h, w, b, mask = (T(a) for a in _fused_inputs(2, 2, 5, 64, "logsig", seed=0))
    with pytest.raises(ValueError, match="act_name"):
        rolann_fused_chunk_batched(g, mv, h, w, b, mask, act_name="linear")
    with pytest.raises(ValueError, match=r"expected h \[k, m_l, n\]"):
        rolann_fused_chunk_batched(g, mv, h, w, b[0], mask, act_name="logsig")
    with pytest.raises(ValueError, match="contiguous"):  # a broadcast mask
        rolann_fused_chunk_batched(g, mv, h, w, b, mask[0].expand(2, 64), act_name="logsig")
    with pytest.raises(ValueError, match="expected accumulators"):
        rolann_fused_chunk_batched(g[:, :1].contiguous(), mv[:, :1].contiguous(), h, w, b,
                                   mask, act_name="logsig")


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_batched_stats_backend(backend):
    """The three batched entry points on both backends against the JAX
    einsum routes; a missing mask means all ones."""
    xa, fsq, fd = _stats_inputs(K, 10, 6, 150, seed=7)
    g, mv = tsb.gram_stats_batched(T(xa), T(fsq), T(fd), backend=backend)
    gj, mj = jsb.gram_stats_batched(*(jnp.asarray(a) for a in (xa, fsq, fd)),
                                    backend="einsum")
    assert_sum_close(g, gj)
    assert_sum_close(mv, mj)
    g0, m0 = _running(K, 6, 10, seed=7)
    g, mv = T(g0.copy()), T(m0.copy())
    out = tsb.gram_stats_acc_batched(g, mv, T(xa), T(fsq), T(fd), backend=backend)
    assert out[0] is g and out[1] is mv
    gj, mj = jsb.gram_stats_acc_batched(*(jnp.asarray(a) for a in (g0, m0, xa, fsq, fd)),
                                        backend="einsum")
    assert_sum_close(g, gj)
    assert_sum_close(mv, mj)
    h, w, b, mask = _fused_inputs(K, 6, 9, 150, "logsig", seed=7)
    for m_arg in (mask, None):
        g, mv = T(g0.copy()), T(m0.copy())
        tsb.fused_chunk_acc_batched(g, mv, T(h), T(w), T(b),
                                    None if m_arg is None else T(m_arg),
                                    act=tact.logsig, backend=backend)
        gj, mj = jsb.fused_chunk_acc_batched(
            *(jnp.asarray(a) for a in (g0, m0, h, w, b)),
            None if m_arg is None else jnp.asarray(m_arg), act=jact.logsig, backend="einsum")
        assert_sum_close(g, gj)
        assert_sum_close(mv, mj)


def _layer_data(act, k=K, m=9, o=6, n=240, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(k, m, n)).astype(np.float32)
    if act == "logsig":
        d = rng.uniform(0.0, 1.0, size=(k, o, n))
        d[:, 0, :3] = [0.0, 1.0, 0.5]
    elif act == "tanh":
        d = rng.uniform(-1.0, 1.0, size=(k, o, n))
    else:
        d = rng.normal(size=(k, o, n))
    weights = (rng.uniform(size=(k, n)) >= 0.25).astype(np.float32)
    return x, d.astype(np.float32), weights


LAMS = np.array([0.3, 0.9, 2.0], np.float32)


@pytest.mark.parametrize("act", ["logsig", "tanh", "linear"])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_batched_stats_and_solve(act, backend):
    """compute_stats_batched, accumulate_stats_batched over two masked
    chunks (in place) and solve with one lambda per tenant, against
    jax.vmap of the reference's one-tenant functions."""
    x, d, wts = _layer_data(act, seed=1)
    tact_, jact_ = tact.get(act), jact.get(act)
    got = trol.compute_stats_batched(T(x), T(d), tact_, backend=backend)
    want = jax.vmap(lambda a, b: jrol.compute_stats(a, b, jact_))(jnp.asarray(x), jnp.asarray(d))
    assert tuple(got.g.shape) == want.g.shape
    assert_sum_close(got.g, want.g)
    assert_sum_close(got.m, want.m)
    stats = trol.init_stats(9, 6, tact_, device="cpu", tenants=K)
    g_id = id(stats.g)
    for sl in (slice(0, 120), slice(120, 240)):
        xs, ds, ws = (np.ascontiguousarray(a[..., sl]) for a in (x, d, wts))
        out = trol.accumulate_stats_batched(stats, T(xs), T(ds), tact_, weights=T(ws),
                                            backend=backend)
        assert out is stats and id(out.g) == g_id
    jstats = jax.vmap(lambda a, b, w: jrol.accumulate_stats(
        jrol.init_stats(9, 6, jact_), a, b, jact_, weights=w))(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(wts))
    assert_sum_close(stats.g, jstats.g)
    assert_sum_close(stats.m, jstats.m)
    for solver in ("chol", "eigh", "auto"):
        w, b = trol.solve(got, T(LAMS), gram_solver=solver, shared_f=act == "linear")
        wj, bj = jax.vmap(lambda kn, lam: jrol.solve(kn, lam, gram_solver=solver))(
            want, jnp.asarray(LAMS))
        assert tuple(w.shape) == wj.shape and tuple(b.shape) == bj.shape
        assert_close(w, wj, what=solver)
        assert_close(b, bj, what=solver)
        for t in range(K):  # tenant by tenant, the one-tenant solve
            one = trol.RolannStats(g=got.g[t], m=got.m[t])
            w1, b1 = trol.solve(one, float(LAMS[t]), gram_solver=solver)
            assert_close(w[t], w1)
            assert_close(b[t], b1)


def test_solve_fails_per_tenant():
    """A tenant whose G + lam I is not positive definite gets NaN weights
    from "chol" (the others are untouched); "auto" redoes that tenant by the
    eigh route, as the reference's vmapped lax.cond selects."""
    x, d, _ = _layer_data("logsig", seed=2)
    stats = trol.compute_stats_batched(T(x), T(d), tact.logsig)
    g = stats.g.clone()
    g[1] = -g[1]  # tenant 1: negative definite
    bad = trol.RolannStats(g=g, m=stats.m)
    w, _ = trol.solve(bad, T(LAMS))
    assert torch.isnan(w[1]).all() and torch.isfinite(w[[0, 2]]).all()
    good, _ = trol.solve(stats, T(LAMS))
    assert torch.equal(w[[0, 2]], good[[0, 2]])
    w_auto, _ = trol.solve(bad, T(LAMS), gram_solver="auto")
    w_eigh, _ = trol.solve(bad, T(LAMS), gram_solver="eigh")
    assert torch.equal(w_auto[[0, 2]], good[[0, 2]])
    assert torch.equal(w_auto[1], w_eigh[1])


def _keys(seeds):
    return tdaef.layer_keys_from_seed(torch.tensor(seeds, dtype=torch.int32), 5)[:, 2]


@pytest.mark.parametrize("aux_bias,backend", [("zero", "fused"), ("c1", "einsum")])
def test_batched_layer_training(aux_bias, backend):
    """train_layer_batched, accumulate_layer_stats_batched and
    layer_from_knowledge_batched against jax.vmap of the reference, with one
    key and one lambda per tenant."""
    seeds = [0, 4, 4]
    keys = _keys(seeds)
    jkeys = jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), 5))(
        jnp.asarray(seeds, jnp.int32))[:, 2]
    rng = np.random.default_rng(3)
    h = rng.uniform(0.0, 1.0, size=(K, 8, 130)).astype(np.float32)
    res = telm.train_layer_batched(keys, T(h), 11, T(LAMS), tact.logsig, aux_bias=aux_bias,
                                   backend=backend)
    jres = jax.vmap(lambda key, hl, lam: jelm.train_layer(key, hl, 11, lam, jact.logsig,
                                                          aux_bias=aux_bias))(
        jkeys, jnp.asarray(h), jnp.asarray(LAMS))
    for name in ("w", "b", "h"):
        assert_close(getattr(res, name), getattr(jres, name), what=name)
    assert_sum_close(res.knowledge.g, jres.knowledge.g)
    wts = (np.arange(130) < 100).astype(np.float32)
    w_c1, b_c1 = telm.stage1_batched(keys, 8, 11, "xavier", device="cpu")
    stats = trol.init_stats(11, 8, tact.logsig, device="cpu", tenants=K)
    out = telm.accumulate_layer_stats_batched(stats, w_c1, b_c1, T(h),
                                              tact.logsig, weights=T(np.tile(wts, (K, 1))),
                                              backend=backend)
    assert out is stats
    jw, jb = jax.vmap(lambda key: jelm.stage1(key, 8, 11, "xavier"))(jkeys)
    jstats = jax.vmap(lambda st, a, b, hl: jelm.accumulate_layer_stats(
        st, a, b, hl, jact.logsig, weights=jnp.asarray(wts)))(
        jax.tree.map(lambda leaf: jnp.broadcast_to(leaf, (K, *leaf.shape)),
                     jrol.init_stats(11, 8, jact.logsig)), jw, jb, jnp.asarray(h))
    assert_sum_close(stats.g, jstats.g)
    assert_sum_close(stats.m, jstats.m)
    w, b = telm.layer_from_knowledge_batched(stats, keys, 8, 11, T(LAMS), tact.logsig,
                                             aux_bias=aux_bias)
    wj, bj = jax.vmap(lambda st, key, lam: jelm.layer_from_knowledge(
        st, key, 8, 11, lam, jact.logsig, aux_bias=aux_bias))(jstats, jkeys, jnp.asarray(LAMS))
    assert_close(w, wj)
    assert_close(b, bj)
    with pytest.raises(ValueError, match="aux_bias"):
        telm.layer_from_knowledge_batched(stats, keys, 8, 11, T(LAMS), tact.logsig,
                                          aux_bias="c2")
