"""The streaming fit's folding pieces against the reference.

* The B2 and B3 wrappers (plain path on the CPU) and their plain versions,
  against the JAX wrappers ``rolann_stats_acc`` / ``rolann_fused_chunk``
  (Pallas kernels in interpret mode, as tests/test_kernels.py runs them) and
  against the JAX einsum routes, from running accumulators that are not
  zero, with masks that hold zeros.
* The accumulator contract: folds are in place and return the tensors
  passed in, in their own dtype, summed in float32; empty chunks change
  nothing.
* ``rolann.init_stats`` / ``accumulate_stats`` / ``merge_stats``,
  ``dsvd.masked_gram`` and ``elm_ae.accumulate_layer_stats`` /
  ``layer_from_knowledge`` against their JAX counterparts.

Sums over samples are compared at ``assert_sum_close`` (atol 1e-4 × the
leaf's largest entry, rtol 1e-4); everything else at ``TOLS``.  The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close

from repro.core import activations as jact
from repro.core import dsvd as jdsvd
from repro.core import elm_ae as jelm
from repro.core import rolann as jrol
from repro.core import stats_backend as jsb
from repro.kernels.rolann_stats import rolann_fused_chunk as jax_fused_chunk
from repro.kernels.rolann_stats import rolann_stats_acc as jax_stats_acc
from repro_torch.core import activations as tact
from repro_torch.core import daef as tdaef
from repro_torch.core import dsvd as tdsvd
from repro_torch.core import elm_ae as telm
from repro_torch.core import rolann as trol
from repro_torch.core import stats_backend as tsb
from repro_torch.kernels.rolann_stats import (
    rolann_fused_chunk,
    rolann_fused_chunk_plain,
    rolann_stats_acc,
    rolann_stats_acc_plain,
)

T = torch.from_numpy


def _running(o, m, seed, dtype=np.float32):
    """Running accumulators as a fold leaves them: G symmetric."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(o, m, m)) * 10.0
    return ((a + a.transpose(0, 2, 1)) / 2).astype(dtype), rng.normal(size=(o, m)).astype(dtype)


def _acc_inputs(m, o, n, seed):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(0.0, 1.0, size=(m, n)).astype(np.float32)
    fsq = rng.uniform(0.0, 0.25, size=(o, n)).astype(np.float32)
    fd = (fsq * rng.normal(size=(o, n))).astype(np.float32)
    fsq[:, n - n // 4:] = 0.0  # a masked, padded tail
    fd[:, n - n // 4:] = 0.0
    return xa, fsq, fd


def _fused_inputs(m_l, m_c1, n, act, seed):
    rng = np.random.default_rng(seed)
    h = 1.0 / (1.0 + np.exp(-2.0 * rng.normal(size=(m_l, n))))
    if act == "tanh":
        h = 2.0 * h - 1.0
    h[0, :4] = [0.0, 1.0, -1.0, 0.5]  # saturated targets get clipped
    w = rng.normal(size=(m_l, m_c1)) * np.sqrt(2.0 / (m_l + m_c1))
    b = rng.normal(size=(m_c1,))
    mask = (rng.uniform(size=n) >= 0.2).astype(np.float32)
    mask[n - n // 5:] = 0.0
    return tuple(a.astype(np.float32) for a in (h, w, b, mask))


# (m, o, n): a hidden layer of the creditcard path at a small n, and a layer
# wider than one 32-row G tile with n a multiple of nothing.
ACC_SHAPES = [(28, 29, 300), (37, 3, 129)]


@pytest.mark.parametrize("m,o,n", ACC_SHAPES)
def test_stats_acc_matches_jax_kernel_and_ref(m, o, n):
    xa, fsq, fd = _acc_inputs(m, o, n, seed=m + n)
    g0, m0 = _running(o, m, seed=o)
    g, mv = T(g0.copy()), T(m0.copy())
    before = rolann_stats_acc.launches
    out = rolann_stats_acc(g, mv, T(xa), T(fsq), T(fd))
    assert out[0] is g and out[1] is mv
    assert rolann_stats_acc.launches == before  # the CPU path launches nothing
    gj, mj = jax_stats_acc(jnp.asarray(g0), jnp.asarray(m0), jnp.asarray(xa),
                           jnp.asarray(fsq), jnp.asarray(fd), block_n=128, interpret=True)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")
    gr = g0 + np.einsum("in,on,jn->oij", xa, fsq, xa, dtype=np.float64)
    mr = m0 + np.einsum("in,on->oi", xa, fd, dtype=np.float64)
    assert_sum_close(g, gr, what="G vs g + ref")
    assert_sum_close(mv, mr, what="M vs m + ref")


# (m_l, m_c1, n, act): the creditcard path's first hidden layer, and a layer
# whose xa spans two G tiles (m_c1 > 32).
FUSED_SHAPES = [(15, 18, 300, "logsig"), (4, 40, 129, "tanh")]


@pytest.mark.parametrize("m_l,m_c1,n,act", FUSED_SHAPES)
def test_fused_chunk_matches_jax_kernel_and_einsum(m_l, m_c1, n, act):
    h, w, b, mask = _fused_inputs(m_l, m_c1, n, act, seed=m_l + n)
    g0, m0 = _running(m_l, m_c1 + 1, seed=m_c1)
    g, mv = T(g0.copy()), T(m0.copy())
    before = rolann_fused_chunk.launches
    out = rolann_fused_chunk(g, mv, T(h), T(w), T(b), T(mask), act_name=act)
    assert out[0] is g and out[1] is mv
    assert rolann_fused_chunk.launches == before
    args = [jnp.asarray(a) for a in (g0, m0, h, w, b, mask)]
    gj, mj = jax_fused_chunk(*args, act_name=act, block_n=128, interpret=True)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")
    ge, me = jsb.fused_chunk_acc(*args, act=act, backend="einsum")
    assert_sum_close(g, ge, what="G vs the JAX einsum route")
    assert_sum_close(mv, me, what="M vs the JAX einsum route")


def test_fused_chunk_mask_removes_columns_exactly():
    """Masked columns add nothing: the fold of a chunk equals the fold of its
    valid columns alone (the streaming fit's padded tail)."""
    h, w, b, mask = _fused_inputs(6, 9, 200, "logsig", seed=3)
    keep = mask > 0
    ga, ma = T(np.zeros((6, 10, 10), np.float32)), T(np.zeros((6, 10), np.float32))
    gb, mb = ga.clone(), ma.clone()
    rolann_fused_chunk(ga, ma, T(h), T(w), T(b), T(mask), act_name="logsig")
    rolann_fused_chunk(gb, mb, T(h[:, keep].copy()), T(w), T(b), act_name="logsig")
    assert_sum_close(ga, gb)
    assert_sum_close(ma, mb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kernel", ["acc", "fused"])
def test_fold_keeps_the_accumulator_dtype(kernel, dtype):
    """bf16 and float64 accumulators stay in their dtype, in place; the fold
    is summed in float32 (float64 is therefore not float64-exact) and
    rounded once into the accumulator."""
    if kernel == "acc":
        xa, fsq, fd = (T(a) for a in _acc_inputs(12, 5, 256, seed=1))
        g0, m0 = _running(5, 12, seed=1)
        fold = lambda g, mv: rolann_stats_acc(g, mv, xa, fsq, fd)  # noqa: E731
    else:
        h, w, b, mask = (T(a) for a in _fused_inputs(5, 11, 256, "logsig", seed=1))
        g0, m0 = _running(5, 12, seed=1)
        fold = lambda g, mv: rolann_fused_chunk(g, mv, h, w, b, mask, act_name="logsig")  # noqa: E731
    g32, m32 = fold(T(g0.copy()), T(m0.copy()))
    g, mv = T(g0).to(dtype), T(m0).to(dtype)
    out = fold(g, mv)
    assert out[0] is g and out[1] is mv and g.dtype == dtype and mv.dtype == dtype
    if dtype == torch.bfloat16:
        # the running values were rounded to bf16 before the fold too: two
        # bf16 ulps (2^-7 relative) of the largest entry
        for got, want in ((g, g32), (mv, m32)):
            np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                                       atol=2.0**-7 * float(want.abs().max()))
    else:
        np.testing.assert_array_equal(g.numpy(), g32.double().numpy())
        np.testing.assert_array_equal(mv.numpy(), m32.double().numpy())


def test_empty_chunks_change_nothing():
    g0, m0 = _running(3, 5, seed=2)
    g, mv = T(g0.copy()), T(m0.copy())
    out = rolann_stats_acc(g, mv, torch.zeros(5, 0), torch.zeros(3, 0), torch.zeros(3, 0))
    assert out[0] is g and out[1] is mv
    out = rolann_fused_chunk(g, mv, torch.zeros(3, 0), torch.zeros(3, 4), torch.zeros(4),
                             torch.zeros(0), act_name="tanh")
    assert out[0] is g and out[1] is mv
    np.testing.assert_array_equal(g.numpy(), g0)
    np.testing.assert_array_equal(mv.numpy(), m0)
    g, mv = torch.zeros(0, 5, 5), torch.zeros(0, 5)
    assert rolann_stats_acc(g, mv, torch.ones(5, 7), torch.ones(0, 7), torch.ones(0, 7))[0] is g


def test_plain_versions_equal_the_wrappers_on_the_cpu():
    xa, fsq, fd = (T(a) for a in _acc_inputs(9, 4, 100, seed=5))
    g0, m0 = (T(a) for a in _running(4, 9, seed=5))
    a = rolann_stats_acc(g0.clone(), m0.clone(), xa, fsq, fd)
    b = rolann_stats_acc_plain(g0.clone(), m0.clone(), xa, fsq, fd)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    h, w, bias, mask = (T(x) for x in _fused_inputs(4, 8, 100, "tanh", seed=5))
    g0, m0 = (T(x) for x in _running(4, 9, seed=6))
    a = rolann_fused_chunk(g0.clone(), m0.clone(), h, w, bias, mask, act_name="tanh")
    b = rolann_fused_chunk_plain(g0.clone(), m0.clone(), h, w, bias, mask, "tanh")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_fold_wrappers_reject_what_the_kernels_do_not_take():
    xa, fsq, fd = (T(a) for a in _acc_inputs(6, 2, 64, seed=0))
    g, mv = (T(a) for a in _running(2, 6, seed=0))
    with pytest.raises(ValueError, match="expected accumulators"):
        rolann_stats_acc(g[:, :5, :5].contiguous(), mv, xa, fsq, fd)
    with pytest.raises(ValueError, match="contiguous"):
        rolann_stats_acc(g.transpose(1, 2), mv, xa, fsq, fd)
    with pytest.raises(ValueError, match="contiguous"):
        rolann_stats_acc(g, mv, xa.T.contiguous().T, fsq, fd)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rolann_stats_acc(g.to("meta"), mv.to("meta"), xa.to("meta"), fsq.to("meta"),
                         fd.to("meta"))
    h, w, b, mask = (T(a) for a in _fused_inputs(2, 5, 64, "logsig", seed=0))
    with pytest.raises(ValueError, match="act_name"):
        rolann_fused_chunk(g, mv, h, w, b, mask, act_name="linear")
    with pytest.raises(ValueError, match="expected h"):
        rolann_fused_chunk(g, mv, h, w[:1].contiguous(), b, mask, act_name="logsig")
    with pytest.raises(ValueError, match="expected h"):
        rolann_fused_chunk(g, mv, h, w, b, mask[:10].contiguous(), act_name="logsig")
    with pytest.raises(ValueError, match="contiguous"):
        rolann_fused_chunk(g, mv, h[:, ::2], w, b, mask[::2].contiguous(), act_name="logsig")
    with pytest.raises(ValueError, match="expected accumulators"):
        rolann_fused_chunk(g[:1].contiguous(), mv[:1].contiguous(), h, w, b, mask,
                           act_name="logsig")


@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_stats_backend_folds(backend):
    """gram_stats_acc and fused_chunk_acc, both backends, against the JAX
    einsum routes; the linear activation is refused as the reference does."""
    xa, fsq, fd = _acc_inputs(10, 6, 150, seed=7)
    g0, m0 = _running(6, 10, seed=7)
    g, mv = T(g0.copy()), T(m0.copy())
    out = tsb.gram_stats_acc(g, mv, T(xa), T(fsq), T(fd), backend=backend)
    assert out[0] is g and out[1] is mv
    gj, mj = jsb.gram_stats_acc(*(jnp.asarray(a) for a in (g0, m0, xa, fsq, fd)),
                                backend="einsum")
    assert_sum_close(g, gj)
    assert_sum_close(mv, mj)
    h, w, b, mask = _fused_inputs(6, 9, 150, "logsig", seed=7)
    for m_arg in (mask, None):
        g, mv = T(g0.copy()), T(m0.copy())
        tsb.fused_chunk_acc(g, mv, T(h), T(w), T(b), None if m_arg is None else T(m_arg),
                            act=tact.logsig, backend=backend)
        gj, mj = jsb.fused_chunk_acc(*(jnp.asarray(a) for a in (g0, m0, h, w, b)),
                                     None if m_arg is None else jnp.asarray(m_arg),
                                     act=jact.logsig, backend="einsum")
        assert_sum_close(g, gj)
        assert_sum_close(mv, mj)
    with pytest.raises(ValueError) as jerr:
        jsb.fused_chunk_acc(jnp.asarray(g0), jnp.asarray(m0), jnp.asarray(h),
                            jnp.asarray(w), jnp.asarray(b), act="linear")
    with pytest.raises(ValueError) as terr:
        tsb.fused_chunk_acc(T(g0), T(m0), T(h), T(w), T(b), act="linear", backend=backend)
    assert str(terr.value) == str(jerr.value)


def _layer_data(act, m=9, o=6, n=240, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(m, n)).astype(np.float32)
    if act == "logsig":
        d = rng.uniform(0.0, 1.0, size=(o, n))
        d[0, :3] = [0.0, 1.0, 0.5]
    elif act == "tanh":
        d = rng.uniform(-1.0, 1.0, size=(o, n))
    else:
        d = rng.normal(size=(o, n))
    weights = (rng.uniform(size=n) >= 0.25).astype(np.float32)
    return x, d.astype(np.float32), weights


@pytest.mark.parametrize("act", ["logsig", "tanh", "linear"])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_init_accumulate_merge_stats(act, backend):
    """init_stats -> accumulate_stats over two masked chunks -> merge_stats,
    against the reference; the fold is in place."""
    x, d, wts = _layer_data(act, seed=1)
    tstats = trol.init_stats(9, 6, tact.get(act), device="cpu")
    jstats = jrol.init_stats(9, 6, jact.get(act))
    assert tstats.shared_f == jstats.shared_f == (act == "linear")
    assert tuple(tstats.g.shape) == jstats.g.shape and not tstats.g.any()
    g_id = id(tstats.g)
    for sl in (slice(0, 120), slice(120, 240)):
        xs, ds = np.ascontiguousarray(x[:, sl]), np.ascontiguousarray(d[:, sl])
        ws = np.ascontiguousarray(wts[sl])
        out = trol.accumulate_stats(tstats, T(xs), T(ds), tact.get(act), weights=T(ws),
                                    backend=backend)
        assert out is tstats and id(out.g) == g_id
        jstats = jrol.accumulate_stats(jstats, jnp.asarray(xs), jnp.asarray(ds),
                                       jact.get(act), weights=jnp.asarray(ws),
                                       backend="einsum")
    assert_sum_close(tstats.g, jstats.g)
    assert_sum_close(tstats.m, jstats.m)
    tm = trol.merge_stats(tstats, tstats)
    jm = jrol.merge_stats(jstats, jstats)
    assert tm.g is not tstats.g
    assert_sum_close(tm.g, jm.g)
    assert_sum_close(tm.m, jm.m)


def test_accumulated_stats_equal_the_one_shot_stats():
    """Summed over chunks, the fold equals compute_stats of the whole block."""
    x, d, _ = _layer_data("logsig", seed=2)
    stats = trol.init_stats(9, 6, tact.logsig, device="cpu")
    for sl in (slice(0, 100), slice(100, 240)):
        trol.accumulate_stats(stats, T(np.ascontiguousarray(x[:, sl])),
                              T(np.ascontiguousarray(d[:, sl])), tact.logsig)
    whole = trol.compute_stats(T(x), T(d), tact.logsig)
    assert_sum_close(stats.g, whole.g)
    assert_sum_close(stats.m, whole.m)


def test_masked_gram():
    x = np.random.default_rng(3).normal(size=(7, 50)).astype(np.float32)
    mask = (np.arange(50) < 37).astype(np.float32)
    assert_sum_close(tdsvd.masked_gram(T(x)), jdsvd.masked_gram(jnp.asarray(x)))
    got = tdsvd.masked_gram(T(x), T(mask))
    assert_sum_close(got, jdsvd.masked_gram(jnp.asarray(x), jnp.asarray(mask)))
    assert_sum_close(got, tdsvd.gram(T(np.ascontiguousarray(x[:, :37]))))


@pytest.mark.parametrize("act", ["logsig", "tanh"])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_accumulate_layer_stats(act, backend):
    """The ELM-AE chunk fold (one fused_chunk_acc call on the fused backend,
    stage-1 then accumulate_stats on einsum) against the reference's einsum
    route, with the stage-1 draws of a real layer key."""
    key = tdaef.DAEFConfig(layer_sizes=(8, 3, 8)).layer_keys()[2]
    jkey = jnp.asarray(key.numpy().astype(np.uint32))
    w_c1, b_c1 = telm.stage1(key, 8, 11, "xavier")
    jw, jb = jelm.stage1(jkey, 8, 11, "xavier")
    assert_close(w_c1, jw)
    rng = np.random.default_rng(4)
    h = rng.uniform(0.0, 1.0, size=(8, 130)).astype(np.float32)
    if act == "tanh":
        h = 2.0 * h - 1.0
    wts = (np.arange(130) < 100).astype(np.float32)
    stats = trol.init_stats(11, 8, tact.get(act), device="cpu")
    out = telm.accumulate_layer_stats(stats, w_c1, b_c1, T(h), tact.get(act),
                                      weights=T(wts), backend=backend)
    assert out is stats
    jstats = jelm.accumulate_layer_stats(jrol.init_stats(11, 8, jact.get(act)), jw, jb,
                                         jnp.asarray(h), jact.get(act),
                                         weights=jnp.asarray(wts), backend="einsum")
    assert_sum_close(stats.g, jstats.g)
    assert_sum_close(stats.m, jstats.m)


@pytest.mark.parametrize("aux_bias", ["zero", "c1"])
@pytest.mark.parametrize("solver", ["chol", "eigh"])
def test_layer_from_knowledge(aux_bias, solver):
    key = tdaef.DAEFConfig(layer_sizes=(8, 3, 8)).layer_keys()[2]
    jkey = jnp.asarray(key.numpy().astype(np.uint32))
    x, d, _ = _layer_data("logsig", m=11, o=8, seed=5)
    jstats = jrol.compute_stats(jnp.asarray(x), jnp.asarray(d), jact.logsig)
    tstats = trol.RolannStats(g=T(np.array(jstats.g)), m=T(np.array(jstats.m)))
    w, b = telm.layer_from_knowledge(tstats, key, 8, 11, 0.5, tact.logsig,
                                     aux_bias=aux_bias, gram_solver=solver)
    wj, bj = jelm.layer_from_knowledge(jstats, jkey, 8, 11, 0.5, jact.logsig,
                                       aux_bias=aux_bias, gram_solver=solver)
    assert tuple(w.shape) == wj.shape == (8, 11) and tuple(b.shape) == bj.shape == (11,)
    assert_close(w, wj)
    assert_close(b, bj)
    with pytest.raises(ValueError, match="aux_bias"):
        telm.layer_from_knowledge(tstats, key, 8, 11, 0.5, tact.logsig, aux_bias="c2")
