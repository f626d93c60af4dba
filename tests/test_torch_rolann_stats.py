"""The port's rolann_stats wrapper (plain path on the CPU) and stats backend.

Held against the port's ``rolann_stats_ref``, against the JAX wrapper
``repro.kernels.rolann_stats.rolann_stats`` (its Pallas kernel in interpret
mode on the CPU, as tests/test_kernels.py runs it) and, for float64, against
numpy.  The CUDA kernel itself runs only on the card: see
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_sum_close

from repro.kernels.rolann_stats import rolann_stats as jax_rolann_stats
from repro_torch.core import stats_backend
from repro_torch.kernels.rolann_stats import ops, rolann_stats, rolann_stats_ref

# (m, o, n): the creditcard path's (m, o) at a small n, then ragged and
# degenerate shapes (m above one 32-wide tile, n a multiple of nothing).
SHAPES = [(19, 15, 700), (28, 24, 333), (37, 3, 517), (5, 2, 33), (1, 1, 5),
          (64, 2, 130)]


def _inputs(m, o, n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(m, n)).astype(dtype)
    fsq = rng.uniform(0.05, 1.0, size=(o, n)).astype(dtype)
    fd = rng.normal(size=(o, n)).astype(dtype)
    return xa, fsq, fd


@pytest.mark.parametrize("m,o,n", SHAPES)
def test_plain_path_matches_ref_and_jax_kernel(m, o, n):
    xa, fsq, fd = _inputs(m, o, n, seed=m + o + n)
    before = rolann_stats.launches
    g, mv = rolann_stats(*(torch.from_numpy(a) for a in (xa, fsq, fd)))
    assert rolann_stats.launches == before  # the CPU path launches nothing
    assert g.shape == (o, m, m) and mv.shape == (o, m) and g.dtype == torch.float32
    gr, mr = rolann_stats_ref(*(torch.from_numpy(a) for a in (xa, fsq, fd)))
    assert_sum_close(g, gr)
    assert_sum_close(mv, mr)
    gj, mj = jax_rolann_stats(*(jnp.asarray(a) for a in (xa, fsq, fd)), block_n=128)
    assert_sum_close(g, gj, what="G vs the JAX kernel")
    assert_sum_close(mv, mj, what="M vs the JAX kernel")


@pytest.mark.parametrize("m,o,n", [(4, 2, 0), (0, 3, 10), (3, 0, 10)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_degenerate_shapes_return_zeros(m, o, n, dtype):
    g, mv = rolann_stats(torch.zeros(m, n, dtype=dtype), torch.zeros(o, n, dtype=dtype),
                         torch.zeros(o, n, dtype=dtype))
    assert g.shape == (o, m, m) and mv.shape == (o, m)
    assert g.dtype == dtype and mv.dtype == dtype
    assert not g.any() and not mv.any()


def test_bf16_in_bf16_out():
    """bf16 in, bf16 out, summed in float32: against the float32 reference on
    the same bf16 values, only the final rounding to bf16 differs (half a
    bf16 ulp of the largest entry, 2^-9 relative; 2^-8 allowed)."""
    xa, fsq, fd = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(16, 4, 512, 1))
    g, mv = rolann_stats(xa, fsq, fd)
    assert g.dtype == torch.bfloat16 and mv.dtype == torch.bfloat16
    gr, mr = rolann_stats_ref(xa.float(), fsq.float(), fd.float())
    for got, want in ((g, gr), (mv, mr)):
        np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                                   atol=2.0**-8 * float(want.abs().max()))
    gj, mj = jax_rolann_stats(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                for t in (xa, fsq, fd)), block_n=128)
    assert gj.dtype == jnp.bfloat16
    # Two float32 sums in different orders, each rounded to bf16: one bf16
    # ulp (2^-8 relative) of the largest entry apart at most.
    np.testing.assert_allclose(g.float().numpy(), np.asarray(gj, np.float32), rtol=0,
                               atol=2.0**-7 * float(gr.abs().max()))


def test_float64_contract_against_numpy():
    """float64 in, float64 out, summed in float32 (the reference's contract),
    checked against float64 numpy without switching JAX to 64-bit mode."""
    xa, fsq, fd = _inputs(8, 3, 256, seed=1, dtype=np.float64)
    g, mv = rolann_stats(*(torch.from_numpy(a) for a in (xa, fsq, fd)))
    assert g.dtype == torch.float64 and mv.dtype == torch.float64
    gn = np.einsum("in,on,jn->oij", xa, fsq, xa)
    mn = np.einsum("in,on->oi", xa, fd)
    scale = float(np.abs(gn).max())
    np.testing.assert_allclose(g.numpy(), gn, atol=1e-4 * scale)
    np.testing.assert_allclose(mv.numpy(), mn, atol=1e-4 * scale)
    # float32 accumulation shows: not float64-exact.
    assert np.abs(g.numpy() - gn).max() > 1e-12 * scale


def test_mixed_dtypes_promote():
    xa, fsq, fd = _inputs(6, 2, 64, seed=2)
    g, mv = rolann_stats(torch.from_numpy(xa).double(), torch.from_numpy(fsq),
                         torch.from_numpy(fd).to(torch.bfloat16))
    assert g.dtype == torch.float64 and mv.dtype == torch.float64


def test_wrapper_rejects_what_the_kernel_does_not_take():
    xa, fsq, fd = (torch.from_numpy(a) for a in _inputs(6, 2, 64))
    with pytest.raises(ValueError, match="contiguous"):
        rolann_stats(xa.T.contiguous().T, fsq, fd)
    with pytest.raises(ValueError, match="2-D"):
        rolann_stats(xa[0], fsq, fd)
    with pytest.raises(ValueError, match="expected xa"):
        rolann_stats(xa, fsq[:, :10].contiguous(), fd)
    with pytest.raises(ValueError, match="expected xa"):
        rolann_stats(xa, fsq, fd[:1].contiguous())
    with pytest.raises(TypeError, match="floating"):
        rolann_stats(xa.to(torch.int32), fsq, fd)
    with pytest.raises(TypeError, match="torch.Tensor"):
        rolann_stats(xa.numpy(), fsq, fd)
    with pytest.raises(ValueError, match="is on meta"):
        rolann_stats(xa, fsq.to("meta"), fd)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        rolann_stats(xa.to("meta"), fsq.to("meta"), fd.to("meta"))


@pytest.mark.parametrize("m,o,n", [(19, 15, 255_883), (28, 24, 255_883), (1, 1, 5),
                                   (37, 3, 1023), (4, 2, 64), (300, 200, 10**7)])
@pytest.mark.parametrize("sms", [1, 132])
def test_plan_slices_cover_the_sample_axis(m, o, n, sms):
    slices, slice_len = ops.plan_slices(m, n, o, sms)
    assert 1 <= slices <= ops.MAX_GRID_Z
    assert slice_len % ops.CHUNK == 0
    assert (slices - 1) * slice_len < n <= slices * slice_len  # no empty slice
    if n >= 2 * ops.MIN_SLICE:
        assert slice_len >= ops.MIN_SLICE - ops.CHUNK


def test_plan_fills_the_card_on_the_creditcard_path():
    """The path's largest layer, (m, o) = (28, 24), gets several blocks per SM."""
    slices, _ = ops.plan_slices(28, 255_883, 24, 132)
    assert slices * 24 >= 4 * 132


def test_gram_stats_backends_agree():
    xa, fsq, fd = (torch.from_numpy(a) for a in _inputs(13, 7, 400, seed=4))
    ge, me = stats_backend.gram_stats(xa, fsq, fd, backend="einsum")
    gf, mf = stats_backend.gram_stats(xa, fsq, fd, backend="fused")
    assert_sum_close(gf, ge)
    assert_sum_close(mf, me)


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(stats_backend.ENV_VAR, raising=False)
    assert stats_backend.resolve() == "einsum"  # "auto" has no H100 verdict yet
    assert stats_backend.resolve("auto") == "einsum"
    assert stats_backend.resolve("fused") == "fused"
    monkeypatch.setenv(stats_backend.ENV_VAR, "fused")
    assert stats_backend.resolve() == "fused"
    assert stats_backend.resolve("einsum") == "einsum"  # explicit beats env
    monkeypatch.setenv(stats_backend.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match="unknown stats backend"):
        stats_backend.resolve()
