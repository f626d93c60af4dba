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


@pytest.mark.parametrize("m,o,n", [(29, 1, 1), (65, 256, 10_007), (513, 256, 2_048),
                                   (513, 3, 2_049), (129, 1, 10**6)])
@pytest.mark.parametrize("sms", [1, 132])
def test_tensor_core_plan_caps_each_accumulator(m, o, n, sms):
    """B1's tensor-core route: slices cover n, none empty.  The kernel caps
    each accumulator at TC_MAX_SLICE samples itself (runs summed on the FP32
    cores), so slices are planned for occupancy only: their count, and the
    workspace, stop growing with n."""
    slices, slice_len = ops.plan_slices_tf32x3(m, n, o, sms)
    assert 1 <= slices <= ops.MAX_GRID_Z
    assert slice_len % ops.TC_STEP == 0
    assert (slices - 1) * slice_len < n <= slices * slice_len
    most = ops.plan_slices_tf32x3(m, 10**12, o, sms)[0]
    assert slices <= most == ops.plan_slices_tf32x3(m, 10**9, o, sms)[0]
    assert most <= -(-ops.TC_BLOCKS_PER_SM * sms // -(-o // ops.TC_OUTPUTS))


@pytest.mark.parametrize("m,o,n,bound", [(513, 256, 10**6, 0), (513, 256, 10**9, 0),
                                         (513, 3, 10**6, 6 * 3 * (513 * 514) * 4),
                                         (65, 1, 10**9, 88 * (65 * 66) * 4)])
def test_tensor_core_scratch_does_not_grow_with_n(m, o, n, bound):
    """B1's tensor-core scratch on a 132-SM card: none at the DAEF head's
    (m, o) for any n (one slice writes G directly), and a fixed number of
    slices' partials where the blocks alone do not fill the card."""
    assert ops.workspace_bytes(1, m, n, o, False, 132) == bound
    assert ops.plan_slices_tf32x3(513, 2_048, 256, 132) == (1, 2_048)
    assert ops.plan_stats(1, 513, 2_048, 256, False, 132) == (True, 1, 2_048, 0)


def test_tensor_core_route_is_one_tenant_large_m_without_accumulators():
    assert ops.tensor_core_route(1, ops.SMALL_M + 1, False)
    assert not ops.tensor_core_route(1, ops.SMALL_M, False)
    assert not ops.tensor_core_route(2, 513, False) and not ops.tensor_core_route(1, 513, True)
    assert ops.plan_slices_tf32x3(513, 2_048, 256, 132) == (1, 2_048)  # the head: direct


def test_fused_chunk_routes_by_shape():
    """B3 and B6 take the slice kernel for ma <= 28 and at most 32 outputs,
    any number of tenants (every hidden layer of the streamed creditcard fit
    and of the chunked fleet fit), the tile kernel otherwise."""
    for k, m_l, m_c1 in ((1, 15, 18), (1, 18, 21), (1, 21, 24), (1, 24, 27), (1, 3, 1),
                         (1, 32, 27), (64, 15, 18), (64, 24, 27), (2, 3, 1)):
        assert ops.fused_slice_route(k, m_l, m_c1)
    for k, m_l, m_c1 in ((1, 33, 27), (1, 24, 28), (1, 40, 50), (64, 33, 27), (2, 40, 50),
                         (0, 15, 18)):
        assert not ops.fused_slice_route(k, m_l, m_c1)


@pytest.mark.parametrize("m,o,slice_route", [(28, 32, True), (29, 32, False), (28, 33, False),
                                             (29, 33, False), (1, 1, True), (19, 15, True)])
def test_stats_slice_route_at_its_boundaries(m, o, slice_route):
    """B4 takes the slice kernel for m <= 28 and o <= 32 (every layer of the
    fleet fit), partial_kernel otherwise; its workspace follows the route
    (packed triangles, a few slices a tenant)."""
    assert ops.stats_slice_route(m, o) == slice_route
    k, n = 3, 10_007
    packed = ops.workspace_bytes(k, m, n, o, False, 132, batched=True)
    slices = (ops.plan_batched_slices(k, n, 132)[0] if slice_route
              else ops.plan_slices(m, n, k * o, 132)[0])
    per = m * (m + 1) // 2 + m if slice_route else m * m + m
    assert packed == 4 * slices * k * o * per


@pytest.mark.parametrize("k,m,o,accumulate,batched,route", [
    (1, 28, 32, False, False, "slice"),    # B1 at the slice route's edge
    (1, 28, 32, True, False, "slice"),     # B2 likewise
    (1, 29, 32, False, False, "tf32x3"),   # B1 past m: the tensor cores
    (1, 29, 32, True, False, "fp32"),      # B2 past m: partial_kernel
    (1, 28, 33, False, False, "fp32"),     # past o
    (1, 28, 33, True, False, "fp32"),
    (1, 29, 33, False, False, "tf32x3"),
    (1, 29, 33, True, False, "fp32"),
    (1, 19, 15, False, False, "slice"),    # the one-shot creditcard fit's first layer
    (1, 28, 29, True, False, "slice"),     # the logistic-output fit's last layer
    (1, 1, 1, True, False, "slice"),
    (1, 513, 256, False, False, "tf32x3"),  # the DAEF head
    # B5 (the ids name the case, not the route)
    pytest.param(64, 28, 29, True, True, "slice", id="64-28-29-True-True-fp32"),
    pytest.param(1, 28, 29, True, True, "slice", id="1-28-29-True-True-fp32"),
    (64, 28, 24, False, True, "slice"),    # B4
    (1, 37, 3, False, True, "tf32x3"),     # B4 with one tenant and m > 28
])
def test_stats_route_at_its_boundaries(k, m, o, accumulate, batched, route):
    """B1 (one tenant) and B2 (one tenant, accumulating) take the slice
    kernel for m <= 28 and o <= 32, as B4 and B5 do; one tenant with m > 28
    and no accumulators keeps the tensor cores.  The workspace follows the route: packed triangles for
    the planned slices on the slice route, full partials otherwise."""
    assert ops.stats_route(k, m, o, accumulate, batched) == route
    n = 32_768
    got = ops.workspace_bytes(k, m, n, o, accumulate, 132, batched)
    if route == "slice":
        plan = ops.plan_batched_slices(k, n, 132) if batched else ops.plan_stats_slices(n, 132)
        assert got == 4 * plan[0] * k * o * (m * (m + 1) // 2 + m)
    else:
        tensor_cores, _, _, ws = ops.plan_stats(k, m, n, o, accumulate, 132)
        assert tensor_cores == (route == "tf32x3")
        assert got == 4 * ws * k * o * (m * m + m)


@pytest.mark.parametrize("m,o,route", [(28, 29, "slice"), (29, 15, "fp32"), (28, 33, "fp32")])
def test_acc_batched_plan_at_the_fleet_shape(m, o, route):
    """B5 at the logistic-output chunked fleet fit's last layer, (m, o) =
    (28, 29), 64 tenants, 1,024-sample chunks, on a 132-SM card: the slice
    kernel on B4's plan, 4 slices of 256 a tenant, its scratch the packed
    partials of the 4 slices' 64 x 29 = 1,856 (tenant, output) pairs,
    4 x 1,856 x (406 + 28) floats; one row or one output more stays on
    partial_kernel."""
    assert ops.stats_route(64, m, o, True, batched=True) == route
    got = ops.workspace_bytes(64, m, 1_024, o, True, 132, batched=True)
    if route == "slice":
        assert ops.plan_batched_slices(64, 1_024, 132) == (4, 256)
        assert got == 4 * (4 * 1_856 * (406 + 28))
    else:
        _, slices, _, ws = ops.plan_stats(64, m, 1_024, o, True, 132)
        assert got == 4 * ws * 64 * o * (m * m + m) and ws == slices


@pytest.mark.parametrize("n", [1, 63, 64, 65, 26_507, 32_768, 255_883, 10**9])
@pytest.mark.parametrize("sms", [1, 132])
def test_one_tenant_stats_plan_covers_the_samples(n, sms):
    """B1's and B2's slices on the slice route: whole 64-sample steps, at
    least STATS_MIN_STEPS of them, no empty slice, at most
    SLICE_BLOCKS_PER_SM blocks an SM (the two the kernel's launch bounds
    keep resident); the count stops growing with n, and so does the
    workspace, even at the route's widest shape."""
    slices, slice_len = ops.plan_stats_slices(n, sms)
    assert slice_len % ops.FUSED_STEP == 0
    assert slice_len >= ops.STATS_MIN_STEPS * ops.FUSED_STEP
    assert (slices - 1) * slice_len < n <= slices * slice_len
    most = ops.SLICE_BLOCKS_PER_SM * sms
    assert 1 <= slices <= most == ops.plan_stats_slices(10**12, sms)[0]
    per_slice = 4 * 32 * (28 * 29 // 2 + 28)
    for accumulate in (False, True):
        assert ops.workspace_bytes(1, 28, n, 32, accumulate, sms) == slices * per_slice
        assert slices * per_slice <= most * per_slice


def test_one_tenant_stats_plans_at_the_creditcard_shapes():
    """On a 132-SM card: each of the one-shot creditcard fit's four B1
    launches (255,883 samples) takes 250 slices of 1,024 samples (16 steps,
    the per-block work of B4 on the fleet) and 10.4 MB of scratch at its
    widest layer; the logistic-output streamed fit's B2 launches at
    (m, o) = (28, 29) take 256 slices of 128 for a 32,768-sample chunk, as
    B3 plans the same chunk, and 208 for the ragged last chunk's 26,507."""
    for m, o in ((19, 15), (22, 18), (25, 21), (28, 24)):
        assert ops.stats_route(1, m, o, False) == "slice"
    assert ops.plan_stats_slices(255_883, 132) == (250, 1_024)
    assert ops.workspace_bytes(1, 28, 255_883, 24, False, 132) == 10_416_000
    assert ops.stats_route(1, 28, 29, True) == "slice"
    assert ops.plan_stats_slices(32_768, 132) == (256, 128) == ops.plan_fused_slices(32_768, 132)
    assert ops.plan_stats_slices(26_507, 132) == (208, 128)
    assert ops.workspace_bytes(1, 28, 32_768, 29, True, 132) == 12_888_064


@pytest.mark.parametrize("n", [1, 63, 926, 1_024, 3_998])
@pytest.mark.parametrize("k", [1, 3, 64])
@pytest.mark.parametrize("sms", [1, 132])
def test_batched_slice_plan_covers_each_chunk(k, n, sms):
    """B4's and B6's slices a tenant: whole 64-sample steps, no empty slice,
    each at least SLICE_MIN_STEPS steps unless the tenant has one slice, and
    no more (tenant, slice) blocks than fill every SM SLICE_BLOCKS_PER_SM
    times (or one slice a tenant).  The fleet's 1,024-sample chunks of 64
    tenants take 4 slices of 256 on a 132-SM card, its one-shot fit's 3,998
    samples 4 slices of 1,024."""
    slices, slice_len = ops.plan_batched_slices(k, n, sms)
    assert slice_len % ops.FUSED_STEP == 0
    assert (slices - 1) * slice_len < n <= slices * slice_len
    assert slices == 1 or slice_len >= ops.SLICE_MIN_STEPS * ops.FUSED_STEP
    assert k * slices <= max(k, ops.SLICE_BLOCKS_PER_SM * sms)
    assert ops.plan_batched_slices(k, 10**9, sms)[0] == max(1, ops.SLICE_BLOCKS_PER_SM * sms // k)
    if (k, sms) == (64, 132):
        want = {1_024: (4, 256), 3_998: (4, 1_024), 926: (3, 320)}
        assert (slices, slice_len) == want.get(n, (slices, slice_len))


@pytest.mark.parametrize("n", [1_024, 3_998, 10**6])
def test_batched_workspace_is_bounded_at_the_fleet_shapes(n):
    """The slice routes' scratch at the fleet's largest layers on a 132-SM
    card, B6 at (m_l, m_c1) = (24, 27) and B4 at (m, o) = (28, 24), 64
    tenants: 4 slices of packed partials, 10.67 MB, at most 264 blocks'
    partials (11.0 MB) for any n."""
    bound = ops.SLICE_BLOCKS_PER_SM * 132 * 24 * (28 * 29 // 2 + 28) * 4
    b6 = ops.fused_workspace_bytes(64, 24, 27, n, 132, batched=True)
    b4 = ops.workspace_bytes(64, 28, n, 24, False, 132, batched=True)
    assert b6 == b4 <= bound == 10_999_296
    if n <= 3_998:
        assert b6 == 4 * 64 * 24 * (28 * 29 // 2 + 28) * 4 == 10_665_984


@pytest.mark.parametrize("n", [1, 63, 64, 65, 26_507, 32_768, 10**6])
@pytest.mark.parametrize("sms", [1, 132])
def test_fused_slice_plan_covers_the_chunk(n, sms):
    """Whole 64-sample steps, no empty slice, about three blocks an SM: the
    streamed fit's 32,768-sample chunks take 256 slices of 128 on a
    132-SM card."""
    slices, slice_len = ops.plan_fused_slices(n, sms)
    assert slice_len % ops.FUSED_STEP == 0
    assert (slices - 1) * slice_len < n <= slices * slice_len
    assert slices <= ops.FUSED_BLOCKS_PER_SM * sms
    if (n, sms) == (32_768, 132):
        assert (slices, slice_len) == (256, 128)


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
    # "auto" on the host: the committed cache's "cpu" verdict
    assert stats_backend.resolve(device="cpu") == "einsum"
    assert stats_backend.resolve("auto", "cpu") == "einsum"
    assert stats_backend.resolve("fused") == "fused"
    monkeypatch.setenv(stats_backend.ENV_VAR, "fused")
    assert stats_backend.resolve() == "fused"
    assert stats_backend.resolve("einsum") == "einsum"  # explicit beats env
    monkeypatch.setenv(stats_backend.ENV_VAR, "pallas")
    with pytest.raises(ValueError, match="unknown stats backend"):
        stats_backend.resolve()
