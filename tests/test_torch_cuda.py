"""Tests of the port that need the CUDA card (marker ``cuda``).

They skip without a card.  On the card's machine, from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no jax), so it runs where jax is
not installed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import lowrank_data

from repro_torch.configs import registry
from repro_torch.core import activations, daef, fleet, rolann
from repro_torch.data import synthetic
from repro_torch import optim
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_magnitudes,
    flash_attention_bwd_ref,
    flash_attention_ref,
)
from repro_torch.kernels.rglru_scan import (
    rglru_scan,
    rglru_scan_bwd,
    rglru_scan_bwd_plain,
    rglru_scan_ref,
)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_magnitudes
from repro_torch.kernels.ssd_chunk import (
    fit_chunk,
    ssd_chunk,
    ssd_chunk_bwd,
    ssd_chunk_bwd_plain,
    ssd_chunk_plain,
)
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_bwd_magnitudes
from repro_torch.kernels.rolann_stats import (
    ops,
    rolann_fused_chunk,
    rolann_fused_chunk_batched,
    rolann_fused_chunk_batched_plain,
    rolann_fused_chunk_plain,
    rolann_stats,
    rolann_stats_acc,
    rolann_stats_acc_batched,
    rolann_stats_acc_batched_plain,
    rolann_stats_acc_plain,
    rolann_stats_batched,
    rolann_stats_batched_plain,
    rolann_stats_plain,
)
from repro_torch.launch import steps
from repro_torch.models import common, get_bundle

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode (runs in chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, o, n, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    xa = torch.rand((m, n), generator=gen, device=dev)
    fsq = torch.rand((o, n), generator=gen, device=dev) / 16
    fd = fsq * torch.randn((o, n), generator=gen, device=dev)
    return xa.to(dtype), fsq.to(dtype), fd.to(dtype)


@pytest.mark.parametrize("m,o,n", [(19, 15, 10_007), (28, 24, 4_096), (37, 3, 517),
                                   (1, 1, 3), (70, 2, 2_049), (5, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_kernel_matches_plain(card, m, o, n, dtype):
    xa, fsq, fd = _inputs(m, o, n, dtype, m * n + o, card)
    before = rolann_stats.launches
    g, mv = rolann_stats(xa, fsq, fd)
    torch.cuda.synchronize()
    assert rolann_stats.launches == before + 1
    gp, mp = rolann_stats_plain(xa, fsq, fd)
    assert g.dtype == dtype and mv.dtype == dtype
    assert torch.equal(g, g.transpose(1, 2))
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    scale = float(gp.double().abs().max())
    assert float((g.double() - gp.double()).abs().max()) <= tol * scale
    assert float((mv.double() - mp.double()).abs().max()) <= tol * max(scale, 1.0)
    g2, m2 = rolann_stats(xa, fsq, fd)
    assert torch.equal(g, g2) and torch.equal(mv, m2)  # no atomics: same bits


# B1's tensor-core route (one tenant, m > 28): every m, o and n the route's
# tiles, output groups and slices can meet (one 64-row tile and a 1-row
# tail, nine tiles with the head's 513; one output, a partial group of 3,
# 64 full groups; one sample, a partial 32-sample step, the head's 2,048
# that plans one slice, ragged n and several slices).
TC_M, TC_O, TC_N = (29, 64, 65, 129, 513), (1, 3, 256), (1, 7, 2_048, 2_049, 10_007)


def _check_stats_route(m, o, n, dtype, dev, route):
    """B1 on ``route``: one launch counted there, the plain version's bar
    (1e-4 of the largest entry of G and of M, one bf16 ulp for bf16), G
    exactly symmetric, a bit-identical repeat."""
    xa, fsq, fd = _inputs(m, o, n, dtype, m * n + o, dev)
    assert ops.stats_route(1, m, o, False) == route
    before, routed = rolann_stats.launches, rolann_stats.route_launches[route]
    g, mv = rolann_stats(xa, fsq, fd)
    torch.cuda.synchronize()
    assert rolann_stats.launches == before + 1
    assert rolann_stats.route_launches[route] == routed + 1
    gp, mp = rolann_stats_plain(xa, fsq, fd)
    assert g.dtype == dtype and mv.dtype == dtype
    assert torch.equal(g, g.transpose(1, 2))
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    assert float((g.double() - gp.double()).abs().max()) <= tol * float(gp.double().abs().max())
    assert float((mv.double() - mp.double()).abs().max()) <= tol * float(mp.double().abs().max())
    g2, m2 = rolann_stats(xa, fsq, fd)
    assert torch.equal(g, g2) and torch.equal(mv, m2)  # no atomics: same bits


@pytest.mark.parametrize("n", TC_N)
@pytest.mark.parametrize("o", TC_O)
@pytest.mark.parametrize("m", TC_M)
def test_tensor_core_stats_match_plain(card, m, o, n):
    """B1's 3xTF32 route against the plain version in float32: 1e-4 of the
    largest entry of G and of M, G exactly symmetric, repeats bit-identical."""
    _check_stats_route(m, o, n, torch.float32, card, "tf32x3")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float64])
@pytest.mark.parametrize("o", TC_O)
@pytest.mark.parametrize("m", TC_M)
def test_tensor_core_stats_other_dtypes(card, m, o, dtype):
    """The same in bf16 (one bf16 ulp of the largest entry) and float64."""
    _check_stats_route(m, o, TC_N[(m + o) % len(TC_N)], dtype, card, "tf32x3")


def test_tensor_core_route_plans_one_slice_at_the_head_shape(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert ops.plan_slices_tf32x3(513, 2_048, 256, sms) == (1, 2_048)


def test_tensor_core_scratch_is_bounded_at_65536_samples(card):
    """B1 at the head's (m, o) with 65,536 samples: one slice of 32 runs of
    2,048 samples summed in G itself, so the call allocates G and M and no
    workspace (269 MB; slices capped at 2,048 samples took 8.6 GB more);
    within 1e-4 of the largest entry, G exactly symmetric, repeats
    bit-identical."""
    m, o, n = 513, 256, 65_536
    xa, fsq, fd = _inputs(m, o, n, torch.float32, 21, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(card)
    base = torch.cuda.memory_allocated(card)
    before = rolann_stats.route_launches["tf32x3"]
    g, mv = rolann_stats(xa, fsq, fd)
    torch.cuda.synchronize()
    assert rolann_stats.route_launches["tf32x3"] == before + 1
    assert torch.cuda.max_memory_allocated(card) - base <= 4 * o * (m * m + m) + 2**20
    # the plain version over 4,096-sample blocks, summed in float64 (in one
    # call its einsum would hold a 34 GB [o, m, n] intermediate)
    gp = torch.zeros((o, m, m), dtype=torch.float64, device=card)
    mp = torch.zeros((o, m), dtype=torch.float64, device=card)
    for k in range(0, n, 4_096):
        dg, dm = rolann_stats_plain(*(a[:, k:k + 4_096].contiguous() for a in (xa, fsq, fd)))
        gp += dg.double()
        mp += dm.double()
    assert torch.equal(g, g.transpose(1, 2))
    assert float((g.double() - gp.double()).abs().max()) <= 1e-4 * float(gp.double().abs().max())
    assert float((mv.double() - mp.double()).abs().max()) <= 1e-4 * float(mp.double().abs().max())
    g2, m2 = rolann_stats(xa, fsq, fd)
    assert torch.equal(g, g2) and torch.equal(mv, m2)


@pytest.mark.parametrize("m,o,n", [(513, 3, 100_003), (129, 1, 200_003)])
def test_tensor_core_runs_within_a_slice(card, m, o, n):
    """Slices of more than 2,048 samples (few output groups: the workspace
    and the reduce pass) sum their runs in order: the plain version's
    values within 1e-4, G exactly symmetric, repeats bit-identical."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    slices, slice_len = ops.plan_slices_tf32x3(m, n, o, sms)
    assert slices > 1 and slice_len > ops.TC_MAX_SLICE
    _check_stats_route(m, o, n, torch.float32, card, "tf32x3")


# The one-shot creditcard fit's B1 launches: one tenant, 255,883 samples,
# (m, o) of each decoder layer.
CREDITCARD_STATS = ((19, 15), (22, 18), (25, 21), (28, 24))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("m,o", CREDITCARD_STATS)
def test_slice_stats_at_the_creditcard_layers(card, m, o, dtype):
    """B1 at each layer of the one-shot creditcard fit on the slice route
    (rolann_stats_slice.cuh with one tenant, the many-slice reduce writing
    G and M from zero)."""
    _check_stats_route(m, o, 255_883, dtype, card, "slice")


@pytest.mark.parametrize("m,o,n,route", [(28, 32, 5_003, "slice"), (1, 1, 3, "slice"),
                                         (5, 2, 64, "slice"), (28, 33, 5_003, "fp32"),
                                         (29, 32, 5_003, "tf32x3")])
def test_stats_routes_by_shape(card, m, o, n, route):
    """B1 takes the slice kernel for m <= 28 and o <= 32 (four outputs a
    warp at o = 32; one step, one sample), partial_kernel past o, the
    tensor cores past m; each holds the plain version's bar."""
    _check_stats_route(m, o, n, torch.float32, card, route)


def test_kernel_rejects_non_contiguous(card):
    xa, fsq, fd = _inputs(8, 2, 100, torch.float32, 0, card)
    with pytest.raises(ValueError, match="contiguous"):
        rolann_stats(xa.T.contiguous().T, fsq, fd)


def test_plan_uses_this_card(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    slices, slice_len = ops.plan_slices(28, 255_883, 24, sms)
    assert slices * slice_len >= 255_883 and slices * 24 >= 4 * sms


@pytest.mark.parametrize("backend", ["fused", "einsum"])
def test_fit_on_card_matches_host(card, backend):
    cfg = daef.DAEFConfig(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9,
                          stats_backend=backend)
    x = lowrank_data(10, 4, 5_000, seed=0)
    x_test = lowrank_data(10, 4, 1_000, seed=1)
    before = rolann_stats.launches
    m_card = daef.fit(cfg, x, n_partitions=4)
    assert rolann_stats.launches - before == (2 if backend == "fused" else 0)
    m_host = daef.fit(cfg, x, n_partitions=4, device="cpu")
    s_card = daef.reconstruction_error(cfg, m_card, x_test).cpu().numpy()
    s_host = daef.reconstruction_error(cfg, m_host, x_test, device="cpu").numpy()
    # Card and host sum in other float32 orders, and the solves amplify that
    # by their condition number (10^3-10^4 here, with G growing with n
    # against a fixed lam): chip_smoke.py's bar, not TOLS.
    np.testing.assert_allclose(s_card, s_host, rtol=1e-3, atol=1e-5 * np.abs(s_host).max())


def _assert_factors_close(card_f, host_f):
    """Factor knowledge from the card against the host's: the rank, U S² Uᵀ,
    S and M within 1e-4 of the leaf's largest entry (float32 sums in other
    orders; U itself is free in sign and within near-equal singular
    values, so it is compared as U S² Uᵀ)."""
    assert [tuple(a.shape) for a in card_f] == [tuple(a.shape) for a in host_f]
    pairs = ((rolann.factors_to_stats(card_f).g, rolann.factors_to_stats(host_f).g),
             (card_f.s, host_f.s), (card_f.m, host_f.m))
    for got, want in pairs:
        want = want.double()
        err = float((got.double().cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), err


def test_stats_to_factors_on_card_is_float64_rounded(card):
    """``rolann.stats_to_factors`` of float32 Grams on the card (per-output
    [o, m, m] hidden-layer Grams, condition numbers up to 1e10 as the
    creditcard fit's) is float64's eigh rounded to float32: S² within 4 eps
    of the largest eigenvalue, G rebuilt to 3e-7 of max|G| and the smallest
    eigenvalue within 1e-5 of float64's (float64 rounded: 1.1e-7 and
    1.2e-7; LAPACK's float32 eigh: 4.5e-7 and 5.2e-5; cuSOLVER's float32
    eigh rebuilt the fit's Grams to 3.4e-6–6.9e-6)."""
    rng = np.random.default_rng(3)
    h = rng.normal(size=(21, 25, 4_000)) * np.logspace(0, -5, 25)[None, :, None]
    g = torch.from_numpy(np.einsum("kin,kjn->kij", h, h)).float()
    e64 = torch.linalg.eigvalsh(g.double()).flip(-1)
    f = rolann.stats_to_factors(rolann.RolannStats(g=g.to(card), m=torch.zeros(21, 25,
                                                                                device=card)))
    assert f.u.dtype == f.s.dtype == torch.float32 and f.u.device.type == "cuda"
    u, e = f.u.double().cpu(), f.s.double().cpu() ** 2
    top = e64[:, :1].abs()
    assert float(((e - e64).abs() / top).max()) <= 4 * 2.0**-23
    rebuilt = (u * e[:, None, :]) @ u.transpose(-1, -2)
    assert float((rebuilt - g.double()).abs().max() / g.abs().max()) <= 3e-7
    assert float(((e[:, -1] - e64[:, -1]).abs() / e64[:, -1].abs()).max()) <= 1e-5


def test_svd_fit_and_merge_on_card_match_host(card):
    """The svd method on the card (QRs and SVDs by cuSOLVER, no kernel of
    the port) against the host: rolann's factors and their merge on the
    same inputs; a 4-partition svd fit (its first decoder layer's factors,
    whose inputs differ only by the encoder's rounding, and its scores) and
    the merge of two halves' fits (the encoder's U S² Uᵀ, the scores).
    Scores at test_fit_on_card_matches_host's bar."""
    h = torch.sigmoid(2 * torch.from_numpy(lowrank_data(6, 3, 5_000, seed=2)))
    got = [rolann.compute_factors(p.to(card), p[:4].to(card), activations.logsig)
           for p in (h[:, :2_500], h[:, 2_500:])]
    want = [rolann.compute_factors(p, p[:4], activations.logsig)
            for p in (h[:, :2_500], h[:, 2_500:])]
    for g, w in zip(got, want):
        _assert_factors_close(g, w)
    _assert_factors_close(rolann.merge_factors(*got), rolann.merge_factors(*want))
    _assert_factors_close(rolann.merge_factors_list(got), rolann.merge_factors_list(want))

    cfg = daef.DAEFConfig(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9,
                          method="svd", stats_backend="fused")
    x = lowrank_data(10, 4, 5_000, seed=0)
    x_test = lowrank_data(10, 4, 1_000, seed=1)
    before = rolann_stats.launches
    m_card = daef.fit(cfg, x, n_partitions=4)
    assert rolann_stats.launches == before  # the svd method folds no Gram
    m_host = daef.fit(cfg, x, n_partitions=4, device="cpu")
    _assert_factors_close(m_card.layer_knowledge[0], m_host.layer_knowledge[0])
    halves = [(daef.fit(cfg, x[:, :2_500]), daef.fit(cfg, x[:, 2_500:])),
              (daef.fit(cfg, x[:, :2_500], device="cpu"),
               daef.fit(cfg, x[:, 2_500:], device="cpu"))]
    merged = [daef.merge_models(cfg, a, b) for a, b in halves]
    enc = [(f.u * f.s**2).double().cpu() @ f.u.double().cpu().T
           for f in (m.encoder_factors for m in merged)]
    assert float((enc[0] - enc[1]).abs().max()) <= 1e-4 * float(enc[1].abs().max())
    for on_card, on_host in ((m_card, m_host), tuple(merged)):
        s_card = daef.reconstruction_error(cfg, on_card, x_test).cpu().numpy()
        s_host = daef.reconstruction_error(cfg, on_host, x_test, device="cpu").numpy()
        np.testing.assert_allclose(s_card, s_host, rtol=1e-3, atol=1e-5 * np.abs(s_host).max())


def _running(o, m, dtype, dev):
    gen = torch.Generator(device=dev).manual_seed(o * m)
    a = torch.randn((o, m, m), generator=gen, device=dev) * 50
    return ((a + a.transpose(1, 2)) / 2).to(dtype), torch.randn((o, m), generator=gen,
                                                               device=dev).to(dtype)


def _check_fold(fold, plain, g0, m0, wrapper):
    """The kernel's fold against the plain fold from the same accumulators:
    in place, one launch, G exactly symmetric, 1e-4 of the largest entry
    (one bf16 ulp for bf16), the same bits on a repeat."""
    g, mv = g0.clone(), m0.clone()
    before = wrapper.launches
    out = fold(g, mv)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert out[0] is g and out[1] is mv and g.dtype == g0.dtype
    assert torch.equal(g, g.transpose(-1, -2))
    gp, mp = plain(g0.clone(), m0.clone())
    tol = 2.0**-7 if g0.dtype == torch.bfloat16 else 1e-4
    scale = max(float(gp.double().abs().max()), float(mp.double().abs().max()))
    assert float((g.double() - gp.double()).abs().max()) <= tol * scale
    assert float((mv.double() - mp.double()).abs().max()) <= tol * scale
    g2, m2 = g0.clone(), m0.clone()
    fold(g2, m2)
    assert torch.equal(g, g2) and torch.equal(mv, m2)


@pytest.mark.parametrize("m,o,n", [(28, 29, 32_768), (19, 15, 5_003), (37, 3, 517),
                                   (70, 2, 2_049)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_acc_kernel_matches_plain(card, m, o, n, dtype):
    xa, fsq, fd = _inputs(m, o, n, torch.float32, m * n + o, card)
    fsq[:, n - n // 5:] = 0  # a masked tail
    fd[:, n - n // 5:] = 0
    g0, m0 = _running(o, m, dtype, card)
    _check_fold(lambda g, mv: rolann_stats_acc(g, mv, xa, fsq, fd),
                lambda g, mv: rolann_stats_acc_plain(g, mv, xa, fsq, fd), g0, m0,
                rolann_stats_acc)


@pytest.mark.parametrize("n,masked", [(32_768, False), (26_507, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_slice_acc_at_the_logistic_output_layer(card, n, masked, dtype):
    """B2 at the logistic-output streamed fit's last layer, (m, o) =
    (28, 29), four outputs a warp, on a full 32,768-sample chunk and on the
    ragged 26,507 with a masked tail: on the slice route (the many-slice
    reduce adding into the running values), in place, the plain fold's
    bar, G exactly symmetric, a bit-identical repeat."""
    m, o = 28, 29
    xa, fsq, fd = _inputs(m, o, n, torch.float32, n + o, card)
    if masked:
        fsq[:, n - n // 5:] = 0
        fd[:, n - n // 5:] = 0
    assert ops.stats_route(1, m, o, True) == "slice"
    g0, m0 = _running(o, m, dtype, card)
    before = rolann_stats_acc.route_launches["slice"]
    _check_fold(lambda g, mv: rolann_stats_acc(g, mv, xa, fsq, fd),
                lambda g, mv: rolann_stats_acc_plain(g, mv, xa, fsq, fd), g0, m0,
                rolann_stats_acc)
    assert rolann_stats_acc.route_launches["slice"] == before + 2


@pytest.mark.parametrize("m_l,m_c1,n,act", [(15, 18, 32_768, "logsig"),
                                            (24, 27, 26_507, "tanh"),
                                            (40, 50, 3_001, "logsig"),
                                            (3, 1, 65, "tanh")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_fused_chunk_kernel_matches_plain(card, m_l, m_c1, n, act, dtype):
    gen = torch.Generator(device=card).manual_seed(m_l * n)
    h = torch.sigmoid(2 * torch.randn((m_l, n), generator=gen, device=card))
    if act == "tanh":
        h = 2 * h - 1
    w = torch.randn((m_l, m_c1), generator=gen, device=card) * (2 / (m_l + m_c1)) ** 0.5
    b = torch.randn((m_c1,), generator=gen, device=card)
    mask = (torch.rand((n,), generator=gen, device=card) > 0.1).float()
    mask[n - n // 5:] = 0
    g0, m0 = _running(m_l, m_c1 + 1, dtype, card)
    _check_fold(lambda g, mv: rolann_fused_chunk(g, mv, h, w, b, mask, act_name=act),
                lambda g, mv: rolann_fused_chunk_plain(g, mv, h, w, b, mask, act), g0, m0,
                rolann_fused_chunk)


@pytest.mark.parametrize("m_l,m_c1,n,act", [(15, 18, 32_768, "logsig"),
                                            (24, 27, 26_507, "logsig"),
                                            (24, 27, 26_507, "tanh"),
                                            (32, 27, 1_000, "tanh"),
                                            (7, 3, 100_003, "logsig"),
                                            (5, 6, 300_001, "tanh"),
                                            (33, 27, 1_000, "logsig"),
                                            (40, 50, 3_001, "logsig")])
def test_fused_chunk_routes_by_shape(card, m_l, m_c1, n, act):
    """B3 takes the slice kernel (a block per sample slice, the activations
    formed once) for ma <= 28 and m_l <= 32, every hidden layer of the
    streamed creditcard fit, and fused_partial_kernel for the rest; both
    hold the plain version's bar, G exactly symmetric, repeats
    bit-identical.  100,003 and 300,001 samples give slices of several
    64-sample steps."""
    gen = torch.Generator(device=card).manual_seed(m_l * n + 1)
    h = torch.sigmoid(2 * torch.randn((m_l, n), generator=gen, device=card))
    if act == "tanh":
        h = 2 * h - 1
    w = torch.randn((m_l, m_c1), generator=gen, device=card) * (2 / (m_l + m_c1)) ** 0.5
    b = torch.randn((m_c1,), generator=gen, device=card)
    mask = torch.ones((n,), device=card)
    mask[n - n // 7:] = 0
    g0, m0 = _running(m_l, m_c1 + 1, torch.float32, card)
    route = "slice" if ops.fused_slice_route(1, m_l, m_c1) else "tile"
    assert route == ("slice" if m_l <= 32 and m_c1 < 28 else "tile")
    before = rolann_fused_chunk.route_launches[route]
    _check_fold(lambda g, mv: rolann_fused_chunk(g, mv, h, w, b, mask, act_name=act),
                lambda g, mv: rolann_fused_chunk_plain(g, mv, h, w, b, mask, act), g0, m0,
                rolann_fused_chunk)
    assert rolann_fused_chunk.route_launches[route] == before + 2


def test_fused_chunk_fold_moves_the_accumulators_version(card):
    """B3 folds into float32 accumulators through a raw pointer; its wrapper
    bumps their versions as the plain version's in-place additions do, so
    autograd and ``analysis.donation.probe`` see the card's fold in place."""
    from repro_torch.analysis import donation

    gen = torch.Generator(device=card).manual_seed(3)
    m_l, m_c1, n = 15, 18, 4_096
    h = torch.sigmoid(torch.randn((m_l, n), generator=gen, device=card))
    w = torch.randn((m_l, m_c1), generator=gen, device=card) * 0.3
    b = torch.randn((m_c1,), generator=gen, device=card)
    mask = torch.ones((n,), device=card)
    g, mv = _running(m_l, m_c1 + 1, torch.float32, card)
    versions = (g._version, mv._version)
    before = rolann_fused_chunk.launches
    got = rolann_fused_chunk(g, mv, h, w, b, mask, act_name="logsig")
    torch.cuda.synchronize()
    assert rolann_fused_chunk.launches == before + 1
    assert got[0] is g and got[1] is mv
    assert g._version > versions[0] and mv._version > versions[1]
    report = donation.probe(lambda g, mv: rolann_fused_chunk(g, mv, h, w, b, mask,
                                                             act_name="logsig"),
                            g, mv, donate_argnums=(0, 1))
    assert report.ok is True and report.kinds == ("in-place", "in-place")


def test_empty_chunk_folds_launch_nothing(card):
    g0, m0 = _running(2, 4, torch.float32, card)
    g, mv = g0.clone(), m0.clone()
    before = (rolann_stats_acc.launches, rolann_fused_chunk.launches)
    z = torch.zeros((4, 0), device=card)
    rolann_stats_acc(g, mv, z, z[:2], z[:2])
    rolann_fused_chunk(g, mv, z[:2], torch.zeros((2, 3), device=card),
                       torch.zeros(3, device=card), torch.zeros(0, device=card),
                       act_name="logsig")
    assert (rolann_stats_acc.launches, rolann_fused_chunk.launches) == before
    assert torch.equal(g, g0) and torch.equal(mv, m0)


@pytest.mark.parametrize("act_last", ["linear", "logsig"])
def test_streamed_fit_on_card_matches_host(card, act_last):
    """fit_chunked and fit_stream on the card, fused backend: B3 for every
    hidden layer chunk (and B2 for a logistic last layer), against the same
    fits on the host.  The bar is test_fit_on_card_matches_host's."""
    cfg = daef.DAEFConfig(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9,
                          act_last=act_last, stats_backend="fused")
    x = lowrank_data(10, 4, 5_000, seed=2)
    x_test = lowrank_data(10, 4, 1_000, seed=3)
    if act_last == "logsig":
        lo, hi = x.min(axis=1, keepdims=True), x.max(axis=1, keepdims=True)
        x, x_test = (x - lo) / (hi - lo), (x_test - lo) / (hi - lo)
    chunks = [x[:, i:i + 1_024] for i in range(0, 5_000, 1_024)]  # 4 x 1024 + 904
    before = (rolann_fused_chunk.launches, rolann_stats_acc.launches)
    m_card = daef.fit_chunked(cfg, x, chunk_samples=1_024)
    s_card = daef.fit_stream(cfg, chunks)
    launched = (rolann_fused_chunk.launches - before[0], rolann_stats_acc.launches - before[1])
    assert launched == (2 * 2 * 5, (2 * 5 if act_last == "logsig" else 0))
    m_host = daef.fit_chunked(cfg, x, chunk_samples=1_024, device="cpu")
    want = daef.reconstruction_error(cfg, m_host, x_test, device="cpu").numpy()
    for model in (m_card, s_card):
        got = daef.reconstruction_error(cfg, model, x_test).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5 * np.abs(want).max())


# ---- the tenant-batched kernels (B4, B5, B6) and the fleet ----

def _batched(k, fn):
    parts = [fn(t) for t in range(k)]
    return tuple(torch.stack(p).contiguous() for p in zip(*parts))


def _running_batch(k, o, m, dtype, dev):
    """k tenants' running accumulators, each G exactly symmetric."""
    gen = torch.Generator(device=dev).manual_seed(k * o * m)
    a = torch.randn((k, o, m, m), generator=gen, device=dev) * 50
    g = ((a + a.transpose(-1, -2)) / 2).to(dtype)
    return g, torch.randn((k, o, m), generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("k,m,o,n", [(64, 19, 15, 3_998), (64, 28, 24, 3_998), (3, 37, 3, 517),
                                     (1, 5, 2, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_batched_kernel_matches_plain(card, k, m, o, n, dtype):
    xa, fsq, fd = _batched(k, lambda t: _inputs(m, o, n, dtype, 7 * t + m, card))
    before = rolann_stats_batched.launches
    g, mv = rolann_stats_batched(xa, fsq, fd)
    torch.cuda.synchronize()
    assert rolann_stats_batched.launches == before + 1
    gp, mp = rolann_stats_batched_plain(xa, fsq, fd)
    assert g.dtype == dtype and tuple(g.shape) == (k, o, m, m)
    assert torch.equal(g, g.transpose(-1, -2))
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    scale = float(gp.double().abs().max())
    assert float((g.double() - gp.double()).abs().max()) <= tol * scale
    assert float((mv.double() - mp.double()).abs().max()) <= tol * max(scale, 1.0)
    g2, m2 = rolann_stats_batched(xa, fsq, fd)
    assert torch.equal(g, g2) and torch.equal(mv, m2)


@pytest.mark.parametrize("k,m,o,n", [(64, 28, 29, 1_024), (5, 28, 29, 926), (2, 70, 4, 2_001)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_batched_acc_kernel_matches_plain(card, k, m, o, n, dtype):
    xa, fsq, fd = _batched(k, lambda t: _inputs(m, o, n, torch.float32, 3 * t + n, card))
    fsq[..., n - n // 5:] = 0  # a masked tail
    fd[..., n - n // 5:] = 0
    g0, m0 = _running_batch(k, o, m, dtype, card)
    _check_fold(lambda g, mv: rolann_stats_acc_batched(g, mv, xa, fsq, fd),
                lambda g, mv: rolann_stats_acc_batched_plain(g, mv, xa, fsq, fd), g0, m0,
                rolann_stats_acc_batched)


@pytest.mark.parametrize("k,m,o,n,masked,dtype", [
    (64, 28, 29, 1_024, False, torch.float32),   # the logistic-output chunked fleet fit
    (64, 28, 29, 1_024, True, torch.float32),
    (64, 28, 29, 1_000, True, torch.float32),    # a ragged width
    (1, 28, 29, 1_024, True, torch.float32),     # one tenant
    (3, 28, 32, 2_049, True, torch.float32),     # o = 32: four outputs a warp in full
    (64, 28, 29, 1_024, True, torch.bfloat16),
    (8, 19, 15, 1_024, True, torch.float64),
])
def test_batched_acc_slice_route(card, k, m, o, n, masked, dtype):
    """B5 with m <= 28 and o <= 32 on the slice route (B4's kernel, then
    the few-slice reduce adding into the running values): both launches
    counted there, in place, the accumulators passed in returned in their
    dtype, G exactly symmetric, the plain fold's bar, a bit-identical
    repeat; masks zero one sample in ten and the last fifth."""
    xa, fsq, fd = _batched(k, lambda t: _inputs(m, o, n, torch.float32, 5 * t + n + o, card))
    if masked:
        gen = torch.Generator(device=card).manual_seed(n)
        keep = (torch.rand((k, 1, n), generator=gen, device=card) > 0.1).float()
        keep[..., n - n // 5:] = 0
        fsq, fd = fsq * keep, fd * keep
    assert ops.stats_route(k, m, o, True, batched=True) == "slice"
    g0, m0 = _running_batch(k, o, m, dtype, card)
    before = rolann_stats_acc_batched.route_launches["slice"]
    _check_fold(lambda g, mv: rolann_stats_acc_batched(g, mv, xa, fsq, fd),
                lambda g, mv: rolann_stats_acc_batched_plain(g, mv, xa, fsq, fd), g0, m0,
                rolann_stats_acc_batched)
    assert rolann_stats_acc_batched.route_launches["slice"] == before + 2


@pytest.mark.parametrize("k,m_l,m_c1,n,act", [(64, 15, 18, 1_024, "logsig"),
                                              (64, 24, 27, 926, "tanh"),
                                              (2, 40, 50, 3_001, "logsig"),
                                              (1, 3, 1, 65, "tanh")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_batched_fused_chunk_kernel_matches_plain(card, k, m_l, m_c1, n, act, dtype):
    gen = torch.Generator(device=card).manual_seed(k * n)
    h = torch.sigmoid(2 * torch.randn((k, m_l, n), generator=gen, device=card))
    if act == "tanh":
        h = 2 * h - 1
    w = torch.randn((k, m_l, m_c1), generator=gen, device=card) * (2 / (m_l + m_c1)) ** 0.5
    b = torch.randn((k, m_c1), generator=gen, device=card)
    mask = (torch.rand((k, n), generator=gen, device=card) > 0.1).float()
    mask[:, n - n // 5:] = 0
    g0, m0 = _running_batch(k, m_l, m_c1 + 1, dtype, card)
    _check_fold(lambda g, mv: rolann_fused_chunk_batched(g, mv, h, w, b, mask, act_name=act),
                lambda g, mv: rolann_fused_chunk_batched_plain(g, mv, h, w, b, mask, act),
                g0, m0, rolann_fused_chunk_batched)


# The fleet's layers: (m, o) of the one-shot fit's B4 launches and
# (m_l, m_c1) of the chunked fit's B6 launches (creditcard, 64 tenants).
FLEET_STATS = ((19, 15), (22, 18), (25, 21), (28, 24))
FLEET_FUSED = ((15, 18), (18, 21), (21, 24), (24, 27))


def _check_batched_stats_route(k, m, o, n, dtype, dev, route):
    """B4 on ``route``: one launch counted there, G exactly symmetric, the
    plain version's bar (1e-4 of the largest entry, one bf16 ulp for bf16),
    a bit-identical repeat."""
    xa, fsq, fd = _batched(k, lambda t: _inputs(m, o, n, dtype, 11 * t + m + o, dev))
    assert ops.stats_slice_route(m, o) == (route == "slice")
    before = (rolann_stats_batched.launches, rolann_stats_batched.route_launches[route])
    g, mv = rolann_stats_batched(xa, fsq, fd)
    torch.cuda.synchronize()
    assert (rolann_stats_batched.launches, rolann_stats_batched.route_launches[route]) == (
        before[0] + 1, before[1] + 1)
    gp, mp = rolann_stats_batched_plain(xa, fsq, fd)
    assert g.dtype == dtype and tuple(g.shape) == (k, o, m, m) and tuple(mv.shape) == (k, o, m)
    assert torch.equal(g, g.transpose(-1, -2))
    tol = 2.0**-7 if dtype == torch.bfloat16 else 1e-4
    assert float((g.double() - gp.double()).abs().max()) <= tol * float(gp.double().abs().max())
    assert float((mv.double() - mp.double()).abs().max()) <= tol * float(mp.double().abs().max())
    g2, m2 = rolann_stats_batched(xa, fsq, fd)
    assert torch.equal(g, g2) and torch.equal(mv, m2)


@pytest.mark.parametrize("m,o", FLEET_STATS)
def test_batched_stats_slice_route_at_the_fleet_layers(card, m, o):
    """B4 at each layer of the fleet fit (64 tenants of 3,998 samples) on
    the slice route (rolann_stats_slice.cuh)."""
    _check_batched_stats_route(64, m, o, 3_998, torch.float32, card, "slice")


@pytest.mark.parametrize("k,m,o,n,dtype,route", [
    (1, 28, 32, 5_003, torch.float32, "slice"),    # one tenant, four outputs a warp
    (1, 1, 1, 3, torch.float32, "slice"),
    (8, 28, 24, 3_998, torch.bfloat16, "slice"),
    (8, 19, 15, 3_998, torch.float64, "slice"),
    (5, 28, 17, 100_003, torch.float32, "slice"),  # slices of many steps
    (2, 29, 15, 2_049, torch.float32, "fp32"),     # m past the slice route
    (2, 28, 33, 2_049, torch.float32, "fp32"),     # o past it
    (3, 37, 3, 10_007, torch.float32, "fp32"),
    (1, 37, 3, 517, torch.float32, "tf32x3"),      # one tenant, m > 28: B1's tensor cores
])
def test_batched_stats_routes_by_shape(card, k, m, o, n, dtype, route):
    """B4 takes the slice kernel for m <= 28 and o <= 32, else B1's routes
    (partial_kernel; the tensor cores for one tenant with m > 28); each holds
    the plain version's bar."""
    _check_batched_stats_route(k, m, o, n, dtype, card, route)


def _fleet_chunk(k, m_l, m_c1, n, act, masked, dev):
    gen = torch.Generator(device=dev).manual_seed(k * n + m_l)
    h = torch.sigmoid(2 * torch.randn((k, m_l, n), generator=gen, device=dev))
    if act == "tanh":
        h = 2 * h - 1
    w = torch.randn((k, m_l, m_c1), generator=gen, device=dev) * (2 / (m_l + m_c1)) ** 0.5
    b = torch.randn((k, m_c1), generator=gen, device=dev)
    mask = torch.ones((k, n), device=dev)
    if masked:
        mask = (torch.rand((k, n), generator=gen, device=dev) > 0.1).float()
        mask[:, n - n // 5:] = 0
    return h, w, b, mask


def _check_batched_fused_route(k, m_l, m_c1, n, act, masked, dtype, dev, route):
    """B6 on ``route``: _check_fold's checks (one launch, in place, G
    exactly symmetric, the plain version's bar, a bit-identical repeat),
    both launches counted on the route."""
    h, w, b, mask = _fleet_chunk(k, m_l, m_c1, n, act, masked, dev)
    g0, m0 = _running_batch(k, m_l, m_c1 + 1, dtype, dev)
    assert ops.fused_slice_route(k, m_l, m_c1) == (route == "slice")
    before = rolann_fused_chunk_batched.route_launches[route]
    _check_fold(lambda g, mv: rolann_fused_chunk_batched(g, mv, h, w, b, mask, act_name=act),
                lambda g, mv: rolann_fused_chunk_batched_plain(g, mv, h, w, b, mask, act),
                g0, m0, rolann_fused_chunk_batched)
    assert rolann_fused_chunk_batched.route_launches[route] == before + 2


@pytest.mark.parametrize("n,act,masked", [(1_024, "logsig", False), (926, "tanh", True)])
@pytest.mark.parametrize("m_l,m_c1", FLEET_FUSED)
def test_batched_fused_chunk_slice_route_at_the_fleet_layers(card, m_l, m_c1, n, act, masked):
    """B6 at each hidden layer of the chunked fleet fit (64 tenants, a full
    1,024-sample chunk and the ragged masked 926-sample one) on the slice
    route (rolann_fused_slice.cuh with its tenant axis)."""
    _check_batched_fused_route(64, m_l, m_c1, n, act, masked, torch.float32, card, "slice")


@pytest.mark.parametrize("k,m_l,m_c1,n,act,dtype,route", [
    (1, 24, 27, 1_024, "logsig", torch.float32, "slice"),  # one tenant, batched entry
    (1, 15, 18, 20_011, "tanh", torch.float32, "slice"),   # one tenant, many slices
    (1, 32, 27, 700, "tanh", torch.float32, "slice"),      # four outputs a warp
    (8, 24, 27, 1_024, "logsig", torch.bfloat16, "slice"),
    (8, 15, 18, 1_024, "tanh", torch.float64, "slice"),
    (3, 33, 27, 1_000, "logsig", torch.float32, "tile"),   # m_l past the slice route
    (2, 40, 50, 2_001, "logsig", torch.float32, "tile"),
])
def test_batched_fused_chunk_routes_by_shape(card, k, m_l, m_c1, n, act, dtype, route):
    """B6 takes the slice kernel for ma <= 28 and m_l <= 32, any k,
    fused_partial_kernel otherwise; both hold the plain version's bar."""
    _check_batched_fused_route(k, m_l, m_c1, n, act, True, dtype, card, route)


def test_empty_batches_launch_nothing(card):
    before = (rolann_stats_batched.launches, rolann_stats_acc_batched.launches,
              rolann_fused_chunk_batched.launches)
    z = torch.zeros((2, 4, 0), device=card)
    g, mv = rolann_stats_batched(z, z[:, :2], z[:, :2])
    assert not g.any() and tuple(g.shape) == (2, 2, 4, 4)
    rolann_stats_acc_batched(g, mv, z, z[:, :2], z[:, :2])
    rolann_fused_chunk_batched(g, mv, z[:, :2], torch.zeros((2, 2, 3), device=card),
                               torch.zeros((2, 3), device=card), torch.zeros((2, 0), device=card),
                               act_name="logsig")
    assert (rolann_stats_batched.launches, rolann_stats_acc_batched.launches,
            rolann_fused_chunk_batched.launches) == before


@pytest.mark.parametrize("act_last", ["linear", "logsig"])
def test_fleet_on_card_matches_a_loop_of_one_tenant_fits(card, act_last):
    """A small fused fleet (B4 one-shot; B6, and B5 for a logistic last
    layer, chunked) against the port's one-tenant fits of each tenant on the
    card, fused backend.  The bar is test_fit_on_card_matches_host's."""
    cfg = daef.DAEFConfig(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9,
                          act_last=act_last, stats_backend="fused")
    xs = np.stack([lowrank_data(10, 4, 3_000, seed=s) for s in range(4)])
    x_test = np.stack([lowrank_data(10, 4, 500, seed=10 + s) for s in range(4)])
    if act_last == "logsig":
        lo, hi = xs.min(axis=2, keepdims=True), xs.max(axis=2, keepdims=True)
        xs, x_test = (xs - lo) / (hi - lo), (x_test - lo) / (hi - lo)
    seeds = [0, 0, 5, 5]
    before = (rolann_stats_batched.launches, rolann_stats_acc_batched.launches,
              rolann_fused_chunk_batched.launches)
    one_shot = fleet._fit_fleet(cfg, xs, seeds=seeds)
    chunked = fleet._fit_fleet_chunked(cfg, xs, chunk_samples=1_024, seeds=seeds)
    launched = tuple(a.launches - b for a, b in zip(
        (rolann_stats_batched, rolann_stats_acc_batched, rolann_fused_chunk_batched), before))
    logsig = act_last == "logsig"  # the last layer folds per-output statistics too
    assert launched == (3 if logsig else 2, 3 if logsig else 0, 2 * 3)
    scores = {name: fleet.fleet_scores(cfg, fl, x_test).cpu().numpy()
              for name, fl in (("one-shot", one_shot), ("chunked", chunked))}
    for t in range(4):
        one = daef.fit(dataclasses.replace(cfg, seed=seeds[t]), xs[t])
        want = daef.reconstruction_error(cfg, one, x_test[t]).cpu().numpy()
        for got in scores.values():
            np.testing.assert_allclose(got[t], want, rtol=1e-3, atol=1e-5 * np.abs(want).max())


# ---- the LM kernels (B7, B9, B10) and the backbones ----

def _randn(shape, gen, dev, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("b,s,h,hkv,d,window", [(2, 256, 16, 8, 128, None),
                                                (1, 1_000, 4, 1, 256, 17),
                                                (2, 300, 4, 4, 64, 1), (1, 77, 2, 1, 32, None),
                                                (1, 513, 4, 2, 128, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, b, s, h, hkv, d, window, dtype):
    """B7 against its plain version: float32 to 1e-5 of the O(1) outputs
    (summation order); bf16 to one bf16 ulp of each element, 2^-7 |ref| plus
    a floor of 2^-7 * 1e-2 where |ref| is near 0 (the kernel and the plain
    version round float32 results that differ in summation order once each);
    lse to 1e-5.  bf16 runs on the bf16 tensor-core kernel, float32 on the
    3xTF32 one (the route counts say which); a repeat is bit-identical."""
    gen = torch.Generator(device=card).manual_seed(s * d + h)
    q, k, v = (_randn((b, s, n, d), gen, card, dtype) for n in (h, hkv, hkv))
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before, before_route = flash_attention.launches, dict(flash_attention.route_launches)
    out, lse = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert flash_attention.route_launches == {**before_route, route: before_route[route] + 1}
    ref, ref_lse = flash_attention_ref(q, k, v, window=window)
    assert out.dtype == dtype and tuple(lse.shape) == (b, h, s)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 2.0**-7 * 1e-2).all())
    else:
        assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
    again, again_lse = flash_attention(q, k, v, window=window)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)


@pytest.mark.parametrize("b,s,h,hkv,window", [(1, 1_000, 8, 8, None), (2, 256, 4, 2, None),
                                              (1, 300, 4, 4, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_mla_head_sizes_match_plain(card, b, s, h, hkv, window, dtype):
    """B7 at MLA's head sizes, q/k 192 and v 128 (the (192, 128)
    instantiations of both kernels), against its plain version under the
    bars of the equal-size test above; out is [B, S, H, 128]; a repeat is
    bit-identical."""
    gen = torch.Generator(device=card).manual_seed(s + h)
    q = _randn((b, s, h, 192), gen, card, dtype)
    k = _randn((b, s, hkv, 192), gen, card, dtype)
    v = _randn((b, s, hkv, 128), gen, card, dtype)
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = dict(flash_attention.route_launches)
    out, lse = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.route_launches == {**before, route: before[route] + 1}
    ref, ref_lse = flash_attention_ref(q, k, v, window=window)
    assert out.dtype == dtype and tuple(out.shape) == (b, s, h, 128)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 2.0**-7 * 1e-2).all())
    else:
        assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
    again, again_lse = flash_attention(q, k, v, window=window)
    assert torch.equal(again, out) and torch.equal(again_lse, lse)


def test_flash_attention_refuses_head_sizes_it_has_no_kernel_for(card):
    q = torch.zeros((1, 8, 2, 192), device=card)
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention(q, q, q)
    q, v = torch.zeros((1, 8, 2, 128), device=card), torch.zeros((1, 8, 2, 64), device=card)
    lse = torch.zeros((1, 2, 8), device=card)
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention_bwd(q, q, v, v, lse, v)


def test_flash_attention_reads_strided_heads(card):
    """q, k, v as head slices of one fused projection: no copy, same result."""
    gen = torch.Generator(device=card).manual_seed(0)
    qkv = _randn((2, 200, 4 + 2 + 2, 64), gen, card)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    out, _ = flash_attention(q, k, v)
    ref, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(out, ref)


def test_flash_attention_bf16_reads_strided_heads(card):
    """The tensor-core kernels read head slices of one fused bf16 projection
    through their TMA maps: forward and backward equal those of contiguous
    copies, bit for bit."""
    gen = torch.Generator(device=card).manual_seed(0)
    qkv = _randn((2, 200, 4 + 2 + 2, 64), gen, card, torch.bfloat16)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    before = dict(flash_attention.route_launches)
    out, lse = flash_attention(q, k, v, window=50)
    assert flash_attention.route_launches["wgmma"] == before["wgmma"] + 1
    copies = [t.contiguous() for t in (q, k, v)]
    ref, ref_lse = flash_attention(*copies, window=50)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)
    do = _randn((2, 200, 4, 64), gen, card, torch.bfloat16)
    got = flash_attention_bwd(q, k, v, out, lse, do, window=50)
    want = flash_attention_bwd(*copies, ref, ref_lse, do, window=50)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("case", ["sequence stride", "address"])
def test_bf16_kernels_refuse_what_tma_cannot_take(card, case):
    """A bf16 input whose sequence stride is not a multiple of 16 bytes, or
    whose address is not 16-byte aligned, raises: TMA cannot load it, and
    nothing falls back."""
    gen = torch.Generator(device=card).manual_seed(1)
    if case == "sequence stride":
        buf = _randn((1, 100, 2 * 64 + 4), gen, card, torch.bfloat16)   # 264-byte rows
        qkv = buf[:, :, :128].unflatten(-1, (2, 64))
    else:
        buf = _randn((1, 100, 2 * 64 + 1), gen, card, torch.bfloat16)
        qkv = buf.flatten()[1:1 + 100 * 128].view(1, 100, 2, 64)      # 2 bytes off
    q, k, v = qkv, qkv[:, :, :1], qkv[:, :, 1:]
    before = (flash_attention.launches, flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="16 bytes|16-byte"):
        flash_attention(q, k, v)
    out, lse = flash_attention(*(t.clone() for t in (q, k, v)))   # fresh, aligned copies
    with pytest.raises(ValueError, match="16 bytes|16-byte"):
        flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out))
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("b,s,w", [(2, 4_096, 4_096), (3, 1, 77), (2, 37, 100)]
                         + [(2, s, w) for s in (1, 37, 4_097) for w in (77, 100, 4_096)])
@pytest.mark.parametrize("x_dtype,gate_dtype", [(torch.float32, torch.float32),
                                                (torch.bfloat16, torch.bfloat16),
                                                (torch.bfloat16, torch.float32)])
def test_rglru_scan_kernel_matches_plain(card, b, s, w, x_dtype, gate_dtype):
    """B9 against its plain version on the same (widened) values: 1e-5 (the
    same operations in the same order; only the transcendentals' last bits
    differ); one launch counted on x's dtype, a repeat bit-identical.  x
    and the gates r, i in float32 or bf16 (the hybrid's bf16 prefill: bf16
    x, float32 gates).  Rows that are whole 16-byte chunks (W = 4,096;
    W = 100 in float32) are staged by cp.async, the others (W = 77; W = 100
    with a bf16 input) loaded by the workers: both are taken."""
    gen = torch.Generator(device=card).manual_seed(s + w)
    x = _randn((b, s, w), gen, card, x_dtype)
    r = torch.sigmoid(_randn((b, s, w), gen, card)).to(gate_dtype)
    i = torch.sigmoid(_randn((b, s, w), gen, card)).to(gate_dtype)
    lam = _randn((w,), gen, card) + 4
    name = str(x_dtype).removeprefix("torch.")
    before = (rglru_scan.launches, rglru_scan.route_launches[name])
    y, h = rglru_scan(x, r, i, lam)
    torch.cuda.synchronize()
    assert (rglru_scan.launches, rglru_scan.route_launches[name]) == (before[0] + 1,
                                                                      before[1] + 1)
    assert y.dtype == h.dtype == torch.float32
    yr, hr = rglru_scan_ref(x.float(), r.float(), i.float(), lam)
    assert float((y - yr).abs().max()) <= 1e-5 and float((h - hr).abs().max()) <= 1e-5
    y2, h2 = rglru_scan(x, r, i, lam)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    if torch.bfloat16 in (x_dtype, gate_dtype):  # widening is exact: float32's bits
        y32, h32 = rglru_scan(x.float(), r.float(), i.float(), lam)
        assert torch.equal(y, y32) and torch.equal(h, h32)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(4, 4_096, 48, 64, 1, 128, 256),
                                               (2, 1_000, 4, 64, 2, 128, 256),
                                               (1, 64, 3, 16, 1, 32, 32),
                                               (2, 256, 4, 64, 2, 128, 100),
                                               (1, 300, 2, 64, 1, 128, 256),   # Q 150
                                               (2, 390, 2, 16, 1, 32, 256),    # Q 195
                                               (1, 128, 2, 7, 1, 20, 64)])     # odd P, N
def test_ssd_chunk_kernel_matches_plain(card, b, s, h, p, g, n, chunk):
    """B10 against its plain chunked version: 1e-5 of the largest output
    (float32 sums of up to Q·N terms in other orders; the products are
    3xTF32, tests/test_torch_tf32x3.py); repeats bit-identical."""
    gen = torch.Generator(device=card).manual_seed(s + h + g)
    xdt = _randn((b, s, h, p), gen, card)
    la = -torch.rand((b, s, h), generator=gen, device=card) * 0.1
    bm, cm = _randn((b, s, g, n), gen, card), _randn((b, s, g, n), gen, card)
    before = ssd_chunk.launches
    y, hf = ssd_chunk(xdt, la, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk.launches == before + 1
    yr, hr = ssd_chunk_plain(xdt, la, bm, cm, fit_chunk(s, chunk))
    assert float((y - yr).abs().max()) <= 1e-5 * float(yr.abs().max())
    assert float((hf - hr).abs().max()) <= 1e-5 * float(hr.abs().max())
    y2, hf2 = ssd_chunk(xdt, la, bm, cm, chunk=chunk)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)


@pytest.mark.parametrize("name,s", [("qwen3-1.7b", 96), ("mamba2-780m", 128),
                                    ("recurrentgemma-9b", 160)])
def test_reduced_backbone_on_card_matches_host(card, name, s):
    """A reduced backbone in float32, the same weights on the card (kernels)
    and on the host (plain versions): hidden states to 1e-4 of their largest
    entry (float32 sums in other orders through two to three layers)."""
    cfg = registry.get(name).reduced()
    bundle = get_bundle(cfg)
    params = bundle.init(0, device="cpu")
    tokens = synthetic.lm_token_stream(cfg.vocab_size, s, 2, seed=1)
    host = bundle.forward(params, tokens)
    card_params = _tree_to(params, card)
    got = bundle.forward(card_params, tokens).cpu()
    assert float((got - host).abs().max()) <= 1e-4 * float(host.abs().max())


DECODE_CASES = {  # id: (arch, config changes, tokens)
    "qwen3": ("qwen3-1.7b", {}, 64),
    "qwen3 ring": ("qwen3-1.7b", {"sliding_window": 16}, 48),
    "mamba2": ("mamba2-780m", {}, 64),
    "recurrentgemma tail ring": ("recurrentgemma-9b", {"n_layers": 5, "local_window": 16}, 48),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_on_card_matches_prefill(card, case):
    """chip_smoke.py phase 21 (b, c) at a reduced width: the tokens
    teacher-forced through ``bundle.decode`` on the card (plain PyTorch),
    the last logits against the card's prefill of the same tokens (B7 on
    its float32 route, B9, B10), at the reference's bar (atol 2e-3, rtol
    1e-2, tests/test_models.py); the ring cases wrap their 16 slots."""
    name, changes, s = DECODE_CASES[case]
    cfg = dataclasses.replace(registry.get(name).reduced(), **changes)
    bundle = get_bundle(cfg)
    params = bundle.init(0, device=card)
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, 2, seed=1),
                             device=card)
    kernels = {"dense": (flash_attention,), "ssm": (ssd_chunk,),
               "hybrid": (flash_attention, rglru_scan)}[cfg.family]
    before = [k.launches for k in kernels]
    want = bundle.prefill(params, {"tokens": tokens})
    assert all(k.launches > n for k, n in zip(kernels, before))
    if cfg.family != "ssm":
        assert flash_attention.route_launches["tf32x3"] > 0
    cache = bundle.init_cache(2, s, torch.float32, device=card)
    for t in range(s):
        logits, cache = bundle.decode(params, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(logits[:, 0].cpu().numpy(), want[:, 0].cpu().numpy(),
                               atol=2e-3, rtol=1e-2)


# deepseek-v2 at a reduced width with MLA's full head sizes (q/k 128 nope +
# 64 rope, v 128), so that its prefill runs B7's (192, 128) kernels; and
# qwen2-moe and internvl2 reduced.  capacity_factor=16 where decode meets
# prefill: capacity routing drops otherwise one token at a time than a whole
# sequence at once (the reference's tests/test_models.py does the same).
MLA_WIDTHS = dict(qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)
FAMILY_CASES = {
    "deepseek-v2 mla": ("deepseek-v2-236b", MLA_WIDTHS),
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "internvl2": ("internvl2-2b", {}),
}


def _family_batch(cfg, s, dev):
    batch = {"tokens": torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, s, 2, seed=1),
                                       device=dev)}
    if cfg.family == "vlm":
        gen = torch.Generator(device=dev).manual_seed(2)
        batch["patch_embeds"] = torch.randn((2, cfg.n_patches, cfg.d_frontend), generator=gen,
                                            device=dev)
    return batch


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_prefill_on_card_matches_host(card, case):
    """The VLM (with its patch prefix) and the MoE families in float32, the
    same weights on the card (B7 on its float32 route, at (192, 128) for MLA)
    and on the host: hidden states to 1e-4 of their largest entry, after the
    dispatch of each MoE layer agreed (the router's float32 logits decide
    it; the check below would show a flipped choice as a large error)."""
    name, changes = FAMILY_CASES[case]
    cfg = dataclasses.replace(registry.get(name).reduced(), **changes)
    bundle = get_bundle(cfg)
    params = bundle.init(0, device="cpu")
    batch = _family_batch(cfg, 96, "cpu")
    args = (batch["tokens"],) + ((batch["patch_embeds"],) if cfg.family == "vlm" else ())
    host = bundle.forward(params, *args)
    before = dict(flash_attention.route_launches)
    got = bundle.forward(_tree_to(params, card), *(a.to(card) for a in args)).cpu()
    assert flash_attention.route_launches["tf32x3"] == before["tf32x3"] + cfg.n_layers
    assert float((got - host).abs().max()) <= 1e-4 * float(host.abs().max())


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_family_decode_on_card_matches_prefill(card, case):
    """chip_smoke.py phase 22 (d) at a reduced width: 48 tokens
    teacher-forced through ``bundle.decode`` on the card against the card's
    prefill (the VLM's without patches: decode is its decoder's), at the
    reference's bar (atol 2e-3, rtol 1e-2)."""
    name, changes = FAMILY_CASES[case]
    cfg = dataclasses.replace(registry.get(name).reduced(), capacity_factor=16.0, **changes)
    bundle = get_bundle(cfg)
    params = bundle.init(0, device=card)
    tokens = _family_batch(cfg, 48, card)["tokens"]
    want = bundle.prefill(params, {"tokens": tokens}) if cfg.family != "vlm" else \
        common.logits_from_hidden(bundle.forward(params, tokens)[:, -1:], params["embed"],
                                  params["lm_head"])
    cache = bundle.init_cache(2, 48, torch.float32, device=card)
    for t in range(48):
        logits, cache = bundle.decode(params, cache, tokens[:, t:t + 1], t)
    np.testing.assert_allclose(logits[:, 0].cpu().numpy(), want[:, 0].cpu().numpy(),
                               atol=2e-3, rtol=1e-2)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "mamba2-780m", "recurrentgemma-9b"])
def test_decode_on_card_matches_host(card, name):
    """chip_smoke.py phase 21 (d) at a reduced width: the same weights and
    tokens decoded 16 steps on the card and on the host, each step's logits
    within 1e-4 of their largest entry (float32 sums in other orders)."""
    cfg = registry.get(name).reduced()
    bundle = get_bundle(cfg)
    params = bundle.init(0, device="cpu")
    card_params = _tree_to(params, card)
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, 16, 2, seed=2))
    host_cache = bundle.init_cache(2, 16, torch.float32, device="cpu")
    card_cache = bundle.init_cache(2, 16, torch.float32, device=card)
    for t in range(16):
        host, host_cache = bundle.decode(params, host_cache, tokens[:, t:t + 1], t)
        got, card_cache = bundle.decode(card_params, card_cache, tokens[:, t:t + 1],
                                        torch.tensor(t, device=card))
        assert got.device.type == "cuda"
        assert float((got.cpu() - host).abs().max()) <= 1e-4 * float(host.abs().max()), t


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def _assert_bwd_close(got, want, mags):
    """B8's per-element bar: float32 within 1e-5 of the element's term
    magnitude (``flash_attention_bwd_magnitudes``: two float32 sums of the
    same terms in other orders differ by a small multiple of eps times
    that); bf16 one bf16 ulp of the element (2^-7·|ref|, each side rounds
    once) plus 2e-5 of the magnitude.  dk's and dv's magnitudes sum over the
    G query heads of their group, as the gradients do."""
    for g, w, m in zip(got, want, mags):
        assert g.dtype == w.dtype and g.shape == w.shape and bool(g.isfinite().all())
        d = (g.double() - w.double()).abs()
        if g.dtype == torch.bfloat16:
            bar = 2.0**-7 * w.double().abs() + 2e-5 * m.double()
        else:
            bar = 1e-5 * m.double()
        assert bool((d <= bar).all()), float((d / bar.clamp_min(1e-30)).max())


@pytest.mark.parametrize("b,s,h,hkv,d,window,dtype", [
    (2, 2_048, 16, 8, 128, None, torch.bfloat16),   # the train shape
    (2, 2_048, 16, 8, 128, None, torch.float32),
    (2, 4_096, 16, 1, 256, 2_048, torch.bfloat16),  # recurrentgemma's windowed MQA
    (1, 1_000, 8, 2, 64, None, torch.float32),      # ragged S
    (2, 1_000, 8, 2, 64, 300, torch.bfloat16),
    (2, 512, 8, 2, 32, 77, torch.float32),
    (1, 300, 4, 1, 128, 1, torch.float32),
    (1, 1_000, 8, 2, 64, None, torch.bfloat16),
    (2, 512, 8, 2, 32, 77, torch.bfloat16),
    (1, 300, 4, 1, 128, 1, torch.bfloat16),
])
def test_flash_attention_bwd_kernel_matches_plain(card, b, s, h, hkv, d, window, dtype):
    """B8 against its plain version, element by element, bf16 on the bf16
    tensor-core kernels and float32 on the 3xTF32 ones (the route counts say
    which); a repeat is bit-identical (no atomics: the group sum is a fixed
    sequence of accumulations)."""
    gen = torch.Generator(device=card).manual_seed(s + d + h)
    q, k, v, do = (_randn((b, s, n, d), gen, card, dtype) for n in (h, hkv, hkv, h))
    out, lse = flash_attention(q, k, v, window=window)
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before, before_route = flash_attention_bwd.launches, dict(flash_attention_bwd.route_launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.route_launches == {**before_route, route: before_route[route] + 1}
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, window=window)
    _assert_bwd_close(got, want,
                      flash_attention_bwd_magnitudes(q, k, v, out, lse, do, window=window))
    again = flash_attention_bwd(q, k, v, out, lse, do, window=window)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("b,s,h,hkv,d,d_v,causal", [
    (4, 1_500, 6, 6, 64, 64, False),      # whisper-tiny's encoder: no causal mask
    (2, 1_000, 4, 2, 64, 64, False),      # ragged S, GQA
    (1, 1_000, 8, 8, 192, 128, True),     # MLA's head sizes, ragged S
    (2, 512, 16, 16, 192, 128, True),
    (1, 300, 4, 2, 192, 128, False),
], ids=["encoder", "full ragged gqa", "mla ragged", "mla", "mla full gqa"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_new_routes_match_plain(card, b, s, h, hkv, d, d_v, causal, dtype):
    """B7 and B8 without the causal mask and at MLA's (192, 128), both
    routes (the route counts say which), against their plain versions under
    the bars of the tests above; dq and dk are D wide, dv D_v; repeats are
    bit-identical."""
    gen = torch.Generator(device=card).manual_seed(s + d + h)
    q, k = (_randn((b, s, n, d), gen, card, dtype) for n in (h, hkv))
    v, do = (_randn((b, s, n, d_v), gen, card, dtype) for n in (hkv, h))
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    before = (dict(flash_attention.route_launches), dict(flash_attention_bwd.route_launches))
    out, lse = flash_attention(q, k, v, causal=causal)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.route_launches[route] == before[0][route] + 1
    assert flash_attention_bwd.route_launches[route] == before[1][route] + 1
    ref, ref_lse = flash_attention_ref(q, k, v, causal=causal)
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 2.0**-7 * 1e-2).all())
    else:
        assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
    assert [tuple(g.shape) for g in got] == [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d_v)]
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)
    _assert_bwd_close(got, want, flash_attention_bwd_magnitudes(q, k, v, out, lse, do,
                                                                causal=causal))
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    assert torch.equal(flash_attention(q, k, v, causal=causal)[0], out)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,window,offsets", [
    (2, 512, 2_048, 12, 2, 128, None, (0, 512, 1_024, 1_536)),   # qwen2-1.5b's stripes
    (1, 250, 1_000, 8, 2, 64, 300, (0, 250, 500, 750)),          # ragged tiles, windowed
    (2, 96, 384, 4, 4, 192, None, (0, 288)),                     # MLA's q/k head size
], ids=["qwen2 stripes", "ragged windowed", "mla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_stripes_match_plain(card, b, sq, sk, h, hkv, d, window, offsets,
                                             dtype):
    """B7 and B8 with ``q_offset`` (a stripe of Sq query rows against Sk
    keys, the sequence-parallel route), both routes, against their plain
    versions under the bars of the tests above; keys past the stripe's
    last position get zero gradients; repeats are bit-identical."""
    gen = torch.Generator(device=card).manual_seed(sq + sk + d)
    d_v = 128 if d == 192 else d
    route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    for off in offsets:
        q, k = _randn((b, sq, h, d), gen, card, dtype), _randn((b, sk, hkv, d), gen, card, dtype)
        v, do = _randn((b, sk, hkv, d_v), gen, card, dtype), _randn((b, sq, h, d_v), gen, card,
                                                                    dtype)
        kw = dict(window=window, q_offset=off)
        before = (dict(flash_attention.route_launches), dict(flash_attention_bwd.route_launches))
        out, lse = flash_attention(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        assert flash_attention.route_launches[route] == before[0][route] + 1
        assert flash_attention_bwd.route_launches[route] == before[1][route] + 1
        ref, ref_lse = flash_attention_ref(q, k, v, **kw)
        diff = (out.float() - ref.float()).abs()
        if dtype == torch.bfloat16:
            assert bool((diff <= 2.0**-7 * ref.float().abs() + 2.0**-7 * 1e-2).all())
        else:
            assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
        assert float((lse - ref_lse).abs().max()) <= 1e-5 * float(ref_lse.abs().max())
        assert [tuple(g.shape) for g in got] == [(b, sq, h, d), (b, sk, hkv, d),
                                                 (b, sk, hkv, d_v)]
        _assert_bwd_close(got, flash_attention_bwd_ref(q, k, v, out, lse, do, **kw),
                          flash_attention_bwd_magnitudes(q, k, v, out, lse, do, **kw))
        assert not got[1][:, off + sq:].any() and not got[2][:, off + sq:].any()
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
        assert torch.equal(flash_attention(q, k, v, **kw)[0], out)


def test_flash_attention_function_on_card(card):
    """The autograd Function on the card (B7 forward, B8 backward) against
    autograd through the plain forward, float32; strided head slices of one
    projection read in place give the same gradients as contiguous copies."""
    gen = torch.Generator(device=card).manual_seed(3)
    qkv = _randn((2, 333, 8 + 2 + 2, 64), gen, card).requires_grad_()
    do = _randn((2, 333, 8, 64), gen, card)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    out, lse = flash_attention(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:], window=100)
    (got,) = torch.autograd.grad(out, qkv, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert lse.grad_fn is None
    ref, _ = flash_attention_ref(qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:], window=100)
    (want,) = torch.autograd.grad(ref, qkv, do)
    leaves = [t.detach().contiguous().requires_grad_()
              for t in (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:])]
    out2, _ = flash_attention(*leaves, window=100)
    contiguous = torch.cat(torch.autograd.grad(out2, leaves, do), dim=2)
    assert torch.equal(got, contiguous)
    mags = flash_attention_bwd_magnitudes(*(t.detach() for t in (qkv[:, :, :8], qkv[:, :, 8:10],
                                                                  qkv[:, :, 10:])),
                                          out.detach(), lse, do, window=100)
    _assert_bwd_close(got.split([8, 2, 2], dim=2), want.split([8, 2, 2], dim=2), mags)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_on_card_matches_host(card, microbatches):
    """One AdamW train step of the reduced qwen3 in float32, the same
    parameters and batch on the card (B7, B8) and on the host (plain
    versions): loss, parameters and moments to 1e-4 of each leaf's largest
    entry (float32 sums in other orders; eps = 1e-3 keeps each update a
    smooth function of its gradient, see tests/test_torch_training.py)."""
    cfg = registry.get("qwen3-1.7b").reduced()
    bundle = get_bundle(cfg)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 96, 4, seed=2)
    results = []
    for dev in ("cpu", card):
        params = _tree_to(bundle.init(0, device="cpu"), dev)
        opt = optim.adamw(optim.linear_warmup_cosine(1e-3, 2, 10), weight_decay=0.01, eps=1e-3)
        step = steps.make_train_step(bundle, opt, microbatches=microbatches)
        before = flash_attention_bwd.launches
        params, state, loss = step(params, opt.init(params), {"tokens": tokens})
        if dev == card:
            assert flash_attention_bwd.launches == before + cfg.n_layers * microbatches
        results.append([loss] + [t.detach().cpu() for t in
                                 torch.utils._pytree.tree_leaves((params, state.mu, state.nu))])
    for host, got in zip(*results):
        scale = max(float(host.abs().max()), 1e-30)
        assert float((got.cpu() - host).abs().max()) <= 1e-4 * scale


# ---- the backwards of B9 and B10, and training the recurrent families ----

def _assert_max_close(got, want, what):
    """The script's rule: max|d| <= 1e-4 max|plain| over the tensor."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool(got.isfinite().all()), what
    d = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    assert d <= 1e-4 * (float(want.abs().max()) if want.numel() else 0.0), (what, d)


def _assert_each_close(got, want, mags, what):
    """Per element |d| <= 1e-5 of its term magnitude: the row and column sums
    that make dla (the sums over batch and time that make dlam) cancel, so
    their float32 error follows the size of the terms, not of the result
    (tests/test_torch_ssm_training.py checks this model on the host)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    d = (got.double() - want.double()).abs()
    assert bool((d <= 1e-5 * mags.double()).all()), (what, float(d.max()))


SSD_BWD_CASES = [(2, 2_048, 48, 64, 1, 128, 256, True),   # mamba2-780m's microbatch
                 (2, 2_048, 48, 64, 1, 128, 256, False),
                 (2, 1_000, 8, 64, 2, 128, 256, True),    # G = 2, ragged: chunk 250
                 (1, 1, 4, 64, 1, 128, 256, True),        # S = 1
                 (0, 64, 4, 64, 1, 128, 256, True),       # B = 0
                 (1, 128, 2, 7, 1, 20, 64, False),        # odd P, N
                 (1, 300, 6, 16, 3, 32, 256, True),       # Q 150, three groups
                 # mamba2's initial decays (cum reaches -10³ within a chunk)
                 pytest.param(2, 2_048, 48, 64, 1, 128, 256, True,
                              id="2-2048-48-64-1-128-256-True-mamba2_decays")]


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,final", SSD_BWD_CASES)
def test_ssd_chunk_bwd_kernel_matches_plain(card, request, b, s, h, p, g, n, chunk, final):
    """B10's backward against its plain version: dxdt, db, dc to the
    script's rule, dla per element to 1e-5 of its term magnitude; one launch
    counted (none at B = 0), a repeat bit-identical; with no h_final
    cotangent, the autograd Function's gradients are the same bits.  The
    case at mamba2's initial decays (a = linspace(1, 16, H)) takes cum to
    -10³ within a chunk."""
    gen = torch.Generator(device=card).manual_seed(s + h + g)
    xdt = _randn((b, s, h, p), gen, card)
    if request.node.callspec.id.endswith("mamba2_decays"):  # la = -a·softplus(z)
        la = -torch.linspace(1.0, 16.0, h, device=card) * torch.nn.functional.softplus(
            _randn((b, s, h), gen, card))
    else:
        la = -torch.rand((b, s, h), generator=gen, device=card) * 0.1
    bm, cm = _randn((b, s, g, n), gen, card), _randn((b, s, g, n), gen, card)
    dy = _randn((b, s, h, p), gen, card)
    dh = _randn((b, h, p, n), gen, card) if final else None
    before = ssd_chunk_bwd.launches
    got = ssd_chunk_bwd(xdt, la, bm, cm, dy, dh, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_chunk_bwd.launches == before + (b > 0)
    q = fit_chunk(s, chunk)
    want = ssd_chunk_bwd_plain(xdt, la, bm, cm, dy, dh, chunk=q)
    mags = ssd_chunk_bwd_magnitudes(xdt, la, bm, cm, dy, dh, chunk=q)
    for name, gt, wt in zip(("dxdt", "db", "dc"), (got[0], *got[2:]), (want[0], *want[2:])):
        _assert_max_close(gt, wt, name)
    _assert_each_close(got[1], want[1], mags[1], "dla")
    again = ssd_chunk_bwd(xdt, la, bm, cm, dy, dh, chunk=chunk)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if not final and b > 0:
        leaves = [t.clone().requires_grad_() for t in (xdt, la, bm, cm)]
        y, _ = ssd_chunk(*leaves, chunk=chunk)
        grads = torch.autograd.grad(y, leaves, dy)
        assert all(torch.equal(a, c) for a, c in zip(grads, got))


def test_ssd_chunk_bwd_refuses_what_the_kernel_does_not_take(card):
    """P > 64, N > 128, a chunk > 256 and float64 raise before any launch."""
    before = ssd_chunk_bwd.launches
    for (s, h, p, g, n, chunk, dtype) in ((64, 2, 65, 1, 32, 64, torch.float32),
                                          (64, 2, 16, 1, 129, 64, torch.float32),
                                          (512, 2, 16, 1, 32, 512, torch.float32),
                                          (64, 2, 16, 1, 32, 64, torch.float64)):
        xdt = torch.zeros((1, s, h, p), device=card, dtype=dtype)
        la = torch.zeros((1, s, h), device=card, dtype=dtype)
        bm = torch.zeros((1, s, g, n), device=card, dtype=dtype)
        with pytest.raises(ValueError, match="the kernel takes"):
            ssd_chunk_bwd(xdt, la, bm, bm, xdt, chunk=chunk)
    assert ssd_chunk_bwd.launches == before


@pytest.mark.parametrize("b,s,w", [(2, 2_048, 4_096), (2, 37, 100), (3, 1, 77),
                                   (2, 1_000, 4_096)])
@pytest.mark.parametrize("x_dtype,gate_dtype", [(torch.float32, torch.float32),
                                                (torch.bfloat16, torch.float32),
                                                (torch.bfloat16, torch.bfloat16)])
def test_rglru_scan_bwd_kernel_matches_plain(card, b, s, w, x_dtype, gate_dtype):
    """B9's backward against its plain version on the forward kernel's y,
    with a nonzero h_last cotangent: dx, dr, di in their inputs' dtypes to
    the script's rule (bf16 outputs also one bf16 ulp of the element: each
    side rounds its float32 value once), dlam per element to 1e-5 of its
    term magnitude; one launch counted on x's dtype, a repeat
    bit-identical."""
    gen = torch.Generator(device=card).manual_seed(s + w + 1)
    x = _randn((b, s, w), gen, card, x_dtype)
    r = torch.sigmoid(_randn((b, s, w), gen, card)).to(gate_dtype)
    i = torch.sigmoid(_randn((b, s, w), gen, card)).to(gate_dtype)
    lam = _randn((w,), gen, card) + 4
    y, _ = rglru_scan(x, r, i, lam)
    dy, dh = _randn((b, s, w), gen, card), _randn((b, w), gen, card)
    name = str(x_dtype).removeprefix("torch.")
    before = (rglru_scan_bwd.launches, rglru_scan_bwd.route_launches[name])
    got = rglru_scan_bwd(x, r, i, lam, y, dy, dh)
    torch.cuda.synchronize()
    assert (rglru_scan_bwd.launches, rglru_scan_bwd.route_launches[name]) == (
        before[0] + 1, before[1] + 1)
    want = rglru_scan_bwd_plain(x, r, i, lam, y, dy, dh)
    for nm, gt, wt in zip(("dx", "dr", "di"), got, want):
        if gt.dtype == torch.bfloat16:
            d = (gt.double() - wt.double()).abs()
            bar = 2.0**-7 * wt.double().abs() + 1e-4 * float(wt.abs().max())
            assert gt.dtype == wt.dtype and bool((d <= bar).all()), nm
        else:
            _assert_max_close(gt, wt, nm)
    mags = rglru_scan_bwd_magnitudes(x, r, i, lam, y, dy, dh)
    _assert_each_close(got[3], want[3], mags[3], "dlam")
    again = rglru_scan_bwd(x, r, i, lam, y, dy, dh)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("name,changes", [("mamba2-780m", {}),
                                          ("recurrentgemma-9b", {"n_layers": 5})])
def test_recurrent_training_on_card_matches_host(card, name, changes):
    """The reduced SSM (2 layers) and hybrid (one period and the 2-block
    tail) families in float32: ``bundle.loss`` and every gradient leaf on the
    card (B9/B10 forward twice a checkpointed layer, their backward kernels
    once) against the host, each leaf to 1e-4 of its largest entry."""
    cfg = dataclasses.replace(registry.get(name).reduced(), **changes)
    bundle = get_bundle(cfg)
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 128, 2, seed=3)
    kernel, bwd = ((ssd_chunk, ssd_chunk_bwd) if cfg.family == "ssm"
                   else (rglru_scan, rglru_scan_bwd))
    results = []
    for dev in ("cpu", card):
        params = _tree_to(bundle.init(0, device="cpu"), dev)
        leaves = torch.utils._pytree.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        before = (kernel.launches, bwd.launches)
        loss = bundle.loss(params, {"tokens": tokens})
        grads = torch.autograd.grad(loss, leaves)
        if dev == card:
            n_rec = cfg.n_layers if cfg.family == "ssm" else 4   # 2 in the period, 2 tail
            n_remat = cfg.n_layers if cfg.family == "ssm" else 2
            assert (kernel.launches - before[0], bwd.launches - before[1]) == (
                n_rec + n_remat, n_rec)
        results.append([loss.detach().cpu()] + [g.cpu() for g in grads])
    for host, got in zip(*results):
        assert float(host.abs().max()) > 0
        assert float((got - host).abs().max()) <= 1e-4 * float(host.abs().max())


# ---- the engine, federation sessions and checkpoints on the card ----

FED_LAYERS = (9, 3, 5, 7, 9)


def _fed_cfg():
    return daef.DAEFConfig(layer_sizes=FED_LAYERS, lam_hidden=0.7, lam_last=0.9,
                           stats_backend="fused")


def test_engine_fit_on_card_is_daef_fit(card):
    """The engine's one-tenant fit and its vmap fleet fit on the card are the
    module-level fits, leaf for leaf, bit for bit; scores and labels too."""
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.train import checkpoint

    cfg = daef.DAEFConfig(layer_sizes=(10, 4, 6, 8, 10), lam_hidden=0.7, lam_last=0.9)
    x = lowrank_data(10, 4, 5_000, seed=0)
    engine = DAEFEngine(cfg, ExecutionPlan(stats_backend="fused"))
    assert engine.device.type == "cuda" and engine.config.stats_backend == "fused"
    before = rolann_stats.launches
    model = engine.fit(x, n_partitions=4)
    assert rolann_stats.launches - before == 2
    want = daef.fit(dataclasses.replace(cfg, stats_backend="fused"), x, n_partitions=4)
    for a, b in zip(checkpoint.flatten(model), checkpoint.flatten(want), strict=True):
        assert a.device.type == "cuda" and torch.equal(a, b)
    scores = engine.scores(model, x[:, :500])
    assert torch.equal(engine.classify(scores, engine.thresholds(model)),
                       (scores > engine.thresholds(model)).to(torch.int32))
    xs = np.stack([lowrank_data(10, 4, 2_000, seed=s) for s in range(4)])
    fleet_engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=4, stats_backend="fused"))
    fl = fleet_engine.fit(xs, seeds=[0, 0, 1, 1])
    fl_want = fleet._fit_fleet(dataclasses.replace(cfg, stats_backend="fused"), xs,
                               seeds=[0, 0, 1, 1])
    for a, b in zip(checkpoint.flatten(fl), checkpoint.flatten(fl_want), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("federation", ["sync", "async"])
def test_session_rounds_on_card_match_host(card, federation):
    """A sequential sync round (B1 per site and layer) and an equal-width
    async round (one fleet fit, B4) on the card against the same rounds on
    the CPU, at TOLS (tests/_torch_parity.py's assert_models_match)."""
    from _torch_parity import assert_models_match

    from repro_torch.engine import DAEFEngine, ExecutionPlan

    x = lowrank_data(9, 3, 480, seed=3)
    if federation == "sync":
        plan = ExecutionPlan(merge="sequential")
        parts = [x[:, a:b] for a, b in ((0, 100), (100, 230), (230, 350), (350, 480))]
        wrapper, launches = rolann_stats, 4 * (len(FED_LAYERS) - 3)
    else:
        plan = ExecutionPlan(federation="async", max_staleness=0)
        parts = [x[:, i * 120:(i + 1) * 120] for i in range(4)]
        wrapper, launches = rolann_stats_batched, len(FED_LAYERS) - 3
    on_card = DAEFEngine(_fed_cfg(), plan).session()
    on_host = DAEFEngine(_fed_cfg(), plan, device="cpu").session()
    before = wrapper.launches
    m_card = on_card.round(parts)
    assert wrapper.launches - before == launches
    m_host = on_host.round(parts)
    assert_models_match(m_host, m_card, 0.9)
    if federation == "async":
        m_card, m_host = on_card.round({0: parts[0]}), on_host.round({0: parts[0]})
        assert on_card.sites == on_host.sites == {0: 0, 1: 1, 2: 1, 3: 1}
        assert_models_match(m_host, m_card, 0.9)


def test_checkpoint_written_on_card_loads_on_host_bit_identical(card, tmp_path):
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.train import checkpoint

    x = lowrank_data(9, 3, 480, seed=4)
    engine = DAEFEngine(_fed_cfg(), ExecutionPlan(federation="async"))
    session = engine.session()
    session.round({"a": x[:, :200], "b": x[:, 200:]})
    model = engine.fit(x)
    host = DAEFEngine(_fed_cfg(), ExecutionPlan(federation="async"), device="cpu")
    back = host.load(engine.save(model, str(tmp_path / "model")))
    for a, b in zip(checkpoint.flatten(back), checkpoint.flatten(model), strict=True):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b.cpu())
    restored = host.load(engine.save(session, str(tmp_path / "session")))
    assert restored.sites == session.sites
    for a, b in zip(checkpoint.flatten(restored.model), checkpoint.flatten(session.model),
                    strict=True):
        assert torch.equal(a, b.cpu())


# ---- the DP release and fleet serving on the card ----

def test_dp_release_on_card_matches_host(card):
    """fit_dp on the card (B3 once per hidden layer on the fused backend)
    against the same release on the CPU under the same key: the noise is
    drawn on the host, so the draws are the same bits; the released blocks
    within 1e-4 of their largest entry, the error pools equal."""
    from repro_torch.core import threefry
    from repro_torch.privacy import PrivacySpec, dp

    cfg = _fed_cfg()
    x = lowrank_data(9, 3, 3_000, seed=5)
    spec = PrivacySpec(epsilon=8.0)
    key = threefry.PRNGKey(7)
    before = rolann_fused_chunk.launches
    m_card = dp.fit_dp(cfg, x, key, spec)
    assert rolann_fused_chunk.launches - before == len(FED_LAYERS) - 3
    m_host = dp.fit_dp(cfg, x, key, spec, device="cpu")
    assert torch.equal(dp._sym_noise(key, (9, 9), 2.0, torch.float32, card).cpu(),
                       dp._sym_noise(key, (9, 9), 2.0, torch.float32))
    for a, b in zip(m_card.layer_knowledge, m_host.layer_knowledge, strict=True):
        for leaf in ("g", "m"):
            got, want = getattr(a, leaf).cpu(), getattr(b, leaf)
            assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert m_card.train_errors.shape == m_host.train_errors.shape == (dp.ERR_POOL,)


def _served_fleet(card, k=8, m0=9):
    from repro_torch.engine import DAEFEngine, ExecutionPlan

    cfg = daef.DAEFConfig(layer_sizes=(m0, 3, 5, m0), lam_hidden=0.9, lam_last=0.9,
                          stats_backend="fused")
    xs = np.stack([lowrank_data(m0, 3, 400, seed=s) for s in range(k)])
    engine = DAEFEngine(cfg, ExecutionPlan(mode="vmap", tenants=k))
    return engine, engine.fit(xs, seeds=np.arange(k))


def test_fleet_server_graph_replay_is_eager_bit_for_bit(card):
    """warmup captures one CUDA graph per packer shape; a replay of each
    shape on random tiles equals the eager _score_tile on the same inputs
    bit for bit (NaN padding in the same places), and serving after warmup
    captures nothing new and matches the pad path."""
    from repro_torch.serving import FleetServer
    from repro_torch.serving import server as server_mod

    engine, fl = _served_fleet(card)
    server = FleetServer(engine, fl, tile_width=16, rule="q90")
    n = server.warmup()
    assert n == len(server.packer.shapes()) == len(server._graphs)
    assert server.probe_donation().ok is True
    mus = torch.as_tensor(server.thresholds, device=card)
    gen = np.random.default_rng(0)
    for (s, t), graph in server._graphs.items():
        x = torch.from_numpy(gen.normal(size=(s, 9, t)).astype(np.float32))
        meta = torch.stack([torch.from_numpy(gen.integers(0, 8, size=s)),
                            torch.from_numpy(gen.integers(0, t + 1, size=s))])
        errs, flags = graph.replay(x.pin_memory(), meta.pin_memory())
        want_errs, want_flags = server_mod._score_tile(
            engine.config, server._leaves, x.to(card), meta[0].to(card), meta[1].to(card), mus)
        assert torch.equal(torch.isnan(errs), torch.isnan(want_errs))
        assert torch.equal(torch.nan_to_num(errs), torch.nan_to_num(want_errs))
        assert torch.equal(flags, want_flags)
    reqs = [lowrank_data(9, 3, 2 + 5 * t, seed=t) for t in range(8)]
    rids = [server.submit(t, x) for t, x in enumerate(reqs)]
    server.flush()
    assert len(server._graphs) == n
    counts = np.array([x.shape[1] for x in reqs])
    batch = np.zeros((8, 9, counts.max()), np.float32)
    for t, x in enumerate(reqs):
        batch[t, :, : counts[t]] = x
    pad = engine.scores(fl, batch, n_valid=counts).cpu().numpy()
    for t, rid in enumerate(rids):
        res = server.take(rid)
        np.testing.assert_allclose(res.scores, pad[t, : counts[t]], rtol=1e-5, atol=1e-6)


def test_fleet_server_on_card_matches_host_and_refits(card):
    """The card's server against the CPU server on the same fleet (flags
    within ties), then partial_fit (B4) refills the captured buffers in
    place: the graphs' scores follow the new fleet."""
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.engine import DAEFEngine, ExecutionPlan
    from repro_torch.serving import FleetServer

    engine, fl = _served_fleet(card)
    host_engine = DAEFEngine(engine.config, engine.plan, device="cpu")
    from repro_torch.train import checkpoint

    host_fl = checkpoint.map_leaves(lambda t: t.cpu(), fl)
    assert isinstance(host_fl, fleet_mod.DAEFFleet) and host_fl.seeds.device.type == "cpu"
    reqs = [lowrank_data(9, 3, 5 + 3 * t, seed=20 + t) for t in range(8)]
    results = []
    for eng, state in ((engine, fl), (host_engine, host_fl)):
        server = FleetServer(eng, state, tile_width=8, rule="q90")
        server.warmup()
        rids = [server.submit(t, x) for t, x in enumerate(reqs)]
        server.flush()
        results.append([server.take(r) for r in rids])
        if eng is engine:
            card_server = server
    for a, b in zip(*results):
        np.testing.assert_allclose(a.scores, b.scores, rtol=1e-4, atol=1e-5)
    n_graphs = len(card_server._graphs)
    before = rolann_stats_batched.launches
    new = card_server.partial_fit(np.stack([lowrank_data(9, 3, 64, seed=40 + t)
                                            for t in range(8)]))
    assert rolann_stats_batched.launches - before == 1  # one hidden decoder layer
    assert len(card_server._graphs) == n_graphs and card_server.stats["recalibrations"] == 1
    rids = [card_server.submit(t, x) for t, x in enumerate(reqs)]
    card_server.flush()
    counts = np.array([x.shape[1] for x in reqs])
    batch = np.zeros((8, 9, counts.max()), np.float32)
    for t, x in enumerate(reqs):
        batch[t, :, : counts[t]] = x
    pad = engine.scores(new, batch, n_valid=counts).cpu().numpy()
    for t, rid in enumerate(rids):
        res = card_server.take(rid)
        assert res.cached_cols == 0
        np.testing.assert_allclose(res.scores, pad[t, : counts[t]], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The iterative AE baseline: its step as one CUDA graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,n,bs", [((33, 25, 20, 15, 20, 25, 33), 203, 64),
                                        ((9, 7, 5, 7, 9), 1_000, 128)])
def test_ae_graphed_step_is_the_eager_step(card, sizes, n, bs):
    """A fit replaying the captured step gives the eager fit's bits on the
    card (same kernels in the same order); the warm-up before the capture
    leaves the state as it was; both are within 1e-4 of each leaf's largest
    entry of the host's fit."""
    from repro_torch.baselines import autoencoder

    x = lowrank_data(sizes[0], 3, n, seed=5)
    cfg = autoencoder.AEConfig(layer_sizes=sizes, epochs=4, batch_size=bs)
    graphed, _ = autoencoder.fit(cfg, x)
    eager, _ = autoencoder.fit(cfg, x, graph=False)
    host, _ = autoencoder.fit(cfg, x, device="cpu")
    for g, e, h in zip(graphed.weights + graphed.biases, eager.weights + eager.biases,
                       host.weights + host.biases, strict=True):
        assert g.device.type == "cuda" and torch.equal(g, e)
        h = h.numpy()
        np.testing.assert_allclose(g.cpu().numpy(), h, rtol=0, atol=1e-4 * np.abs(h).max())
    assert torch.equal(graphed.train_errors, eager.train_errors)
    test = autoencoder.reconstruction_error(cfg, graphed, x[:, :50])
    assert test.shape == (50,) and bool(torch.isfinite(test).all())


# ---------------------------------------------------------------------------
# repro_torch.analysis's guard where graphs capture and kernels load
# ---------------------------------------------------------------------------

def test_analysis_warmup_captures_one_graph_a_shape_and_serving_none(card):
    from repro_torch.analysis.__main__ import retrace_serve

    out = retrace_serve("cuda")
    assert out["warmup"].traces == out["shapes"] > 0
    assert (out["serve"].traces, out["serve"].compiles) == (0, 0)


def test_analysis_autoencoder_fit_captures_its_step_once(card):
    from repro_torch.analysis import retrace
    from repro_torch.baselines import autoencoder

    cfg = autoencoder.AEConfig(layer_sizes=(6, 3, 6), epochs=2, batch_size=8)
    x = np.random.default_rng(0).normal(size=(6, 32)).astype(np.float32)
    for _ in range(2):
        with retrace.trace_guard() as rep:
            autoencoder.fit(cfg, x, device="cuda")
        assert rep.traces == 1 and rep.traced_names[-1] == "autoencoder._Trainer.step"


def test_analysis_chunked_fleet_fit_loads_flat_in_chunks(card):
    from repro_torch.analysis import retrace
    from repro_torch.kernels import _build

    cfg = daef.DAEFConfig(layer_sizes=(6, 3, 4, 6), lam_hidden=0.9, lam_last=0.9,
                          stats_backend="fused")
    xs = np.random.default_rng(21).normal(size=(2, 6, 128)).astype(np.float32)
    counts = []
    for chunk in (32, 16):
        _build.clear_loaded()
        with retrace.trace_guard() as rep:
            fleet._fit_fleet_chunked(cfg, xs, chunk_samples=chunk, seeds=np.arange(2),
                                     device="cuda")
        counts.append(rep.compiles)
    assert counts[0] == counts[1] > 0
    with retrace.trace_guard(max_traces=0, max_compiles=0):
        fleet._fit_fleet_chunked(cfg, xs, chunk_samples=16, seeds=np.arange(2), device="cuda")


def test_analysis_donation_reports_are_effective(card):
    from repro_torch.analysis.__main__ import donation_reports

    assert [r.ok for r in donation_reports("cuda")] == [True, True]


# granite-20b and mistral-nemo-12b (chip_smoke.py phase 25), smaller: their
# quirks at a reduced width (tests/test_torch_dense_variants.py's configs)
DENSE_VARIANTS = {"granite": ("granite-20b", dict(n_heads=8, n_kv_heads=1, head_dim=32)),
                  "mistral": ("mistral-nemo-12b", dict(n_heads=4, n_kv_heads=2, head_dim=48))}


def test_rope_on_card_is_the_hosts(card):
    """RoPE's inverse frequencies of every registry architecture and of the
    reduced variants bit for bit the host's (float64, rounded once; head
    sizes 48 and 1,536 are not powers of two, where the card's float32
    quotient by a scalar is an ulp off), and ``apply_rope`` up to position
    524,287 within a few float32 ulps of the host's (each side's sin and
    cos of angles of ~5e5 rad)."""
    pairs = {(c.head_dim, c.rope_theta) for c in registry.ARCHS.values()}
    for head_dim, theta in sorted(pairs | {(32, 1e4), (48, 1e6)}):
        got = common.rope_frequencies(head_dim, theta, card)
        assert torch.equal(got.cpu(), common.rope_frequencies(head_dim, theta)), head_dim
    x = torch.randn((2, 8, 4, 128), generator=torch.Generator().manual_seed(5))
    pos = torch.tensor([0, 63, 4_095, 32_767, 131_071, 524_280, 524_286, 524_287])
    got = common.apply_rope(x.to(card), pos.to(card), 1e6).cpu()
    assert float((got - common.apply_rope(x, pos, 1e6)).abs().max()) <= 2e-6


def test_stacked_bf16_init_on_card_holds_no_float32_copy(card):
    """A stacked leaf drawn in bf16 takes its own bytes and one float32
    layer slice at most, not a float32 copy of the stack (granite-20b's bf16
    init on one 80 GB card needs it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    w = common.dense_init(torch.Generator(device=card).manual_seed(0), (1_024, 4_096),
                          torch.bfloat16, lead=(8,))
    torch.cuda.synchronize()
    slice_bytes = 1_024 * 4_096 * 4
    assert w.dtype == torch.bfloat16 and w.shape == (8, 1_024, 4_096)
    assert torch.cuda.max_memory_allocated() - base <= w.numel() * 2 + slice_bytes + 2**20


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dense_variant_attention_matches_plain(card, dtype):
    """B8 at granite-20b's group of 48 query heads over one KV head (1 x
    1,024), per element against its plain version; B7 at 1 x 32,768 with
    mistral-nemo's 32 query heads over 8 on the stripe of the last 512 query
    rows of two query heads (``q_offset``), under the bars of the tests
    above (bf16: one ulp an element; float32 1e-5 of max(1, max|ref|))."""
    gen = torch.Generator(device=card).manual_seed(48)
    q, do = (_randn((1, 1_024, 48, 128), gen, card, dtype) for _ in range(2))
    k, v = (_randn((1, 1_024, 1, 128), gen, card, dtype) for _ in range(2))
    out, lse = flash_attention(q, k, v)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    _assert_bwd_close(got, flash_attention_bwd_ref(q, k, v, out, lse, do),
                      flash_attention_bwd_magnitudes(q, k, v, out, lse, do))
    s, rows = 32_768, 512
    q = _randn((1, s, 32, 128), gen, card, dtype)
    k, v = (_randn((1, s, 8, 128), gen, card, dtype) for _ in range(2))
    out, lse = flash_attention(q, k, v)
    ref, ref_lse = flash_attention_ref(q[:, -rows:, 30:], k[:, :, 7:], v[:, :, 7:],
                                       q_offset=s - rows)
    diff = (out[:, -rows:, 30:].float() - ref.float()).abs()
    if dtype == torch.bfloat16:
        assert bool((diff <= 2.0**-7 * ref.float().abs() + 2.0**-7 * 1e-2).all())
    else:
        assert float(diff.max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((lse[:, 30:, -rows:] - ref_lse).abs().max()) <= \
        1e-5 * float(ref_lse.abs().max())


@pytest.mark.parametrize("case", sorted(DENSE_VARIANTS))
def test_dense_variant_long_decode_on_card_matches_host(card, case):
    """chip_smoke.py phase 25 (d) at a reduced width: long_500k's
    sliding-window variant (the window cut to 16) from one seeded ring, 8
    decode steps at positions 524,280-524,287 on the card and on the host,
    each step's logits within 1e-4 of their largest entry."""
    name, changes = DENSE_VARIANTS[case]
    shape = registry.SHAPES["long_500k"]
    cfg = dataclasses.replace(registry.for_shape(registry.get(name).reduced(), shape),
                              sliding_window=16, **changes)
    bundle = get_bundle(cfg)
    params = bundle.init(0, device="cpu")
    card_params = _tree_to(params, card)
    host_cache = bundle.init_cache(2, shape.seq_len, torch.float32, device="cpu")
    assert host_cache.k.shape[2] == 16
    gen = torch.Generator().manual_seed(3)
    for t in (host_cache.k, host_cache.v):
        t.normal_(generator=gen)
    card_cache = type(host_cache)(host_cache.k.to(card), host_cache.v.to(card))
    tokens = torch.as_tensor(synthetic.lm_token_stream(cfg.vocab_size, 8, 2, seed=2))
    for t in range(8):
        pos = shape.seq_len - 8 + t
        host, host_cache = bundle.decode(params, host_cache, tokens[:, t:t + 1], pos)
        got, card_cache = bundle.decode(card_params, card_cache, tokens[:, t:t + 1], pos)
        assert float((got.cpu() - host).abs().max()) <= 1e-4 * float(host.abs().max()), pos
