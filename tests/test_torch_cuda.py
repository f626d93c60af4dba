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

from repro_torch.core import daef, fleet
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
