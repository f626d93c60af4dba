"""Tests of the port that need the CUDA card (marker ``cuda``).

They skip without a card.  On the card's machine, from the repo root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only (no jax), so it runs where jax is
not installed.
"""
import numpy as np
import pytest
import torch

from _torch_parity import lowrank_data

from repro_torch.core import daef
from repro_torch.kernels.rolann_stats import ops, rolann_stats, rolann_stats_plain

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
