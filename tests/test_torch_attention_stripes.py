"""B7's and B8's plain versions at a query offset, against the reference's
``attend_chunked(..., q_offset=)`` and its VJP, on the CPU.

The sequence-parallel attention (``models/attention.py``) attends each
model rank's stripe of Sq = S / ext query rows, at ``q_offset = rank·Sq``,
against the full K/V: ``flash_attention(q, k, v, q_offset=...)``, whose
plain version (``kernels/flash_attention/ref.py``) runs here and is the one
the CUDA kernels are held to on the card (``chip_smoke.py``).  The
reference's twin of the stripe is ``attend_chunked`` with the same
``q_offset`` (``src/repro/models/attention.py``), differentiated with
``jax.vjp``.

Cases: causal and windowed, offsets 0, S/4 and 3S/4 of a stripe of S/4
rows, GQA (4 query heads over 2 KV heads).  Tolerance: ``TOLS`` float32
(the two sides sum the same float32 products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.models import attention as jattention
from repro_torch.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_ref,
)

B, S, H, HKV, D = 2, 64, 4, 2, 16
SQ = S // 4


def _inputs(offset, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, SQ, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, S, HKV, D)).astype(np.float32)
    do = rng.normal(size=(B, SQ, H, D)).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, window, offset):
    return lambda q, k, v: jattention.attend_chunked(
        q, k, v, causal=True, window=window, q_block=8, kv_block=16, q_offset=offset)


@pytest.mark.parametrize("window", [None, 12], ids=["causal", "windowed"])
@pytest.mark.parametrize("offset", [0, S // 4, 3 * S // 4])
def test_stripe_forward_and_backward_match_attend_chunked(offset, window):
    q, k, v, do = _inputs(offset, seed=offset + (window or 0))
    fn = _reference(q, k, v, window, offset)
    jout, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(do))

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, window=window, q_offset=offset)
    assert tuple(out.shape) == (B, SQ, H, D) and tuple(lse.shape) == (B, H, SQ)
    assert_close(out, jout, what="out")
    dq, dk, dv = flash_attention_bwd(tq, tk, tv, out, lse, torch.from_numpy(do),
                                     window=window, q_offset=offset)
    assert tuple(dk.shape) == (B, S, HKV, D)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert_close(got, want, what=name)
    if window is not None or offset < 3 * S // 4:
        # keys past the stripe's last position get no gradient
        assert not dk[:, offset + SQ:].any() and not dv[:, offset + SQ:].any()


def test_stripe_autograd_is_the_plain_backward():
    """Through ``FlashAttention`` (the train path) the gradients are the
    plain backward's, and ``q_offset = 0`` with Sq = Sk is the square case."""
    q, k, v, do = _inputs(16, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, _ = flash_attention(tq, tk, tv, q_offset=16)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    with torch.no_grad():
        o, lse = flash_attention_ref(tq, tk, tv, q_offset=16)
        want = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(), o, lse,
                                   torch.from_numpy(do), q_offset=16)
    for g, w in zip(grads, want, strict=True):
        assert torch.equal(g, w)
    square = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 8, 2, 16)).astype(
        np.float32))
    a, _ = FlashAttention.apply(square, square, square, True, None)
    b, _ = FlashAttention.apply(square, square, square, True, None, 0)
    assert torch.equal(a, b)


def test_stripe_outside_the_keys_is_refused():
    q, k, v, _ = _inputs(0, seed=0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for bad in (-1, S - SQ + 1):
        with pytest.raises(ValueError, match="do not lie"):
            flash_attention(tq, tk, tv, q_offset=bad)
