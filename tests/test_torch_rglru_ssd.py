"""The RG-LRU scan (B9) and the SSD chunk scan (B10) against the JAX
package, on the CPU.

On CPU tensors the port's ``rglru_scan`` and ``ssd_chunk`` run their plain
versions; the CUDA kernels are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here the plain versions
meet the reference's Pallas kernels in interpret mode (as
``tests/test_kernels.py`` runs them), their ``ref.py`` oracles and the model
layers' own scans (``rglru.rg_lru``, ``mamba2.ssd_chunked``), on the same
numpy inputs.

Tolerances: ``TOLS`` float32 (atol = rtol = 1e-4) for the RG-LRU, whose
outputs are O(1) running sums of O(1) terms.  The SSD outputs are sums over
a chunk of up to Q·N products (values up to ~1e2 here), taken in other
orders (a sequential scan, a blocked kernel, einsums): they are held to
``assert_sum_close`` (atol 1e-4 × max|reference|, rtol 1e-4), the repo's
rule for sums (``tests/_torch_parity.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, assert_sum_close

from repro.kernels.rglru_scan import rglru_scan as jrglru_scan
from repro.kernels.rglru_scan import rglru_scan_ref as jrglru_ref
from repro.kernels.ssd_chunk import ssd_chunk as jssd_chunk
from repro.kernels.ssd_chunk import ssd_chunk_ref as jssd_ref
from repro.models import mamba2 as jmamba2
from repro.models import rglru as jrglru
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_chunk import fit_chunk, ssd_chunk, ssd_chunk_plain, ssd_chunk_ref
from repro_torch.models import mamba2, rglru


def _rglru_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, w)).astype(np.float32)
    r = (1 / (1 + np.exp(-rng.normal(size=(b, s, w))))).astype(np.float32)
    i = (1 / (1 + np.exp(-rng.normal(size=(b, s, w))))).astype(np.float32)
    lam = (rng.normal(size=(w,)) + 4).astype(np.float32)
    return x, r, i, lam


@pytest.mark.parametrize("b,s,w", [(2, 48, 64), (1, 16, 96), (3, 128, 32)])
def test_rglru_plain_matches_pallas_kernel_and_oracle(b, s, w):
    x, r, i, lam = _rglru_inputs(b, s, w, seed=s + w)
    y, h = rglru_scan(*map(torch.from_numpy, (x, r, i, lam)))
    jy, jh = jrglru_scan(*map(jnp.asarray, (x, r, i, lam)), block_s=16, block_w=32)
    assert_close(y, jy, what="y vs the Pallas kernel")
    assert_close(h, jh, what="h_last vs the Pallas kernel")
    ry, rh = jrglru_ref(*map(jnp.asarray, (x, r, i, lam)))
    assert_close(y, ry, what="y vs rglru_scan_ref")
    assert_close(h, rh, what="h_last vs rglru_scan_ref")


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_model_layer(with_h0):
    """The port's ``rglru.rg_lru`` (the plain route) against the reference
    layer's associative scan, with and without an initial state."""
    x, r, i, lam = _rglru_inputs(2, 16, 48, seed=5)
    h0 = np.random.default_rng(6).normal(size=(2, 48)).astype(np.float32) if with_h0 else None
    y, h = rglru.rg_lru(*map(torch.from_numpy, (x, r, i, lam)),
                        None if h0 is None else torch.from_numpy(h0))
    jy, jh = jrglru.rg_lru(*map(jnp.asarray, (x, r, i, lam)),
                           None if h0 is None else jnp.asarray(h0))
    assert_close(y, jy, what="y")
    assert_close(h, jh, what="h_last")


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(b, s, h, p)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(b, s, h))) * 0.3).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return xdt, la, bm, cm


def _fold(t, h):
    """Model layout [B, S, G or H, X] -> the reference kernel's [B·H, S, X]."""
    b, s = t.shape[:2]
    t = np.repeat(t, h // t.shape[2], axis=2)
    return jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * h, s, t.shape[3]))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 16)])
def test_ssd_plain_matches_pallas_kernel_and_oracle(g, s, chunk):
    b, h, p, n = 2, 4, 8, 16
    xdt, la, bm, cm = _ssd_inputs(b, s, h, p, g, n, seed=s + g)
    y, hf = ssd_chunk(*map(torch.from_numpy, (xdt, la, bm, cm)), chunk=chunk)
    assert tuple(y.shape) == (b, s, h, p) and tuple(hf.shape) == (b, h, p, n)
    jla = jnp.asarray(la.transpose(0, 2, 1).reshape(b * h, s))
    args = (_fold(xdt, h), jla, _fold(bm, h), _fold(cm, h))
    for what, (jy, jh) in (("Pallas kernel", jssd_chunk(*args, chunk=chunk)),
                           ("ssd_chunk_ref", jssd_ref(*args))):
        jy = np.asarray(jy).reshape(b, h, s, p).transpose(0, 2, 1, 3)
        assert_sum_close(y, jy, what=f"y vs the {what}")
        assert_sum_close(hf, np.asarray(jh).reshape(b, h, p, n), what=f"h_final vs the {what}")


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_matches_model_layer(g):
    """The port's ``mamba2.ssd_chunked`` (the plain route, the reference's
    signature) against the reference layer's."""
    rng = np.random.default_rng(10 + g)
    b, s, h, p, n = 2, 64, 4, 8, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, s, h))) + 0.1).astype(np.float32)
    a = (np.abs(rng.normal(size=(h,))) + 0.1).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    y, hf = mamba2.ssd_chunked(*map(torch.from_numpy, (x, dt, a, bm, cm)), 16)
    jy, jh = jmamba2.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)), chunk=16)
    assert_sum_close(y, jy, what="y")
    assert_sum_close(hf, jh, what="final state")


def test_ssd_sequential_oracle_and_chunk_rule():
    """The port's own oracle against its chunked plain version, and the
    reference's chunk rule (min(chunk, S), lowered until it divides S)."""
    xdt, la, bm, cm = map(torch.from_numpy, _ssd_inputs(1, 30, 3, 4, 1, 8, seed=2))
    y, hf = ssd_chunk(xdt, la, bm, cm, chunk=16)  # 30 % 16 -> chunk 15
    ry, rh = ssd_chunk_ref(xdt, la, bm, cm)
    assert_sum_close(y, ry, what="y")
    assert_sum_close(hf, rh, what="h_final")
    assert (fit_chunk(30, 16), fit_chunk(4096, 256), fit_chunk(4000, 256), fit_chunk(7, 256)) \
        == (15, 256, 250, 7)
    with pytest.raises(ValueError, match="does not divide"):
        ssd_chunk_plain(xdt, la, bm, cm, 16)
    with pytest.raises(ValueError, match="heads over"):
        ssd_chunk(xdt, la, torch.cat([bm, bm], 2), torch.cat([cm, cm], 2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_cpu_path_did_not_move(monkeypatch, dtype):
    """The hybrid's recurrent block hands rglru_scan the backbone's x, r and
    i uncast (the card's kernel widens bf16 itself); on the CPU the wrapper
    widens them, so a reduced recurrentgemma's hidden states and prefill
    logits are the same bits as with the float32 casts at the call site.
    In bf16 every parameter is cast, lam too, as a caller may do."""
    from torch.utils import _pytree as pytree

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import get_bundle

    cfg = registry.get("recurrentgemma-9b").reduced()
    bundle = get_bundle(cfg)
    params = pytree.tree_map(lambda t: t.to(dtype), bundle.init(0, device="cpu"))
    tokens = synthetic.lm_token_stream(cfg.vocab_size, 80, 2, seed=5)
    got = bundle.forward(params, tokens), bundle.prefill(params, {"tokens": tokens})
    monkeypatch.setattr(rglru, "rglru_scan", lambda x, r, i, lam: rglru_scan(
        x.float(), r.float(), i.float(), lam))
    want = bundle.forward(params, tokens), bundle.prefill(params, {"tokens": tokens})
    for a, b in zip(got, want, strict=True):
        assert a.dtype == dtype and torch.equal(a, b)
