"""The flash-attention forward (B7) and the attention layer against the JAX
package, on the CPU.

On a CPU tensor the port's ``flash_attention`` runs its plain version
(``kernels/flash_attention/ref.py``); the CUDA kernel is held against that
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here
the plain version meets the reference's Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it), its ``flash_attention_ref`` oracle and
the model layer's attention, on the same numpy inputs.

Tolerance: ``TOLS`` float32 (atol = rtol = 1e-4); the two sides sum the same
float32 products in other orders (one [S, S] softmax against blocks of an
online softmax), a difference of a few float32 ulps on O(1) outputs.

The bf16 kernels' arithmetic (bf16 operands, float32 accumulation per
16-deep wgmma step, P and dS as hi + lo bf16 pairs) is modelled in plain
torch by ``tests/_flash_emulation.py`` and held here to the plain versions
under the card's unchanged bars (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _flash_emulation as emulation
from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_attention_ref as jflash_ref
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.models import attention as jattention
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref, ops
from repro_torch.models import attention


def _qkv(b, s, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))


def _fold(x, h):
    """[B, S, Hkv, D] -> the reference kernel's [B·H, S, D] (GQA repeat)."""
    b, s, hkv, d = x.shape
    x = np.repeat(x, h // hkv, axis=2)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_matches_pallas_kernel(groups, window):
    q, k, v = _qkv(2, 64, 4, 4 // groups, 16, seed=groups * 10 + (window or 0))
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    jout, jlse = flash_attention_kernel(_fold(q, 4), _fold(k, 4), _fold(v, 4), window=window,
                                        block_q=32, block_k=32, interpret=True)
    jout = np.asarray(jout).reshape(2, 4, 64, 16).transpose(0, 2, 1, 3)
    assert_close(out, jout, what="out vs the Pallas kernel")
    assert tuple(lse.shape) == (2, 4, 64) and lse.dtype == torch.float32
    assert_close(lse.reshape(8, 64), jlse, what="lse vs the Pallas kernel")


def test_plain_matches_pallas_wrapper():
    """The reference's GQA wrapper around the kernel (the model layout)."""
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=5)
    out, _ = flash_attention(*map(torch.from_numpy, (q, k, v)))
    ref = jflash(*map(jnp.asarray, (q, k, v)), block_q=32, block_k=32)
    assert_close(out, ref, what="out vs the Pallas wrapper")


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("groups", [1, 2])
def test_plain_matches_oracle_at_ragged_s(groups, window):
    """S = 50 (the Pallas kernel asserts S % block == 0; its oracle does not)."""
    q, k, v = _qkv(2, 50, 4, 4 // groups, 16, seed=7 + groups)
    out, _ = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    ref = jflash_ref(_fold(q, 4), _fold(k, 4), _fold(v, 4), window=window)
    ref = np.asarray(ref).reshape(2, 4, 50, 16).transpose(0, 2, 1, 3)
    assert_close(out, ref, what="out vs flash_attention_ref")


@pytest.mark.parametrize("window", [None, 24])
def test_plain_matches_model_attention(window):
    """The model layer's own attention routes: direct and chunked."""
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=3)
    out, _ = flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    assert_close(out, jattention.attend_full(jq, jk, jv, window=window), what="attend_full")
    assert_close(out, jattention.attend_chunked(jq, jk, jv, window=window, q_block=16,
                                                kv_block=16), what="attend_chunked")


def test_wrapper_rejects_bad_inputs():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 4, 3, 8, seed=0))
    with pytest.raises(ValueError, match="query heads over"):
        flash_attention(q, k, v)
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 4, 2, 8, seed=0))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v)
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    out, lse = flash_attention_ref(q, k, v)
    assert out.dtype == q.dtype and tuple(lse.shape) == (1, 4, 8)


@pytest.mark.parametrize("name,window", [("qwen3-1.7b", None), ("recurrentgemma-9b", 40)])
def test_attention_block_matches_reference(name, window):
    """Projections, qk-norm, RoPE, GQA/MQA attention and the output
    projection of the reduced config, with the reference's own weights."""
    jcfg, cfg = jregistry.get(name).reduced(), registry.get(name).reduced()
    jp = jattention.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    x = np.random.default_rng(2).normal(size=(2, 72, jcfg.d_model)).astype(np.float32)
    jout, (jk, jv) = jattention.attention_block(jp, jcfg, jnp.asarray(x), window=window)
    tp = {k2: (jax.tree.map(lambda a: torch.from_numpy(np.array(a)), v2))
          for k2, v2 in jp.items()}
    out, (k, v) = attention.attention_block(tp, cfg, torch.from_numpy(x), window=window)
    assert_close(k, jk, what="k")
    assert_close(v, jv, what="v")
    assert_close(out, jout, what="attention block")


@pytest.mark.parametrize("s,h,hkv,d,window", emulation.CASES)
def test_tensor_core_forward_model_within_the_bars(s, h, hkv, d, window):
    """B7's bf16 arithmetic (P as hi + lo) against the plain forward: every
    output element within one bf16 ulp, 2^-7·|ref| + 2^-7·1e-2, and lse
    within 1e-5 of its largest magnitude: the bars of the card's checks."""
    q, k, v, _ = emulation.inputs(s, h, hkv, d, seed=s + d)
    out_share, lse_share = emulation.forward_share(q, k, v, window, split=True)
    assert out_share <= 1.0 and lse_share <= 1.0, (out_share, lse_share)


@pytest.mark.parametrize("s,h,hkv,d,window", emulation.CASES)
def test_tensor_core_backward_model_within_the_bars(s, h, hkv, d, window):
    """B8's bf16 arithmetic (P and dS as hi + lo) against the plain
    backward: every element of dq, dk and dv within one bf16 ulp plus 2e-5
    of its term magnitude, the bar of the card's checks."""
    q, k, v, do = emulation.inputs(s, h, hkv, d, seed=s + d)
    assert emulation.backward_share(q, k, v, do, window, split=True) <= 1.0


def test_strides_of_single_entry_axes_are_contiguous():
    """An axis of one entry is never stepped along; the kernels get its
    contiguous stride, whatever the view reports (TMA takes only strides of
    whole 16 bytes)."""
    x = torch.zeros((2, 5, 4, 32), dtype=torch.bfloat16)
    strides = list(ops._strides(x[:, :1], x[:, :1, :2], x[:1, :, :1]))
    assert strides == [640, 128, 32, 640, 64, 32, 160, 128, 32]


def test_tma_check_names_the_stride_or_address_it_refuses():
    buf = torch.zeros((1, 100, 2 * 64 + 4), dtype=torch.bfloat16)
    ops._check_tma("f", q=buf[:, :1, :128].unflatten(-1, (2, 64)))   # one row: no stride
    with pytest.raises(ValueError, match="q's sequence stride .132 elements"):
        ops._check_tma("f", q=buf[:, :, :128].unflatten(-1, (2, 64)))
    with pytest.raises(ValueError, match="k's data is not 16-byte aligned"):
        ops._check_tma("f", k=buf.flatten()[1:1 + 100 * 128].view(1, 100, 2, 64))
