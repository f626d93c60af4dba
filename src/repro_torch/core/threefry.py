"""The part of ``jax.random`` that the DAEF fit draws from, in torch integer ops.

Every federated node derives its stage-1 ELM-AE weights from the shared seed
(``daef.layer_keys_from_seed`` -> ``elm_ae.stage1``).  For a fit in this port
to match the JAX reference -- and for a federation that mixes JAX and torch
sites to agree on those weights -- the port must draw the same bits as
``jax.random``.  This module reproduces, bit for bit, the default
``threefry2x32`` generator of jax 0.9 with ``jax_threefry_partitionable``
on: ``PRNGKey``, ``split``, ``fold_in``, ``random_bits`` (32-bit),
``uniform`` and ``normal``.

Keys are int64 tensors of shape ``[2]`` holding the two uint32 words of a
JAX key; ``numpy.asarray(jax_key).astype(np.int64)`` gives the same values.
A batch of keys ``[..., 2]`` (a tenant fleet's) draws for every key in one
call: each function then returns its result with the batch's leading axes
in front, the bits ``jax.vmap`` of the same call gives.  Everything runs on
the host: the matrices drawn in a fit are at most a few hundred entries per
key, so callers move the result to the card.

Floating draws are float32, JAX's default.  A float64 request gets the
float32 draw widened; JAX in 64-bit mode would draw 64-bit bits instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000  # float32 1.0
_NMANT_F32 = 23


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def _key_words(key: torch.Tensor, ndim: int):
    """The two words of ``key`` [2] as ints, or of a key batch [..., 2] as
    tensors shaped to broadcast in front of ``ndim`` counter axes."""
    if key.ndim == 1:
        k0, k1 = (int(v) for v in key.reshape(2).tolist())
        return k0, k1
    lead = (*key.shape[:-1], *(1,) * ndim)
    return key[..., 0].reshape(lead), key[..., 1].reshape(lead)


def threefry2x32(
    key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``; all values are uint32 held in int64 tensors.  A key batch
    [..., 2] gives results of shape ``[..., *x0.shape]``."""
    k0, k1 = _key_words(key, x0.ndim)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _counters(shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-major flat index of every element of ``shape`` as (hi, lo) words
    (``jax._src.prng.iota_2x32_shape``)."""
    count = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    return count >> 32, count & _MASK


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 (jax.random's name)
    """The raw key of an integer seed: its high and low 32-bit words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64)


def prng_keys(seeds: torch.Tensor) -> torch.Tensor:
    """Keys [K, 2] of int32 seeds [K], as ``jax.vmap(jax.random.PRNGKey)``
    makes them: a 32-bit seed has no high word (0), and its low word is the
    seed's two's-complement bits."""
    lo = seeds.to(torch.int64) & _MASK
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys ``[num, 2]``: key i is threefry of the counter (0, i).
    A key batch [..., 2] gives [..., num, 2]."""
    hi, lo = _counters((num,))
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key [2] from ``key`` and the 32-bit value ``data``
    (``jax.random.fold_in``): threefry of the counter ``(0, data)``, the
    seed words ``threefry_seed`` makes of a 32-bit integer."""
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    b0, b1 = threefry2x32(key, x0, x1)
    return torch.cat([b0, b1])


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32-bit random words of ``shape`` (``jax.random.bits`` for uint32);
    ``[..., *shape]`` for a key batch [..., 2]."""
    shape = tuple(shape)
    hi, lo = _counters(shape)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0 ^ b1


def uniform(
    key: torch.Tensor,
    shape: tuple[int, ...],
    dtype: torch.dtype = torch.float32,
    minval: float | torch.Tensor = 0.0,
    maxval: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """U[minval, maxval) of ``shape``: the mantissa of 1.0 filled with the top
    23 random bits, minus one, scaled and shifted in float32 (``[..., *shape]``
    for a key batch [..., 2])."""
    bits = random_bits(key, shape)
    float_bits = (bits >> (32 - _NMANT_F32)) | _ONE_F32_BITS
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.as_tensor(minval, dtype=torch.float32)
    hi = torch.as_tensor(maxval, dtype=torch.float32)
    out = torch.maximum(lo, _fma(floats, hi - lo, lo))
    return out.to(dtype)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend fuses it:
    the float64 product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


# XLA's CPU log1p for float32: Cephes' rational form below sqrt(2) - 1 in
# magnitude, log(1 + x) above, each polynomial a chain of fused multiply-adds.
_LOG1P_SMALL = 0.41421356237309504880
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's CPU logf (Cephes' logf as Eigen's plog writes it).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
          3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_SQRT_HALF = 0.707106781186547524


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, _f32(c))
    return p


def _logf32(y: torch.Tensor) -> torch.Tensor:
    """float32 log of positive normal ``y``: split off the exponent, then a
    degree-8 polynomial of the mantissa."""
    bits = y.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    t = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = t < _f32(_SQRT_HALF)
    t = torch.where(low, (t - 1.0) + t, t - 1.0)
    e = torch.where(low, e - 1.0, e)
    x2 = t * t
    x3 = x2 * t
    p = [_f32(c) for c in _LOG_P]
    y0, y1, y2 = _fma(t, p[0], p[1]), _fma(t, p[3], p[4]), _fma(t, p[6], p[7])
    y0, y1, y2 = _fma(y0, t, p[2]), _fma(y1, t, p[5]), _fma(y2, t, p[8])
    y0 = _fma(_fma(y0, x3, y1), x3, y2)
    y0 = _fma(y0, x3, _f32(_LOG_Q1) * e)
    t = (t - 0.5 * x2) + y0
    return t + _f32(_LOG_Q2) * e


def _log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 log1p as XLA's CPU backend computes it, for x in (-1, 0]
    (``torch.log1p`` rounds about one value in ten otherwise)."""
    x2 = x * x
    small = x + (-0.5 * x2 + (x2 * x) * (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _logf32(x + 1.0))


# Giles' single-precision erfinv coefficients, highest power first, for
# w = -log1p(-x^2) below 5 and above it (XLA's ErfInv32).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by the polynomial ``jax.lax.erf_inv`` lowers to, with
    XLA's log1p, a correctly rounded square root (the CPU's vectorised
    ``torch.sqrt`` is not) and the same fused multiply-adds: the
    reference's bits for every x in (-1, 1) checked."""
    w = -_log1p32(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, w.double().sqrt().float() - 3.0)

    def coeff(i: int) -> torch.Tensor:
        lt = torch.tensor(_ERFINV_LT5[i], dtype=torch.float32)
        ge = torch.tensor(_ERFINV_GE5[i], dtype=torch.float32)
        return torch.where(small, lt, ge)

    p = coeff(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coeff(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(
    key: torch.Tensor, shape: tuple[int, ...], dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """N(0, 1) of ``shape``: ``sqrt(2) * erfinv(u)``, u uniform on (-1, 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, torch.float32, lo, 1.0)
    out = torch.tensor(math.sqrt(2), dtype=torch.float32) * _erfinv32(u)
    return out.to(dtype)
