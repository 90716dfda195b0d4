"""The ``jax.random`` threefry stream that the serving clustering draws,
in numpy.

``reduction.pipeline.lloyd_reseed`` of the JAX package reseeds centroids
by a Gumbel top-k whose noise is ``jax.random.gumbel(fold_in(PRNGKey(seed),
it), (N,), float32)``.  Without the same noise the port's clusters, slab
layouts and every certificate would differ from the reference, and the
port does not import JAX, so this module recomputes that stream.

Reproduced settings (those of JAX 0.9.0's defaults):

- the ``threefry2x32`` PRNG implementation (``jax_default_prng_impl``);
- ``jax_threefry_partitionable=True``: the random bits of element i of a
  flat shape are ``y0 ^ y1`` of ``threefry2x32(key, (hi32(i), lo32(i)))``;
- ``jax_use_high_dynamic_range_gumbel=False``: ``gumbel`` (``mode=None``)
  takes the low mode, ``-log(-log(uniform(tiny, 1)))``;
- ``uniform`` in float32: the top 23 bits as the mantissa of a float in
  [1, 2), minus 1, scaled to [minval, maxval) and clamped below by minval.

Seeds and counters are non-negative and below 2**31, where ``PRNGKey``
gives the same key with and without ``jax_enable_x64``.  The two logs are
XLA's CPU float32 log, which is not correctly rounded: the Cephes
polynomial in the order XLA evaluates it, with the fused multiply-adds it
compiles for an x86 CPU with FMA (``log32``).  A correctly rounded log
differs from it in the last bit of about a fifth of the values.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)
    under ``key`` = (k0, k1), all uint32."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, dtype=np.uint32) + ks[0]
    x1 = np.asarray(x1, dtype=np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31: (0, seed)."""
    if not 0 <= int(seed) < 2 ** 31:
        raise ValueError(f"seed {seed} outside [0, 2**31)")
    return 0, int(seed)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the hash of the counter pair
    (0, data)."""
    if not 0 <= int(data) < 2 ** 32:
        raise ValueError(f"fold_in data {data} outside [0, 2**32)")
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                              np.full(1, data, np.uint32))
    return int(y0[0]), int(y1[0])


def random_bits(key, n: int) -> np.ndarray:
    """32 random bits for each of n elements (a flat shape (n,))."""
    i = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        y0, y1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                              i.astype(np.uint32))
    return y0 ^ y1


def uniform(key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    f32 = np.float32
    bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _fma32(a, b, c) -> np.ndarray:
    """float32 fma(a, b, c), rounded once: a * b is exact in float64, the
    sum's float64 rounding error comes from TwoSum, and it decides the
    float32 rounding where the float64 sum sits on a float32 midpoint."""
    f64 = np.float64
    p = np.asarray(a, f64) * np.asarray(b, f64)
    c = np.asarray(c, f64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    r = s.astype(np.float32)
    d = s - r.astype(f64)
    nb = np.nextafter(r, np.where(d > 0, np.inf, -np.inf).astype(np.float32))
    tie = (d != 0) & (d == (nb.astype(f64) - r.astype(f64)) * 0.5)
    return np.where(tie & (err != 0) & (np.sign(err) == np.sign(d)), nb, r)


_f32 = np.float32
_SQRTHF = _f32(0.707106781186547524)
_P = tuple(_f32(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_Q1, _Q2 = _f32(-2.12194440e-4), _f32(0.693359375)


def log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 natural log of positive finite x."""
    x = np.maximum(np.asarray(x, _f32), np.finfo(_f32).tiny)
    bits = x.view(np.uint32)
    e = ((bits >> np.uint32(23)).astype(np.int32) - 127).astype(_f32) + 1
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(_f32)
    low = m < _SQRTHF
    x = (m - _f32(1)) + np.where(low, m, _f32(0))
    e = e - np.where(low, _f32(1), _f32(0))
    x2 = x * x
    x3 = x2 * x
    y = _fma32(_fma32(_P[0], x, _P[1]), x, _P[2])
    y1 = _fma32(_fma32(_P[3], x, _P[4]), x, _P[5])
    y2 = _fma32(_fma32(_P[6], x, _P[7]), x, _P[8])
    y = _fma32(x3, y, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(x3, y, e * _Q1)
    xm = _fma32(_f32(-0.5), x2, x)
    return _fma32(_Q2, e, xm + y)


def gumbel(key, n: int) -> np.ndarray:
    """``jax.random.gumbel(key, (n,), float32)`` (low mode)."""
    u = uniform(key, n, minval=float(np.finfo(np.float32).tiny))
    return -log32(-log32(u))
