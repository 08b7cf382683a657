"""The JAX package's random draws in numpy: the threefry-2x32 PRNG of
``jax.random`` (its default implementation, with
``jax_threefry_partitionable`` on, as JAX 0.9 sets it) and the samplers
the models' initializers use.

A seed names a run. The port's own initializers draw from
``torch.Generator``, so a port run and a JAX run of one seed start from
different weights. Where a result depends on the starting draw itself
(the convergence protocol, ``tools/converge.py``, whose FM run lands in
one basin or another by it), `models.jax_init` rebuilds the JAX
package's initial weights of the seed from these draws.

- keys, `split`, `fold_in` and the 32-bit random bits are bitwise JAX's;
- `uniform` is JAX's float32 uniform, from the same bits, to within an
  ulp or two of its range (XLA may fuse the scale and the shift);
- `normal` and `truncated_normal` map uniforms through ``erfinv`` as JAX
  does; their ``erf``/``erfinv`` are float64 here and rounded to float32,
  so a value may differ from JAX's by an ulp or so.

Keys are uint32 arrays of shape [2].
"""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data in JAX's default 32-bit mode: the
    seed taken as a 32-bit integer, so [0, seed mod 2³²]."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k: np.ndarray, x1: np.ndarray, x2: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 block (20 rounds) of key ``k`` over the count pair
    (``x1``, ``x2``), uint32 arrays of one shape."""
    with np.errstate(over="ignore"):
        ks = [_U32(k[0]), _U32(k[1]),
              _U32(k[0]) ^ _U32(k[1]) ^ _U32(0x1BD11BDA)]
        x = [x1.astype(_U32) + ks[0], x2.astype(_U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _counts(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The high and low words of a 64-bit iota of length ``n``."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), \
        (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: [num, 2] keys."""
    b1, b2 = threefry2x32(k, *_counts(num))
    return np.stack([b1, b2], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    b1, b2 = threefry2x32(k, np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([b1[0], b2[0]], _U32)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape`` (uint32)."""
    n = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(k, *_counts(n))
    return (b1 ^ b2).reshape(shape)


def uniform(k: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the bits' top 23 as the mantissa
    of a float in [1, 2), less 1, scaled, and not below ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo)


def _erf32(x) -> np.float32:
    from scipy.special import erf
    return np.float32(erf(np.float64(x)))


def _erfinv32(u: np.ndarray) -> np.ndarray:
    from scipy.special import erfinv
    return erfinv(u.astype(np.float64)).astype(np.float32)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: √2·erfinv of a uniform on
    (−1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv32(uniform(k, shape, lo, 1.0))


def truncated_normal(k: np.ndarray, lower: float, upper: float,
                     shape) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32: √2·erfinv of a uniform
    between erf(lower/√2) and erf(upper/√2), clipped inside the bounds."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    u = uniform(k, shape, _erf32(lo / sqrt2), _erf32(hi / sqrt2))
    out = sqrt2 * _erfinv32(u)
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf)))
