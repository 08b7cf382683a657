"""String → id hashing for categorical features.

Replaces TF's ``categorical_column_with_hash_bucket`` (FarmHash
Fingerprint64 mod bucket size — fm/fm.py:88-90) with a documented,
implementation-portable hash: FNV-1a 64-bit over the raw bytes followed by a
splitmix64 finalizer for avalanche, reduced mod the field's bucket size.

Exact TF hash parity is not required for metric parity — only a uniform,
stable assignment of strings to buckets is (collision statistics are what
drive AUC). The same spec is implemented in the native C++ loader
(native/criteo_parser.cc) so host paths agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

FNV_OFFSET = np.uint64(0xCBF29CE484222325)
FNV_PRIME = np.uint64(0x100000001B3)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _splitmix64(x: np.uint64) -> np.uint64:
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= _M1
        x ^= x >> np.uint64(27)
        x *= _M2
        x ^= x >> np.uint64(31)
    return x


def hash64(data: bytes) -> int:
    """FNV-1a 64 + splitmix64 finalizer."""
    h = FNV_OFFSET
    with np.errstate(over="ignore"):
        for b in data:
            h ^= np.uint64(b)
            h *= FNV_PRIME
    return int(_splitmix64(h))


def hash_bucket(value: str | bytes, num_buckets: int) -> int:
    """String → [0, num_buckets)."""
    if isinstance(value, str):
        value = value.encode("utf-8")
    return hash64(value) % num_buckets


def hash_bucket_array(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Vectorized-ish batch hashing of an object/str array → int32 ids."""
    out = np.empty(len(values), np.int32)
    cache: dict = {}
    for i, v in enumerate(values):
        h = cache.get(v)
        if h is None:
            h = hash_bucket(v, num_buckets)
            cache[v] = h
        out[i] = h
    return out


def hash_int_bucket(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Integer-keyed hashing (deepfm's int64 u_id/i_id hash columns,
    deepfm/deepfm.py:41-46): splitmix64 of the value mod buckets."""
    v = values.astype(np.uint64)
    return (_splitmix64(v) % np.uint64(num_buckets)).astype(np.int32)
