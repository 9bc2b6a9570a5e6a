"""Stable string hashes and name keys for the device tables.

Copies of ``minisched_tpu/models/tables.py``'s ``fnv1a32``,
``_name_suffix`` and ``pod_seed``, plus numpy batch forms of them in place
of the JAX package's native string kernels: one vectorized FNV-1a pass
over a padded byte matrix, one column step per byte position.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193
_M32 = 0xFFFFFFFF


def fnv1a32(s: str) -> int:
    """Stable 32-bit FNV-1a of the UTF-8 bytes, as a signed int32 value."""
    h = _FNV_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _M32
    return h - (1 << 32) if h >= (1 << 31) else h


def name_suffix(name: str) -> int:
    """Trailing ASCII digit of an object name, -1 if absent (the NodeNumber
    key; Go's strconv.Atoi accepts ASCII digits only)."""
    if name and "0" <= name[-1] <= "9":
        return int(name[-1])
    return -1


def pod_seed(uid: str) -> int:
    """Deterministic per-pod tie-break seed (unsigned 32-bit)."""
    return fnv1a32(uid) & _M32


def _byte_matrix(strings: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[n, maxlen] zero-padded UTF-8 bytes, int64[n] lengths)."""
    enc = [s.encode("utf-8") for s in strings]
    lens = np.fromiter(map(len, enc), np.int64, count=len(enc))
    width = int(lens.max()) if len(enc) else 0
    mat = np.zeros((len(enc), width), np.uint8)
    if width:
        flat = np.frombuffer(b"".join(enc), np.uint8)
        rows = np.repeat(np.arange(len(enc)), lens)
        starts = np.repeat(np.cumsum(lens) - lens, lens)
        mat[rows, np.arange(flat.size) - starts] = flat
    return mat, lens


def fnv1a32_u32_batch(strings: Sequence[str]) -> np.ndarray:
    """uint32 FNV-1a per string (the unsigned bits of ``fnv1a32``)."""
    mat, lens = _byte_matrix(strings)
    h = np.full(len(lens), _FNV_OFFSET, np.uint64)
    for j in range(mat.shape[1]):
        # (h ^ b) < 2**32 and the prime < 2**25: the product fits in u64
        step = ((h ^ mat[:, j]) * np.uint64(_FNV_PRIME)) & np.uint64(_M32)
        h = np.where(lens > j, step, h)
    return h.astype(np.uint32)


def fnv1a32_batch(strings: Sequence[str]) -> np.ndarray:
    """Signed-int32 FNV-1a per string (== ``fnv1a32``)."""
    return fnv1a32_u32_batch(strings).view(np.int32)


def pod_seed_batch(strings: Sequence[str]) -> np.ndarray:
    """uint32 tie-break seed per uid (== ``pod_seed``)."""
    return fnv1a32_u32_batch(strings)


def name_suffix_batch(strings: Sequence[str]) -> np.ndarray:
    """Trailing ASCII digit per name, -1 if absent (== ``name_suffix``).

    The last UTF-8 byte is an ASCII digit exactly when the last character
    is one: a multi-byte character ends in a continuation byte."""
    mat, lens = _byte_matrix(strings)
    out = np.full(len(lens), -1, np.int32)
    live = lens > 0
    last = mat[np.flatnonzero(live), lens[live] - 1].astype(np.int32)
    digit = (last >= ord("0")) & (last <= ord("9"))
    out[np.flatnonzero(live)[digit]] = last[digit] - ord("0")
    return out
