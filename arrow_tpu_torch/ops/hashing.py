"""Vectorized key hashing of fixed-width columns.

Reference: ``cpp/src/arrow/compute/key_hash_internal.{h,cc}``
(``Hashing32/64``: per-column hash + combine). The counterpart of the JAX
package's ``ops/hashing.py``: every key column is normalized to u32 lanes
(``ops/bits.value_lanes32``: the bits of integers, temporals and bools;
float bits with NaNs canonicalized) and a Murmur3-style mix runs over the
lanes with a per-column seed, then the Murmur3 finalizer.

``hash32`` gives the SAME bits as the JAX function: ``hash % P`` decides
which shard of an exchange owns a key, and with it the row order of a
distributed result. torch has no u32 arithmetic, so hashes and lanes are
int64 tensors holding u32 values: the low 32 bits of an int64 product, sum
or left shift of u32 values are the u32 result, so each such step is masked
with ``& U32``; right shifts, xors and remainders then see a non-negative
value and are the unsigned ones.

Varlen (string) and dictionary key columns are not hashed yet (queue item
A3 of ROADMAP.md: string fingerprints and dictionary content lanes).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core import datatype as dt
from ..core.array import Array
from .bits import U32, value_lanes32

__all__ = ["hash32", "hash64", "normalize_keys", "hash_batch_columns",
           "combine_hashes32"]

# Murmur3 constants
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FMIX1 = 0x85EBCA6B
_FMIX2 = 0xC2B2AE35
_NULL_MARKER = 0x7FB5D329
_COL_SEED = 0x9E3779B9


def _rotl32(x, r: int):
    return ((x << r) & U32) | (x >> (32 - r))


def _fmix32(h):
    h = h ^ (h >> 16)
    h = (h * _FMIX1) & U32
    h = h ^ (h >> 13)
    h = (h * _FMIX2) & U32
    return h ^ (h >> 16)


def _mix32(h, k):
    k = (k * _C1) & U32
    k = _rotl32(k, 15)
    k = (k * _C2) & U32
    h = h ^ k
    h = _rotl32(h, 13)
    return (h * 5 + 0xE6546B64) & U32


def _word_lanes(a: Array) -> List[torch.Tensor]:
    """One key column as u32 lanes (int64). The same lanes as the grouper's
    equality lanes, so equal group keys hash alike."""
    t = a.type
    if t.is_varlen or isinstance(t, dt.DictionaryType):
        raise NotImplementedError(
            f"hash of {t} key columns (ROADMAP queue item A3: string "
            "fingerprints and dictionary content lanes)")
    return value_lanes32(a.values, t)


def normalize_keys(columns: Sequence[Array]) -> List[torch.Tensor]:
    """All key columns as u32 lanes (int64); nulls are the groupers' and
    ``hash32``'s business."""
    lanes: List[torch.Tensor] = []
    for c in columns:
        lanes.extend(_word_lanes(c))
    return lanes


def hash32(columns: Sequence[Array], seed: int = 0) -> torch.Tensor:
    """(capacity,) int64 holding the u32 hash of the key tuple in each row.

    A null key hashes as zeroed value bits with a null marker mixed in, so
    null == null and null != 0. The hash depends on each row's (value,
    is_null) pair only, NOT on whether the column carries a validity
    buffer: the marker round runs either way, so two sides of an exchange
    that differ in that still send equal keys to one shard."""
    cap = columns[0].capacity
    dev = columns[0].device
    h = torch.full((cap,), (seed ^ 0x9747B28C) & U32, dtype=torch.int64,
                   device=dev)
    for ci, c in enumerate(columns):
        col_seed = (_COL_SEED * (ci + 1)) & U32
        for lane in _word_lanes(c):
            if c.validity is not None:
                lane = torch.where(c.validity, lane, 0)
            h = _mix32(h, lane ^ col_seed)
        if c.validity is not None:
            h = _mix32(h, torch.where(c.validity, 0, _NULL_MARKER))
        else:
            h = _mix32(h, 0)
    return _fmix32(h)


def combine_hashes32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _fmix32(_mix32(a, b))


def hash64(columns: Sequence[Array], seed: int = 0) -> torch.Tensor:
    """(capacity,) int64 holding the BITS of the u64 hash: two decorrelated
    32-bit hashes packed (view as ``torch.uint64`` for the unsigned
    value)."""
    h1 = hash32(columns, seed=seed)
    h2 = hash32(columns, seed=seed ^ 0x52DCE729)
    return (h1 << 32) | h2


def hash_batch_columns(batch, names: Sequence[str],
                       seed: int = 0) -> torch.Tensor:
    return hash32([batch.column(n) for n in names], seed=seed)
