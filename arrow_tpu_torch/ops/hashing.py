"""Vectorized key hashing, and the content lanes of string and dictionary
keys.

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

A varlen key hashes through a sampled 64-bit fingerprint of its bytes
(``_string_fingerprint64``), a dictionary key through the lanes of its
VALUES (``dict_content_lanes``): codes are only comparable under one
dictionary. Groupers and joins key strings by ``varlen_content_lanes``:
the exact bytes of rows up to 16 bytes, two full-content polynomial
fingerprints (``string_fingerprint_exact``) of longer rows. All of these
are mod-2^64 arithmetic on int64 tensors holding the u64 bits (products and
sums wrap alike), with every right shift masked to be the logical one, so
the lanes equal the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from .bits import U32, value_lanes32

__all__ = ["hash32", "hash64", "normalize_keys", "hash_batch_columns",
           "combine_hashes32", "string_fingerprint_exact",
           "varlen_content_lanes", "dict_value_lane_width",
           "dict_content_lanes"]

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
    equality lanes for fixed-width and dictionary columns, so equal group
    keys hash alike; a varlen column's are its sampled fingerprint's two
    halves (equal strings, equal fingerprints)."""
    t = a.type
    if t.is_varlen:
        fp = _string_fingerprint64(a)
        return [fp & U32, _srl(fp, 32)]
    if isinstance(t, dt.DictionaryType):
        return dict_content_lanes(a)
    return value_lanes32(a.values, t)


# ---- 64-bit arithmetic on int64 tensors --------------------------------------

_M64 = (1 << 64) - 1
_PRIME64_1 = 0x9E3779B185EBCA87
_PRIME64_2 = 0xC2B2AE3D27D4EB4F
_PRIME64_3 = 0x165667B19E3779F9


def _i64(c: int) -> int:
    """The int64 with the bits of the u64 constant ``c``."""
    c &= _M64
    return c - (1 << 64) if c >= (1 << 63) else c


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _srl(h, 33)
    h = h * _i64(0xFF51AFD7ED558CCD)
    h = h ^ _srl(h, 33)
    h = h * _i64(0xC4CEB9FE1A85EC53)
    return h ^ _srl(h, 33)


def _string_fingerprint64(a: Array) -> torch.Tensor:
    """Sampled 64-bit content fingerprint of each string row (the JAX
    package's): 16 strided probes (every byte of a short string, a sample
    of a long one) plus the exact last 8 bytes and the length. Only
    dispersion matters: groupers and joins key strings by their exact
    content lanes."""
    off = a.offsets
    lens = (off[1:] - off[:-1]).to(torch.int64)
    data = a.values if a.values.shape[0] else \
        torch.zeros((1,), dtype=torch.uint8, device=off.device)
    bmax = data.shape[0] - 1
    start = off[:-1].to(torch.int64)
    h = lens * _i64(_PRIME64_2) + _i64(_PRIME64_3)
    stride = torch.clamp(lens // 16, min=1)
    for k in range(16):
        valid = stride * k < lens
        byte = data[(start + stride * k).clamp(0, bmax)].to(torch.int64)
        h = (h ^ torch.where(valid, byte + (k + 1), 0)) * _i64(_PRIME64_1)
        h = h ^ _srl(h, 29)
    end = off[1:].to(torch.int64)
    for k in range(8):
        byte = data[(end - 1 - k).clamp(0, bmax)].to(torch.int64)
        contrib = torch.where(lens > k, byte, 0)
        h = (h ^ (contrib << (8 * k))) * _i64(_PRIME64_2)
    return h ^ _srl(h, 32)


_POW_TABLES: Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def _pow_tables(base: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64 tables with ``base ** e == lo[e & 0xFFFF] *
    hi[e >> 16] mod 2^64`` for 0 <= e < 2^31, made on the host once per
    base and device (numpy's uint64 products wrap mod 2^64)."""
    key = (base, str(device))
    if key not in _POW_TABLES:
        def powers(b: int, n: int) -> np.ndarray:
            steps = np.full((n,), b & _M64, dtype=np.uint64)
            steps[0] = 1
            with np.errstate(over="ignore"):
                return np.cumprod(steps, dtype=np.uint64)
        lo = powers(base, 1 << 16)
        hi = powers(pow(base, 1 << 16, 1 << 64), 1 << 15)
        _POW_TABLES[key] = tuple(torch.from_numpy(t.view(np.int64))
                                 .to(device) for t in (lo, hi))
    return _POW_TABLES[key]


def _pow_bits(exp: torch.Tensor, base: int) -> torch.Tensor:
    """Elementwise ``base ** exp mod 2^64`` (int64 bits) for 0 <= exp <
    2^31: the JAX package's square-and-multiply over the bits of ``exp``
    gives the same values; here two gathers from 2^16-entry tables and one
    product."""
    lo, hi = _pow_tables(base, exp.device)
    return lo[exp & 0xFFFF] * hi[exp >> 16]


_FP_CHUNK = 1 << 24     # pool bytes a step of the fingerprint's running sum
_CHUNK_POWERS: Dict[Tuple[int, str], torch.Tensor] = {}


def _chunk_powers(base: int, device) -> torch.Tensor:
    """(``_FP_CHUNK``,) int64: ``base ** j mod 2^64`` for j < _FP_CHUNK,
    made once per base and device."""
    key = (base, str(device))
    if key not in _CHUNK_POWERS:
        _CHUNK_POWERS[key] = _pow_bits(
            torch.arange(_FP_CHUNK, dtype=torch.int64, device=device), base)
    return _CHUNK_POWERS[key]


def string_fingerprint_exact(a: Array, mult: int = 0x9E3779B185EBCA87,
                             used_bytes: Optional[int] = None
                             ) -> torch.Tensor:
    """Full-content 64-bit polynomial fingerprint of each string row
    (int64 bits), the JAX package's (all mod 2^64):

        h[r] = fmix64(sum_p (byte[p] + 1) * mult**(p - start(r))
                      ^ len(r) * PRIME64_2)

    ``mult`` is odd, so ``mult**(p - start) = mult**p * inv(mult)**start``:
    one running sum of the byte terms over the pool, each row's sum the
    difference of the running sum at its two ends, scaled per ROW by
    ``inv(mult)**start``. The terms are made 2^24 bytes at a time (the
    powers of a step are a cached table times ``mult`` to the step's
    first position), summed
    into one int64 running sum with the previous step's carry.
    ``used_bytes`` (the end of the last row, when the caller read it)
    stops the sum there: no row ends past it."""
    off = a.offsets
    dev = off.device
    lens = (off[1:] - off[:-1]).to(torch.int64)
    data = a.values
    bcap = data.shape[0]
    if bcap == 0:
        return _fmix64(lens)
    stop = bcap if used_bytes is None else min(bcap, used_bytes)
    if stop == 0:
        return _fmix64(lens * _i64(_PRIME64_2))
    ends = off.to(torch.int64).clamp(0, stop)      # running-sum positions
    csum = torch.empty((stop,), dtype=torch.int64, device=dev)
    powers = _chunk_powers(mult, dev)
    for c0 in range(0, stop, _FP_CHUNK):
        c1 = min(c0 + _FP_CHUNK, stop)
        terms = (data[c0:c1].to(torch.int64) + 1) * powers[:c1 - c0]
        terms *= _i64(pow(mult, c0, 1 << 64))
        piece = csum[c0:c1]
        torch.cumsum(terms, 0, out=piece)
        if c0:
            piece += csum[c0 - 1]
        del terms
    g = torch.where(ends > 0, csum[(ends - 1).clamp(min=0)], 0)
    del csum
    raw = g[1:] - g[:-1]
    inv = pow(mult, -1, 1 << 64)
    acc = raw * _pow_bits(off[:-1].to(torch.int64), inv)
    return _fmix64(acc ^ (lens * _i64(_PRIME64_2)))


_SLOT_W = 16    # short-string exact width (bytes)


def _short_lanes(a: Array) -> List[torch.Tensor]:
    """4 u32 lanes (int64) of each row's first 16 bytes, zero past its
    end: bytes 4j..4j+3 little-endian in lane j (the JAX package's slot
    bitcast)."""
    off = a.offsets
    dev = off.device
    cap = off.shape[0] - 1
    data = a.values
    bmax = data.shape[0] - 1
    starts = off[:-1].to(torch.int32)
    lens = off[1:] - off[:-1]
    k4 = torch.arange(4, dtype=torch.int32, device=dev)
    lanes = []
    for j in range(_SLOT_W // 4):
        k = 4 * j + k4                                       # (4,)
        idx = (starts[:, None] + k[None, :]).clamp_(0, bmax)
        b = data.index_select(0, idx.reshape(-1)).reshape(cap, 4)
        b = b.masked_fill_(k[None, :] >= lens[:, None], 0)
        lanes.append(b.view(torch.int32).reshape(cap).to(torch.int64) & U32)
    return lanes


def varlen_content_lanes(a: Array) -> List[torch.Tensor]:
    """5 u32 lanes (int64) keying a varlen column by content: the byte
    length, then 4 content lanes: a row of at most 16 bytes keys by its
    exact bytes (``_short_lanes``), a longer row by two full-content
    fingerprints (``string_fingerprint_exact`` with two odd multipliers,
    2^-128 collision confidence). The form is chosen PER ROW by its length
    (lanes are compared across arrays: join build against probe, the
    group table against later batches). One host read of the longest and
    shortest row and of the rows' end lets an array whose rows all take one
    form skip the other's work (the JAX package's ``lax.cond`` skips the
    same work on the device) and the fingerprints stop at the used bytes;
    no row's lanes depend on it."""
    off = a.offsets
    lens = off[1:] - off[:-1]
    lens64 = lens.to(torch.int64)
    cap = lens.shape[0]
    if a.values.shape[0] == 0 or cap == 0:
        z = torch.zeros_like(lens64)
        return [lens64, z, z, z, z]
    # the forms the rows in range take (padding rows' lanes are
    # unspecified)
    live = a.row_mask()
    lo, hi, used = torch.stack([
        torch.where(live, lens, 1 << 30).min(),
        torch.where(live, lens, 0).max(), off.max()]).tolist()
    short = _short_lanes(a) if min(lo, hi) <= _SLOT_W else None
    if hi <= _SLOT_W:
        return [lens64] + short
    fp1 = string_fingerprint_exact(a, used_bytes=used)
    fp2 = string_fingerprint_exact(a, 0xC2B2AE3D27D4EB4F, used)
    long_ = [fp1 & U32, _srl(fp1, 32), fp2 & U32, _srl(fp2, 32)]
    if short is None:
        return [lens64] + long_
    is_short = lens <= _SLOT_W
    return [lens64] + [torch.where(is_short, s_, l_)
                       for s_, l_ in zip(short, long_)]


def dict_value_lane_width(t) -> int:
    """Lane count of ``dict_content_lanes`` for a dictionary type: that of
    its value type (varlen 5, 64-bit 2, else 1), so a dictionary column
    keys like a plain column of its values."""
    vt = t.value_type
    if vt.is_varlen:
        return 5
    if isinstance(vt, dt.BoolType):
        return 1
    if vt.is_floating:
        return 2 if vt.bits == 64 else 1
    return 2 if getattr(vt, "bit_width", 32) == 64 else 1


def dict_content_lanes(a: Array) -> List[torch.Tensor]:
    """Key lanes of a dictionary column by CONTENT: the lanes of its
    dictionary's values (few), gathered per row by index as one row
    gather of a (D, L) matrix. A null dictionary slot keys like the zero
    value (nulls belong in row validity; staging zeroes null indices)."""
    d = a.dictionary
    if d is None:
        return [a.values.to(torch.int64) & U32]
    idx = a.values.long().clamp(0, max(d.capacity, 1) - 1)
    dl = varlen_content_lanes(d) if d.type.is_varlen else \
        value_lanes32(d.values, d.type)
    if d.validity is not None:
        dl = [torch.where(d.validity, l, 0) for l in dl]
    rows = torch.stack(dl, dim=1)[idx]
    return [rows[:, j] for j in range(rows.shape[1])]


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
