"""Bloom-filter pushdown for hash joins.

Reference: ``cpp/src/arrow/acero/bloom_filter.h:42`` (``BlockedBloomFilter``
built from build-side key hashes) and the pushdown machinery in
``hash_join_node.cc:499`` that filters probe-side rows before they reach
the join. The counterpart of the JAX package's ``ops/bloom.py``.

The filter is a flat byte-mask bitset (one bool per slot, as in the JAX
package, so that a state built by either package reads the same slot for
slot). ``k`` probes derive from two lane-mixed 32-bit hashes
(Kirsch-Mitzenmacher double hashing): insert is ``k`` scatter-ORs, query
is ``k`` gathers, with no data-dependent control flow. The hashes are the
mixers of ``ops/hashing`` over u32 lanes held in int64, masked to 32 bits
after every product, sum and left shift.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import U32
from .hashing import _fmix32, _mix32

__all__ = ["bloom_m_log2", "build_bloom", "query_bloom", "BLOOM_K"]

BLOOM_K = 3          # probes / key; at m / n = 8: FPR ~ 3.1 %
_SLOTS_PER_KEY = 8
_SEED1 = 0x9747B28C
_SEED2 = 0x85EBCA6B


def bloom_m_log2(max_keys: int) -> int:
    """Bitset size (log2 slots) for an expected key count, clamped to
    [2^13, 2^23] (8 KiB .. 8 MiB of bool bytes)."""
    m = int(max(max_keys, 1)) * _SLOTS_PER_KEY
    return int(min(23, max(13, int(np.ceil(np.log2(m))))))


def _lane_hashes(lanes: torch.Tensor):
    """(n, L) u32 key lanes (int64) -> two independent 32-bit hashes (n,),
    int64 tensors of u32 values. Equal keys (equal lanes, by the grouper's
    normalization contract) always fall into the same slots."""
    n, L = lanes.shape
    h1 = torch.full((n,), _SEED1, dtype=torch.int64, device=lanes.device)
    h2 = torch.full((n,), _SEED2, dtype=torch.int64, device=lanes.device)
    for j in range(L):
        w = lanes[:, j]
        h1 = _mix32(h1, w)
        h2 = _mix32(h2, w ^ 0x6B43A9B5)
    return _fmix32(h1 ^ L), _fmix32(h2 ^ L)


def build_bloom(lanes: torch.Tensor, active: torch.Tensor,
                m_log2: int, k: int = BLOOM_K) -> torch.Tensor:
    """Insert active rows' keys; returns a (2^m_log2,) bool byte-mask."""
    m = 1 << m_log2
    h1, h2 = _lane_hashes(lanes)
    # slot m takes the inactive rows and is dropped
    bits = torch.zeros((m + 1,), dtype=torch.bool, device=lanes.device)
    for i in range(k):
        pos = ((h1 + i * h2) & U32) & (m - 1)
        bits.index_fill_(0, torch.where(active, pos, m), True)
    return bits[:m]


def query_bloom(bits: torch.Tensor, lanes: torch.Tensor,
                active: torch.Tensor, k: int = BLOOM_K) -> torch.Tensor:
    """True where the key MAY be present (false positives possible, false
    negatives impossible). Inactive rows (null keys / padding) -> False."""
    m = bits.shape[0]
    h1, h2 = _lane_hashes(lanes)
    hit = active
    for i in range(k):
        hit = hit & bits[((h1 + i * h2) & U32) & (m - 1)]
    return hit
