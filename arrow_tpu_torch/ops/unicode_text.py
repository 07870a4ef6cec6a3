"""Unicode tables on the device and codepoint-level UTF-8 transforms; the
counterpart of the JAX package's ``ops/unicode_text.py``.

Reference: ``cpp/src/arrow/compute/kernels/scalar_string_utf8.cc``: the
utf8_* kernels run codepoint LUTs (built from utf8proc) over decoded
UTF-8. The tables are the JAX package's, generated from the pyarrow
oracle (``tools/gen_unicode_tables.py``) and copied here as
``_unicode_tables.npz``; each goes to a device once, on first use there
(a cache keyed by the device), never at import.

Decode -> map -> encode are byte-pool-parallel passes:

  * decode: every pool byte classifies itself (head / continuation) and a
    head assembles its codepoint from the next <= 3 bytes;
  * map: one LUT gather per head;
  * encode: each head's output byte length prefix-sums into its output
    start, the new row offsets are that prefix at the old row starts, and
    each head scatters its (at most 4) UTF-8 bytes from its start (the
    JAX package maps each output byte back to its head and encodes there:
    twice the positions, and a gather for each).

Where the JAX package forward-fills head positions with cummax / cummin
scans, the port ranks the heads by one cumsum and compacts their
positions by one scatter (``head_positions``): a byte's head, the
previous head and the next one are then gathers.

Output pools are 2x the input pool: no simple case mapping more than
doubles a codepoint's UTF-8 bytes (the widest grows 1.5x: 2-byte U+00DF
-> 3-byte U+1E9E), asserted against the tables at load.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch

from ..core.array import Array
from .segment import _scatter, rows_of_positions

__all__ = ["unicode_case_transform", "head_codepoints", "head_positions",
           "predicate_flags", "cased_flags", "row_heads", "rows_of_bytes"]

_NPZ = os.path.join(os.path.dirname(__file__), "_unicode_tables.npz")


def _u8len_np(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64)
    return 1 + (c >= 0x80) + (c >= 0x800) + (c >= 0x10000)


@functools.lru_cache(maxsize=1)
def _tables():
    z = np.load(_NPZ)
    t = {
        "bound": int(z["bound"]),
        "upper": z["upper"].astype(np.int32),
        "lower": z["lower"].astype(np.int32),
        "swapcase": z["swapcase"].astype(np.int32),
        "flags": z["flags"].astype(np.int32),
        "pred_index": {str(b): i for i, b in enumerate(z["pred_bits"])},
    }
    cp = np.arange(t["bound"])
    for name in ("upper", "lower", "swapcase"):
        assert (_u8len_np(t[name]) <= 2 * _u8len_np(cp)).all(), name
    return t


@functools.lru_cache(maxsize=None)
def _dev_table(name: str, device: torch.device) -> torch.Tensor:
    """One table on one device (int32: no gather of uint16 on the card)."""
    return torch.from_numpy(_tables()[name]).to(device)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def predicate_flags(cp: torch.Tensor, name: str) -> torch.Tensor:
    """Per-codepoint oracle-derived character-class bit: one of alpha /
    alnum / digit / decimal / numeric / space / printable / lower /
    title_char / cased."""
    bit = _tables()["pred_index"][name]
    t = _dev_table("flags", cp.device)
    f = t.index_select(0, cp.clamp(0, t.shape[0] - 1))
    return (f & (1 << bit)) != 0


def cased_flags(cp: torch.Tensor) -> torch.Tensor:
    return predicate_flags(cp, "cased")


def _lut(cp: torch.Tensor, name: str) -> torch.Tensor:
    """Case LUT, the identity beyond the table's bound."""
    t = _dev_table(name, cp.device)
    n = t.shape[0]
    return torch.where(cp < n, t.index_select(0, cp.clamp(0, n - 1)), cp)


def _u8len(c: torch.Tensor) -> torch.Tensor:
    return (1 + (c >= 0x80).int() + (c >= 0x800).int()
            + (c >= 0x10000).int())


def head_codepoints(a: Array
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-pool-byte decode: (is_head bool (B,), cp int32 (B,) valid at
    head bytes, in_pool bool (B,)). Malformed bytes decode best-effort, as
    in the JAX package."""
    b = a.values
    B = b.shape[0]
    dev = b.device
    in_pool = _iota(B, dev) < a.offsets[a.capacity]
    is_head = in_pool & ((b & 0xC0) != 0x80)
    b0 = b.to(torch.int32)

    def nxt(k):
        return torch.cat([b0[k:], b0.new_zeros((min(k, B),))]) & 0x3F

    b1, b2, b3 = nxt(1), nxt(2), nxt(3)
    cp = torch.where(
        b0 < 0x80, b0,
        torch.where((b0 & 0xE0) == 0xC0, ((b0 & 0x1F) << 6) | b1,
                    torch.where((b0 & 0xF0) == 0xE0,
                                ((b0 & 0x0F) << 12) | (b1 << 6) | b2,
                                ((b0 & 0x07) << 18) | (b1 << 12)
                                | (b2 << 6) | b3)))
    return is_head, cp.clamp_(0, 0x10FFFF), in_pool


def head_positions(is_head: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rank (B + 1,) int32: heads before each byte, pos (B + 1,) int32:
    the byte of each head in order, B past the last). The head of byte p
    is ``pos[rank[p + 1] - 1]``, the next head after it
    ``pos[rank[p + 1]]``."""
    B = is_head.shape[0]
    dev = is_head.device
    rank = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                      torch.cumsum(is_head, 0, dtype=torch.int32)])
    pos = _scatter(B + 1, B, torch.where(is_head, rank[:-1], B + 1).long(),
                   _iota(B, dev))
    return rank, pos


def row_heads(a: Array) -> torch.Tensor:
    """(B,) bool: the first byte of each non-empty row."""
    off = a.offsets
    B = a.values.shape[0]
    nonempty = off[1:] > off[:-1]
    mark = torch.zeros((B + 1,), dtype=torch.bool, device=off.device)
    mark.index_fill_(0, torch.where(nonempty, off[:-1], B).long()
                     .clamp_(0, B), True)
    return mark[:B]


def rows_of_bytes(a: Array) -> torch.Tensor:
    """(B,) int32: the row of each pool byte (padding bytes clamp)."""
    return rows_of_positions(a.offsets, a.values.shape[0]).clamp_(
        0, max(a.capacity - 1, 0))


def prev_head_cased(a: Array, is_head: torch.Tensor, cased: torch.Tensor
                    ) -> torch.Tensor:
    """(B,) bool at heads: the previous codepoint of the same row is
    cased (the word state of utf8_title and utf8_is_title)."""
    B = is_head.shape[0]
    rank, pos = head_positions(is_head)
    prev = pos.index_select(0, (rank[:-1] - 1).clamp_(0, B))
    prev = torch.where(rank[:-1] >= 1, prev, -1)
    in_row = prev >= a.offsets.index_select(0, rows_of_bytes(a))
    return in_row & cased.index_select(0, prev.clamp(0, max(B - 1, 0)))


def _encode_byte(c: torch.Tensor, ln: torch.Tensor, k: int
                 ) -> torch.Tensor:
    """The k-th UTF-8 byte of each codepoint c whose encoded length is ln
    (meaningless where k >= ln)."""
    if k == 0:
        lead = torch.where(ln == 2, 0xC0 | (c >> 6),
                           torch.where(ln == 3, 0xE0 | (c >> 12),
                                       0xF0 | (c >> 18)))
        return torch.where(ln == 1, c, lead).to(torch.uint8)
    shift = (6 * (ln - 1 - k)).clamp_(min=0)
    return (0x80 | ((c >> shift) & 0x3F)).to(torch.uint8)


def unicode_case_transform(a: Array, mode: str) -> Array:
    """utf8_{upper,lower,swapcase,capitalize,title}.

    As ``scalar_string_utf8.cc``: upper / lower / swapcase map every
    codepoint through the LUT; capitalize upper-maps the first codepoint
    and lower-maps the rest; title upper-maps the first cased codepoint of
    each word, lower-maps the cased codepoints after it and passes
    uncased ones through (word state = IsCasedCharacterUnicode)."""
    B = a.values.shape[0]
    if B == 0:
        return a
    is_head, cp, _ = head_codepoints(a)
    if mode in ("upper", "lower", "swapcase"):
        mapped = _lut(cp, mode)
    elif mode == "capitalize":
        mapped = torch.where(row_heads(a), _lut(cp, "upper"),
                             _lut(cp, "lower"))
    elif mode == "title":
        cased = cased_flags(cp) & is_head
        word_start = cased & ~prev_head_cased(a, is_head, cased)
        mapped = torch.where(word_start, _lut(cp, "upper"),
                             torch.where(cased, _lut(cp, "lower"), cp))
    else:
        raise ValueError(mode)
    out_len = torch.where(is_head, _u8len(mapped), 0)
    # each head's output start; the row offsets are the same prefix at
    # the old row starts
    out_start = torch.cat([out_len.new_zeros((1,)),
                           torch.cumsum(out_len, 0, dtype=torch.int32)])
    new_off = out_start.index_select(0, a.offsets.clamp(0, B))
    # each head writes its k-th byte, k < its length, at its start + k
    out_bcap = 2 * B
    out = torch.zeros((out_bcap + 1,), dtype=torch.uint8, device=a.device)
    for k in range(4):
        at = torch.where(out_len > k, out_start[:-1] + k, out_bcap)
        out.index_copy_(0, at.long(), _encode_byte(mapped, out_len, k))
    out = out[:out_bcap]
    return Array(a.type, out, a.validity, offsets=new_off, length=a.length)
