"""String / binary kernel family; the counterpart of the JAX package's
``ops/strings.py``.

Reference: ``cpp/src/arrow/compute/kernels/scalar_string_ascii.cc`` and
``scalar_string_utf8.cc``. Strings are (offsets int32[cap + 1], byte pool
uint8[B]) tensors, and every kernel is byte-pool-parallel, as in the JAX
package:

  * same-length transforms (ASCII case maps, reverse) map the pool, the
    offsets unchanged;
  * per-row predicates and counts are differences of ONE prefix count over
    the pool at the row offsets (``_row_counts``): no per-byte row ids and
    no scatter-reduce (the JAX package scatters a min / max / add per
    byte by row, and torch has no bool scatter-reduce on the card);
  * the first / last flagged byte of a row (find, trim) reads the flagged
    positions compacted by rank (``_flag_positions``);
  * shape-changing functions (slice, trim, pad, repeat, join, replace)
    make new per-row lengths, prefix-sum them into new offsets, then one
    gather in which each OUTPUT byte finds its source (``_build_varlen``);
  * substring search compares the pattern at every pool position (m
    compares of pool slices), and the greedy non-overlapping count /
    replace jumps along the match chain by binary lifting.

Where the port differs from the JAX package (ROADMAP C28):

  * ``utf8_slice_codeunits`` slices codepoints, not bytes;
  * the ``utf8_*pad`` / ``utf8_center`` width counts codepoints, and the
    padding may be any one codepoint;
  * ``utf8_trim`` / ``utf8_ltrim`` / ``utf8_rtrim`` trim a set of
    codepoints, and the ``utf8_*trim_whitespace`` functions Unicode
    whitespace;
  * an output pool past 2^31 - 1 bytes raises ``ValueError`` naming the
    function (the JAX package's int32 prefix sums wrap);
  * the greedy tables have ceil(log2(longest row / m + 2)) levels, one
    host read of the longest row, where the JAX package's static shapes
    take the pool's bytes for the row;
  * a dictionary column of strings is read through its dictionary (the
    JAX package reads its codes as bytes).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from .segment import _scatter, rows_of_positions
from .unicode_text import (cased_flags, head_codepoints, head_positions,
                           predicate_flags, prev_head_cased, row_heads,
                           rows_of_bytes, unicode_case_transform)

__all__ = ["MatchSubstringOptions", "SliceOptions", "TrimOptions",
           "PadOptions", "ReplaceSubstringOptions", "JoinOptions",
           "compare_varlen"]

_BIG = 2147483647
_MAX_POOL = (1 << 31) - 1      # int32 offsets
_FLIP = {"less": "greater", "greater": "less", "less_equal": "greater_equal",
         "greater_equal": "less_equal"}


# ---- options ------------------------------------------------------------------

class MatchSubstringOptions:
    def __init__(self, pattern: str = "", ignore_case: bool = False):
        self.pattern = pattern
        self.ignore_case = ignore_case


class SliceOptions:
    def __init__(self, start: int = 0, stop: Optional[int] = None,
                 step: int = 1):
        self.start = start
        self.stop = stop
        self.step = step


class TrimOptions:
    def __init__(self, characters: str = ""):
        self.characters = characters


class PadOptions:
    def __init__(self, width: int = 0, padding: str = " ",
                 lean_left_on_odd_padding: bool = True):
        self.width = width
        self.padding = padding
        self.lean_left_on_odd_padding = lean_left_on_odd_padding


class ReplaceSubstringOptions:
    def __init__(self, pattern: str = "", replacement: str = "",
                 max_replacements: Optional[int] = None):
        self.pattern = pattern
        self.replacement = replacement
        self.max_replacements = max_replacements


class JoinOptions:
    def __init__(self, null_handling: str = "emit_null",
                 null_replacement: str = ""):
        self.null_handling = null_handling
        self.null_replacement = null_replacement


# ---- low-level helpers --------------------------------------------------------

def _pat_bytes(s: Union[str, bytes]) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode("utf-8")
    return np.frombuffer(s, dtype=np.uint8)


def _lens(a: Array) -> torch.Tensor:
    return a.offsets[1:] - a.offsets[:-1]


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _prefix(flags: torch.Tensor) -> torch.Tensor:
    """(B + 1,) int32 exclusive prefix count of a (B,) bool."""
    return torch.cat([torch.zeros((1,), dtype=torch.int32,
                                  device=flags.device),
                      torch.cumsum(flags, 0, dtype=torch.int32)])


def _row_counts(a: Array, flags: torch.Tensor) -> torch.Tensor:
    """(capacity,) int32: the flagged bytes of each row."""
    P = _prefix(flags)
    return P.index_select(0, a.offsets[1:]) - \
        P.index_select(0, a.offsets[:-1])


def _flag_positions(a: Array, flags: torch.Tensor):
    """Per row: (count, first, last) of its flagged bytes; first and last
    are pool positions, meaningless where count is 0."""
    B = flags.shape[0]
    P = _prefix(flags)
    pos = _scatter(B + 1, B, torch.where(flags, P[:-1], B + 1).long(),
                   _iota(B, flags.device))
    lo = P.index_select(0, a.offsets[:-1])
    hi = P.index_select(0, a.offsets[1:])
    return (hi - lo, pos.index_select(0, lo),
            pos.index_select(0, (hi - 1).clamp_(min=0)))


def _check_pool(name: str, new_off: torch.Tensor, out_bcap: int) -> int:
    """The output pool's capacity: ``out_bcap`` (an upper bound of the
    bytes written); past int32 offsets, one host read of the total, which
    must fit them and is then the capacity."""
    if out_bcap <= _MAX_POOL:
        return out_bcap
    total = int(new_off[-1])
    if total > _MAX_POOL:
        raise ValueError(
            f"{name}: an output pool of {total} bytes does not fit int32 "
            "offsets (at most 2^31 - 1 bytes): split the rows")
    return total


def _new_offsets(a: Array, new_lens: torch.Tensor) -> torch.Tensor:
    """(capacity + 1,) int64 offsets of the per-row ``new_lens``, rows past
    the length empty."""
    n = torch.where(a.row_mask(), new_lens.to(torch.int64), 0)
    return torch.cat([n.new_zeros((1,)), torch.cumsum(n, 0)])


def _build_varlen(a: Array, new_lens: torch.Tensor, src_of, out_bcap: int,
                  name: str, filler=None) -> Array:
    """A varlen output of per-row ``new_lens`` (capacity,): output byte k
    of row r is the pool byte ``src_of(r, k)``, or, where that is < 0,
    ``filler(r, k)``."""
    cap = a.capacity
    dev = a.device
    off64 = _new_offsets(a, new_lens)
    out_bcap = max(_check_pool(name, off64, out_bcap), 1)
    new_off = off64.to(torch.int32)
    q = _iota(out_bcap, dev)
    r = rows_of_positions(new_off, out_bcap).clamp_(0, max(cap - 1, 0))
    k = q - new_off.index_select(0, r)
    src = src_of(r, k)
    vals = a.values if a.values.shape[0] else \
        torch.zeros((1,), dtype=torch.uint8, device=dev)
    out = vals.index_select(0, src.clamp(0, vals.shape[0] - 1))
    if filler is not None:
        out = torch.where(src < 0, filler(r, k), out)
    out.masked_fill_(q >= new_off[cap], 0)
    return Array(a.type, out, a.validity, offsets=new_off, length=a.length)


def _is_upper_b(b):
    return (b >= 65) & (b <= 90)


def _is_lower_b(b):
    return (b >= 97) & (b <= 122)


def _to_lower_b(b):
    return torch.where(_is_upper_b(b), b + 32, b)


def _to_upper_b(b):
    return torch.where(_is_lower_b(b), b - 32, b)


def _decode(a: Array) -> Array:
    """A dictionary column of strings as the plain varlen column of its
    rows' values."""
    from .selection import take_array
    return take_array(a.dictionary, Array(dt.int32, a.values, None,
                                          length=a.length))


def _arg_array(a) -> Array:
    if not isinstance(a, Array):
        raise TypeError("string kernels require an Array input")
    if isinstance(a.type, dt.DictionaryType) and a.dictionary is not None \
            and a.dictionary.type.is_varlen:
        return _decode(a)
    return a


def _bool_out(a: Array, values: torch.Tensor, validity=None) -> Array:
    return Array(dt.bool_, values, validity, length=a.length)


def _int_out(a: Array, values: torch.Tensor, validity=None) -> Array:
    return Array(dt.int32, values.to(torch.int32), validity,
                 length=a.length)


# ---- lengths ------------------------------------------------------------------

@register_function("binary_length", Kind.SCALAR, 1)
def _binary_length(args, options):
    a = _arg_array(args[0])
    return _int_out(a, _lens(a))


def _is_codepoint(b: torch.Tensor) -> torch.Tensor:
    """Bytes that start a codepoint: not UTF-8 continuations."""
    return (b & 0xC0) != 0x80


@register_function("utf8_length", Kind.SCALAR, 1)
def _utf8_length(args, options):
    a = _arg_array(args[0])
    return _int_out(a, _row_counts(a, _is_codepoint(a.values)))


# ---- case / byte transforms ----------------------------------------------------

def _map_pool(a: Array, fn) -> Array:
    return Array(a.type, fn(a.values).to(torch.uint8), a.validity,
                 offsets=a.offsets, length=a.length)


def _capitalize_pool(a: Array) -> Array:
    return _map_pool(a, lambda b: torch.where(row_heads(a), _to_upper_b(b),
                                              _to_lower_b(b)))


def _word_starts(a: Array, alpha: torch.Tensor) -> torch.Tensor:
    """ASCII letters that start a word: first in the row or after a
    non-letter."""
    prev_alpha = torch.cat([alpha.new_zeros((1,)), alpha[:-1]])
    return alpha & (row_heads(a) | ~prev_alpha)


def _title_pool(a: Array) -> Array:
    b = a.values
    start = _word_starts(a, _is_upper_b(b) | _is_lower_b(b))
    return _map_pool(a, lambda b: torch.where(start, _to_upper_b(b),
                                              _to_lower_b(b)))


def _reverse_rows(a: Array) -> Array:
    B = a.values.shape[0]
    if B == 0:
        return a
    rows = rows_of_bytes(a)
    start = a.offsets.index_select(0, rows)
    end = a.offsets.index_select(0, rows + 1)
    src = start + end - 1 - _iota(B, a.device)
    out = a.values.index_select(0, src.clamp_(0, B - 1))
    return Array(a.type, out, a.validity, offsets=a.offsets,
                 length=a.length)


for _name, _fn in [
    ("ascii_upper", lambda a: _map_pool(a, _to_upper_b)),
    ("ascii_lower", lambda a: _map_pool(a, _to_lower_b)),
    ("ascii_swapcase", lambda a: _map_pool(
        a, lambda b: torch.where(_is_upper_b(b), b + 32,
                                 torch.where(_is_lower_b(b), b - 32, b)))),
    ("ascii_capitalize", _capitalize_pool),
    ("ascii_title", _title_pool),
    ("ascii_reverse", _reverse_rows),
    ("binary_reverse", _reverse_rows),
]:
    register_function(_name, Kind.SCALAR, 1)(
        lambda args, options, _f=_fn: _f(_arg_array(args[0])))


# ---- Unicode (codepoint-level) utf8_* case kernels ------------------------------
# LUTs generated from the pyarrow oracle, applied on the device by
# ops/unicode_text.unicode_case_transform.

for _name, _mode in [
    ("utf8_upper", "upper"),
    ("utf8_lower", "lower"),
    ("utf8_swapcase", "swapcase"),
    ("utf8_capitalize", "capitalize"),
    ("utf8_title", "title"),
]:
    register_function(_name, Kind.SCALAR, 1)(
        lambda args, options, _m=_mode: unicode_case_transform(
            _arg_array(args[0]), _m))


def _codepoint_spans(a: Array, is_head: torch.Tensor):
    """(B,) int32 each: the start of each byte's codepoint (clamped to its
    row) and that codepoint's end (the next head, or the row's end), and
    (B,) int32 the row of each byte."""
    B = is_head.shape[0]
    rows = rows_of_bytes(a)
    rank, pos = head_positions(is_head)
    inc = rank[1:]
    hs = torch.where(inc >= 1, pos.index_select(0, (inc - 1).clamp_(0, B)),
                     -1)
    row_start = a.offsets.index_select(0, rows)
    row_end = a.offsets.index_select(0, rows + 1)
    hs = torch.maximum(hs, row_start)
    cp_end = torch.minimum(pos.index_select(0, inc), row_end)
    return hs, cp_end, rows


@register_function("utf8_reverse", Kind.SCALAR, 1)
def _utf8_reverse(args, options):
    """Codepoint-order reverse (Utf8ReverseTransform): each byte scatters
    to the mirrored position of its codepoint, the bytes WITHIN a
    codepoint in order."""
    a = _arg_array(args[0])
    B = a.values.shape[0]
    if B == 0:
        return a
    is_head, _cp, in_pool = head_codepoints(a)
    hs, cp_end, rows = _codepoint_spans(a, is_head)
    off = a.offsets
    start = off.index_select(0, rows)
    end = off.index_select(0, rows + 1)
    bidx = _iota(B, a.device)
    dest = start + (end - cp_end) + (bidx - hs)
    dest = torch.where(in_pool, dest, B).clamp_(0, B)
    out = _scatter(B, 0, dest.long(), a.values)
    return Array(a.type, out, a.validity, offsets=off, length=a.length)


# ---- classification predicates -------------------------------------------------

def _classify(a: Array, byte_pred, empty_result: bool) -> Array:
    """Every byte of the row satisfies the predicate; empty rows ->
    empty_result."""
    ok = _row_counts(a, ~byte_pred(a.values)) == 0
    return _bool_out(a, torch.where(_lens(a) == 0, empty_result, ok))


_DIGIT = lambda b: (b >= 48) & (b <= 57)  # noqa: E731
_ALPHA = lambda b: _is_upper_b(b) | _is_lower_b(b)  # noqa: E731
_SPACE = lambda b: (b == 32) | ((b >= 9) & (b <= 13))  # noqa: E731
_PRINT = lambda b: (b >= 32) & (b <= 126)  # noqa: E731

for _name, _pred, _empty in [
    ("ascii_is_alnum", lambda b: _ALPHA(b) | _DIGIT(b), False),
    ("ascii_is_alpha", _ALPHA, False),
    ("ascii_is_decimal", _DIGIT, False),
    ("ascii_is_space", _SPACE, False),
    ("ascii_is_printable", _PRINT, True),
    ("string_is_ascii", lambda b: b < 128, True),
]:
    register_function(_name, Kind.SCALAR, 1)(
        lambda args, options, _p=_pred, _e=_empty: _classify(
            _arg_array(args[0]), _p, _e))


def _classify_unicode(a: Array, pred_name: str, empty_result: bool) -> Array:
    """Every codepoint of the row is in the character class
    (CharacterPredicateUnicode)."""
    if a.values.shape[0] == 0:
        return _bool_out(a, torch.full((a.capacity,), empty_result,
                                       dtype=torch.bool, device=a.device))
    is_head, cp, _ = head_codepoints(a)
    ok = _row_counts(a, is_head & ~predicate_flags(cp, pred_name)) == 0
    return _bool_out(a, torch.where(_lens(a) == 0, empty_result, ok))


for _name, _bit, _empty in [
    ("utf8_is_alnum", "alnum", False),
    ("utf8_is_alpha", "alpha", False),
    ("utf8_is_decimal", "decimal", False),
    ("utf8_is_digit", "digit", False),
    ("utf8_is_numeric", "numeric", False),
    ("utf8_is_space", "space", False),
    ("utf8_is_printable", "printable", True),
]:
    register_function(_name, Kind.SCALAR, 1)(
        lambda args, options, _b=_bit, _e=_empty: _classify_unicode(
            _arg_array(args[0]), _b, _e))


def _is_cased(a: Array, want_upper: bool) -> Array:
    """ascii_is_lower / upper: every cased character is lower / upper, and
    there is at least one."""
    b = a.values
    cased = _ALPHA(b)
    good = _is_upper_b(b) if want_upper else _is_lower_b(b)
    all_good = _row_counts(a, cased & ~good) == 0
    return _bool_out(a, all_good & (_row_counts(a, cased) > 0))


register_function("ascii_is_lower", Kind.SCALAR, 1)(
    lambda args, options: _is_cased(_arg_array(args[0]), False))
register_function("ascii_is_upper", Kind.SCALAR, 1)(
    lambda args, options: _is_cased(_arg_array(args[0]), True))


def _is_cased_unicode(a: Array, want: str) -> Array:
    """utf8_is_lower / upper (IsLowerUnicode / IsUpperUnicode): every
    cased codepoint is lower / upper-case and at least one exists."""
    if a.values.shape[0] == 0:
        return _bool_out(a, torch.zeros((a.capacity,), dtype=torch.bool,
                                        device=a.device))
    is_head, cp, _ = head_codepoints(a)
    cased = is_head & predicate_flags(cp, "cased")
    all_good = _row_counts(a, cased & ~predicate_flags(cp, want)) == 0
    return _bool_out(a, all_good & (_row_counts(a, cased) > 0))


register_function("utf8_is_lower", Kind.SCALAR, 1)(
    lambda args, options: _is_cased_unicode(_arg_array(args[0]), "lower"))
register_function("utf8_is_upper", Kind.SCALAR, 1)(
    lambda args, options: _is_cased_unicode(_arg_array(args[0]), "upper"))


def _is_title(a: Array) -> Array:
    """Title-cased: every word starts upper, the rest of the word lower, at
    least one cased character."""
    b = a.values
    alpha = _ALPHA(b)
    start = _word_starts(a, alpha)
    bad = torch.where(start, ~_is_upper_b(b), alpha & ~_is_lower_b(b))
    return _bool_out(a, (_row_counts(a, bad) == 0)
                     & (_row_counts(a, alpha) > 0))


register_function("ascii_is_title", Kind.SCALAR, 1)(
    lambda args, options: _is_title(_arg_array(args[0])))


def _is_title_unicode(a: Array) -> Array:
    """utf8_is_title (IsTitleUnicode): a lower codepoint must follow a
    cased one, a non-lower cased one an uncased one; at least one cased."""
    if a.values.shape[0] == 0:
        return _bool_out(a, torch.zeros((a.capacity,), dtype=torch.bool,
                                        device=a.device))
    is_head, cp, _ = head_codepoints(a)
    cased = cased_flags(cp) & is_head
    lower = predicate_flags(cp, "lower") & is_head
    prev_cased = prev_head_cased(a, is_head, cased)
    bad = torch.where(lower, ~prev_cased, cased & prev_cased)
    return _bool_out(a, (_row_counts(a, is_head & bad) == 0)
                     & (_row_counts(a, cased & ~lower) > 0))


register_function("utf8_is_title", Kind.SCALAR, 1)(
    lambda args, options: _is_title_unicode(_arg_array(args[0])))


# ---- substring search -----------------------------------------------------------

def _search_pool(a: Array, options):
    """(pool, pattern bytes), both lower-cased (ASCII) for ignore_case."""
    pat = _pat_bytes(options.pattern)
    pool = a.values
    if getattr(options, "ignore_case", False):
        pool = _to_lower_b(pool)
        pat = _pat_bytes(options.pattern.lower())
    return pool, pat


def _match_positions(a: Array, options) -> torch.Tensor:
    """(B,) bool: the pattern matches starting at this pool byte, wholly
    inside its row (m compares of pool slices; no row ids: a match may not
    hold the first byte of another row, nor pass the last row's end)."""
    pool, pat = _search_pool(a, options)
    m = len(pat)
    B = pool.shape[0]
    ok = torch.zeros((B,), dtype=torch.bool, device=a.device)
    if m == 0 or B < m:
        return ok
    n = B - m + 1
    hit = pool[:n] == int(pat[0])
    for k in range(1, m):
        hit &= pool[k:k + n] == int(pat[k])
    heads = _prefix(row_heads(a))
    hit &= heads[m:m + n] == heads[1:1 + n]
    hit &= _iota(n, a.device) + m <= a.offsets[a.capacity]
    ok[:n] = hit
    return ok


def _match_reduce(a: Array, options, kind: str) -> Array:
    m = len(_pat_bytes(options.pattern))
    cap = a.capacity
    if m == 0:
        if kind == "match":
            return _bool_out(a, torch.ones((cap,), dtype=torch.bool,
                                           device=a.device), a.validity)
        if kind == "find":
            return _int_out(a, torch.zeros((cap,), dtype=torch.int32,
                                           device=a.device), a.validity)
        # the empty pattern occurs len + 1 times
        return _int_out(a, _lens(a) + 1, a.validity)
    match = _match_positions(a, options)
    if kind == "match":
        return _bool_out(a, _row_counts(a, match) > 0, a.validity)
    if kind == "find":
        count, first, _ = _flag_positions(a, match)
        return _int_out(a, torch.where(count > 0, first - a.offsets[:-1],
                                       -1), a.validity)
    return _int_out(a, _greedy_count(a, match, m), a.validity)


def _greedy_levels(a: Array, match: torch.Tensor, m: int, keep: bool):
    """Binary lifting over the greedy non-overlapping chain of matches:
    from a match p, one step goes to the first match at >= p + m in the
    same row (END = B past the last). Returns (the jump tables of levels
    0 .. K - 1 when ``keep``, the count table of level K: matches on the
    chain of 2^K steps from each node, END's 0; the chain's first match
    of each row and whether the row has one). K = ceil(log2(longest row
    / m + 2)): one host read of the longest row."""
    B = match.shape[0]
    dev = match.device
    P = _prefix(match)
    # the matches compacted by rank, END past the last
    mpos = _scatter(B + 1, B, torch.where(match, P[:-1], B + 1).long(),
                    _iota(B, dev))
    after = (_iota(B, dev) + m).clamp_(max=B)
    t = mpos.index_select(0, P.index_select(0, after))
    heads = _prefix(row_heads(a))
    same_row = heads.index_select(0, (t + 1).clamp_(max=B)) == heads[1:]
    jump = torch.where(match & (t < B) & same_row, t, B)
    j = torch.cat([jump, jump.new_full((1,), B)])
    c = torch.cat([match.to(torch.int32), match.new_zeros((1,),
                                                          dtype=torch.int32)])
    longest = int(torch.where(a.row_mask(), _lens(a), 0).max()) \
        if a.capacity else 0
    K = max(1, math.ceil(math.log2(max(longest // m, 1) + 2)))
    levels = []
    for _ in range(K):
        if keep:
            levels.append(j)
        c = c + c.index_select(0, j)
        j = j.index_select(0, j)
    lo = P.index_select(0, a.offsets[:-1])
    has = P.index_select(0, a.offsets[1:]) > lo
    first = torch.where(has, mpos.index_select(0, lo), B)
    return levels, c, first, has


def _greedy_count(a: Array, match: torch.Tensor, m: int) -> torch.Tensor:
    if match.shape[0] == 0:
        return torch.zeros((a.capacity,), dtype=torch.int32, device=a.device)
    _, c, first, has = _greedy_levels(a, match, m, keep=False)
    return torch.where(has, c.index_select(0, first), 0)


def _greedy_selected(a: Array, match: torch.Tensor, m: int,
                     max_repl: Optional[int]) -> torch.Tensor:
    """(B,) bool: the greedily selected match starts, at most
    ``max_replacements`` a row."""
    B = match.shape[0]
    if B == 0:
        return match
    levels, c, first, _ = _greedy_levels(a, match, m, keep=True)
    # every node on the chains: a descending sweep from each row's first
    marked = torch.zeros((B + 1,), dtype=torch.bool, device=match.device)
    marked.index_fill_(0, first.long(), True)
    for j in reversed(levels):
        marked.index_fill_(0, torch.where(marked, j, B).long(), True)
    sel = marked[:B] & match
    if max_repl is not None and max_repl >= 0:
        # the match's index in its row's chain
        first_of = first.index_select(0, rows_of_bytes(a))
        idx = c.index_select(0, first_of) - c[:B]
        sel &= idx < max_repl
    return sel


def _register_match(name, kind):
    @register_function(name, Kind.SCALAR, 1,
                       options_class=MatchSubstringOptions)
    def _fn(args, options, _k=kind):
        if options is None:
            raise ValueError(f"{name} requires a pattern")
        return _match_reduce(_arg_array(args[0]), options, _k)
    return _fn


_register_match("match_substring", "match")
_register_match("find_substring", "find")
_register_match("count_substring", "count")


def _edge_with(a: Array, options, at_start: bool) -> Array:
    pool, pat = _search_pool(a, options)
    m = len(pat)
    lens = _lens(a)
    if pool.shape[0] == 0:
        pool = torch.zeros((1,), dtype=torch.uint8, device=a.device)
    base = a.offsets[:-1] if at_start else a.offsets[1:] - m
    ok = lens >= m
    for k in range(m):
        ok &= pool.index_select(0, (base + k).clamp(0, pool.shape[0] - 1)) \
            == int(pat[k])
    return _bool_out(a, ok, a.validity)


register_function("starts_with", Kind.SCALAR, 1,
                  options_class=MatchSubstringOptions)(
    lambda args, options: _edge_with(_arg_array(args[0]), options, True))
register_function("ends_with", Kind.SCALAR, 1,
                  options_class=MatchSubstringOptions)(
    lambda args, options: _edge_with(_arg_array(args[0]), options, False))


@register_function("match_like", Kind.SCALAR, 1,
                   options_class=MatchSubstringOptions)
def _match_like(args, options):
    """SQL LIKE in its common shapes: 'lit', '%lit', 'lit%', '%lit%';
    patterns with _ or an interior % are rejected, as in the JAX
    package."""
    a = _arg_array(args[0])
    p = options.pattern
    if "_" in p or "%" in p.strip("%"):
        raise NotImplementedError(f"match_like pattern {p!r}")
    body = p.strip("%")
    sub = MatchSubstringOptions(body, getattr(options, "ignore_case", False))
    if p.startswith("%") and p.endswith("%") and len(p) >= 2:
        return _match_reduce(a, sub, "match")
    if p.endswith("%"):
        return _edge_with(a, sub, True)
    if p.startswith("%"):
        return _edge_with(a, sub, False)
    eq = compare_varlen("equal", a, Scalar(body, a.type))
    return _bool_out(a, eq, a.validity)


# ---- slicing / trimming / padding ----------------------------------------------

def _slice_bounds(lens: torch.Tensor, start: int, stop: Optional[int],
                  step: int):
    """Python slice semantics per row: (first index, count)."""
    ln = lens.to(torch.int32)
    if step < 0:
        s = ln + start if start < 0 else torch.full_like(ln, start)
        s = torch.minimum(s, ln - 1)
        if stop is None:
            e = torch.full_like(ln, -1)
        elif stop < 0:
            e = torch.clamp(ln + stop, min=-1)
        else:
            e = torch.minimum(torch.full_like(ln, stop), ln)
        n = torch.clamp((s - e + (-step) - 1) // (-step), min=0)
        return s, torch.where(s < 0, 0, n)
    s = torch.clamp(ln + start, min=0) if start < 0 else \
        torch.minimum(torch.full_like(ln, start), ln)
    if stop is None:
        e = ln
    elif stop < 0:
        e = torch.clamp(ln + stop, min=0)
    else:
        e = torch.minimum(torch.full_like(ln, stop), ln)
    return s, torch.clamp((e - s + step - 1) // step, min=0)


def _slice_step(options) -> tuple:
    opts = options or SliceOptions()
    step = opts.step or 1
    if step == 0:
        raise ValueError("slice step cannot be zero")
    return opts.start, opts.stop, step


@register_function("binary_slice", Kind.SCALAR, 1,
                   options_class=SliceOptions)
def _binary_slice(args, options):
    a = _arg_array(args[0])
    start, stop, step = _slice_step(options)
    s, n = _slice_bounds(_lens(a), start, stop, step)

    def src_of(r, k):
        return a.offsets.index_select(0, r) + s.index_select(0, r) + k * step

    return _build_varlen(a, n, src_of, a.values.shape[0], "binary_slice")


@register_function("utf8_slice_codeunits", Kind.SCALAR, 1,
                   options_class=SliceOptions)
def _utf8_slice(args, options):
    """Python slicing of each row's codepoints (C28a: the JAX package
    slices bytes). Two levels of the shape-changing recipe: the output's
    codepoints (each row's count from the slice bounds; each names its
    source head), then their bytes."""
    a = _arg_array(args[0])
    start, stop, step = _slice_step(options)
    B = a.values.shape[0]
    cap = a.capacity
    dev = a.device
    if B == 0:
        return a
    is_head, _cp, _ = head_codepoints(a)
    _, cp_end, _ = _codepoint_spans(a, is_head)
    rank, pos = head_positions(is_head)
    cplen = torch.where(is_head, cp_end - _iota(B, dev), 0)
    s, n = _slice_bounds(_row_counts(a, is_head), start, stop, step)
    # level 1: output codepoint c of row r is the row's codepoint
    # s[r] + i * step, i = c - coff[r]; its global head rank g
    coff = _new_offsets(a, n).to(torch.int32)
    rc = rows_of_positions(coff, B).clamp_(0, max(cap - 1, 0))
    i = _iota(B, dev) - coff.index_select(0, rc)
    g = (rank.index_select(0, a.offsets.index_select(0, rc))
         + s.index_select(0, rc) + i * step)
    head = pos.index_select(0, g.clamp_(0, B)).clamp_(max=B - 1)
    live = _iota(B, dev) < coff[cap]
    L = torch.where(live, cplen.index_select(0, head), 0)
    # level 2: the bytes of the output codepoints, in order
    boff = torch.cat([L.new_zeros((1,)), torch.cumsum(L, 0,
                                                      dtype=torch.int32)])
    h = rows_of_positions(boff, B).clamp_(0, B - 1)
    q = _iota(B, dev)
    src = head.index_select(0, h) + q - boff.index_select(0, h)
    out = a.values.index_select(0, src.clamp_(0, B - 1))
    out.masked_fill_(q >= boff[B], 0)
    return Array(a.type, out, a.validity, offsets=boff.index_select(0, coff),
                 length=a.length)


def _trim_flags(a: Array, char_set: Optional[str], unicode: bool):
    """(B,) bool: the byte's character is in the trim set (None: the
    whitespace). With ``unicode``, characters are codepoints, and a
    continuation byte takes its head's flag."""
    b = a.values
    if unicode and (char_set is None or not char_set.isascii()):
        is_head, cp, _ = head_codepoints(a)
        if char_set is None:
            flag = predicate_flags(cp, "space")
        else:
            cps = sorted({ord(ch) for ch in char_set})
            flag = torch.isin(cp, torch.tensor(cps, dtype=torch.int32,
                                               device=a.device))
        hs, _, _ = _codepoint_spans(a, is_head)
        return (flag & is_head).index_select(
            0, hs.clamp_(0, max(b.shape[0] - 1, 0)))
    if char_set is None:
        return _SPACE(b)
    flag = torch.zeros_like(b, dtype=torch.bool)
    for c in np.unique(_pat_bytes(char_set)).tolist():
        flag |= b == c
    return flag


def _trim(a: Array, char_set: Optional[str], left: bool, right: bool,
          unicode: bool, name: str) -> Array:
    B = a.values.shape[0]
    if B == 0:
        return a
    keep = ~_trim_flags(a, char_set, unicode)
    count, first, last = _flag_positions(a, keep)
    start = a.offsets[:-1]
    lens = _lens(a)
    has = count > 0
    nstart = torch.where(has, first - start, lens) if left \
        else torch.zeros_like(lens)
    nend = torch.where(has, last - start + 1, 0) if right else lens
    n = torch.clamp(nend - nstart, min=0)

    def src_of(r, k):
        return start.index_select(0, r) + nstart.index_select(0, r) + k

    return _build_varlen(a, n, src_of, B, name)


for _name, _l, _r, _ws in [
    ("utf8_trim", True, True, False), ("utf8_ltrim", True, False, False),
    ("utf8_rtrim", False, True, False),
    ("ascii_trim", True, True, False), ("ascii_ltrim", True, False, False),
    ("ascii_rtrim", False, True, False),
    ("utf8_trim_whitespace", True, True, True),
    ("utf8_ltrim_whitespace", True, False, True),
    ("utf8_rtrim_whitespace", False, True, True),
    ("ascii_trim_whitespace", True, True, True),
    ("ascii_ltrim_whitespace", True, False, True),
    ("ascii_rtrim_whitespace", False, True, True),
]:
    register_function(_name, Kind.SCALAR, 1,
                      options_class=None if _ws else TrimOptions)(
        lambda args, options, _lf=_l, _rf=_r, _w=_ws, _n=_name: _trim(
            _arg_array(args[0]),
            None if _w else (options.characters if options else ""),
            _lf, _rf, _n.startswith("utf8"), _n))


def _pad(a: Array, options, side: str, unicode: bool, name: str) -> Array:
    """Pad each row to ``width`` characters: bytes for ascii_*, codepoints
    for utf8_* (C28b), the padding one character of either."""
    width = int(options.width)
    pad_str = options.padding or " "
    padding = _pat_bytes(pad_str)
    if unicode:
        if len(pad_str) != 1:
            raise ValueError("padding must be one codepoint")
    elif len(padding) != 1:
        raise ValueError("padding must be one byte")
    plen = len(padding)
    dev = a.device
    lens = _lens(a).to(torch.int64)
    chars = _row_counts(a, _is_codepoint(a.values)) if unicode else lens
    total_pad = torch.clamp(width - chars.to(torch.int64), min=0)
    if side == "left":
        lpad = total_pad
    elif side == "right":
        lpad = torch.zeros_like(total_pad)
    elif getattr(options, "lean_left_on_odd_padding", True):
        lpad = total_pad // 2
    else:
        lpad = (total_pad + 1) // 2
    lpad_b = lpad * plen
    pad_dev = torch.from_numpy(padding.copy()).to(dev)

    def src_of(r, k):
        src_k = k - lpad_b.index_select(0, r)
        ok = (src_k >= 0) & (src_k < lens.index_select(0, r))
        return torch.where(ok, a.offsets.index_select(0, r) + src_k, -1)

    def filler(r, k):
        at = k - lpad_b.index_select(0, r)
        at = torch.where(at < 0, k, at - lens.index_select(0, r))
        return pad_dev.index_select(0, at.remainder(plen))

    out_bcap = a.values.shape[0] + a.capacity * max(width, 1) * plen
    return _build_varlen(a, lens + total_pad * plen, src_of, out_bcap, name,
                         filler=filler)


for _name, _side in [("utf8_lpad", "left"), ("utf8_rpad", "right"),
                     ("utf8_center", "center"), ("ascii_lpad", "left"),
                     ("ascii_rpad", "right"), ("ascii_center", "center")]:
    register_function(_name, Kind.SCALAR, 1, options_class=PadOptions)(
        lambda args, options, _s=_side, _n=_name: _pad(
            _arg_array(args[0]), options, _s, _n.startswith("utf8"), _n))


# ---- repeat / join / replace ---------------------------------------------------

@register_function("binary_repeat", Kind.SCALAR, 2,
                   null_handling=NullHandling.INTERSECTION)
def _binary_repeat(args, options):
    a = _arg_array(args[0])
    reps = args[1]
    if isinstance(reps, Scalar):
        nrep = int(reps.value)
        reps_v = torch.full((a.capacity,), nrep, dtype=torch.int64,
                            device=a.device)
        max_rep = max(nrep, 0)
    else:
        reps_v = reps.values.to(torch.int64)
        max_rep = int(torch.where(a.row_mask(), reps_v, 0).max()) \
            if a.capacity else 0
    lens = _lens(a)

    def src_of(r, k):
        return a.offsets.index_select(0, r) + \
            k % lens.index_select(0, r).clamp(min=1)

    return _build_varlen(a, lens.to(torch.int64) * reps_v.clamp(min=0),
                         src_of, a.values.shape[0] * max(max_rep, 1),
                         "binary_repeat")


def _scalar_column(value, base: Array) -> Array:
    """A string scalar as a column of ``base``'s capacity."""
    sb = _pat_bytes(value or "")
    cap = base.capacity
    off = torch.arange(cap + 1, dtype=torch.int32, device=base.device) \
        * len(sb)
    vals = torch.from_numpy(np.tile(sb, cap).copy()).to(base.device)
    return Array(base.type, vals, None, offsets=off, length=base.length)


@register_function("binary_join_element_wise", Kind.SCALAR, -1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=JoinOptions)
def _binary_join_element_wise(args, options):
    """Concatenate N string columns with a separator (the last argument),
    row by row; null where any input or the separator is."""
    if len(args) < 2:
        raise ValueError("binary_join_element_wise needs >= 2 args")
    *cols_in, sep = args
    base = _arg_array(next(a for a in cols_in if isinstance(a, Array)))
    cap = base.capacity
    dev = base.device
    cols = [_scalar_column(c.value, base) if isinstance(c, Scalar)
            else _arg_array(c) for c in cols_in]
    sep_col = _scalar_column(sep.value, base) if isinstance(sep, Scalar) \
        else _arg_array(sep)
    # the pieces of a row in order: col 0, sep, col 1, sep, ..., col N-1
    pieces = []
    for i, c in enumerate(cols):
        if i:
            pieces.append((sep_col, _lens(sep_col)))
        pieces.append((c, torch.where(c.validity_or_true(), _lens(c), 0)))
    n = sum(ln.to(torch.int64) for _, ln in pieces)
    total_in = sum(c.values.shape[0] for c in cols) + (
        cap * len(_pat_bytes(sep.value or "")) if isinstance(sep, Scalar)
        else sep_col.values.shape[0])
    off64 = _new_offsets(base, n)
    out_bcap = max(_check_pool("binary_join_element_wise", off64,
                               int(total_in)), 1)
    new_off = off64.to(torch.int32)
    q = _iota(out_bcap, dev)
    r = rows_of_positions(new_off, out_bcap).clamp_(0, max(cap - 1, 0))
    k = q - new_off.index_select(0, r)
    out = torch.zeros((out_bcap,), dtype=torch.uint8, device=dev)
    lo = torch.zeros_like(k)
    for c, ln in pieces:
        ln_r = ln.index_select(0, r)
        hit = (k >= lo) & (k < lo + ln_r)
        if c.values.shape[0]:
            src = (c.offsets.index_select(0, r) + k - lo).clamp_(
                0, c.values.shape[0] - 1)
            out = torch.where(hit, c.values.index_select(0, src), out)
        lo = lo + ln_r
    out.masked_fill_(q >= new_off[cap], 0)
    validity = None
    for c in cols + [sep_col]:
        if c.validity is not None:
            validity = c.validity if validity is None \
                else validity & c.validity
    return Array(base.type, out, validity, offsets=new_off,
                 length=base.length)


@register_function("replace_substring", Kind.SCALAR, 1,
                   options_class=ReplaceSubstringOptions)
def _replace_substring(args, options):
    a = _arg_array(args[0])
    m = len(_pat_bytes(options.pattern))
    rep = _pat_bytes(options.replacement).tolist()
    rl = len(rep)
    if m == 0:
        raise NotImplementedError("replace of empty pattern")
    B = a.values.shape[0]
    cap = a.capacity
    if B == 0:
        return a
    dev = a.device
    match = _match_positions(a, MatchSubstringOptions(options.pattern))
    sel = _greedy_selected(a, match, m, options.max_replacements)
    S = _prefix(sel)
    # consumed: inside [s, s + m) of a selected s (windows are disjoint):
    # a selected start in [p - m + 1, p]
    behind = torch.cat([S.new_zeros((m - 1,)), S])[:B]
    consumed = (S[1:] - behind) > 0
    nsel = _row_counts(a, sel)
    n = _lens(a).to(torch.int64) + nsel.to(torch.int64) * (rl - m)
    off64 = _new_offsets(a, n)
    out_bcap = B + (B // m) * (rl - m) if rl > m else B
    out_bcap = max(_check_pool("replace_substring", off64, out_bcap), 1)
    new_off = off64.to(torch.int32)
    # output position of each kept byte and each selected start:
    # new_off[row] + pos - consumed before it + selected before it * rl
    rows = rows_of_bytes(a)
    rs = a.offsets.index_select(0, rows)
    C = _prefix(consumed)
    bidx = _iota(B, dev)
    dest = (new_off.index_select(0, rows) + bidx - rs
            - (C[:-1] - C.index_select(0, rs))
            + (S[:-1] - S.index_select(0, rs)) * rl)
    in_pool = bidx < a.offsets[cap]
    out = torch.zeros((out_bcap + 1,), dtype=torch.uint8, device=dev)
    keep = in_pool & ~consumed
    out.index_copy_(0, torch.where(keep, dest.clamp(0, out_bcap - 1),
                                   out_bcap).long(), a.values)
    at = sel & in_pool
    for k, byte in enumerate(rep):
        out.index_fill_(0, torch.where(at, dest + k, out_bcap)
                        .clamp_(0, out_bcap).long(), byte)
    return Array(a.type, out[:out_bcap], a.validity, offsets=new_off,
                 length=a.length)


# ---- exact varlen comparison (wired into scalar_compare) -----------------------

def _result(op: str, cmp: torch.Tensor) -> torch.Tensor:
    return {"equal": cmp == 0, "not_equal": cmp != 0, "less": cmp < 0,
            "less_equal": cmp <= 0, "greater": cmp > 0,
            "greater_equal": cmp >= 0}[op]


def _compare_scalar(a: Array, value) -> torch.Tensor:
    """(capacity,) int32: -1 / 0 / 1 as each row of ``a`` orders against
    the scalar's bytes: the first differing byte decides, else the
    length."""
    pat = _pat_bytes(value if value is not None else "")
    lens = _lens(a)
    dev = a.device
    bcap = a.values.shape[0]
    pool = a.values if bcap else torch.zeros((1,), dtype=torch.uint8,
                                             device=dev)
    starts = a.offsets[:-1].long()
    cmp = torch.zeros((a.capacity,), dtype=torch.int32, device=dev)
    decided = torch.zeros((a.capacity,), dtype=torch.bool, device=dev)
    for k, pb in enumerate(pat.tolist()):
        byte = pool[(starts + k).clamp_(0, max(bcap - 1, 0))].to(torch.int32)
        have = lens > k
        # a row that runs out first is a prefix of the scalar: less
        d = torch.where(have, torch.sign(byte - pb), -1).to(torch.int32)
        newly = ~decided & (d != 0)
        cmp = torch.where(newly, d, cmp)
        decided |= newly
    # the first len(pat) bytes are equal: a longer row is greater
    return torch.where(decided, cmp, (lens > len(pat)).to(torch.int32))


def _compare_arrays(a: Array, b: Array) -> torch.Tensor:
    """(capacity,) int32 row-wise order of two varlen columns of one
    capacity: an aligned walk over ``a``'s pool (byte j of row r against
    ``b``'s byte ``b.off[r] + j - a.off[r]``), the first differing position
    per row by one index-min, else the lengths. Every per-byte array is
    int32 or narrower and is freed once used."""
    cap = a.capacity
    dev = a.device
    lens_a, lens_b = _lens(a), _lens(b)
    len_cmp = torch.sign(lens_a - lens_b).to(torch.int32)
    bcap_a, bcap_b = a.values.shape[0], b.values.shape[0]
    if bcap_a == 0 or bcap_b == 0:
        return len_cmp
    rows = rows_of_positions(a.offsets, bcap_a).clamp_(0, max(cap - 1, 0))
    pos = torch.arange(bcap_a, dtype=torch.int32, device=dev)
    pos -= a.offsets.index_select(0, rows)          # byte j of its row
    src = b.offsets.index_select(0, rows)
    src += pos
    differ = a.values != b.values.index_select(0, src.clamp_(0, bcap_b - 1))
    del src
    # bytes past either row's end, or outside every row, differ in neither
    differ &= pos < torch.minimum(lens_a, lens_b).index_select(0, rows)
    differ &= pos >= 0
    rows.masked_fill_(~differ, cap)
    del differ
    first = torch.full((cap + 1,), _BIG, dtype=torch.int32, device=dev)
    first.index_reduce_(0, rows, pos, "amin")
    del rows, pos
    first = first[:cap]
    decided = first < _BIG
    at = torch.where(decided, first, 0)
    byte_a = a.values[(a.offsets[:-1] + at).clamp_(0, bcap_a - 1).long()]
    byte_b = b.values[(b.offsets[:-1] + at).clamp_(0, bcap_b - 1).long()]
    d = torch.sign(byte_a.to(torch.int32) - byte_b.to(torch.int32))
    return torch.where(decided, d.to(torch.int32), len_cmp)


def compare_varlen(op: str, a, b) -> torch.Tensor:
    """Exact lexicographic (unsigned) byte comparison: Array vs Array (one
    capacity) or Array vs Scalar, either side a dictionary of strings.
    Returns (capacity,) bool values; validity is the caller's."""
    if isinstance(a, Scalar) and isinstance(b, Array):
        return compare_varlen(_FLIP.get(op, op), b, a)
    if isinstance(b, Scalar):
        if isinstance(a.type, dt.DictionaryType):
            # through the dictionary: compare its values, gather by index
            inner = compare_varlen(op, a.dictionary, b)
            return inner[a.values.long().clamp(
                0, max(a.dictionary.capacity - 1, 0))]
        return _result(op, _compare_scalar(a, b.value))
    if isinstance(a.type, dt.DictionaryType):
        a = _decode(a)
    if isinstance(b.type, dt.DictionaryType):
        b = _decode(b)
    return _result(op, _compare_arrays(a, b))
