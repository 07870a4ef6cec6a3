"""Regex and host-elementwise string kernels: the host boundary; the
counterpart of the JAX package's ``ops/strings_regex.py`` for its eight
functions whose output is not nested.

Reference: the RE2-backed regex kernels of ``scalar_string_ascii.cc`` /
``scalar_string_utf8.cc``. A regex engine is scalar and backtracking:
Arrow runs RE2 on the CPU, and so does this port, through pyarrow compute
(RE2), with Python ``re`` where RE2 rejects the pattern (backreferences,
lookaround). The result goes back to the input's device. ``_via_pc``
takes one of three branches, as the JAX package's does:

  * a dictionary column: the regex over the dictionary's values on the
    host, then one device take by code;
  * a plain column of at least 65,536 rows (the pushdown): ONE device
    pass distinct-encodes it (``vector_hash._distinct``) and writes the
    unique values into 64-byte slots (``grouper.SlotStrings``); at most
    8,192 slots cross to the host, RE2 runs over them, and one device take
    by code brings the result back. More uniques, or one longer than its
    slot, fall to the direct hop;
  * the direct hop: the column to the host, RE2, the result back.

``binary_replace_slice``, ``utf8_replace_slice``, ``utf8_zero_fill`` and
``utf8_normalize`` are host-elementwise Python, as in the JAX package.
``HOST_HOPS`` counts the branches taken (``reset_host_hops`` zeroes it);
``arrow_tpu_torch.profile_step`` times them. pyarrow is imported only
inside the functions.

The seven functions of the JAX module whose output or input is a list or
a struct: the JAX package runs all seven as Python loops over the rows.
Here ``split_pattern``, ``utf8_split_whitespace``,
``ascii_split_whitespace`` and ``binary_join`` run on the device:

  * a split marks its separators (the greedy non-overlapping matches of
    the pattern, from the right for ``reverse``, through the pattern
    kernels of ``ops/strings``; or the maximal whitespace runs), counts
    each row's tokens for the list offsets, takes each token's first byte
    for the child offsets, and compacts the pool without the separator
    bytes by one launch of the compaction kernel
    (``cuda_kernels.filter_compact_columns``); one host read sizes the
    child (``_split_at``);
  * ``binary_join`` lays every element and the separator after it out as
    two segments of one gather (``selection._gather_bytes``), the lengths
    summed in int64 and one host read of the total, which must fit int32
    offsets.

``split_pattern_regex``, ``extract_regex`` and ``extract_regex_span`` are
regex host hops through ``_via_pc``; a nested result of its dictionary or
pushdown branch is taken by code on the host.

Where the port follows pyarrow and not the JAX package (ROADMAP C30):
``ascii_split_whitespace`` splits on ASCII whitespace only (the JAX
package's ``\\s+`` splits on Unicode whitespace) and
``utf8_split_whitespace`` on the codepoints of the oracle's ``space``
class; ``split_pattern`` with ``reverse`` and no ``max_splits`` matches
from the right (the JAX package matches from the left, which differs for a
self-overlapping pattern). ``reverse`` whitespace splits raise
``NotImplementedError``, as in the JAX package.
"""

from __future__ import annotations

import collections
import re

import numpy as np
import torch

from typing import Optional

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..utils.errors import ArrowInvalid
from . import selection
from .segment import _scatter, rows_of_positions
from .strings import MatchSubstringOptions, ReplaceSubstringOptions, \
    _arg_array, _greedy_selected, _lens, _match_positions, _pat_bytes, \
    _prefix, _row_counts, _trim_flags
from .unicode_text import row_heads, rows_of_bytes

__all__ = ["MatchSubstringOptions", "ReplaceSubstringOptions",
           "ReplaceSliceOptions", "ZeroFillOptions", "Utf8NormalizeOptions",
           "SplitOptions", "SplitPatternOptions", "ExtractRegexOptions",
           "HOST_HOPS", "reset_host_hops"]

_PUSHDOWN_MIN_ROWS = 65536      # below this the direct host hop is cheap
_PUSHDOWN_MAX_DISTINCT = 8192   # slot-buffer capacity for device uniques
_PUSHDOWN_SLOT_BYTES = 64       # the longest string the pushdown serves

# branch -> calls: "dictionary", "pushdown", "direct", "python_re" (the
# fallback for patterns RE2 rejects), "host_elementwise"
HOST_HOPS: collections.Counter = collections.Counter()


def reset_host_hops() -> None:
    HOST_HOPS.clear()


class SplitOptions:
    def __init__(self, max_splits: Optional[int] = None,
                 reverse: bool = False):
        self.max_splits = max_splits
        self.reverse = reverse


class SplitPatternOptions(SplitOptions):
    def __init__(self, pattern: str = "",
                 max_splits: Optional[int] = None, reverse: bool = False):
        super().__init__(max_splits, reverse)
        self.pattern = pattern


class ExtractRegexOptions:
    def __init__(self, pattern: str = ""):
        self.pattern = pattern


class ReplaceSliceOptions:
    def __init__(self, start: int = 0, stop: int = 0,
                 replacement: str = ""):
        self.start = start
        self.stop = stop
        self.replacement = replacement


class ZeroFillOptions:
    def __init__(self, width: int = 0, padding: str = "0"):
        self.width = width
        self.padding = padding


class Utf8NormalizeOptions:
    def __init__(self, form: str = "NFC"):
        self.form = form


def _compile(pattern: str, ignore_case: bool = False):
    return re.compile(pattern, re.IGNORECASE if ignore_case else 0)


def _from_py(objs, pa_type, like: Array) -> Array:
    import pyarrow as pa
    from ..core.interop import array_from_pyarrow
    return array_from_pyarrow(pa.array(objs, type=pa_type),
                              capacity=like.capacity, device=like.device)


def _host_elementwise(a: Array, fn, pa_type,
                      hop: str = "host_elementwise") -> Array:
    """fn over each value on the host; the result on ``a``'s device."""
    HOST_HOPS[hop] += 1
    return _from_py([None if v is None else fn(v) for v in a.to_pylist()],
                    pa_type, a)


def _pushdown_encode(a: Array):
    """One device pass: distinct-encode a varlen column and write the
    unique VALUES into fixed byte slots (not a varlen take, whose pool
    would be the input's size). Returns (codes int32 (cap,), n_distinct
    0-d, slots (R, W) u8, slot lengths (R,), slot error 0-d: nonzero when
    a distinct string is longer than W)."""
    from .grouper import SlotStrings
    from .vector_hash import _distinct
    codes, unique_rows, n = _distinct(a, include_nulls=False)
    R = _PUSHDOWN_MAX_DISTINCT
    dev = a.device
    n = torch.as_tensor(n, device=dev)
    rows = unique_rows[:R].clamp(0, max(a.capacity, 1) - 1)
    ridx = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
    pos = torch.where(ridx < torch.clamp(n, max=R), ridx, R)
    ss = SlotStrings.init(R, _PUSHDOWN_SLOT_BYTES, dev).scatter_from(
        a, rows, pos)
    return codes.clamp(min=0), n, ss.slots, ss.lens, ss.error


def _slots_to_pyarrow(a: Array, n: int, slots: torch.Tensor,
                      lens: torch.Tensor):
    """The first n slots as a pyarrow string (or binary) array, on the
    host, with no per-row Python."""
    import pyarrow as pa
    W = slots.shape[1]
    sl = slots[:n].cpu().numpy()
    ln = np.minimum(lens[:n].cpu().numpy().astype(np.int64), W)
    pool = np.ascontiguousarray(sl[np.arange(W)[None, :] < ln[:, None]])
    offs = np.zeros((n + 1,), np.int32)
    np.cumsum(ln, out=offs[1:])
    cls = pa.BinaryArray if isinstance(a.type, dt.BinaryType) \
        else pa.StringArray
    return cls.from_buffers(n, pa.py_buffer(offs.tobytes()),
                            pa.py_buffer(pool.tobytes()))


def _host_regex(name: str, pa_arr, pc_options):
    """RE2 through pyarrow compute on the host."""
    import pyarrow.compute as pc
    return getattr(pc, name)(pa_arr, options=pc_options)


def _via_pc(name: str, a: Array, pc_options, fallback) -> Array:
    """``name`` through RE2 on the host; ``fallback()`` only where RE2
    rejects the pattern (pyarrow's ArrowInvalid / ArrowNotImplementedError).
    Any other error propagates."""
    import pyarrow as pa
    from ..core.interop import (array_from_pyarrow, array_to_pyarrow,
                                host_dictionary)
    from .selection import take_array

    rejected = (pa.ArrowInvalid, pa.ArrowNotImplementedError)
    codes = uniq_pa = None
    uniq_cap = 0
    if isinstance(a.type, dt.DictionaryType) and a.dictionary is not None \
            and a.dictionary.type.is_varlen:
        uniq_cap = max(a.dictionary.capacity, 1)
        codes = Array(dt.int32, a.values.to(torch.int32).clamp(
            0, uniq_cap - 1), a.validity, length=a.length)
        uniq_pa = host_dictionary(a.dictionary)
        if uniq_pa is None:
            uniq_pa = array_to_pyarrow(a.dictionary)
        branch = "dictionary"
    elif a.type.is_varlen and a.capacity >= _PUSHDOWN_MIN_ROWS:
        # the codes stay on the device; only the <= R unique slots cross
        c_dev, n_dev, slots, lens, err = _pushdown_encode(a)
        n, err = torch.stack([n_dev.to(torch.int64).reshape(()),
                              err.to(torch.int64).reshape(())]).tolist()
        if n <= _PUSHDOWN_MAX_DISTINCT and not err:
            uniq_cap = _PUSHDOWN_MAX_DISTINCT
            uniq_pa = _slots_to_pyarrow(a, n, slots, lens)
            codes = Array(dt.int32, c_dev, a.validity, length=a.length)
            branch = "pushdown"

    if codes is not None:
        try:
            uniq_out = _host_regex(name, uniq_pa, pc_options)
        except rejected:
            return fallback()
        HOST_HOPS[branch] += 1
        if pa.types.is_nested(uniq_out.type):
            # a list or struct result is taken by code on the host: its
            # children's sizes are known there
            n = len(codes)
            idx = codes.values[:n].cpu().numpy()
            mask = None if codes.validity is None else \
                ~codes.validity[:n].cpu().numpy()
            return array_from_pyarrow(
                uniq_out.take(pa.array(idx, mask=mask)),
                capacity=codes.capacity, device=a.device)
        uniq_arr = array_from_pyarrow(uniq_out, capacity=uniq_cap,
                                      device=a.device)
        return take_array(uniq_arr, codes)

    try:
        out = _host_regex(name, array_to_pyarrow(a), pc_options)
    except rejected:
        return fallback()
    HOST_HOPS["direct"] += 1
    return array_from_pyarrow(out, capacity=a.capacity, device=a.device)


def _match_options(options):
    import pyarrow.compute as pc
    return pc.MatchSubstringOptions(
        options.pattern, ignore_case=getattr(options, "ignore_case", False))


def _register_regex(name: str, py_fn, pa_type_name: str):
    """A MatchSubstringOptions regex function: RE2 through ``_via_pc``,
    ``py_fn(compiled, s)`` per value where RE2 rejects the pattern."""
    @register_function(name, Kind.SCALAR, 1,
                       null_handling=NullHandling.COMPUTED,
                       options_class=MatchSubstringOptions)
    def _fn(args, options):
        import pyarrow as pa

        def slow():
            rx = _compile(options.pattern,
                          getattr(options, "ignore_case", False))
            return _host_elementwise(args[0], lambda s: py_fn(rx, s),
                                     getattr(pa, pa_type_name)(),
                                     "python_re")
        return _via_pc(name, args[0], _match_options(options), slow)
    return _fn


_register_regex("match_substring_regex",
                lambda rx, s: rx.search(s) is not None, "bool_")
_register_regex("count_substring_regex",
                lambda rx, s: len(rx.findall(s)), "int32")


def _find(rx, s) -> int:
    m = rx.search(s)
    return -1 if m is None else m.start()


_register_regex("find_substring_regex", _find, "int32")


@register_function("replace_substring_regex", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ReplaceSubstringOptions)
def _replace_substring_regex(args, options):
    import pyarrow as pa
    import pyarrow.compute as pc
    mr = getattr(options, "max_replacements", None)

    def slow():
        rx = _compile(options.pattern)
        # Python re takes \1 backreferences as RE2 does
        return _host_elementwise(
            args[0], lambda s: rx.sub(options.replacement, s,
                                      count=mr if mr is not None else 0),
            pa.string(), "python_re")
    return _via_pc("replace_substring_regex", args[0],
                   pc.ReplaceSubstringOptions(
                       options.pattern, options.replacement,
                       max_replacements=mr), slow)


@register_function("binary_replace_slice", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ReplaceSliceOptions)
@register_function("utf8_replace_slice", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ReplaceSliceOptions)
def _replace_slice(args, options):
    import pyarrow as pa
    st, sp, rep = options.start, options.stop, options.replacement
    return _host_elementwise(args[0], lambda s: s[:st] + rep + s[sp:],
                             pa.string())


@register_function("utf8_zero_fill", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ZeroFillOptions)
def _utf8_zero_fill(args, options):
    import pyarrow as pa
    w = options.width
    p = options.padding
    if p == "0":
        return _host_elementwise(args[0], lambda s: s.zfill(w), pa.string())

    def zf(s):
        if len(s) >= w:
            return s
        # s[:1] of "" is "", which `in "+-"` would take for a sign (the
        # JAX package's IndexError, ROADMAP C28f)
        sign = s[:1] if s[:1] in ("+", "-") else ""
        return sign + p * (w - len(s)) + s[len(sign):]
    return _host_elementwise(args[0], zf, pa.string())


@register_function("utf8_normalize", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=Utf8NormalizeOptions)
def _utf8_normalize(args, options):
    import pyarrow as pa
    import unicodedata
    form = options.form
    return _host_elementwise(
        args[0], lambda s: unicodedata.normalize(form, s), pa.string())


# ---- the nested functions ------------------------------------------------------

def _strings_arg(a) -> Array:
    """A string column as a plain varlen Array: a dictionary column
    decoded, its rows' nulls kept."""
    out = _arg_array(a)
    if out is not a and a.validity is not None:
        out = out.with_validity(out.validity_or_true() & a.validity)
    return out


def _split_at(a: Array, first: torch.Tensor, last: torch.Tensor,
              consumed: torch.Tensor) -> Array:
    """list<a.type> of the tokens of each present row between its
    separators: ``first`` / ``last`` flag each separator's first and last
    byte (separators are disjoint, in order, inside their rows),
    ``consumed`` their bytes. A row of s separators has s + 1 tokens, the
    empty ones included; a null row is a null list. The child's pool is
    the present rows' pool without the separator bytes (one launch of the
    compaction kernel); one host read of the token count sizes the
    child."""
    cap = a.capacity
    B = a.values.shape[0]
    dev = a.device
    ntok = torch.where(a.present_mask(), _row_counts(a, first) + 1, 0)
    list_off = _prefix(ntok)
    T = int(list_off[cap])
    tcap = max(T, 1)
    # the separators' last bytes compacted by rank (B past the last)
    L = _prefix(last)
    lastpos = _scatter(B + 1, B, torch.where(last, L[:-1], B + 1).long(),
                       torch.arange(B, dtype=torch.int32, device=dev))
    t = torch.arange(tcap, dtype=torch.int32, device=dev)
    r = rows_of_positions(list_off, tcap).clamp_(0, max(cap - 1, 0))
    j = t - list_off.index_select(0, r)
    row_start = a.offsets.index_select(0, r)
    before = _prefix(first).index_select(0, row_start) + j - 1
    start = torch.where(j == 0, row_start, lastpos.index_select(
        0, before.clamp_(0, B)) + 1)
    keep = selection._byte_selection(a.offsets, a.present_mask(), B) & \
        ~consumed
    K = _prefix(keep)
    child_off = torch.cat([torch.where(t < T, K.index_select(
        0, start.clamp_(0, B)), K[B]), K[B:]])
    pool = a.values
    if B:
        # called through ``selection``, as every caller of the kernel is
        (pool,), _ = selection.filter_compact_columns(keep, [pool])
    child = Array(a.type, pool, None, length=T, offsets=child_off)
    return Array(dt.list_(a.type), torch.zeros((0,), dtype=torch.uint8,
                                               device=dev), a.validity,
                 length=a.length, offsets=list_off, dictionary=child)


def _reversed_rows(a: Array) -> Array:
    """``a`` with each row's bytes in reverse order (the same offsets)."""
    B = a.values.shape[0]
    rows = rows_of_bytes(a).long()
    p = torch.arange(B, dtype=torch.int32, device=a.device)
    src = a.offsets[rows] + a.offsets[rows + 1] - 1 - p
    src = torch.where(p < a.offsets[a.capacity], src, p).clamp_(0, B - 1)
    return Array(a.type, a.values.index_select(0, src), a.validity,
                 length=a.length, offsets=a.offsets)


def _max_splits(options) -> Optional[int]:
    ms = getattr(options, "max_splits", None)
    return None if ms is None or ms < 0 else int(ms)


@register_function("split_pattern", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SplitPatternOptions)
def _split_pattern(args, options):
    """Split at the greedy non-overlapping matches of the pattern, at most
    ``max_splits`` of them; with ``reverse`` the matches are taken from
    the right (on each row's bytes reversed, the pattern reversed)."""
    a = _strings_arg(args[0])
    pat = _pat_bytes(options.pattern)
    m = len(pat)
    if m == 0:
        raise ArrowInvalid("Empty separator")
    B = a.values.shape[0]
    ms = _max_splits(options)
    if B == 0:
        none = torch.zeros((0,), dtype=torch.bool, device=a.device)
        return _split_at(a, none, none, none)
    if not options.reverse:
        first = _greedy_selected(a, _match_positions(a, options), m, ms)
    else:
        ra = _reversed_rows(a)
        rpat = MatchSubstringOptions(pat[::-1].tobytes())
        sel = _greedy_selected(ra, _match_positions(ra, rpat), m, ms)
        # a match at reversed byte s of row r starts at byte
        # offsets[r] + offsets[r + 1] - s - m
        rows = rows_of_bytes(a).long()
        p = torch.arange(B, dtype=torch.int32, device=a.device)
        at = a.offsets[rows] + a.offsets[rows + 1] - p - m
        first = torch.zeros((B + 1,), dtype=torch.bool, device=a.device)
        first.index_fill_(0, torch.where(sel, at, B).long(), True)
        first = first[:B]
    S = _prefix(first)
    # a byte is consumed when a selected start lies in [p - m + 1, p]
    behind = torch.cat([S.new_zeros((m - 1,)), S])[:B]
    consumed = (S[1:] - behind) > 0
    last = torch.cat([first.new_zeros((m - 1,)), first])[:B]
    return _split_at(a, first, last, consumed)


def _split_whitespace(a: Array, options, unicode: bool) -> Array:
    """Split on maximal whitespace runs, the first ``max_splits`` of each
    row, keeping empty leading and trailing tokens (" a " -> ['', 'a',
    ''])."""
    if options is not None and options.reverse:
        raise NotImplementedError("reverse whitespace split")
    a = _strings_arg(a)
    B = a.values.shape[0]
    dev = a.device
    if B == 0:
        none = torch.zeros((0,), dtype=torch.bool, device=dev)
        return _split_at(a, none, none, none)
    p = torch.arange(B, dtype=torch.int32, device=dev)
    ws = _trim_flags(a, None, unicode) & (p < a.offsets[a.capacity])
    heads = row_heads(a)
    no = torch.zeros((1,), dtype=torch.bool, device=dev)
    first = ws & ~(torch.cat([no, ws[:-1]]) & ~heads)
    last = ws & ~(torch.cat([ws[1:], no]) & ~torch.cat([heads[1:], ~no]))
    ms = _max_splits(options)
    if ms is not None:
        # the run's index in its row
        S = _prefix(first)
        rows = rows_of_bytes(a).long()
        ok = S[1:] - S.index_select(0, a.offsets[rows]) <= ms
        first, last, ws = first & ok, last & ok, ws & ok
    return _split_at(a, first, last, ws)


@register_function("utf8_split_whitespace", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SplitOptions)
def _utf8_split_whitespace(args, options):
    return _split_whitespace(args[0], options, unicode=True)


@register_function("ascii_split_whitespace", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SplitOptions)
def _ascii_split_whitespace(args, options):
    return _split_whitespace(args[0], options, unicode=False)


@register_function("split_pattern_regex", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SplitPatternOptions)
def _split_pattern_regex(args, options):
    import pyarrow as pa
    import pyarrow.compute as pc

    def slow():
        rx = _compile(options.pattern)
        ms = _max_splits(options)
        return _host_elementwise(
            args[0], lambda s: rx.split(s, maxsplit=ms or 0),
            pa.list_(pa.string()), "python_re")
    return _via_pc("split_pattern_regex", args[0],
                   pc.SplitPatternOptions(
                       options.pattern, max_splits=options.max_splits,
                       reverse=options.reverse), slow)


def _group_names(rx, name: str) -> list:
    names = [n for n, _ in sorted(rx.groupindex.items(),
                                  key=lambda kv: kv[1])]
    if not names:
        raise ValueError(f"{name} requires named groups (?P<name>...)")
    return names


@register_function("extract_regex", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ExtractRegexOptions)
def _extract_regex(args, options):
    """Named groups -> struct<group: string, ...>; null on no match
    (``extract_regex`` in scalar_string*.cc)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    def slow():
        rx = _compile(options.pattern)
        names = _group_names(rx, "extract_regex")

        def ext(s):
            mt = rx.search(s)
            return None if mt is None else {n: mt.group(n) for n in names}
        return _host_elementwise(
            args[0], ext, pa.struct([(n, pa.string()) for n in names]),
            "python_re")
    return _via_pc("extract_regex", args[0],
                   pc.ExtractRegexOptions(options.pattern), slow)


@register_function("extract_regex_span", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=ExtractRegexOptions)
def _extract_regex_span(args, options):
    """Named groups -> struct<group: fixed_size_list<int32, 2>, ...> of
    (byte offset, byte length) spans; null on no match, a null span for a
    group that took no part. Where RE2 rejects the pattern, Python ``re``
    runs over the UTF-8 bytes, so that the spans are byte spans."""
    import pyarrow as pa
    import pyarrow.compute as pc

    def slow():
        names = _group_names(_compile(options.pattern), "extract_regex_span")
        brx = re.compile(options.pattern.encode("utf-8"))

        def ext(s):
            mt = brx.search(s.encode("utf-8"))
            if mt is None:
                return None
            spans = {}
            for n in names:
                st, en = mt.span(n)
                spans[n] = None if st < 0 else [st, en - st]
            return spans
        return _host_elementwise(
            args[0], ext, pa.struct([(n, pa.list_(pa.int32(), 2))
                                     for n in names]), "python_re")
    return _via_pc("extract_regex_span", args[0],
                   pc.ExtractRegexSpanOptions(options.pattern)
                   if hasattr(pc, "ExtractRegexSpanOptions")
                   else pc.ExtractRegexOptions(options.pattern), slow)


_MAX_POOL = (1 << 31) - 1


@register_function("binary_join", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _binary_join(args, options):
    """list<string> and a separator (a scalar or a string column) -> the
    joined string; null if the list, the separator or any element is null
    (``scalar_string_ascii.cc`` binary_join). Every element and the
    separator after it (none after a row's last element) are two segments
    of one byte gather."""
    lists, sep = args
    if not isinstance(lists, Array) or \
            not isinstance(lists.type, dt.ListType):
        raise TypeError("binary_join expects a list<string> array")
    child = _strings_arg(lists.dictionary)
    cap = lists.capacity
    dev = lists.device
    off = lists.offsets
    ccap = child.capacity
    present = lists.present_mask()
    if isinstance(sep, Array):
        sep = _strings_arg(sep)
        sep_pool, sep_start = sep.values, sep.offsets[:-1]
        sep_len, sep_ok = _lens(sep), sep.validity_or_true()
    else:
        sv = sep.as_py()
        sb = b"" if sv is None else (sv.encode("utf-8")
                                     if isinstance(sv, str) else bytes(sv))
        sep_pool = torch.tensor(list(sb), dtype=torch.uint8, device=dev)
        sep_start = torch.zeros((cap,), dtype=torch.int32, device=dev)
        sep_len = torch.full((cap,), len(sb), dtype=torch.int32, device=dev)
        sep_ok = torch.full((cap,), sv is not None, dtype=torch.bool,
                            device=dev)
    valid = present & sep_ok
    if child.validity is not None:
        nulls = _prefix(~child.validity)
        valid &= nulls.index_select(0, off[1:]) == \
            nulls.index_select(0, off[:-1])
    t = torch.arange(ccap, dtype=torch.int32, device=dev)
    r = rows_of_positions(off, ccap).clamp_(0, max(cap - 1, 0))
    row_ok = valid.index_select(0, r) & (t < off[cap])
    last = t == off.index_select(0, r + 1) - 1
    elen = torch.where(row_ok, _lens(child), 0)
    slen = torch.where(row_ok & ~last, sep_len.index_select(0, r), 0)
    seg_len = torch.stack([elen, slen], 1).reshape(-1).to(torch.int64)
    CB = child.values.shape[0]
    seg_start = torch.stack([child.offsets[:-1],
                             sep_start.index_select(0, r) + CB], 1) \
        .reshape(-1)
    seg_off = torch.cat([seg_len.new_zeros((1,)), torch.cumsum(seg_len, 0)])
    total = int(seg_off[-1])
    if total > _MAX_POOL:
        raise ValueError(
            f"binary_join: an output pool of {total} bytes does not fit "
            "int32 offsets (at most 2^31 - 1 bytes): split the rows")
    seg_off = seg_off.to(torch.int32)
    pool = selection._gather_bytes(torch.cat([child.values, sep_pool]),
                                   seg_start, seg_off, max(total, 1))
    return Array(child.type, pool, valid, length=lists.length,
                 offsets=seg_off.index_select(0, 2 * off.long()))
