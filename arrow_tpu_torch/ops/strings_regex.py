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
a struct (``split_pattern``, ``split_pattern_regex``,
``ascii_split_whitespace``, ``utf8_split_whitespace``, ``extract_regex``,
``extract_regex_span``, ``binary_join``) come with the nested layouts
(ROADMAP A7).
"""

from __future__ import annotations

import collections
import re

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from .strings import MatchSubstringOptions, ReplaceSubstringOptions

__all__ = ["MatchSubstringOptions", "ReplaceSubstringOptions",
           "ReplaceSliceOptions", "ZeroFillOptions", "Utf8NormalizeOptions",
           "HOST_HOPS", "reset_host_hops"]

_PUSHDOWN_MIN_ROWS = 65536      # below this the direct host hop is cheap
_PUSHDOWN_MAX_DISTINCT = 8192   # slot-buffer capacity for device uniques
_PUSHDOWN_SLOT_BYTES = 64       # the longest string the pushdown serves

# branch -> calls: "dictionary", "pushdown", "direct", "python_re" (the
# fallback for patterns RE2 rejects), "host_elementwise"
HOST_HOPS: collections.Counter = collections.Counter()


def reset_host_hops() -> None:
    HOST_HOPS.clear()


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
    import pyarrow.compute as pc
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
        uniq_arr = array_from_pyarrow(uniq_out, capacity=uniq_cap,
                                      device=a.device)
        grow = 1
        if uniq_arr.type.is_varlen:
            # every output row may repeat the LONGEST unique value: sizes
            # are known on the host here, so the bound is exact
            max_len = int(pc.max(pc.binary_length(uniq_out)).as_py() or 0)
            pool = max(int(uniq_arr.values.shape[0]), 1)
            grow = max(1, -(-codes.capacity * max(max_len, 1) // pool))
        return take_array(uniq_arr, codes, grow)

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
