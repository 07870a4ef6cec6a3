"""Cast kernels; the counterpart of the JAX package's ``ops/scalar_cast.py``.

Reference: ``scalar_cast_*.cc`` + ``cast.cc``. Numeric <-> numeric, bool
<-> numeric, temporal <-> temporal / int, dictionary decode and encode,
and the string casts. Unchecked semantics by default (Arrow
``safe=False``): a narrowing integer cast wraps.

Where torch and XLA differ, the port computes XLA's answer on both
devices:

  * **float -> integer saturates.** XLA truncates toward zero and clamps
    to the target's range, NaN -> 0 (float64 NaN -> int32 is 0, +inf and
    3e10 are 2147483647, -2.9 -> uint8 is 0). torch's ``.to()`` is C's
    undefined conversion (the CPU gives -2147483648 for all three, -2.9 ->
    uint8 254, and the card differs again), so ``_float_to_int`` clamps
    explicitly, in float64, before it converts.
  * uint16 / uint32 / uint64 sources and targets move through
    ``ops/bits.py`` (torch has no arithmetic on them on the card); uint64
    digits divide through ``scalar_arithmetic._udiv64``.

Where the port differs from the JAX package (ROADMAP C29 (b)):
``CastOptions(allow_overflow=False)`` raises ``ArrowInvalid`` naming the
cast when an integer (or float) value does not fit the integer target, as
pyarrow's safe cast does; the JAX package stores the flag and wraps.

The float -> string, string -> temporal and temporal -> string casts are
host hops, as in the JAX package: one device -> host copy, numpy (or
pyarrow) on the host, one copy back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from ..compute.scalar import Scalar
from ..utils import errors
from .bits import SIGNED_OF, as_signed_bits, unsigned_to_int64
from .kernel_utils import to_storage, torch_dtype, values_of
from .scalar_arithmetic import _udiv64, _uge
from .strings import _build_varlen, _flag_positions, _lens
from .unicode_text import rows_of_bytes

__all__ = ["CastOptions"]

_I64_MIN = -(1 << 63)


class CastOptions:
    def __init__(self, target_type: dt.DataType, allow_overflow: bool = True):
        self.target_type = target_type
        self.allow_overflow = allow_overflow


def dictionary_decode(a: Array) -> Array:
    """dictionary<T> -> T by gathering dictionary values at indices (a
    varlen pool sized to its rows)."""
    from .selection import take_array
    idx = Array(dt.int32, a.values.to(torch.int32), a.validity,
                length=a.length)
    return take_array(a.dictionary, idx)


@register_function("cast", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=CastOptions)
def _cast(args, options):
    (a,) = args
    if options is None:
        raise ValueError("cast requires CastOptions(target_type=...)")
    dst = options.target_type

    if isinstance(a, Scalar):
        raise NotImplementedError("cast of scalars: wrap in array")

    src = a.type
    if src == dst:
        return a

    if isinstance(src, dt.DictionaryType):
        decoded = dictionary_decode(a)
        if decoded.type == dst:
            return decoded
        return _cast([decoded], options)

    if isinstance(dst, dt.DictionaryType):
        from .vector_hash import dictionary_encode_array
        enc = a if src == dst.value_type else _cast(
            [a], CastOptions(dst.value_type, options.allow_overflow))
        return dictionary_encode_array(enc, index_type=dst.index_type)

    if src.is_integer and isinstance(dst, dt.StringType):
        return _int_to_string(a)
    if src.is_floating and isinstance(dst, dt.StringType):
        return _float_to_string(a)
    if isinstance(src, dt.BoolType) and isinstance(dst, dt.StringType):
        return _bool_to_string(a)
    if isinstance(src, dt.StringType) and dst.is_integer:
        return _string_to_int(a, dst)
    if isinstance(src, dt.StringType) and dst.is_floating:
        return _string_to_float(a, dst)
    if isinstance(src, dt.StringType) and isinstance(dst, dt.BoolType):
        return _string_to_bool(a)
    if isinstance(src, dt.StringType) and isinstance(
            dst, (dt.TimestampType, dt.Date32Type, dt.Date64Type)):
        return _string_to_temporal(a, dst)
    if src.is_temporal and isinstance(dst, dt.StringType):
        return _temporal_to_string(a)

    if src.is_temporal and dst.is_temporal:
        return _temporal_to_temporal(a, dst)
    if (src.is_numeric or isinstance(src, dt.BoolType) or src.is_temporal) \
            and (dst.is_numeric or isinstance(dst, dt.BoolType)
                 or dst.is_temporal):
        if not options.allow_overflow:
            _check_fits(a, dst)
        return Array(dst, _convert(a, dst), a.validity, length=a.length)

    raise NotImplementedError(f"cast {src} -> {dst}")


# ---- fixed-width conversion ---------------------------------------------------

def _int_range(t: dt.DataType):
    info = np.iinfo(t.storage_np)
    return int(info.min), int(info.max)


def _convert(a: Array, dst: dt.DataType) -> torch.Tensor:
    """Values of a numeric / bool / temporal column as ``dst``'s storage,
    as XLA's convert gives them."""
    src = a.type
    if isinstance(dst, dt.BoolType):
        return as_signed_bits(a.values) != 0
    if src.is_floating and not (dst.is_floating or isinstance(
            dst, dt.BoolType)):
        return _float_to_int(a.values, dst)
    if isinstance(src, dt.BoolType):
        return to_storage(a.values.to(torch.int64), dst)
    return values_of(a, dst)


def _float_to_int(v: torch.Tensor, dst: dt.DataType) -> torch.Tensor:
    """float -> integer storage of ``dst``: truncate toward zero, clamp to
    the range, NaN -> 0 (XLA's saturating convert), on either device."""
    lo, hi = _int_range(dst)
    x = v.to(torch.float64)
    t = torch.trunc(x)
    nan = torch.isnan(x)
    below = t <= float(lo)
    above = t >= float(hi)        # float(hi) rounds up past 2^53
    mid = torch.where(below | above | nan, 0.0, t)
    if torch_dtype(dst) == torch.uint64:
        big = mid >= 2.0 ** 63
        m = torch.where(big, (mid - 2.0 ** 63).to(torch.int64) + _I64_MIN,
                        mid.to(torch.int64))
        hi = -1                   # the bits of 2^64 - 1
    else:
        m = mid.to(torch.int64)
    out = torch.where(above, hi, torch.where(below, lo, m))
    return to_storage(out, dst)


def _check_fits(a: Array, dst: dt.DataType) -> None:
    """ROADMAP C29 (b): with ``allow_overflow=False`` an integer or float
    value that does not fit the integer target raises, naming the cast
    (pyarrow's safe cast); one host read."""
    src = a.type
    if not dst.is_integer or not (src.is_integer or src.is_floating):
        return
    lo, hi = _int_range(dst)
    if src.is_floating:
        x = a.values.to(torch.float64)
        t = torch.trunc(x)
        bad = torch.isnan(x) | (t < float(lo)) | (t >= float(hi) + 1.0)
    elif torch_dtype(src) == torch.uint64:
        bits = as_signed_bits(a.values)   # >= 2^63 reads negative
        bad = (bits < 0) | (bits > hi) if hi < (1 << 63) else \
            torch.zeros_like(bits, dtype=torch.bool)
    else:
        v = unsigned_to_int64(a.values) if a.values.dtype in SIGNED_OF \
            else a.values.to(torch.int64)
        bad = (v < lo) | (v > min(hi, (1 << 63) - 1))
    bad = bad & a.present_mask()
    if not bool(bad.any()):
        return
    i = int(torch.nonzero(bad)[0, 0])
    value = a.values[i:i + 1].cpu().numpy()[0].item()
    raise errors.ArrowInvalid(
        f"cast {src} -> {dst}: value {value} not in range: {lo} to {hi}")


# ---- temporal unit rescaling -------------------------------------------------

_UNIT_NS = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}


def _ns_per_tick(t: dt.DataType) -> int:
    """Nanoseconds represented by one stored unit of ``t``."""
    if isinstance(t, dt.Date32Type):
        return 86_400 * 10**9
    if isinstance(t, dt.Date64Type):
        return 10**6       # ms
    if isinstance(t, (dt.TimestampType, dt.DurationType, dt.Time32Type,
                      dt.Time64Type)):
        return _UNIT_NS[t.unit]
    raise NotImplementedError(f"temporal cast for {t}")


def _temporal_to_temporal(a: Array, dst: dt.DataType) -> Array:
    """Unit-aware temporal cast (``scalar_cast_temporal.cc``): upscaling
    multiplies; downscaling divides TRUNCATING TOWARD ZERO (C++ integer
    division: pre-epoch -1500 ms -> -1 s, as Arrow has it), calendar days
    and times of day floor (``//`` on int64 floors, as ``jnp.floor_divide``
    does)."""
    sn = _ns_per_tick(a.type)
    dn = _ns_per_tick(dst)
    v = a.values.to(torch.int64)
    to_date = isinstance(dst, (dt.Date32Type, dt.Date64Type)) and \
        not isinstance(a.type, (dt.Date32Type, dt.Date64Type))
    to_time = isinstance(dst, (dt.Time32Type, dt.Time64Type)) and \
        isinstance(a.type, dt.TimestampType)
    if to_date:
        # calendar-day casts FLOOR (pre-epoch instants belong to the
        # previous day), unlike plain unit downscale which truncates
        day = 86_400 * 10**9 // sn
        days = v // day
        out = days if isinstance(dst, dt.Date32Type) else days * 86_400_000
    elif to_time:
        day = 86_400 * 10**9 // sn
        tod = v - (v // day) * day  # time of day in src units
        k_up, k_dn = (sn // dn, 1) if sn >= dn else (1, dn // sn)
        out = tod * k_up // k_dn
    elif sn >= dn:
        out = v * (sn // dn)
    else:
        mag = v.abs() // (dn // sn)
        out = torch.where(v < 0, -mag, mag)
    return Array(dst, out.to(torch_dtype(dst)), a.validity, length=a.length)


# ---- string casts -------------------------------------------------------------

def _shell(a: Array) -> Array:
    """An empty string column of ``a``'s rows: ``_build_varlen``'s input
    when every output byte comes from its filler."""
    cap = a.capacity
    return Array(dt.string, torch.zeros((1,), dtype=torch.uint8,
                                        device=a.device), a.validity,
                 offsets=torch.zeros((cap + 1,), dtype=torch.int32,
                                     device=a.device), length=a.length)


def _bool_to_string(a: Array) -> Array:
    """bool -> "true" / "false" on the device (byte-table writes)."""
    v = a.values.to(torch.bool)
    lens = torch.where(v, 4, 5).to(torch.int32)
    table = torch.tensor([list(b"true\x00"), list(b"false")],
                         dtype=torch.uint8, device=a.device)

    def filler(r, k):
        row = torch.where(v.index_select(0, r), 0, 1)
        return table[row, k.clamp(0, 4)]

    return _build_varlen(_shell(a), lens, lambda r, k: torch.full_like(r, -1),
                         a.capacity * 5, "cast", filler=filler)


def _string_bytes(a: Array):
    """(pool, lowered pool, row lengths, row starts) of a string column;
    an empty pool reads as one zero byte."""
    pool = a.values if a.values.shape[0] else \
        torch.zeros((1,), dtype=torch.uint8, device=a.device)
    lower = torch.where((pool >= 65) & (pool <= 90), pool + 32, pool)
    return pool, lower, _lens(a), a.offsets[:-1]


def _row_sum(a: Array, per_byte: torch.Tensor) -> torch.Tensor:
    """(capacity,) per-row sums of an int64 per-byte value: differences
    of one prefix sum at the row offsets (wrapping sums: exact mod 2^64,
    as the JAX package's scatter-add of int64)."""
    c = torch.cat([per_byte.new_zeros((1,)), torch.cumsum(per_byte, 0)])
    off = a.offsets.long()
    return c.index_select(0, off[1:]) - c.index_select(0, off[:-1])


def _string_to_bool(a: Array) -> Array:
    """"1"/"true" -> True, "0"/"false" -> False (case-insensitive,
    ``scalar_cast_string.cc`` ParseBool semantics); unparseable rows
    become null (the unchecked-cast analog, as ``_string_to_int``)."""
    _, lower, lens, start = _string_bytes(a)
    bcap = lower.shape[0]

    def byte_at(j):
        return torch.where(j < lens,
                           lower[(start + j).clamp(0, bcap - 1).long()], 0)

    b = [byte_at(j) for j in range(5)]

    def _is(word: bytes):
        m = lens == len(word)
        for i, ch in enumerate(word):
            m = m & (b[i] == ch)
        return m

    t = _is(b"1") | _is(b"true")
    ok = t | _is(b"0") | _is(b"false")
    validity = ok if a.validity is None else (a.validity & ok)
    return Array(dt.bool_, t, validity, length=a.length)


def _float_to_string(a: Array) -> Array:
    """float -> shortest-roundtrip decimal string: Python's ``repr`` of
    the value (float32 / float16: of its own shortest digits read back as
    a float64), as the JAX package formats it, by numpy's conversions in
    one pass. HOST HOP."""
    from .temporal import _strings_out
    n = len(a)
    vals = a.values[:n].cpu().numpy()
    if vals.dtype != np.float64:
        vals = vals.astype(str).astype(np.float64)
    valid = None if a.validity is None else a.validity[:n].cpu().numpy()
    return _strings_out(vals.astype(str), None if valid is None or
                        valid.all() else valid, a)


def _string_to_temporal(a: Array, dst: dt.DataType) -> Array:
    """ISO-8601 string -> timestamp / date with ``datetime.fromisoformat``
    (the reference parses in C via ParseTimestampISO8601), once per
    distinct string (``temporal._host_parse``). HOST HOP."""
    import datetime as _dtm
    from .temporal import _host_parse
    epoch = _dtm.datetime(1970, 1, 1)
    scale = {"s": 10**6, "ms": 10**3, "us": 1}.get(getattr(dst, "unit", None))

    def parse(v):
        try:
            delta = _dtm.datetime.fromisoformat(v) - epoch
        except ValueError:
            raise ValueError(f"cannot parse {v!r} as {dst}")
        if isinstance(dst, dt.Date32Type):
            return delta.days
        if isinstance(dst, dt.Date64Type):
            return int(delta.total_seconds() * 1000)
        us = delta.days * 86_400_000_000 + delta.seconds * 10**6 \
            + delta.microseconds
        return us // scale if scale else us * 1000

    buf, ok = _host_parse(a, parse)
    n = len(a)
    validity = None if bool(ok[:n].all()) and a.validity is None \
        else torch.from_numpy(ok).to(a.device)
    return Array(dst, torch.from_numpy(buf.astype(dst.storage_np)).to(
        a.device), validity, length=a.length)


def _temporal_to_string(a: Array) -> Array:
    """timestamp / date -> ISO string via the strftime host hop (Arrow's
    cast formats ISO with unit-dependent precision)."""
    from ..compute.registry import call_function
    from .temporal import StrftimeOptions
    t = a.type
    if isinstance(t, (dt.Date32Type, dt.Date64Type)):
        fmt = "%Y-%m-%d"
    elif isinstance(t, dt.TimestampType) and t.unit == "s":
        fmt = "%Y-%m-%d %H:%M:%S"
    else:
        fmt = "%Y-%m-%d %H:%M:%S.%f"
    return call_function("strftime", [a],
                         options=StrftimeOptions(format=fmt))


def _pow10_bits(p: int) -> int:
    """10^p as the int64 holding its u64 bits."""
    x = 10 ** p
    return x - (1 << 64) if x >= (1 << 63) else x


def _int_to_string(a: Array) -> Array:
    """int -> decimal string on the device: per row its digit count by
    threshold compares and its 20 digits by repeated unsigned division
    of the magnitude's u64 bits (INT64_MIN and uint64 included); each
    output byte reads its digit (``scalar_cast_string.cc`` role)."""
    v = a.values
    if v.dtype in SIGNED_OF:
        mag = unsigned_to_int64(v)
        neg = torch.zeros_like(mag, dtype=torch.bool)
    else:
        v = v.to(torch.int64)
        neg = v < 0
        mag = torch.where(neg, -v, v)   # -INT64_MIN wraps to its 2^63 bits
    ndig = torch.ones(mag.shape, dtype=torch.int32, device=a.device)
    for p in range(1, 20):
        ndig += _uge(mag, torch.tensor(_pow10_bits(p), device=a.device)
                     ).to(torch.int32)
    digits = torch.empty((mag.shape[0], 20), dtype=torch.uint8,
                         device=a.device)
    q = mag
    for p in range(20):
        nq = _udiv64(q, torch.full_like(q, 10))
        digits[:, p] = (q - nq * 10).to(torch.uint8)
        q = nq
    digits = digits.reshape(-1)
    negi = neg.to(torch.int32)

    def filler(r, k):
        neg_r = negi.index_select(0, r)
        p = (ndig.index_select(0, r) - 1 - (k - neg_r)).clamp(0, 19)
        byte = digits.index_select(0, r.long() * 20 + p) + 48
        return torch.where((neg_r == 1) & (k == 0), 45, byte).to(torch.uint8)

    return _build_varlen(_shell(a), ndig + negi,
                         lambda r, k: torch.full_like(r, -1),
                         a.capacity * 21, "cast", filler=filler)


_POW10_I64 = [10 ** q for q in range(19)]


def _string_to_int(a: Array, dst: dt.DataType) -> Array:
    """decimal string -> integer with per-row validity (parse failures
    are nulls: the unchecked-cast analog of Arrow's safe=False). Each
    digit byte contributes digit * 10^place; per-row sums are prefix-sum
    differences at the offsets."""
    dev = a.device
    pool, _, lens, start = _string_bytes(a)
    bcap = pool.shape[0]
    cap = a.capacity
    rows = rows_of_bytes(a).long() if a.values.shape[0] else \
        torch.zeros((1,), dtype=torch.int64, device=dev)
    bidx = torch.arange(bcap, dtype=torch.int64, device=dev)
    first = pool[start.clamp(0, bcap - 1).long()]
    has_sign = ((first == 45) | (first == 43)) & (lens > 0)
    sign = torch.where(first == 45, -1, 1).to(torch.int64)
    ndig = lens - has_sign.to(lens.dtype)
    dpos = bidx - a.offsets.long()[rows] - has_sign.long()[rows]
    in_pool = bidx < a.offsets[cap]
    is_digit_pos = in_pool & (dpos >= 0)
    digit = (pool - 48).to(torch.int64)      # wraps as uint8, as JAX
    valid_byte = (pool >= 48) & (pool <= 57)
    p = (ndig.long()[rows] - 1 - dpos).clamp(0, 18)
    pow10 = torch.tensor(_POW10_I64, dtype=torch.int64, device=dev)
    contrib = torch.where(is_digit_pos, digit * pow10[p], 0)
    total = _row_sum(a, contrib)
    bad = _row_sum(a, (is_digit_pos & ~valid_byte).to(torch.int64)) > 0
    parse_ok = (ndig > 0) & (ndig <= 19) & ~bad
    out = to_storage(sign * total, dst)
    validity = parse_ok if a.validity is None else parse_ok & a.validity
    return Array(dst, out, validity, length=a.length)


_BIG = 2147483647


def _string_to_float(a: Array, dst: dt.DataType) -> Array:
    """decimal / scientific string -> float over the byte pool: each row's
    first '.' / 'e' from its flagged bytes, the integer, fraction and
    exponent digits as int64 sums (prefix-sum differences), scaled in
    float64. Not guaranteed correctly rounded in the last ulp (the JAX
    package's multi-step float math; Arrow's parser is)."""
    dev = a.device
    pool, pool_l, lens, start = _string_bytes(a)
    bcap = pool.shape[0]
    cap = a.capacity
    lens = lens.long()
    start = start.long()
    rows = rows_of_bytes(a).long() if a.values.shape[0] else \
        torch.zeros((1,), dtype=torch.int64, device=dev)
    bidx = torch.arange(bcap, dtype=torch.int64, device=dev)
    in_pool = bidx < a.offsets[cap]
    off = a.offsets.long()
    pos = bidx - off[rows]

    def first_pos_of(byte_val):
        count, first, _ = _flag_positions(a, in_pool & (pool_l == byte_val))
        return torch.where(count > 0, first.long() - start, _BIG)

    def row_sum(x):
        return _row_sum(a, x)

    dot = first_pos_of(46)       # '.'
    epos = first_pos_of(101)     # 'e'
    first = pool[start.clamp(0, bcap - 1)]
    has_sign = ((first == 45) | (first == 43)) & (lens > 0)
    sign = torch.where(first == 45, -1.0, 1.0).to(torch.float64)
    mant_end = torch.minimum(torch.minimum(dot, epos), lens)  # int digits
    frac_end = torch.minimum(epos, lens)

    digit = (pool - 48).to(torch.int64)      # wraps as uint8, as JAX
    is_digit = (pool >= 48) & (pool <= 57)
    pow10 = torch.tensor(_POW10_I64, dtype=torch.int64, device=dev)
    # integer part: digits in [sign, mant_end)
    ip_lo = has_sign.long()
    ip_in = in_pool & (pos >= ip_lo[rows]) & (pos < mant_end[rows])
    ip_p = (mant_end[rows] - 1 - pos).clamp(0, 18)
    int_sum = row_sum(torch.where(ip_in, digit * pow10[ip_p], 0))
    n_int = (mant_end - ip_lo).clamp(min=0)
    # fraction: digits in (dot, frac_end)
    fr_in = in_pool & (pos > dot[rows]) & (pos < frac_end[rows])
    fr_p = (pos - dot[rows] - 1).clamp(0, 18)
    frac_sum = row_sum(torch.where(fr_in, digit * pow10[18 - fr_p], 0))
    n_frac = torch.where(dot == _BIG, 0, (frac_end - dot - 1).clamp(min=0))
    # exponent: signed int after 'e'
    ex_sign_pos = epos + 1
    exb = pool[(start + ex_sign_pos).clamp(0, bcap - 1)]
    ex_has_sign = (exb == 45) | (exb == 43)
    ex_sign = torch.where(exb == 45, -1, 1).to(torch.int64)
    ex_lo = ex_sign_pos + ex_has_sign.long()
    ex_in = in_pool & (pos >= ex_lo[rows]) & (pos < lens[rows]) & \
        (epos[rows] != _BIG)
    ex_p = (lens[rows] - 1 - pos).clamp(0, 18)
    exp_sum = row_sum(torch.where(ex_in, digit * pow10[ex_p], 0))
    n_exp = torch.where(epos == _BIG, -1, lens - ex_lo)
    exp_val = ex_sign * exp_sum
    # combine in float64: (int + frac*10^-19) * 10^exp
    mag = (int_sum.to(torch.float64) + frac_sum.to(torch.float64) * 1e-19) \
        * torch.pow(10.0, exp_val.clamp(-330, 330).to(torch.float64))
    out = sign * mag
    # bad-character / structure detection
    is_struct = (pool_l == 46) | (pool_l == 101) | (pool == 43) | \
        (pool == 45)
    bad = row_sum((in_pool & ~is_digit & ~is_struct).to(torch.int64)) > 0
    parse_ok = ~bad & ((n_int > 0) | (n_frac > 0)) & (n_exp != 0) & \
        (n_int <= 19)

    # special literals: inf / -inf / nan (case-insensitive)
    def _is_word(word: str):
        m = lens == len(word)
        for k, ch in enumerate(word.encode()):
            m = m & (pool_l[(start + k).clamp(0, bcap - 1)] == ch)
        return m

    is_inf, is_nan, neg_inf = _is_word("inf"), _is_word("nan"), \
        _is_word("-inf")
    out = torch.where(is_inf, float("inf"), out)
    out = torch.where(neg_inf, float("-inf"), out)
    out = torch.where(is_nan, float("nan"), out)
    parse_ok = parse_ok | is_inf | is_nan | neg_inf
    validity = parse_ok if a.validity is None else parse_ok & a.validity
    return Array(dst, out.to(torch_dtype(dst)), validity, length=a.length)
