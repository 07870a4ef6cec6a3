"""Temporal field extraction, rounding, differences and time zones; the
counterpart of the JAX package's ``ops/temporal.py``.

Reference: ``cpp/src/arrow/compute/kernels/scalar_temporal_unary.cc`` /
``scalar_temporal_binary.cc`` (year/month/day/... extraction, ISO/US week
calendars, floor/ceil/round_temporal, the ``*_between`` family).

All extraction is int64 civil-calendar arithmetic on the device (Howard
Hinnant's days-from-civil / civil-from-days, closed form and branch-free).
torch's ``//`` and ``%`` on int64 tensors floor, as ``jnp.floor_divide``
and ``jnp.mod`` do, so instants before 1970 (and before year 0) land on the
right day.

Time zones come from the host's tz database through ``zoneinfo``, as in
the JAX package, but as a table: the zone's transitions over the column's
range (one host read of its min and max), found by sampling ``zoneinfo``
once a day and bisecting to the second, then ``torch.searchsorted`` on the
device. No value makes the trip to the host.

Where the port differs from the JAX package (ROADMAP C29):

  * (a) the fields, weeks, differences and calendars of a timestamp with a
    time zone are those of its local time, as pyarrow has them (the JAX
    package reads the stored UTC instant);
  * (c) ``assume_timezone``, ``local_timestamp`` and ``strptime``'s Python
    path compute in integers and keep every digit of the unit (the JAX
    package goes through microseconds and rounds float64 seconds).

``strftime`` / ``strptime`` are host hops through pyarrow (the reference
also calls libc), with a Python path for the formats pyarrow rejects.
"""

from __future__ import annotations

import functools
import re
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, varlen_from_numpy
from ..core.batch import Batch
from ..core.schema import Field, Schema
from ..compute.registry import Kind, NullHandling, register_function

__all__ = ["DayOfWeekOptions", "WeekOptions", "RoundTemporalOptions",
           "StrftimeOptions", "StrptimeOptions", "AssumeTimezoneOptions"]

_I64 = torch.int64


class DayOfWeekOptions:
    def __init__(self, count_from_zero: bool = True, week_start: int = 1):
        self.count_from_zero = count_from_zero
        self.week_start = week_start  # 1=Monday .. 7=Sunday


class WeekOptions:
    def __init__(self, week_starts_monday: bool = True,
                 count_from_zero: bool = False,
                 first_week_is_fully_in_year: bool = False):
        self.week_starts_monday = week_starts_monday
        self.count_from_zero = count_from_zero
        self.first_week_is_fully_in_year = first_week_is_fully_in_year


class RoundTemporalOptions:
    def __init__(self, multiple: int = 1, unit: str = "day",
                 week_starts_monday: bool = True,
                 ceil_is_strictly_greater: bool = False,
                 calendar_based_origin: bool = False):
        self.multiple = multiple
        self.unit = unit
        self.week_starts_monday = week_starts_monday
        self.ceil_is_strictly_greater = ceil_is_strictly_greater
        self.calendar_based_origin = calendar_based_origin


class StrftimeOptions:
    def __init__(self, format: str = "%Y-%m-%dT%H:%M:%S",
                 locale: str = "C"):
        self.format = format
        self.locale = locale


class StrptimeOptions:
    def __init__(self, format: str = "%Y-%m-%dT%H:%M:%S", unit: str = "us",
                 error_is_null: bool = False):
        self.format = format
        self.unit = unit
        self.error_is_null = error_is_null


class AssumeTimezoneOptions:
    def __init__(self, timezone: str = "UTC", ambiguous: str = "raise",
                 nonexistent: str = "raise"):
        self.timezone = timezone
        self.ambiguous = ambiguous
        self.nonexistent = nonexistent


# ---- civil calendar (Hinnant's algorithms) -----------------------------------

def civil_from_days(z: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """days-since-epoch -> (year, month, day), proleptic Gregorian."""
    z = z.to(_I64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(_I64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor
                    ) -> torch.Tensor:
    y = y.to(_I64) - (m <= 2).to(_I64)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + torch.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}
_DAY_NS = 86_400 * 1_000_000_000
_DAY_S = 86_400


def _unit_of(t: dt.DataType) -> Optional[int]:
    """ns per storage unit; None for date32 (days)."""
    if isinstance(t, dt.Date32Type):
        return None
    if isinstance(t, dt.Date64Type):
        return _UNIT_NS["ms"]
    if isinstance(t, (dt.TimestampType, dt.Time32Type, dt.Time64Type,
                      dt.DurationType)):
        return _UNIT_NS[t.unit]
    raise TypeError(f"not a temporal type: {t}")


# ---- time zones ----------------------------------------------------------------

# datetime's range, less two days at each end for the sampling margin
_S_MIN = -62135596800 + 2 * _DAY_S
_S_MAX = 253402300799 - 2 * _DAY_S
_FIXED = re.compile(r"^([+-])(\d\d):(\d\d)$")


@functools.lru_cache(maxsize=64)
def _zone_table(tz: str, lo_day: int, hi_day: int):
    """(transitions, offsets, dst flags) of zone ``tz`` over the UTC days
    [lo_day, hi_day]: the transitions' UTC seconds (ascending), and the
    offset (seconds) and dst flag before the first (index 0) and after
    each one. ``zoneinfo`` is read once a day over the range, and each
    change is bisected to its second (tzdata changes at whole seconds; two
    changes within one day would be missed: the tz database has none)."""
    m = _FIXED.match(tz)
    if tz == "UTC" or m:
        m = m or _FIXED.match("+00:00")
        off = (int(m.group(2)) * 3600 + int(m.group(3)) * 60) * \
            (-1 if m.group(1) == "-" else 1)
        return (np.zeros((0,), np.int64), np.array([off], np.int64),
                np.zeros((1,), np.bool_))
    import datetime as _dtm
    from zoneinfo import ZoneInfo
    zone = ZoneInfo(tz)

    def state(s: int):
        local = _dtm.datetime.fromtimestamp(s, tz=zone)
        return (int(local.utcoffset().total_seconds()),
                bool(local.dst()))

    lo = min(max((lo_day - 2) * _DAY_S, _S_MIN), _S_MAX)
    hi = min(max((hi_day + 2) * _DAY_S, _S_MIN), _S_MAX)
    trans, offs, dsts = [], [], []
    prev_s, prev = lo, state(lo)
    offs.append(prev[0])
    dsts.append(prev[1])
    for s in range(lo + _DAY_S, hi + _DAY_S, _DAY_S):
        cur = state(s)
        if cur != prev:
            a, b = prev_s, s          # state(a) == prev != state(b)
            while b - a > 1:
                mid = (a + b) // 2
                if state(mid) == prev:
                    a = mid
                else:
                    b = mid
            trans.append(b)
            offs.append(cur[0])
            dsts.append(cur[1])
        prev_s, prev = s, cur
    return (np.asarray(trans, np.int64), np.asarray(offs, np.int64),
            np.asarray(dsts, np.bool_))


def _seconds_range(secs: torch.Tensor, present: torch.Tensor):
    """(lo_day, hi_day) of the present rows' seconds: one host read."""
    if not bool(present.any()):
        return 0, 0
    big = torch.iinfo(_I64).max
    lo_hi = torch.stack([torch.where(present, secs, big).min(),
                         torch.where(present, secs, -big).max()])
    lo, hi = (int(x) for x in lo_hi.cpu())
    return lo // _DAY_S, hi // _DAY_S


def _zone_lookup(a: Array, tz: str, wall: bool):
    """(offset seconds, dst flag) of each row of a timestamp column in
    zone ``tz``, on its device. ``wall=False``: the values are UTC
    instants. ``wall=True``: they are local wall times, resolved as
    ``zoneinfo`` resolves fold=0 (an ambiguous time takes the earlier
    instant, a time in a gap the offset before it): a wall time is past a
    transition once it reaches the transition's instant plus the larger
    of the two offsets."""
    per_s = 10**9 // _UNIT_NS[a.type.unit]
    secs = a.values.to(_I64) // per_s
    lo_day, hi_day = _seconds_range(secs, a.present_mask())
    if wall:           # a wall time is within a day of its instant
        lo_day, hi_day = lo_day - 1, hi_day + 1
    trans, offs, dsts = _zone_table(tz, lo_day, hi_day)
    if wall and trans.shape[0]:
        trans = trans + np.maximum(offs[:-1], offs[1:])
    dev = a.device
    idx = torch.searchsorted(torch.from_numpy(trans).to(dev), secs,
                             right=True)
    return (torch.from_numpy(offs).to(dev)[idx],
            torch.from_numpy(dsts).to(dev)[idx])


def _zoned(t: dt.DataType) -> bool:
    return isinstance(t, dt.TimestampType) and t.tz not in (None, "UTC")


def _local_values(a: Array) -> torch.Tensor:
    """The stored values, shifted to local time where the column has a
    time zone (ROADMAP C29 (a))."""
    v = a.values.to(_I64)
    if not _zoned(a.type):
        return v
    off, _ = _zone_lookup(a, a.type.tz, wall=False)
    return v + off * (10**9 // _UNIT_NS[a.type.unit])


def _days_and_tod_ns(a: Array) -> Tuple[torch.Tensor, torch.Tensor]:
    """(days since epoch, time-of-day in ns >= 0), in local time."""
    t = a.type
    v = _local_values(a)
    if isinstance(t, dt.Date32Type):
        return v, torch.zeros_like(v)
    if isinstance(t, (dt.Time32Type, dt.Time64Type)):
        return torch.zeros_like(v), v * _unit_of(t)
    ns_per = _unit_of(t)
    per_day = _DAY_NS // ns_per
    days = v // per_day
    return days, (v - days * per_day) * ns_per


# ---- fields ---------------------------------------------------------------------

def _iso_weekday(z: torch.Tensor) -> torch.Tensor:
    """ISO weekday 1=Mon..7=Sun (1970-01-01 was a Thursday)."""
    return (z + 3) % 7 + 1


def _iso_year_week(z: torch.Tensor, sunday_start: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ISO (or US Sunday-start) year + week via the mid-week-day trick."""
    wd = (z + 4) % 7 + 1 if sunday_start else _iso_weekday(z)  # 1=Sun..7
    z_mid = z + (4 - wd)            # Thursday (ISO) / Wednesday (US)
    y, _, _ = civil_from_days(z_mid)
    one = torch.ones_like(y)
    return y, (z_mid - days_from_civil(y, one, one)) // 7 + 1


def _field(a: Array, name: str, options=None) -> Array:
    days, tod = _days_and_tod_ns(a)
    if name in ("year", "month", "day", "quarter", "is_leap_year",
                "day_of_year"):
        y, m, d = civil_from_days(days)
        if name == "year":
            out = y
        elif name == "month":
            out = m
        elif name == "day":
            out = d
        elif name == "quarter":
            out = (m - 1) // 3 + 1
        elif name == "day_of_year":
            one = torch.ones_like(y)
            out = days - days_from_civil(y, one, one) + 1
        else:
            leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
            return Array(dt.bool_, leap, a.validity, length=a.length)
    elif name == "day_of_week":
        opts = options or DayOfWeekOptions()
        shifted = ((days + 3) % 7 - (opts.week_start - 1)) % 7  # 0=Mon..
        out = shifted + (0 if opts.count_from_zero else 1)
    elif name in ("iso_year", "iso_week", "us_year", "us_week"):
        y, w = _iso_year_week(days, sunday_start=name.startswith("us"))
        out = y if name.endswith("year") else w
    elif name == "hour":
        out = tod // (3600 * 1_000_000_000)
    elif name == "minute":
        out = (tod // (60 * 1_000_000_000)) % 60
    elif name == "second":
        out = (tod // 1_000_000_000) % 60
    elif name == "millisecond":
        out = (tod // 1_000_000) % 1000
    elif name == "microsecond":
        out = (tod // 1_000) % 1000
    elif name == "nanosecond":
        out = tod % 1000
    elif name == "subsecond":
        # a 0-d tensor on the device: the card divides by a CPU scalar as
        # a product with its reciprocal, one ulp off the quotient
        frac = (tod % 1_000_000_000).to(torch.float64) / torch.tensor(
            1e9, dtype=torch.float64, device=tod.device)
        return Array(dt.float64, frac, a.validity, length=a.length)
    else:
        raise KeyError(name)
    return Array(dt.int64, out.to(_I64), a.validity, length=a.length)


for _name in ["year", "month", "day", "quarter", "day_of_year", "hour",
              "minute", "second", "millisecond", "microsecond",
              "nanosecond", "subsecond", "is_leap_year", "iso_year",
              "iso_week", "us_year", "us_week"]:
    register_function(_name, Kind.SCALAR, 1)(
        lambda args, options, _n=_name: _field(args[0], _n, options))

register_function("day_of_week", Kind.SCALAR, 1,
                  options_class=DayOfWeekOptions)(
    lambda args, options: _field(args[0], "day_of_week", options))


@register_function("week", Kind.SCALAR, 1, options_class=WeekOptions)
def _week(args, options):
    opts = options or WeekOptions()
    if opts.count_from_zero or opts.first_week_is_fully_in_year:
        raise NotImplementedError("non-default WeekOptions")
    (a,) = args
    days, _ = _days_and_tod_ns(a)
    _, w = _iso_year_week(days, sunday_start=not opts.week_starts_monday)
    return Array(dt.int64, w, a.validity, length=a.length)


@register_function("year_month_day", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED)
def _year_month_day(args, options):
    """Arrow emits struct<year,month,day>; this engine emits a 3-column
    Batch (structs surface as batches here, as in the JAX package)."""
    (a,) = args
    days, _ = _days_and_tod_ns(a)
    schema = Schema(tuple(Field(n, dt.int64, True)
                          for n in ("year", "month", "day")))
    return Batch(schema, [Array(dt.int64, x, a.validity, length=a.length)
                          for x in civil_from_days(days)], a.length)


# ---- temporal rounding ---------------------------------------------------------

_ROUND_UNIT_NS = {
    "nanosecond": 1, "microsecond": 1_000, "millisecond": 1_000_000,
    "second": 1_000_000_000, "minute": 60 * 1_000_000_000,
    "hour": 3600 * 1_000_000_000, "day": _DAY_NS, "week": 7 * _DAY_NS,
}


def _round_temporal(a: Array, options, mode: str) -> Array:
    """floor / ceil / round of the stored value to a multiple of the unit
    (the JAX package's: a zoned timestamp rounds its UTC instant, where
    pyarrow rounds the local time: ROADMAP C29 (e))."""
    opts = options or RoundTemporalOptions()
    if opts.unit not in _ROUND_UNIT_NS:
        raise NotImplementedError(f"round_temporal unit {opts.unit!r} "
                                  "(month/quarter/year are calendar-based)")
    t = a.type
    ns_per = _unit_of(t) or _DAY_NS
    scale_ns = _ROUND_UNIT_NS[opts.unit] * max(int(opts.multiple), 1)
    if scale_ns % ns_per != 0 and ns_per % scale_ns != 0:
        raise ValueError("rounding unit finer than storage unit")
    scale = max(scale_ns // ns_per, 1)
    v = a.values.to(_I64)
    shift = 0
    if opts.unit == "week":
        # weeks anchor on Monday (or Sunday): epoch was a Thursday
        shift = (4 if opts.week_starts_monday else 3) * (_DAY_NS // ns_per)
        v = v + shift
    if mode == "floor":
        out = v // scale * scale
    elif mode == "ceil":
        out = -((-v) // scale) * scale
        if opts.ceil_is_strictly_greater:
            out = torch.where(out == v, out + scale, out)
    else:
        out = (v + scale // 2) // scale * scale
    return Array(t, (out - shift).to(a.values.dtype), a.validity,
                 length=a.length)


for _m in ("floor", "ceil", "round"):
    register_function(f"{_m}_temporal", Kind.SCALAR, 1,
                      options_class=RoundTemporalOptions)(
        lambda args, options, _mm=_m: _round_temporal(args[0], options,
                                                      _mm))


# ---- strftime / strptime (host hops) --------------------------------------------

def _strings_out(text: np.ndarray, valid: Optional[np.ndarray], like: Array
                 ) -> Array:
    """A string column of ``like``'s capacity from host strings (nulls
    empty), its pool padded as staging pads it."""
    from ..core.interop import pad_capacity
    if valid is not None:
        text = np.where(valid, text, "")
    nbytes = int(np.char.str_len(np.char.encode(text, "utf-8")).sum()) \
        if text.size else 0
    return varlen_from_numpy(text.astype(str), validity=valid,
                             capacity=like.capacity,
                             byte_capacity=pad_capacity(max(nbytes, 1)),
                             device=like.device)


def _via_pyarrow(fn, a: Array, **kw):
    """``pyarrow.compute.<fn>`` of ``a`` on the host, back on a's device;
    None where pyarrow refuses (its Python path then decides)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from ..core.interop import array_from_pyarrow, array_to_pyarrow
    try:
        out = getattr(pc, fn)(array_to_pyarrow(a), **kw)
    except pa.ArrowException:
        return None
    return array_from_pyarrow(out, capacity=a.capacity, device=a.device)


@register_function("strftime", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=StrftimeOptions)
def _strftime(args, options):
    """Timestamp -> formatted string. HOST HOP: pyarrow's strftime (the
    reference implementation); Python's for the formats it rejects (``%f``:
    pyarrow's ``%S`` already carries the subseconds), over the local
    wall time at microseconds."""
    (a,) = args
    opts = options or StrftimeOptions()
    if "%f" not in opts.format:
        out = _via_pyarrow("strftime", a, format=opts.format)
        if out is not None:
            return out
    n = len(a)
    days, tod = _days_and_tod_ns(a)
    days = days[:n].cpu().numpy()
    stamps = (days.astype("datetime64[D]")
              + (tod[:n].cpu().numpy() // 1000).astype("timedelta64[us]"))
    valid = np.ones(n, bool) if a.validity is None else \
        a.validity[:n].cpu().numpy()
    years = stamps.astype("datetime64[Y]").astype(np.int64) + 1970
    if opts.format == _ISO_US and bool(np.all(
            ((years >= 1000) & (years <= 9999)) | ~valid)):
        # numpy's ISO text is strftime's for 4-digit years: one pass
        text = np.char.replace(np.datetime_as_string(stamps, unit="us"),
                               "T", " ")
    else:
        text = np.array([s.strftime(opts.format) if ok else ""
                         for s, ok in zip(stamps.astype(object), valid)],
                        dtype=object).astype(str)
    return _strings_out(text if n else np.zeros(0, str),
                        None if valid.all() else valid, a)


# the cast of a timestamp to a string formats with it (scalar_cast)
_ISO_US = "%Y-%m-%d %H:%M:%S.%f"


def _host_parse(a: Array, parse):
    """``parse(str) -> int or None`` once per distinct string of ``a``
    (pyarrow's ``dictionary_encode`` on the host finds them): (int64
    values, ok) numpy arrays of a's capacity; null and unparsed rows not
    ok."""
    from ..core.interop import array_to_pyarrow
    enc = array_to_pyarrow(a).dictionary_encode()
    uniques = enc.dictionary.to_pylist()
    conv = np.zeros((len(uniques) + 1,), np.int64)
    good = np.zeros((len(uniques) + 1,), np.bool_)
    for i, s in enumerate(uniques):
        v = parse(s)
        if v is not None:
            conv[i], good[i] = v, True
    n = len(a)
    codes = enc.indices.fill_null(len(uniques)).to_numpy()
    buf = np.zeros((a.capacity,), np.int64)
    ok = np.zeros((a.capacity,), np.bool_)
    buf[:n], ok[:n] = conv[codes], good[codes]
    return buf, ok


@register_function("strptime", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=StrptimeOptions)
def _strptime(args, options):
    """String -> timestamp. HOST HOP: pyarrow's strptime; Python's for
    ``%f`` (glibc's rejects it), in integers (ROADMAP C29 (c))."""
    import datetime as _dtm
    (a,) = args
    opts = options or StrptimeOptions()
    if "%f" not in opts.format:
        out = _via_pyarrow("strptime", a, format=opts.format,
                           unit=opts.unit, error_is_null=opts.error_is_null)
        if out is not None:
            return out
    epoch = _dtm.datetime(1970, 1, 1)
    scale = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[opts.unit]

    def parse(s):
        try:
            d = _dtm.datetime.strptime(s, opts.format) - epoch
        except ValueError:
            if opts.error_is_null:
                return None
            raise
        q = ((d.days * _DAY_S + d.seconds) * 10**6 + d.microseconds) * scale
        return q // 10**6 if q >= 0 else -((-q) // 10**6)  # toward zero

    buf, ok = _host_parse(a, parse)
    has_null = not bool(ok[:len(a)].all())
    return Array(dt.timestamp(opts.unit), torch.from_numpy(buf).to(a.device),
                 torch.from_numpy(ok).to(a.device) if has_null else None,
                 length=len(a))


# ---- temporal differences ("*_between", scalar_temporal_binary.cc) ----------

_BETWEEN_UNIT_NS = {
    "hours": 3600 * 10**9, "minutes": 60 * 10**9, "seconds": 10**9,
    "milliseconds": 10**6, "microseconds": 10**3, "nanoseconds": 1,
}


def _between_validity(a: Array, b: Array):
    validity = None
    for x in (a, b):
        if x.validity is not None:
            validity = x.validity if validity is None else \
                (validity & x.validity)
    return validity


def _register_between():
    def make(name):
        def _exec(args, options, _n=name):
            a, b = args
            da, ta = _days_and_tod_ns(a)
            db, tb = _days_and_tod_ns(b)
            if _n == "days":
                out = db - da
            elif _n == "weeks":
                # week-boundary crossings, Monday start (epoch day 4 was
                # the first Monday)
                out = (db - 4) // 7 - (da - 4) // 7
            elif _n in ("years", "quarters"):
                ya, ma, _ = civil_from_days(da)
                yb, mb, _ = civil_from_days(db)
                out = yb - ya if _n == "years" else \
                    (yb * 4 + (mb - 1) // 3) - (ya * 4 + (ma - 1) // 3)
            else:
                u = _BETWEEN_UNIT_NS[_n]
                out = (db * _DAY_NS + tb) // u - (da * _DAY_NS + ta) // u
            return Array(dt.int64, out.to(_I64), _between_validity(a, b),
                         length=a.length)
        return _exec

    for n in ["years", "quarters", "weeks", "days", "hours", "minutes",
              "seconds", "milliseconds", "microseconds", "nanoseconds"]:
        register_function(f"{n}_between", Kind.SCALAR, 2,
                          null_handling=NullHandling.COMPUTED)(make(n))


_register_between()


# ---- interval-producing *_between (scalar_temporal_binary.cc:178-275) ------

def _interval_struct(t, comps, validity, length, cap, device):
    children = tuple(Array(ft, v.to(torch.int64 if ft.bits == 64
                                    else torch.int32), None, length=length)
                     for (_n, ft), v in zip(t.fields, comps))
    return Array(t, torch.zeros((cap,), dtype=torch.uint8, device=device),
                 validity, length=length, children=children)


@register_function("month_interval_between", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _month_interval_between(args, options):
    """MonthsBetween (scalar_temporal_binary.cc:178): calendar month
    index difference as a month_interval."""
    a, b = args
    ya, ma, _ = civil_from_days(_days_and_tod_ns(a)[0])
    yb, mb, _ = civil_from_days(_days_and_tod_ns(b)[0])
    out = (yb * 12 + mb) - (ya * 12 + ma)
    return Array(dt.month_interval, out.to(torch.int32),
                 _between_validity(a, b), length=a.length)


@register_function("day_time_interval_between", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _day_time_interval_between(args, options):
    """DayTimeBetween (scalar_temporal_binary.cc:253): whole-day
    difference + time-of-day millisecond difference."""
    a, b = args
    da, ta = _days_and_tod_ns(a)
    db, tb = _days_and_tod_ns(b)
    return _interval_struct(dt.day_time_interval,
                            (db - da, tb // 1_000_000 - ta // 1_000_000),
                            _between_validity(a, b), a.length, a.capacity,
                            a.device)


@register_function("month_day_nano_interval_between", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _month_day_nano_interval_between(args, options):
    """MonthDayNanoBetween (scalar_temporal_binary.cc:224): calendar
    month difference, day-of-month difference, time-of-day nanosecond
    difference."""
    a, b = args
    da, ta = _days_and_tod_ns(a)
    db, tb = _days_and_tod_ns(b)
    ya, ma, dda = civil_from_days(da)
    yb, mb, ddb = civil_from_days(db)
    return _interval_struct(dt.month_day_nano_interval,
                            ((yb * 12 + mb) - (ya * 12 + ma), ddb - dda,
                             tb - ta),
                            _between_validity(a, b), a.length, a.capacity,
                            a.device)


@register_function("iso_calendar", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED)
def _iso_calendar(args, options):
    """struct<iso_year, iso_week, iso_day_of_week> (temporal.cc
    ISOCalendar): a struct-layout Array whose children are the three
    columns."""
    (a,) = args
    days, _ = _days_and_tod_ns(a)
    y, w = _iso_year_week(days, sunday_start=False)
    t = dt.struct([("iso_year", dt.int64), ("iso_week", dt.int64),
                   ("iso_day_of_week", dt.int64)])
    children = tuple(Array(dt.int64, v, a.validity, length=a.length)
                     for v in (y, w, _iso_weekday(days)))
    return Array(t, torch.zeros((a.capacity,), dtype=torch.uint8,
                                device=a.device), a.validity,
                 length=a.length, children=children)


# ---- time zones -----------------------------------------------------------------

@register_function("assume_timezone", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=AssumeTimezoneOptions)
def _assume_timezone(args, options):
    """Naive wall time -> instant in options.timezone (``temporal.cc``
    AssumeTimezone), resolved as ``zoneinfo`` resolves a wall time with
    fold=0, in integers."""
    (a,) = args
    off, _ = _zone_lookup(a, options.timezone, wall=True)
    out = a.values.to(_I64) - off * (10**9 // _UNIT_NS[a.type.unit])
    return Array(dt.timestamp(a.type.unit, options.timezone), out,
                 a.validity, length=a.length)


@register_function("local_timestamp", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED)
def _local_timestamp(args, options):
    """Instant -> naive local wall time in the column's time zone."""
    (a,) = args
    out = a.values.to(_I64)
    if a.type.tz is not None:
        out = _local_values(a)
    return Array(dt.timestamp(a.type.unit), out, a.validity,
                 length=a.length)


@register_function("is_dst", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED)
def _is_dst(args, options):
    """Daylight-saving flag of each instant in the column's time zone."""
    (a,) = args
    _, dst = _zone_lookup(a, a.type.tz or "UTC", wall=False)
    return Array(dt.bool_, dst, a.validity, length=a.length)
