"""Port parity of the temporal functions (``ops/temporal.py``) with the
JAX package's, on the same pyarrow data made from a seed, on the CPU:
the 17 field extractors at every timestamp unit and on date32 / date64
(instants before 1970 and dates before year 0 pinned), day_of_week /
week options, year_month_day, the three roundings, strftime / strptime,
the ``*_between`` family, the interval functions and iso_calendar (their
children), and the time-zone functions. Exact, but ``subsecond``
(float64 of the same integer: exact too).

Where the port does not copy a fault of the JAX package (ROADMAP C29 (a):
the fields of a zoned timestamp are UTC fields there; C29 (c): the zone
host hop drops sub-microsecond digits and rounds float seconds), it is
held against pyarrow and the JAX package's difference is kept on record.
"""

import datetime as dtm

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from arrow_tpu.compute import call_function as jcall
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.ops import temporal as ttemporal

from torch_parity import assert_same, both, stage

FIELDS = ["year", "month", "day", "quarter", "day_of_year", "hour",
          "minute", "second", "millisecond", "microsecond", "nanosecond",
          "subsecond", "is_leap_year", "iso_year", "iso_week", "us_year",
          "us_week"]
ZONES = ["America/New_York", "Europe/Paris"]
_PER_S = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def rand_timestamps(seed, n=300, unit="us", tz=None, null_every=9):
    """Instants over 1906-2096 with every digit of the unit, one row in
    ``null_every`` null, the epoch's neighbours pinned."""
    rng = np.random.default_rng(seed)
    per = _PER_S[unit]
    v = rng.integers(-2_000_000_000, 4_000_000_000, n) * per + \
        rng.integers(0, per, n)
    v[:4] = [-1, 0, -per, -86_400 * per - 1]
    vals = [None if i % null_every == 5 else int(x)
            for i, x in enumerate(v)]
    return pa.array(vals, pa.int64()).cast(pa.timestamp(unit, tz))


def rand_dates(seed, n=200, far=False):
    rng = np.random.default_rng(seed)
    lo, hi = (-1_200_000, -700_000) if far else (-40_000, 40_000)
    d = rng.integers(lo, hi, n)
    d[:3] = [-1, 0, -719_468] if not far else d[:3]  # 1969-12-31, 0000-03-01
    return pa.array(d.astype(np.int32)).cast(pa.date32())


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("fn", FIELDS)
def test_fields_timestamp(fn, unit):
    a = rand_timestamps(1, unit=unit)
    got = both(fn, [a], capacity=512)
    if fn != "nanosecond" or unit == "ns":
        assert got.to_pylist() == getattr(pc, fn)(a).to_pylist()


@pytest.mark.parametrize("far", [False, True], ids=["near", "before_year_0"])
@pytest.mark.parametrize("fn", ["year", "month", "day", "quarter",
                                "day_of_year", "is_leap_year", "iso_year",
                                "iso_week", "us_year", "us_week",
                                "day_of_week"])
def test_fields_date32(fn, far):
    """Dates before 1970 and before year 0 (Hinnant's floor divisions:
    torch's ``//`` on int64 floors as ``jnp.floor_divide`` does)."""
    a = rand_dates(2, far=far)
    got = both(fn, [a], capacity=256)
    if not far:
        assert got.to_pylist() == getattr(pc, fn)(a).to_pylist()


def test_fields_date64_and_times():
    d64 = pa.array([0, -1, 86_400_000 * 365 + 5, None], pa.int64()).cast(
        pa.date64())
    for fn in ("year", "month", "day", "hour"):
        both(fn, [d64])
    rng = np.random.default_rng(3)
    for t, hi in ((pa.time32("s"), 86_400), (pa.time32("ms"), 86_400_000),
                  (pa.time64("us"), 86_400 * 10**6),
                  (pa.time64("ns"), 86_400 * 10**9)):
        storage = pa.int32() if t.bit_width == 32 else pa.int64()
        a = pa.array(rng.integers(0, hi, 50), storage).cast(t)
        for fn in ("hour", "minute", "second", "millisecond",
                   "microsecond", "nanosecond", "subsecond"):
            got = both(fn, [a])
            if fn in ("hour", "minute", "second", "millisecond"):
                assert got.to_pylist() == getattr(pc, fn)(a).to_pylist()


@pytest.mark.parametrize("cfz,ws", [(True, 1), (False, 1), (True, 7),
                                    (False, 3)])
def test_day_of_week_options(cfz, ws):
    a = rand_dates(4, n=40)
    got = both("day_of_week", [a], count_from_zero=cfz, week_start=ws)
    assert got.to_pylist() == pc.day_of_week(
        a, count_from_zero=cfz, week_start=ws).to_pylist()


@pytest.mark.parametrize("monday", [True, False])
def test_week(monday):
    a = rand_dates(5, n=150)
    got = both("week", [a], week_starts_monday=monday)
    assert got.to_pylist() == pc.week(
        a, week_starts_monday=monday).to_pylist()


def test_year_month_day():
    a = rand_timestamps(6, n=80, unit="s")
    t, j = stage(a)
    got = tcall("year_month_day", [t])
    want = jcall("year_month_day", [j])
    for name in ("year", "month", "day"):
        assert_same(got.column(name), want.column(name))
        assert got.column(name).to_pylist() == \
            getattr(pc, name)(a).to_pylist()


@pytest.mark.parametrize("mode", ["floor_temporal", "ceil_temporal",
                                  "round_temporal"])
@pytest.mark.parametrize("mult,unit", [(1, "hour"), (15, "minute"),
                                       (1, "day"), (30, "second"),
                                       (2, "week"), (250, "millisecond")])
@pytest.mark.parametrize("ts_unit", ["us", "ns"])
def test_round_temporal(mode, mult, unit, ts_unit):
    a = rand_timestamps(7, n=120, unit=ts_unit)
    got = both(mode, [a], multiple=mult, unit=unit)
    if unit != "week":
        assert got.to_pylist() == getattr(pc, mode)(
            a, multiple=mult, unit=unit).to_pylist()


def test_round_temporal_strictly_greater_and_date32():
    a = rand_timestamps(8, n=60, unit="s")
    both("ceil_temporal", [a], unit="minute", ceil_is_strictly_greater=True)
    both("floor_temporal", [rand_dates(9, n=50)], unit="week",
         week_starts_monday=False)


@pytest.mark.parametrize("fmt", ["%Y-%m-%d %H:%M:%S", "%d/%m/%Y",
                                 "%Y-%m-%d %H:%M:%S.%f"])
@pytest.mark.parametrize("unit", ["s", "us"])
def test_strftime(fmt, unit):
    both("strftime", [rand_timestamps(10, n=60, unit=unit)], capacity=64,
         format=fmt)


def test_strptime():
    s = pa.array(["2020-01-31 10:20:30", "1969-07-20 20:17:40", None,
                  "2100-02-28 00:00:01"])
    both("strptime", [s], format="%Y-%m-%d %H:%M:%S", unit="s")
    f = pa.array(["2020-01-31 10:20:30.123456", "1969-07-20 20:17:40.5",
                  None, "1969-12-31 23:59:59.999999"])
    for unit in ("s", "ms", "us", "ns"):
        both("strptime", [f], format="%Y-%m-%d %H:%M:%S.%f", unit=unit)
    bad = pa.array(["2020-01-31 10:20:30.1", "garbage"])
    both("strptime", [bad], format="%Y-%m-%d %H:%M:%S.%f", unit="us",
         error_is_null=True)
    with pytest.raises(ValueError):
        tcall("strptime", [stage(bad)[0]], format="%Y-%m-%d %H:%M:%S.%f")


BETWEEN = ["years_between", "quarters_between", "weeks_between",
           "days_between", "hours_between", "minutes_between",
           "seconds_between", "milliseconds_between",
           "microseconds_between", "nanoseconds_between"]


@pytest.mark.parametrize("fn", BETWEEN)
def test_between(fn):
    a = rand_timestamps(11, n=100, unit="ns")
    b = rand_timestamps(12, n=100, unit="ns")
    got = both(fn, [a, b], capacity=128)
    assert got.to_pylist() == getattr(pc, fn)(a, b).to_pylist()


@pytest.mark.parametrize("fn", ["month_interval_between",
                                "day_time_interval_between",
                                "month_day_nano_interval_between"])
def test_interval_between(fn):
    """Against the JAX package, children and all; month_day_nano also
    against pyarrow (pyarrow 25 cannot wrap its own month_interval and
    day_time_interval results in Python: KeyError 21)."""
    a = rand_timestamps(13, n=70, unit="ms")
    b = rand_timestamps(14, n=70, unit="ms")
    got = both(fn, [a, b], capacity=128)
    if fn == "month_day_nano_interval_between":
        assert got.to_pylist() == getattr(pc, fn)(a, b).to_pylist()


def test_iso_calendar():
    d = rand_dates(15, n=90)
    t, j = stage(d, capacity=128)
    got = tcall("iso_calendar", [t])
    want = jcall("iso_calendar", [j])
    assert_same(got, want)
    rows = pc.iso_calendar(d).to_pylist()
    for i, name in enumerate(("iso_year", "iso_week", "iso_day_of_week")):
        assert got.children[i].with_validity(got.validity).to_pylist() == \
            [None if r is None else r[name] for r in rows]


def zone_oracle(a: pa.Array):
    """Each instant's local wall time by Python's zoneinfo, row by row
    (None for nulls). pyarrow 25's tz reader knows no daylight saving
    past 2037 (the explicit transitions of the zone's file end there),
    so pyarrow is the oracle of the rows before 2038 and zoneinfo of
    all."""
    from zoneinfo import ZoneInfo
    zone = ZoneInfo(a.type.tz)
    per = _PER_S[a.type.unit]
    return [None if v is None else
            dtm.datetime.fromtimestamp(v // per, tz=zone).replace(
                tzinfo=None)
            for v in a.cast(pa.int64()).to_pylist()]


def before_2038(a: pa.Array) -> np.ndarray:
    lim = pa.scalar(dtm.datetime(2038, 1, 1), pa.timestamp("s"))
    return pc.fill_null(pc.less(a.cast(pa.timestamp(a.type.unit)),
                                lim.cast(pa.timestamp(a.type.unit))),
                        True).to_numpy(zero_copy_only=False)


_WALL = {"year": lambda w: w.year, "day": lambda w: w.day,
         "hour": lambda w: w.hour, "minute": lambda w: w.minute,
         "day_of_week": lambda w: w.weekday(),
         "iso_week": lambda w: w.isocalendar()[1],
         "day_of_year": lambda w: w.timetuple().tm_yday,
         "is_leap_year": lambda w: w.year % 4 == 0 and (
             w.year % 100 != 0 or w.year % 400 == 0)}


def _masked(values, keep):
    return [v for v, k in zip(values, keep) if k]


@pytest.mark.parametrize("fn", list(_WALL))
@pytest.mark.parametrize("tz", ZONES)
def test_zoned_fields_are_local_c29a(fn, tz):
    """C29 (a): fields of a zoned timestamp are local, as pyarrow has
    them; the JAX package's are the UTC instant's."""
    a = rand_timestamps(16, n=200, unit="ns", tz=tz)
    t, j = stage(a)
    got = tcall(fn, [t]).to_pylist()
    assert got == [None if w is None else _WALL[fn](w)
                   for w in zone_oracle(a)]
    keep = before_2038(a)
    assert _masked(got, keep) == _masked(getattr(pc, fn)(a).to_pylist(),
                                         keep)
    naive = a.cast(pa.timestamp("ns"))
    assert jcall(fn, [j]).to_pylist() == getattr(pc, fn)(naive).to_pylist()


def test_zoned_probe_of_record_c29a():
    """The probe behind C29 (a): ``timestamp('s', 'America/New_York')``
    holding [0, 18000, 17290800]."""
    a = pa.array([0, 18000, 17290800], pa.int64()).cast(
        pa.timestamp("s", "America/New_York"))
    t, j = stage(a)
    assert tcall("hour", [t]).to_pylist() == [19, 0, 23]
    assert tcall("day", [t]).to_pylist() == [31, 1, 19]
    assert tcall("year", [t]).to_pylist()[0] == 1969
    assert jcall("hour", [j]).to_pylist() == [0, 5, 3]
    assert jcall("day", [j]).to_pylist() == [1, 1, 20]
    assert jcall("year", [j]).to_pylist()[0] == 1970


@pytest.mark.parametrize("tz", ZONES)
def test_zoned_between_and_strftime(tz):
    a = rand_timestamps(17, n=100, unit="us", tz=tz)
    b = rand_timestamps(18, n=100, unit="us", tz=tz)
    keep = before_2038(a) & before_2038(b)
    for fn in ("days_between", "weeks_between", "years_between"):
        got = tcall(fn, [stage(a)[0], stage(b)[0]]).to_pylist()
        assert _masked(got, keep) == _masked(
            getattr(pc, fn)(a, b).to_pylist(), keep)
    got = tcall("strftime", [stage(a)[0]], format="%Y-%m-%dT%H:%M:%S")
    assert got.to_pylist() == pc.strftime(
        a, format="%Y-%m-%dT%H:%M:%S").to_pylist()


@pytest.mark.parametrize("tz", ZONES)
def test_local_timestamp_keeps_nanoseconds_c29c(tz):
    """C29 (c): local_timestamp in integers, every digit of the unit, as
    pyarrow; the JAX package's hop drops the sub-microsecond digits."""
    a = rand_timestamps(19, n=200, unit="ns", tz=tz)
    t, j = stage(a)
    got = tcall("local_timestamp", [t]).to_pyarrow().cast(pa.int64())
    walls = zone_oracle(a)
    epoch = dtm.datetime(1970, 1, 1)
    assert got.to_pylist() == [
        None if w is None else
        (w - epoch) // dtm.timedelta(seconds=1) * 10**9 + v % 10**9
        for w, v in zip(walls, a.cast(pa.int64()).to_pylist())]
    keep = before_2038(a)
    assert _masked(got.to_pylist(), keep) == _masked(
        pc.local_timestamp(a).cast(pa.int64()).to_pylist(), keep)
    one = pa.array([1_700_000_000_123_456_789]).cast(
        pa.timestamp("ns", "Europe/Paris"))
    t1, j1 = stage(one)
    assert tcall("local_timestamp", [t1]).values[0] == 1700003600123456789
    assert jcall("local_timestamp", [j1]).to_pyarrow().cast(
        pa.int64())[0].as_py() == 1700003600123456000


def test_zoned_rounding_is_utc_like_jax_c29e():
    """C29 (e), copied for parity: a zoned timestamp rounds its UTC
    instant, as the JAX package's; pyarrow rounds the local time."""
    a = pa.array([1700000000, 1600000000]).cast(
        pa.timestamp("s", "America/New_York"))
    got = both("floor_temporal", [a], unit="day")
    assert got.values[:2].tolist() == [1699920000, 1599955200]
    assert pc.floor_temporal(a, unit="day").cast(pa.int64()).to_pylist() \
        == [1699938000, 1599969600]


@pytest.mark.parametrize("unit", ["s", "ms", "us", "ns"])
@pytest.mark.parametrize("tz", ZONES)
def test_assume_timezone(tz, unit):
    """Naive wall times -> instants as ``zoneinfo`` resolves them with
    fold=0 (the JAX package's rule, in integers): equal to the JAX
    package's where it keeps the digits (s, ms, us), and to pyarrow's
    ``assume_timezone`` (ambiguous="earliest") on the wall times that
    exist, before 2038."""
    a = rand_timestamps(20, n=300, unit=unit)
    t, j = stage(a)
    got = tcall("assume_timezone", [t], timezone=tz)
    want = pc.assume_timezone(a, timezone=tz, ambiguous="earliest",
                              nonexistent="earliest")
    exists = pc.fill_null(pc.equal(pc.local_timestamp(want), a), False
                          ).to_numpy(zero_copy_only=False) & before_2038(a)
    assert _masked(got.to_pyarrow().cast(pa.int64()).to_pylist(),
                   exists) == _masked(want.cast(pa.int64()).to_pylist(),
                                      exists)
    if unit != "ns":
        assert_same(got, jcall("assume_timezone", [j], timezone=tz))


def test_assume_timezone_gap_and_fold_like_zoneinfo():
    """A wall time in New York's spring gap takes the offset before it,
    one in the autumn fold the earlier instant (zoneinfo, fold=0)."""
    from zoneinfo import ZoneInfo
    walls = [dtm.datetime(2021, 3, 14, 2, 30), dtm.datetime(2021, 11, 7, 1,
                                                            30),
             dtm.datetime(2021, 6, 1, 12), dtm.datetime(1950, 1, 1)]
    a = pa.array(walls, pa.timestamp("s"))
    got = tcall("assume_timezone", [stage(a)[0]],
                timezone="America/New_York").values[:4].tolist()
    zone = ZoneInfo("America/New_York")
    assert got == [int(w.replace(tzinfo=zone).timestamp()) for w in walls]


@pytest.mark.parametrize("tz", ZONES + ["UTC", "+05:30"])
def test_is_dst(tz):
    a = rand_timestamps(21, n=300, unit="us", tz=tz)
    t, j = stage(a)
    got = tcall("is_dst", [t])
    keep = before_2038(a)
    assert _masked(got.to_pylist(), keep) == _masked(
        pc.is_dst(a).to_pylist(), keep)
    if not tz.startswith("+"):
        assert_same(got, jcall("is_dst", [j]))


def test_zone_table_is_cached_and_exact():
    """The transitions found by sampling once a day and bisecting are
    zoneinfo's to the second."""
    from zoneinfo import ZoneInfo
    trans, offs, _ = ttemporal._zone_table("Europe/Paris", 0, 20_000)
    zone = ZoneInfo("Europe/Paris")
    for s, before, after in zip(trans[:40], offs[:40], offs[1:41]):
        at = dtm.datetime.fromtimestamp(int(s), tz=zone).utcoffset()
        just_before = dtm.datetime.fromtimestamp(int(s) - 1,
                                                 tz=zone).utcoffset()
        assert at.total_seconds() == after
        assert just_before.total_seconds() == before
    assert ttemporal._zone_table("Europe/Paris", 0, 20_000) is \
        ttemporal._zone_table("Europe/Paris", 0, 20_000)
