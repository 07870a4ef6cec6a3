"""Port parity of string (varlen) and dictionary columns: staging both
ways, take / filter / concat, comparisons, sort lanes, fingerprints and
content lanes, against the JAX package on the same pyarrow data (numpy made
from a seed) and against pyarrow. Strings compare exactly: the offsets of
the rows and the bytes they use (pool bytes past the last row are
unspecified in both packages); integers, validity, lanes (u32 values, the
port's held in int64) and fingerprints (the u64 bits) bit for bit.

The data holds empty and null strings, bytes >= 0x80 (unsigned order),
rows of exactly 16 and 17 bytes (the two content-lane forms), rows longer
than 32 bytes sharing a 32-byte prefix (the sort prefix's widening) and
dictionaries with unused and null entries."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import call_function as jcall
from arrow_tpu.core import interop as jinterop
from arrow_tpu.ops import concat as jconcat
from arrow_tpu.ops import hashing as jhash
from arrow_tpu.ops import selection as jsel
from arrow_tpu.ops import sorting as jsort
import arrow_tpu_torch as att
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.core.array import array_from_numpy, \
    dictionary_from_numpy, full, nulls, varlen_from_numpy
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.ops import concat as tconcat
from arrow_tpu_torch.ops import hashing as thash
from arrow_tpu_torch.ops import selection as tsel
from arrow_tpu_torch.ops import sorting as tsort

# values that exercise every edge named in the module docstring
SPECIAL = [b"", b"a", b"\x80", b"\xff\x00z", b"x" * 16, b"y" * 17,
           b"p" * 32 + b"A", b"p" * 32 + b"B", b"p" * 33, b"p" * 32,
           b"BUILDING", b"AUTOMOBILE"]


def _values(n, seed, null_p=0.1, special=SPECIAL):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < null_p:
            out.append(None)
        elif r < 0.6:
            out.append(special[rng.integers(len(special))])
        else:
            out.append(bytes(rng.integers(0, 256, rng.integers(0, 40))
                             .astype(np.uint8)))
    return out


def _binary(n, seed, **kw):
    return pa.array(_values(n, seed, **kw), pa.binary())


def _utf8(n, seed):
    words = ["", "é", "日本", "BUILDING", "x" * 16, "y" * 17, "q" * 40]
    rng = np.random.default_rng(seed)
    return pa.array([None if rng.random() < 0.1 else
                     words[rng.integers(len(words))] for _ in range(n)])


def _dictionary(n, seed):
    """dictionary<int32, binary> whose dictionary has a null entry (slot 1)
    and unused values; no valid index points at the null entry."""
    rng = np.random.default_rng(seed)
    dictionary = pa.array(SPECIAL[:3] + [None] + SPECIAL[3:], pa.binary())
    used = [i for i in range(len(dictionary)) if i != 3 and i % 5 != 4]
    idx = rng.choice(used, n).astype(np.int32)
    mask = rng.random(n) < 0.1
    return pa.DictionaryArray.from_arrays(pa.array(idx, mask=mask),
                                          dictionary)


def _np(x):
    return np.asarray(x)


def _valid(validity, n):
    return np.ones(n, bool) if validity is None else _np(validity)[:n]


def _assert_same(t, j, n=None):
    """A port Array against a JAX Array: rows, validity, and for strings
    the offsets and used bytes, for dictionaries the indices of valid rows
    and the dictionary."""
    n = len(j) if n is None else n
    assert len(t) == n
    np.testing.assert_array_equal(_valid(t.validity, n),
                                  _valid(j.validity, n))
    if t.offsets is not None:
        off = t.offsets[:n + 1].numpy()
        np.testing.assert_array_equal(off, _np(j.offsets)[:n + 1])
        np.testing.assert_array_equal(t.values[:off[-1]].numpy(),
                                      _np(j.values)[:off[-1]])
        return
    ok = _valid(t.validity, n)
    np.testing.assert_array_equal(t.values[:n].numpy()[ok],
                                  _np(j.values)[:n][ok])
    if t.dictionary is not None:
        _assert_same(t.dictionary, j.dictionary)


def _stage(pa_arr, capacity=None):
    return (tinterop.array_from_pyarrow(pa_arr, capacity=capacity,
                                        device="cpu"),
            jinterop.array_from_pyarrow(pa_arr, capacity=capacity))


# ---- staging ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["binary", "utf8", "large_string",
                                  "string_view", "dictionary", "sliced"])
def test_interop_round_trip_vs_jax(kind):
    arr = {"binary": lambda: _binary(300, 1),
           "utf8": lambda: _utf8(300, 2),
           "large_string": lambda: _utf8(300, 3).cast(pa.large_string()),
           "string_view": lambda: _utf8(300, 4).cast(pa.string_view()),
           "dictionary": lambda: _dictionary(300, 5),
           "sliced": lambda: _binary(300, 6).slice(37, 150)}[kind]()
    t, j = _stage(arr, capacity=512)
    assert t.capacity == j.capacity == 512
    assert t.type.id == j.type.id
    _assert_same(t, j)
    back = t.to_pyarrow()
    if kind in ("large_string", "string_view"):
        arr = arr.cast(pa.string())
    assert back.equals(arr)
    if kind == "dictionary":
        assert tinterop.host_dictionary(t.dictionary) is not None


def test_pool_split_vs_jax(monkeypatch):
    """Record batches whose pools pass the limit are cut where the JAX
    package cuts them; every batch's rows and bytes equal."""
    tbl = pa.table({"s": _binary(2000, 7), "k": np.arange(2000)})
    monkeypatch.setenv("ARROW_TPU_MAX_POOL_BYTES", "4096")
    monkeypatch.setattr(jinterop, "_MAX_POOL_BYTES", 4096)
    t = att.Table.from_pyarrow(tbl, max_rows_per_batch=1000, device="cpu")
    j = at.Table.from_pyarrow(tbl, max_rows_per_batch=1000)
    assert len(t.batches) == len(j.batches) > 2
    for tb, jb in zip(t.batches, j.batches):
        assert int(tb.column("s").offsets[len(tb)]) <= 4096
        _assert_same(tb.column("s"), jb.column("s"))
    assert t.to_pyarrow().equals(tbl)


def test_dictionary_ingest_vs_jax(monkeypatch):
    """Below ARROW_TPU_DICT_INGEST_MIN rows nothing is encoded; at it a
    low-cardinality string column becomes a transparent dictionary with
    the JAX package's codes, and exports as the plain strings."""
    rng = np.random.default_rng(8)
    words = pa.array(SPECIAL, pa.binary())
    tbl = pa.table({"s": words.take(pa.array(rng.integers(0, 12, 400))),
                    "u": _binary(400, 9)})
    for lo in (1000, 64):
        monkeypatch.setenv("ARROW_TPU_DICT_INGEST_MIN", str(lo))
        monkeypatch.setattr(jinterop, "_DICT_INGEST_MIN", lo)
        t = att.Table.from_pyarrow(tbl, max_rows_per_batch=128, device="cpu")
        j = at.Table.from_pyarrow(tbl, max_rows_per_batch=128)
        st, sj = t.schema.field("s").type, j.schema.field("s").type
        assert st.id == sj.id and (isinstance(st, tdt.DictionaryType) == (lo == 64))
        assert getattr(st, "transparent", False) == (lo == 64)
        assert not isinstance(t.schema.field("u").type, tdt.DictionaryType)
        for tb, jb in zip(t.batches, j.batches):
            _assert_same(tb.column("s"), jb.column("s"))
        assert t.to_pyarrow().equals(tbl)


def test_numpy_constructors():
    """Strings and dictionaries with no pyarrow: from bytes_ / str_ numpy
    arrays, from offsets and a pool, from indices and values; nulls, full,
    empty_batch."""
    a = array_from_numpy(np.array([b"ab", b"", b"\xff\x01"]),
                                validity=[True, False, True], capacity=5,
                                device="cpu")
    assert a.type == tdt.binary and a.capacity == 5
    assert a.to_pylist() == [b"ab", None, b"\xff\x01"]
    s = array_from_numpy(np.array(["é", "xyz"]), device="cpu")
    assert s.type == tdt.string and s.to_pylist() == ["é", "xyz"]
    v = varlen_from_numpy(offsets=[0, 2, 2, 5],
                                 pool=np.frombuffer(b"abcde", np.uint8),
                                 device="cpu")
    assert v.to_pylist() == ["ab", "", "cde"]
    d = dictionary_from_numpy(np.array([2, 0, 1, 2]),
                                     np.array(["x", "yy", "zzz"]),
                                     validity=[True, True, False, True],
                                     device="cpu")
    assert d.to_pylist() == ["zzz", "x", None, "zzz"]
    assert d.values[2].item() == 0
    assert nulls(3, tdt.string, device="cpu").to_pylist() == [None] * 3
    assert full(2, "ab", tdt.string, capacity=4,
                       device="cpu").to_pylist() == ["ab", "ab"]
    sch = att.Schema((att.Field("s", tdt.string),
                      att.Field("d", tdt.DictionaryType(tdt.int32,
                                                        tdt.string))))
    e = att.empty_batch(sch, device="cpu")
    assert len(e) == 0 and e.to_pyarrow().num_rows == 0


# ---- take, filter, concat ----------------------------------------------------

def _indices(n, cap, seed, nulls):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cap, n).astype(np.int32)
    mask = rng.random(n) < 0.2 if nulls else None
    return pa.array(idx, mask=mask)


@pytest.mark.parametrize("kind", ["binary", "dictionary"])
@pytest.mark.parametrize("nulls", [False, True], ids=["dense", "null_idx"])
def test_take_vs_jax(kind, nulls):
    arr = _binary(400, 10) if kind == "binary" else _dictionary(400, 11)
    t, j = _stage(arr, capacity=512)
    idx = _indices(700, 400, 12, nulls)
    ti, ji = _stage(idx, capacity=1024)
    got = tsel.take_array(t, ti)
    want = jsel.take_array(j, ji, grow=2)
    _assert_same(got, want, 700)
    assert got.to_pyarrow().equals(arr.take(idx))


def _str_batch(n, seed):
    return pa.table({"s": _binary(n, seed), "d": _dictionary(n, seed + 1),
                     "k": np.arange(n), "u": _utf8(n, seed + 2)})


@pytest.mark.parametrize("impl", ["dma", "pallas"])
@pytest.mark.parametrize("emit", [False, True], ids=["drop", "emit_null"])
def test_filter_batch_vs_jax(impl, emit):
    """The one-launch filter (the pool by a second launch over a per-byte
    selection) and the take-index route, against the JAX package's
    filter."""
    tbl = _str_batch(900, 13)
    rng = np.random.default_rng(14)
    mask = pa.array(rng.random(900) < 0.4, mask=rng.random(900) < 0.1)
    tb = att.Batch.from_pyarrow(tbl, capacity=1024, device="cpu")
    jb = at.Batch.from_pyarrow(tbl, capacity=1024)
    tm, jm = _stage(mask, capacity=1024)
    opts = (tsel.FilterOptions("emit_null" if emit else "drop"),
            jsel.FilterOptions("emit_null" if emit else "drop"))
    got = tsel.filter_batch(tb, tm, opts[0], impl=impl)
    want = jsel.filter_batch(jb, jm, opts[1])
    n = len(want)
    for name in tbl.column_names:
        _assert_same(got.column(name), want.column(name), n)
    exp = tbl.filter(mask, null_selection_behavior="emit_null" if emit
                     else "drop")
    assert pa.Table.from_batches([got.to_pyarrow()]).equals(exp)


def test_filter_array_and_drop_null():
    arr = _binary(300, 15)
    t, j = _stage(arr)
    m = pa.array(np.random.default_rng(16).random(300) < 0.5)
    tm, jm = _stage(m)
    _assert_same(tsel.filter_array(t, tm), jsel.filter_array(j, jm))
    assert tcall("drop_null", [t]).to_pyarrow().equals(pc.drop_null(arr))
    tbl = _str_batch(300, 17)
    b = att.Batch.from_pyarrow(tbl, device="cpu")
    assert pa.Table.from_batches([tcall("drop_null", [b]).to_pyarrow()]) \
        .equals(tbl.drop_null())


@pytest.mark.parametrize("kind", ["binary", "dictionary"])
def test_concat_vs_jax(kind):
    make = _binary if kind == "binary" else _dictionary
    arrs = [make(n, 18) for n in (70, 0, 130)]
    if kind == "dictionary":        # batches share one dictionary
        arrs = [pa.DictionaryArray.from_arrays(a.indices, arrs[0].dictionary)
                for a in arrs]
    ts, js = zip(*[_stage(a, capacity=256) for a in arrs])
    got = tconcat.concat_arrays(list(ts))
    want = jconcat.concat_arrays(list(js))
    _assert_same(got, want, 200)
    assert got.capacity == want.capacity == 768
    exp = pa.concat_arrays(arrs)
    assert got.to_pyarrow().equals(exp)


# ---- comparisons -------------------------------------------------------------

OPS = ["equal", "not_equal", "less", "less_equal", "greater",
       "greater_equal"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["binary", "dictionary"])
def test_compare_scalar_vs_jax(op, kind):
    arr = _binary(400, 19) if kind == "binary" else _dictionary(400, 20)
    t, j = _stage(arr)
    for lit in (b"BUILDING", b"", b"p" * 32, b"\x80"):
        got = tcall(op, [t, att.compute.scalar(lit, tdt.binary)])
        want = jcall(op, [j, at.compute.scalar(lit, at.types.binary)])
        _assert_same(got, want)
        exp = getattr(pc, op)(arr.cast(pa.binary()) if kind == "dictionary"
                              else arr, pa.scalar(lit, pa.binary()))
        assert got.to_pyarrow().equals(exp)
        # the scalar on the left flips the order
        flipped = tcall(op, [att.compute.scalar(lit, tdt.binary), t])
        assert flipped.to_pyarrow().equals(getattr(pc, op)(
            pa.scalar(lit, pa.binary()), exp.type and
            (arr.cast(pa.binary()) if kind == "dictionary" else arr)))


@pytest.mark.parametrize("op", OPS)
def test_compare_arrays_vs_jax(op):
    a, b = _binary(500, 21), _binary(500, 22)
    ta, ja = _stage(a)
    tb, jb = _stage(b)
    got = tcall(op, [ta, tb])
    _assert_same(got, jcall(op, [ja, jb]))
    assert got.to_pyarrow().equals(getattr(pc, op)(a, b))
    # a dictionary side goes through its values
    d = _dictionary(500, 23)
    td, _ = _stage(d)
    got = tcall(op, [td, tb])
    assert got.to_pyarrow().equals(getattr(pc, op)(d.cast(pa.binary()), b))


# ---- sort --------------------------------------------------------------------

@pytest.mark.parametrize("words", [None, 11])
def test_sort_lanes_vs_jax(words):
    arr = _binary(300, 24)
    t, j = _stage(arr)
    got = tsort.sortable_lanes(t, varlen_words=words)
    want = jsort.sortable_lanes(j, varlen_words=words)
    assert len(got) == len(want) == (words or 8) + 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w).astype(np.int64))


def test_sort_lanes_windows_in_steps_vs_jax(monkeypatch):
    """The pool's 4-byte windows built in steps of a few bytes (windows
    that straddle a step, and the pool's last three positions) give the
    same lanes as in one step, equal to the JAX package's."""
    arr = _binary(300, 25)
    t, j = _stage(arr)
    want = jsort.sortable_lanes(j, varlen_words=11)
    for step in (5, 8):
        monkeypatch.setattr(tsort, "_WINDOW_STEP", step)
        got = tsort.sortable_lanes(t, varlen_words=11)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w).astype(np.int64))


def test_dictionary_rank_vs_jax():
    d = _dictionary(200, 25)
    t, j = _stage(d)
    np.testing.assert_array_equal(tsort._dictionary_rank(t.dictionary)
                                  .numpy(),
                                  _np(jsort._dictionary_rank(j.dictionary)))
    for cross in (False, True):
        got = tsort.sortable_lanes(t, cross_batch=cross)
        want = jsort.sortable_lanes(j, cross_batch=cross)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), _np(w).astype(np.int64))


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("placement", ["at_start", "at_end"])
def test_sort_indices_vs_pyarrow_and_jax(order, placement):
    """Strings that share a 32-byte prefix order exactly once the prefix
    widens to the longest row (11 words); the default 8 words order them as
    the JAX package does."""
    arr = _binary(400, 26)
    t, j = _stage(arr)
    got = tsort.sort_indices_array(t, order, placement, varlen_words=11)
    exp = pc.array_sort_indices(arr, order=order, null_placement=placement)
    np.testing.assert_array_equal(got.values.view(torch.int64)[:400].numpy(),
                                  exp.to_numpy())
    short = tsort.sort_indices_array(t, order, placement)
    want = jsort.sort_indices_array(j, order, placement)
    np.testing.assert_array_equal(
        short.values.view(torch.int64)[:400].numpy(),
        _np(want.values)[:400].astype(np.int64))
    d = _dictionary(300, 27)
    td, _ = _stage(d)
    got = tsort.sort_indices_array(td, order, placement)
    exp = pc.array_sort_indices(d.cast(pa.binary()), order=order,
                                null_placement=placement)
    np.testing.assert_array_equal(got.values.view(torch.int64)[:300].numpy(),
                                  exp.to_numpy())


# ---- hashing -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mixed", "short", "long", "steps"])
def test_fingerprints_and_content_lanes_vs_jax(kind, monkeypatch):
    """Both fingerprints and the content lanes of the rows equal the JAX
    package's u64 and u32 values bit for bit, whichever forms the rows
    take, and however many steps the running sum takes."""
    if kind == "steps":
        monkeypatch.setattr(thash, "_FP_CHUNK", 64)
        monkeypatch.setattr(thash, "_CHUNK_POWERS", {})
        kind = "mixed"
    special = {"mixed": SPECIAL,
               "short": [v for v in SPECIAL if len(v) <= 16],
               "long": [v for v in SPECIAL if len(v) > 16]}[kind]
    arr = pa.array(_values(300, 28, 0.0, special) if kind != "mixed"
                   else _values(300, 28), pa.binary())
    if kind != "mixed":
        arr = pa.array([v if v is None or (len(v) > 16) == (kind == "long")
                        else special[0] for v in arr.to_pylist()],
                       pa.binary())
    t, j = _stage(arr)
    for name in ("_string_fingerprint64", "string_fingerprint_exact"):
        got = getattr(thash, name)(t).numpy()
        want = _np(getattr(jhash, name)(j)).view(np.int64)
        np.testing.assert_array_equal(got, want)
    got = thash.string_fingerprint_exact(t, 0xC2B2AE3D27D4EB4F).numpy()
    want = _np(jhash.string_fingerprint_exact(j, 0xC2B2AE3D27D4EB4F))
    np.testing.assert_array_equal(got, want.view(np.int64))
    for g, w in zip(thash.varlen_content_lanes(t),
                    jhash.varlen_content_lanes(j)):
        np.testing.assert_array_equal(g.numpy()[:300],
                                      _np(w).astype(np.int64)[:300])
    np.testing.assert_array_equal(thash.hash32([t]).numpy(),
                                  _np(jhash.hash32([j])).astype(np.int64))


def test_dictionary_content_lanes_vs_jax():
    """A dictionary column keys by its values' lanes, as a plain column of
    the same strings does."""
    d = _dictionary(300, 29)
    t, j = _stage(d)
    got = thash.dict_content_lanes(t)
    assert len(got) == thash.dict_value_lane_width(t.type) == 5
    for g, w in zip(got, jhash.dict_content_lanes(j)):
        np.testing.assert_array_equal(g.numpy(), _np(w).astype(np.int64))
    plain, _ = _stage(d.cast(pa.binary()))
    ok = t.validity.numpy()[:300]
    for g, p in zip(got, thash.varlen_content_lanes(plain)):
        np.testing.assert_array_equal(g.numpy()[:300][ok],
                                      p.numpy()[:300][ok])
    np.testing.assert_array_equal(thash.hash32([t]).numpy(),
                                  _np(jhash.hash32([j])).astype(np.int64))
