"""The port's repairs of ROADMAP C31 and C32, each against pyarrow, with
the JAX package's different answer kept on record (C33, the public
names, is ``test_torch_public_names.py``).

  * C31: a string take or join that fans long rows out past the input's
    byte pool. The port sizes the pool from the gathered total and answers
    as pyarrow; the JAX package overflows its pool and raises at export.
  * C32 (a): NaN under a descending sort key goes after the numbers, as in
    pyarrow (sort indices, select_k, rank, Table.sort_by, the distributed
    sort); the JAX package puts it first.
  * C32 (b): min / max / min_max, scalar and grouped, skip NaN; a group of
    NaNs alone gives NaN (every route: the dense kernel's plain version,
    the sorted dense route, the sort-grouping routes, the scalar
    aggregates); the JAX package's NaN wins.
  * C32 (c): scalar min_max / first / last / first_last of a string or
    binary column give its values, as pyarrow; the grouped min, max,
    first, last and list of one raise, naming the type.
  * C32 (d): ``RankOptions(sort_keys="descending")`` ranks descending.

Exact comparison throughout."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import call_function as jcall
from arrow_tpu.ops import sorting as jsort
from arrow_tpu.ops import selection as jsel
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    array_to_pyarrow, batch_from_pyarrow
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import selection as tsel
from arrow_tpu_torch.ops import sorting as tsort
from arrow_tpu_torch.ops.segment import _scatter

NAN = float("nan")
LONG = "x" * 40


# ---- C31 ---------------------------------------------------------------------

def test_c31_string_take_past_its_pool():
    a = pa.array([LONG, "a"])
    idx = pa.array([0, 0, 0, 0])
    got = tsel.take_array(array_from_pyarrow(a, device="cpu"),
                          array_from_pyarrow(idx, device="cpu"))
    assert array_to_pyarrow(got).equals(a.take(idx))
    # on record: the JAX package's pool overflows
    with pytest.raises(ValueError, match="byte-pool overflow"):
        jsel.take_array(at.array(a), at.array(idx)).to_pyarrow()


def test_c31_list_take_past_its_child():
    a = pa.array([[1, 2, 3], [4]])
    idx = pa.array([0, 0, 0, 0, 1])
    got = tsel.take_array(array_from_pyarrow(a, device="cpu"),
                          array_from_pyarrow(idx, device="cpu"))
    assert array_to_pyarrow(got).equals(a.take(idx))


@pytest.mark.parametrize("join_type", ["inner", "left outer", "right outer",
                                       "full outer"])
def test_c31_string_key_join_fanning_out(join_type):
    """One 40-byte key three times on the left and twice on the right: six
    rows of it, past both pools."""
    left = pa.table({"k": [LONG, LONG, LONG, "b"], "lv": [1, 2, 3, 4]})
    right = pa.table({"k": [LONG, LONG, "c"], "rv": [10, 20, 30],
                      "rs": [LONG + "r", LONG + "s", "t"]})
    got = Table.from_pyarrow(left, device="cpu").join(
        Table.from_pyarrow(right, device="cpu"), "k",
        join_type=join_type).to_pyarrow()
    want = left.join(right, "k", join_type=join_type,
                     coalesce_keys=False)
    cols = ["lv", "rv", "rs"]
    assert sorted(got.select(cols).to_pylist(), key=repr) == \
        sorted(want.select(cols).to_pylist(), key=repr)
    if join_type == "inner":
        # on record: the JAX package's joined string columns overflow
        with pytest.raises(ValueError, match="byte-pool overflow"):
            at.Table.from_pyarrow(left).join(
                at.Table.from_pyarrow(right), "k",
                join_type=join_type).to_pyarrow()


def test_c31_scatter_drops_every_index_past_its_size():
    """JAX's ``mode="drop"``: an index past the size is dropped, not only
    the dump slot's."""
    out = _scatter(4, -1, torch.tensor([0, 4, 9, 2, 100]),
                   torch.tensor([5, 6, 7, 8, 9]))
    assert out.tolist() == [5, -1, 8, -1]


# ---- C32 (a) -------------------------------------------------------------------

PROBE = pa.array([1.5, None, NAN, -2.0, NAN, 3.0])


def _perm(a):
    return a.values.view(torch.int64)[:int(a.length)].tolist()


def test_c32a_descending_sort_puts_nan_after_the_numbers():
    got = tcall("array_sort_indices", [array_from_pyarrow(PROBE,
                                                          device="cpu")],
                options=tsort.ArraySortOptions("descending"))
    assert _perm(got) == [5, 0, 3, 2, 4, 1] == pc.array_sort_indices(
        PROBE, order="descending").to_pylist()
    want = jcall("array_sort_indices", [at.array(PROBE)],
                 options=jsort.ArraySortOptions("descending"))
    assert np.asarray(want.values)[:6].tolist() == [2, 4, 5, 0, 3, 1]


def test_c32a_select_k_rank_and_table_sort():
    ta = array_from_pyarrow(PROBE, device="cpu")
    top = tcall("select_k_unstable", [ta],
                options=tsort.SelectKOptions(2, [("x", "descending")]))
    assert _perm(top) == [5, 0]         # 3.0 and 1.5, as pyarrow's
    jtop = jcall("select_k_unstable", [at.array(PROBE)],
                 options=jsort.SelectKOptions(2, [("x", "descending")]))
    assert sorted(np.asarray(jtop.values)[:2].tolist()) == [2, 4]
    rank = tcall("rank", [ta], options=tsort.RankOptions(
        [("x", "descending")]))
    want = pc.rank(PROBE, sort_keys="descending").to_pylist()
    assert rank.values.view(torch.int64)[:6].tolist() == want
    t = pa.table({"v": PROBE, "i": np.arange(6)})
    got = Table.from_pyarrow(t, device="cpu").sort_by(
        [("v", "descending")]).to_pyarrow()
    assert got["i"].to_pylist() == [5, 0, 3, 2, 4, 1]


@pytest.mark.parametrize("null_placement", ["at_end", "at_start"])
def test_c32a_distributed_sort_places_nan_as_pyarrow(null_placement):
    from arrow_tpu_torch.parallel import DistContext
    rng = np.random.default_rng(5)
    n = 1024
    v = np.round(rng.standard_normal(n), 2)
    v[rng.random(n) < 0.1] = np.nan
    t = pa.table({"a": pa.array(v, mask=rng.random(n) < 0.05),
                  "b": np.arange(n)})
    keys = [("a", "descending"), ("b", "ascending")]
    got = DistContext(devices=["cpu"] * 4).sort_by(
        batch_from_pyarrow(t.to_batches()[0], device="cpu"), keys,
        samples_per_shard=64, null_placement=null_placement)
    want = t.take(pc.sort_indices(t, sort_keys=[
        (k, o, null_placement) for k, o in keys]))
    assert got.to_pyarrow()["b"].to_pylist() == want["b"].to_pylist()


# ---- C32 (b) -------------------------------------------------------------------

def test_c32b_scalar_min_max_skip_nan():
    for t in (pa.float32(), pa.float64()):
        a = array_from_pyarrow(pa.array([1.5, None, NAN, -2.0], t),
                               device="cpu")
        assert tcall("min_max", [a]).as_py() == {"min": -2.0, "max": 1.5}
        assert tcall("min", [a]).as_py() == -2.0
        assert tcall("max", [a]).as_py() == 1.5
        nan2 = array_from_pyarrow(pa.array([NAN, NAN], t), device="cpu")
        mm = tcall("min_max", [nan2]).as_py()
        assert np.isnan(mm["min"]) and np.isnan(mm["max"])
        assert np.isnan(tcall("min", [nan2]).as_py())
    # on record: the JAX package's NaN wins
    j = jcall("min_max", [at.array(pa.array([1.5, None, NAN, -2.0],
                                            pa.float32()))]).as_py()
    assert np.isnan(j["min"]) and np.isnan(j["max"])


@pytest.mark.parametrize("vtype,key_hi", [
    (pa.float32(), 4), (pa.float64(), 4), (pa.float32(), 1 << 20)],
    ids=["dense_kernel", "sort_grouping", "sorted_dense"])
def test_c32b_grouped_min_max_skip_nan(vtype, key_hi):
    """A probe, k [1, 1, 2, 2] and v [nan, nan, nan, 3.0] ->
    min / max [nan, 3.0], through each route (an int key with a float32
    value takes the dense kernel, a float64 value the sort grouping, a
    key domain past the kernel's slots the sorted dense reduction)."""
    k = [1, 1, 2, 2, key_hi, key_hi, 3]
    v = [NAN, NAN, NAN, 3.0, -1.0, NAN, None]
    t = pa.table({"k": pa.array(k), "v": pa.array(v, vtype)})
    got = Table.from_pyarrow(t, device="cpu").group_by("k").aggregate(
        [("v", "min"), ("v", "max"), ("v", "count")]).to_pyarrow()
    want = t.group_by("k").aggregate([("v", "min"), ("v", "max"),
                                      ("v", "count")])
    assert got["k"].to_pylist() == want["k"].to_pylist()
    for c in ("v_min", "v_max"):
        g, w = got[c].to_pylist(), want[c].to_pylist()
        assert [x is None for x in g] == [x is None for x in w]
        assert all(a == b or (a != a and b != b) for a, b in zip(g, w)
                   if a is not None), (c, g, w)
    assert got["v_count"].equals(want["v_count"])
    assert [x != x for x in got["v_min"].to_pylist()[:2]] == [True, False]


def test_c32b_dense_kernel_plain_version_skips_nan():
    """The dense kernel's contract (its plain version here): slot 0 holds
    NaN beside numbers, slot 1 NaN alone, slot 2 nothing."""
    gid = torch.tensor([0, 0, 0, 1, 1, 5], dtype=torch.int32)
    x = torch.tensor([NAN, 2.0, -1.0, NAN, NAN, 7.0])
    rows, (mn, mx) = ck.dense_group_reduce_plain(gid, (x, x), ("min", "max"),
                                                 128)
    assert mn[0] == -1.0 and mx[0] == 2.0
    assert bool(mn[1].isnan()) and bool(mx[1].isnan())
    assert mn[2] == float("inf") and mx[2] == float("-inf")
    assert rows[:3].tolist() == [3, 2, 0]


# ---- C32 (c) -------------------------------------------------------------------

@pytest.mark.parametrize("t", [pa.string(), pa.binary()], ids=str)
def test_c32c_scalar_string_min_max_first_last(t):
    a = pa.array(["b", None, "a", "c"], t) if t == pa.string() else \
        pa.array([b"b", None, b"a", b"c"], t)
    ta = array_from_pyarrow(a, device="cpu")
    for fn in ("min_max", "first", "last", "first_last"):
        assert tcall(fn, [ta]).as_py() == pc.call_function(fn, [a]).as_py()
    # a key longer than the 32-byte sort prefix
    long = pa.array([LONG + "b", LONG + "a", None], t)
    assert tcall("min_max", [array_from_pyarrow(long, device="cpu")]) \
        .as_py() == pc.min_max(long).as_py()
    # on record: the JAX package's min_max reads the pool's bytes
    assert jcall("min_max", [at.array(a)]).as_py() != pc.min_max(a).as_py()


@pytest.mark.parametrize("fn", ["min", "max", "first", "last", "list"])
def test_c32c_grouped_string_aggregators_raise_naming_the_type(fn):
    t = pa.table({"k": [1, 1, 2], "s": ["b", "a", "c"]})
    with pytest.raises(NotImplementedError, match="string"):
        Table.from_pyarrow(t, device="cpu").group_by("k").aggregate(
            [("s", fn)])


# ---- C32 (d) -------------------------------------------------------------------

def test_c32d_rank_sort_keys_as_an_order_string():
    a = pa.array([3, 1, None, 2, 3])
    got = tcall("rank", [array_from_pyarrow(a, device="cpu")],
                options=tsort.RankOptions(sort_keys="descending"))
    want = pc.rank(a, sort_keys="descending")
    assert got.values.view(torch.int64)[:5].tolist() == want.to_pylist()
    # on record: the JAX package reads the string as keys of one letter
    # each, the first ascending
    j = jcall("rank", [at.array(a)],
              options=jsort.RankOptions(sort_keys="descending"))
    assert np.asarray(j.values)[:5].tolist() == pc.rank(
        a, sort_keys="ascending").to_pylist()
