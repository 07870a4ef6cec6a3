"""Port parity of string and dictionary columns through the grouper, the
hash join and the plan engine, against the JAX package (the same
Declaration over the same pyarrow tables) and pyarrow; and the three entry
points of the string slice at small sizes against numpy oracles.

Group keys, their first-appearance order, counts and integer sums are
exact; float64 sums within 1e-12 * sum|x| + 1e-12 (ROADMAP C5); joins
compare as multisets of rows. The tables stage in batches of ``ROWS`` = 60
rows in a capacity of 64: the JAX package's short-string content lanes
misread the last row of a batch's capacity (ROADMAP C19), which is then
padding."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu_torch as att
from arrow_tpu_torch import entry as tentry
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core.array import varlen_from_numpy
from arrow_tpu_torch.ops.grouper import Grouper
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, HashAggregate
from test_torch_acero import PORT, _assert_equal, _both, _run, _seq, \
    _drop_jax_executables  # noqa: F401 (an autouse fixture)
from test_torch_acero_q3 import _q3, _q3_tables
from test_torch_strings import SPECIAL

ROWS = 60


def _str_table(n, seed, long_keys=False):
    """s: binary keys (the edge values, nulls), d: the same as a dictionary
    with unused and null entries, k: int64 in [0, 5), v: float64, x:
    int64."""
    rng = np.random.default_rng(seed)
    special = SPECIAL + ([b"L" * 70] if long_keys else [])
    vals = [special[rng.integers(len(special))]
            if rng.random() > 0.08 else None for _ in range(n)]
    dictionary = pa.array([None, b"unused"] + SPECIAL, pa.binary())
    idx = pa.array(rng.integers(2, len(dictionary), n).astype(np.int32),
                   mask=rng.random(n) < 0.08)
    return pa.table({
        "s": pa.array(vals, pa.binary()),
        "d": pa.DictionaryArray.from_arrays(idx, dictionary),
        "k": pa.array(rng.integers(0, 5, n)),
        "v": pa.array(rng.standard_normal(n)),
        "x": pa.array(rng.integers(-1000, 1000, n)),
    })


def _agg_plan(keys):
    def plan(P, t):
        A = P.acero
        return _seq(P, t, A.Declaration("aggregate", A.AggregateNodeOptions(
            [A.AggregateSpec("sum", "x"), A.AggregateSpec("count_all"),
             A.AggregateSpec("sum", "v"), A.AggregateSpec("count", "s")],
            keys=keys, max_groups=64)))
    return plan


@pytest.mark.parametrize("keys", [["s", "k"], ["d"]],
                         ids=["raw_int", "dictionary"])
def test_group_by_string_keys_vs_jax_and_pyarrow(keys):
    """Groups in first-appearance order, as the JAX package gives them, and
    as a set equal to pyarrow's (single-threaded: ROADMAP C1)."""
    t = _str_table(240, 1)
    got, want = _both(_agg_plan(keys), t, rows=ROWS)
    ints = [c for c in got.column_names if c != "v_sum"]
    for c in ints:
        g, w = got[c].combine_chunks(), want[c].combine_chunks()
        if pa.types.is_dictionary(w.type):
            w = w.cast(pa.binary())
            g = g.cast(pa.binary())
        assert g.equals(w), c
    gv, wv = got["v_sum"].to_numpy(), want["v_sum"].to_numpy()
    assert (np.abs(gv - wv) <= 1e-12 * np.abs(wv) + 1e-12 + 1e-12 * 240).all()
    tt = t.set_column(1, "d", t["d"].cast(pa.binary()))
    exp = tt.group_by(keys, use_threads=False).aggregate(
        [("x", "sum"), ([], "count_all")])
    g = got.select(keys + ["x_sum", "count_all"])
    if "d" in keys:
        g = g.set_column(g.column_names.index("d"), "d",
                         g["d"].cast(pa.binary()))
    order = [(k, "ascending") for k in keys]
    assert g.sort_by(order).equals(exp.select(keys + ["x_sum", "count_all"])
                                   .sort_by(order))


def test_group_by_key_past_slot_raises():
    """A raw string key longer than the 64-byte unique slot sets the
    deferred slot error; the plan reports it (with the JAX package's
    message)."""
    t = _str_table(200, 2, long_keys=True)
    plan = _agg_plan(["s"])
    with pytest.raises(RuntimeError, match="exceeds the 64-byte unique slot"):
        plan(PORT, PORT.table(t, ROWS)).to_table()


def test_hash_aggregate_merge_of_slot_uniques():
    """``merge`` of two states keyed by raw strings: the slot-form uniques
    become strings again and group by content."""
    t = _str_table(300, 3)
    b1 = att.Batch.from_pyarrow(t.slice(0, 150), device="cpu")
    b2 = att.Batch.from_pyarrow(t.slice(150), device="cpu")
    ha = HashAggregate(b1.schema, ["s"], [AggregateSpec("count_all"),
                                          AggregateSpec("sum", "x")], 64)
    s1 = ha.consume(ha.init_state("cpu"), b1)
    s2 = ha.consume(ha.init_state("cpu"), b2)
    got = pa.Table.from_batches([ha.finalize(ha.merge(s1, s2)).to_pyarrow()])
    exp = t.group_by(["s"], use_threads=False).aggregate(
        [([], "count_all"), ("x", "sum")])
    assert got.sort_by("s").select(["s", "count_all", "x_sum"]).equals(
        exp.sort_by("s").select(["s", "count_all", "x_sum"]))
    assert Grouper([tdt.binary], [True]).num_lanes == 6


def _rows(t: pa.Table):
    """Sorted row tuples (a multiset); dictionary columns by value."""
    cols = []
    for c in t.columns:
        c = c.combine_chunks()
        if pa.types.is_dictionary(c.type):
            c = c.cast(c.type.value_type)
        cols.append([repr(v) for v in c.to_pylist()])
    return sorted(zip(*cols))


@pytest.mark.parametrize("join_type,key", [
    ("inner", "s"), ("left outer", "d"), ("full outer", "s"),
    ("left semi", "d"), ("right anti", "s")])
def test_join_string_keys_vs_jax(join_type, key):
    """String (or dictionary) keys match by content; string and dictionary
    payloads come out on both sides. (A full outer join's null left rows
    carry no dictionary column: the JAX package's finish cannot export one,
    ROADMAP C19.)"""
    left = _str_table(180, 4)
    right = _str_table(60, 5).rename_columns(["rs", "rd", "rk", "rv", "rx"])
    rkey = {"s": "rs", "d": "rd"}[key]
    lout = ["s", "x"] if join_type == "full outer" else ["s", "d", "x"]
    rout = [] if join_type in ("left semi",) else ["rs", "rd", "rx"]
    if join_type == "right anti":
        lout = []

    def plan(P, lt, rt):
        A = P.acero
        return A.Declaration("hashjoin", A.HashJoinNodeOptions(
            join_type, left_keys=[key], right_keys=[rkey], left_output=lout,
            right_output=rout, max_build_rows=256,
            fanout_capacity=4096), inputs=[_seq(P, lt), _seq(P, rt)])
    got, want = _both(plan, left, right, rows=ROWS)
    assert got.num_rows == want.num_rows > 0
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("bloom", [True, False])
def test_join_string_payload_compacts_from_one_read(bloom, monkeypatch):
    """With compaction on at any size, a join with string keys and string
    and dictionary payloads hands ``maybe_compact`` every scalar it needs
    (the length and each pool's used bytes) from the probe's own read, and
    still equals the JAX package's rows."""
    from arrow_tpu_torch.acero import nodes as tnodes
    monkeypatch.setenv("ARROW_TPU_COMPACT_MIN", "0")
    monkeypatch.setenv("ARROW_TPU_COMPACT_MIN_BYTES", "0")
    given = []
    inner = tnodes.maybe_compact

    def spy(b, vals=None):
        if vals is not None:
            given.append(len(vals) == len(tnodes.compact_scalars(b)))
        return inner(b, vals)
    monkeypatch.setattr(tnodes, "maybe_compact", spy)
    left = _str_table(180, 6)
    right = _str_table(60, 7).rename_columns(["rs", "rd", "rk", "rv", "rx"])

    def plan(P, lt, rt):
        A = P.acero
        return A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=["s"], right_keys=["rs"],
            left_output=["s", "d", "x"], right_output=["rs", "rd"],
            max_build_rows=256, fanout_capacity=4096,
            disable_bloom_filter=not bloom),
            inputs=[_seq(P, lt), _seq(P, rt)])
    got, want = _both(plan, left, right, rows=ROWS)
    assert given and all(given)
    assert got.num_rows == want.num_rows > 0
    assert _rows(got) == _rows(want)


def test_q3_with_mktsegment_vs_jax():
    """The Q3 Declaration with customer's segment a dictionary string
    filtered by ``c_mktsegment == "BUILDING"`` equals the JAX package's
    table of the same plan, and the port's plan on the int32 code."""
    li, od, cu = _q3_tables(seed=1)
    segs = pa.array(list(tentry.SEGMENTS))
    cus = pa.table({"c_custkey": cu["c_custkey"],
                    "c_mktsegment": pa.DictionaryArray.from_arrays(
                        cu["c_seg"].combine_chunks(), segs)})

    def plan(P, li_, od_, cu_):
        return _q3(P, li_, od_, cu_)

    def q3s(P, li_, od_, cu_):
        A, f, lit = P.acero, P.field, P.literal
        co = A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
            left_output=["o_orderkey", "o_date"], right_output=[],
            max_build_rows=max(cu_.num_rows, 16)), inputs=[
                _seq(P, od_, A.Declaration("filter", A.FilterNodeOptions(
                    f("o_date") < lit(25)))),
                _seq(P, cu_, A.Declaration("filter", A.FilterNodeOptions(
                    f("c_mktsegment") == "BUILDING")))])
        return A.Declaration.from_sequence([
            A.Declaration("hashjoin", A.HashJoinNodeOptions(
                "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
                left_output=["l_orderkey", "l_price", "l_disc"],
                right_output=["o_date"], max_build_rows=max(od_.num_rows,
                                                             16)),
                inputs=[_seq(P, li_, A.Declaration("filter",
                        A.FilterNodeOptions(f("l_ship") > lit(40)))), co]),
            A.Declaration("project", A.ProjectNodeOptions(
                [f("l_orderkey"), f("l_price") * (lit(1.0) - f("l_disc")),
                 f("o_date")], ["l_orderkey", "rev", "o_date"])),
            A.Declaration("aggregate", A.AggregateNodeOptions(
                [A.AggregateSpec("sum", "rev", name="revenue")],
                keys=["l_orderkey", "o_date"], max_groups=256)),
            A.Declaration("order_by", A.OrderByNodeOptions(
                [("revenue", "descending"), ("l_orderkey", "ascending")])),
            A.Declaration("fetch", A.FetchNodeOptions(0, 10)),
        ])
    got, want = _both(q3s, li, od, cus, rows=ROWS)
    _assert_equal(got.select(["l_orderkey", "o_date"]),
                  want.select(["l_orderkey", "o_date"]))
    g = got["revenue"].to_numpy()
    assert (np.abs(g - want["revenue"].to_numpy())
            <= 1e-12 * np.abs(g) + 1e-12).all()
    assert got.equals(_run(PORT, plan, li, od, cu, rows=ROWS))


def test_order_by_string_key_widens_prefix():
    """order_by reads the longest key once and sorts exactly past the
    32-byte default prefix (rows sharing 32 bytes), as pyarrow does. (The
    JAX package's order_by of this plan ties them: ROADMAP C19.)"""
    t = _str_table(400, 6)

    def plan(P, tt):
        A = P.acero
        return _seq(P, tt, A.Declaration("order_by", A.OrderByNodeOptions(
            [("s", "descending"), ("x", "ascending")])))
    got = _run(PORT, plan, t, rows=ROWS)
    exp = t.sort_by([("s", "descending"), ("x", "ascending")])
    for c in ("s", "x", "k"):
        assert got[c].combine_chunks().equals(exp[c].combine_chunks())


# ---- the entry points of the string slice, small, on the CPU ---------------

def test_entry_sort_dict_small():
    cols = tentry.example_columns_sort_dict(5000, 3, 50)
    step, (b,) = tentry.entry_sort_dict("cpu", 5000, 3, 50)
    idx, out = step(b)
    valid = cols["s_valid"]
    want = np.lexsort((-cols["i"], np.where(valid, cols["s_idx"], 0),
                       ~valid))
    np.testing.assert_array_equal(idx.values[:5000].numpy().view(np.int64),
                                  want)
    got = out.to_pyarrow()
    vocab = np.array([f"cat{i:04d}" for i in range(50)], dtype=object)
    s = np.where(valid, vocab[cols["s_idx"]], None)[want]
    assert got.column(1).to_pylist() == list(s)


def test_entry_q3s_small():
    """The same top 10 as ``entry_q3``'s on the int32 segment code."""
    step, tables = tentry.entry_q3s("cpu", 3000, 4, 256, 256)
    qstep, qtables = tentry.entry_q3("cpu", 3000, 4, 256, 256)
    assert step(*tables).to_pyarrow().equals(qstep(*qtables).to_pyarrow())
    seg = tables[2].schema.field("c_mktsegment").type
    assert isinstance(seg, tdt.DictionaryType) and seg.value_type.is_varlen


def test_entry_strings_small():
    cols = tentry.example_columns_strings(6000, 300, 5)
    step, (b,) = tentry.entry_strings("cpu", 6000, 300, 5, 1 << 10)
    got = step(b).to_pyarrow()
    sel = cols["w"] > 0
    ck, v, w = cols["custkey"][sel], cols["v"][sel], cols["w"][sel]
    _, first = np.unique(ck, return_index=True)
    keys = ck[np.sort(first)]
    assert got.column(0).to_pylist() == [f"Customer#{k:09d}" for k in keys]
    assert got.column("count_all").to_pylist() == \
        np.bincount(ck, minlength=301)[keys].tolist()
    mins = [int(w[ck == k].min()) for k in keys]
    assert got.column("w_min").to_pylist() == mins
    sums = np.bincount(ck, weights=v, minlength=301)[keys]
    absum = np.bincount(ck, weights=np.abs(v), minlength=301)[keys]
    assert (np.abs(got.column("v_sum").to_numpy() - sums)
            <= 1e-12 * absum + 1e-12).all()
    off, pool = tentry.numbered_strings(b"Customer#", keys, 9)
    names = varlen_from_numpy(offsets=off, pool=pool, device="cpu")
    assert names.to_pylist() == got.column(0).to_pylist()
