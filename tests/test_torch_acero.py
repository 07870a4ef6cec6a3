"""Port parity: the plan engine ``arrow_tpu_torch.acero`` (``nodes.py``,
``plan.py``) against the JAX package's ``arrow_tpu.acero``: the same
Declaration, built by each package over the same pyarrow tables (numpy
made from a seed, staged in small batches so that every plan streams
several), must give the same table. Integers, nulls and row order are
exact where the JAX package fixes an order (filter, project, fetch,
order_by, aggregate groups); joins compare as multisets; float sums within
1e-12 * sum|x| + 1e-12 per group (float64) or 1e-5 * sum|x| + 1e-6
(float32). The join matrix is in ``test_torch_acero_join.py``, the
Q3-shaped plan in ``test_torch_acero_q3.py``; both import the helpers
here."""

import types

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow_tpu as at
import arrow_tpu.acero as jacero
import arrow_tpu_torch as att
import arrow_tpu_torch.acero as tacero
from arrow_tpu.compute.expressions import field as jfield, \
    literal as jliteral
from arrow_tpu_torch.acero import nodes as tnodes
from arrow_tpu_torch.compute.expressions import field as tfield, \
    literal as tliteral
from arrow_tpu_torch.ops import join as tjoin

BATCH_ROWS = 64


@pytest.fixture(autouse=True)
def _drop_jax_executables():
    """The JAX side compiles a program per stage and capacity; a process
    that keeps them all crashes in XLA:CPU's JIT (tests/conftest.py drops
    them per module; this module compiles enough to need it per test)."""
    yield
    from arrow_tpu.acero.nodes import clear_stage_cache
    clear_stage_cache()


def _pkg(acero, field, literal, table_of):
    return types.SimpleNamespace(acero=acero, field=field, literal=literal,
                                 table=table_of)


JAX = _pkg(jacero, jfield, jliteral, lambda t, rows=BATCH_ROWS:
           at.Table.from_pyarrow(t, max_rows_per_batch=rows))
PORT = _pkg(tacero, tfield, tliteral, lambda t, rows=BATCH_ROWS:
            att.Table.from_pyarrow(t, max_rows_per_batch=rows, device="cpu"))


def _run(P, plan, *tables, rows=BATCH_ROWS, **kw):
    """``plan(P, *tables_of_P)`` run by ``to_table`` -> pyarrow."""
    return plan(P, *[P.table(t, rows) for t in tables], **kw).to_table() \
        .to_pyarrow()


def _both(plan, *tables, **kw):
    return _run(PORT, plan, *tables, **kw), _run(JAX, plan, *tables, **kw)


def _source(P, t):
    return P.acero.Declaration("table_source",
                               P.acero.TableSourceNodeOptions(t))


def _seq(P, t, *decls):
    return P.acero.Declaration.from_sequence([_source(P, t), *decls])


def _assert_equal(got: pa.Table, want: pa.Table):
    """Same names, types, nulls and values in the same order."""
    assert got.column_names == want.column_names
    assert got.schema.types == want.schema.types
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        g, w = got[name].combine_chunks(), want[name].combine_chunks()
        assert g.equals(w), (name, g, w)


def _rows(t: pa.Table):
    """Sorted row tuples (a multiset): floats by their bits, nulls first."""
    cols = []
    for c in t.columns:
        c = c.combine_chunks()
        ok = np.asarray(c.is_valid())
        v = c.fill_null(0).to_numpy(zero_copy_only=False)
        if v.dtype.kind == "f":
            v = v.view(np.uint32 if v.dtype == np.float32 else np.uint64)
        cols.append([(1, int(x)) if k else (0, 0) for x, k in zip(v, ok)])
    return sorted(zip(*cols))


def _table(n, seed, nulls=True):
    """k int64 in [0, 40), g int32 in [0, 5), f32 / f64 / int64 values;
    nulls in x, w and g."""
    rng = np.random.default_rng(seed)
    mask = (lambda p: rng.random(n) < p) if nulls else (lambda p: None)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n)),
        "g": pa.array(rng.integers(0, 5, n).astype(np.int32), mask=mask(.1)),
        "x": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=mask(.15)),
        "v": pa.array(rng.standard_normal(n)),
        "w": pa.array(rng.integers(-1000, 1000, n), mask=mask(.2)),
    })


# ---- filter, project -----------------------------------------------------------

@pytest.mark.parametrize("pred", ["compare", "kleene_and", "kleene_or",
                                  "arith", "none_pass"])
def test_filter_node_vs_jax(pred):
    t = _table(300, 1)

    def plan(P, tt):
        f, lit = P.field, P.literal
        e = {"compare": f("w") > lit(0),
             "kleene_and": (f("x") > lit(0.0)) & (f("g") < lit(3)),
             "kleene_or": (f("w") < lit(-500)) | (f("g") == lit(1)),
             "arith": (f("v") * lit(2.0) - f("x")) / lit(3.0) > lit(0.1),
             "none_pass": f("k") > lit(1000)}[pred]
        return _seq(P, tt, P.acero.Declaration(
            "filter", P.acero.FilterNodeOptions(e)))

    got, want = _both(plan, t)
    _assert_equal(got, want)


def test_project_node_vs_jax():
    """Expressions, a scalar (a full column), arithmetic over nulls."""
    t = _table(200, 2)

    def plan(P, tt):
        f, lit = P.field, P.literal
        return _seq(P, tt, P.acero.Declaration(
            "project", P.acero.ProjectNodeOptions(
                [f("k"), f("x") * (lit(1.0) - f("v")), lit(7),
                 f("w") + f("k"), f("w") / lit(3), f("g") - lit(2)],
                ["k", "rev", "seven", "wk", "w3", "g2"])))

    got, want = _both(plan, t)
    _assert_equal(got, want)
    node = plan(PORT, PORT.table(t))._build()
    assert [f.type for f in node.output_schema().fields] == \
        [att.int64, att.float64, att.int64, att.int64, att.int64, att.int64]


# ---- aggregate -----------------------------------------------------------------

AGGS = [("sum", "v"), ("sum", "x"), ("mean", "x"), ("min", "w"),
        ("max", "x"), ("count", "w"), ("count_all", None)]


def _agg_specs(P, aggs):
    return [P.acero.AggregateSpec(fn, tgt) for fn, tgt in aggs]


def _abs_sums(t, keys, col, out):
    """Per output group, the sum of |col| over its rows."""
    a = t.append_column("_abs", pc.abs(t[col])).group_by(keys) \
        .aggregate([("_abs", "sum")])
    index = {tuple(r[k] for k in keys): r["_abs_sum"]
             for r in a.to_pylist()}
    return np.array([index[tuple(r[k] for k in keys)] or 0.0
                     for r in out.select(keys).to_pylist()])


def _assert_sums_close(got, want, t, keys, pairs):
    """Float sums within the stated tolerance, per group."""
    for col, name in pairs:
        g = got[name].to_numpy(zero_copy_only=False)
        w = want[name].to_numpy(zero_copy_only=False)
        assert got[name].null_count == want[name].null_count
        f64 = pa.types.is_float64(t[col].type)
        rtol, atol = (1e-12, 1e-12) if f64 else (1e-5, 1e-6)
        bound = rtol * _abs_sums(t, keys, col, got) + atol
        ok = np.isnan(g) & np.isnan(w) | (np.abs(g - w) <= bound)
        assert ok.all(), (name, g, w)


@pytest.mark.parametrize("keys", [["k"], ["k", "g"]])
def test_aggregate_keyed_vs_jax(keys):
    t = _table(400, 3)

    def plan(P, tt):
        return _seq(P, tt, P.acero.Declaration(
            "aggregate", P.acero.AggregateNodeOptions(
                _agg_specs(P, AGGS), keys=keys, max_groups=1 << 10)))

    got, want = _both(plan, t)
    exact = [n for n in got.column_names
             if n not in ("v_sum", "x_sum", "x_mean")]
    _assert_equal(got.select(exact), want.select(exact))
    _assert_sums_close(got, want, t, keys,
                       [("v", "v_sum"), ("x", "x_sum")])
    g, w = got["x_mean"].to_numpy(zero_copy_only=False), \
        want["x_mean"].to_numpy(zero_copy_only=False)
    assert np.allclose(g, w, rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("case", ["rows", "empty", "min_count"])
def test_aggregate_keyless_vs_jax(case):
    """The streaming one-group path; an input of no rows (nulls and zeros
    of the scalar functions) and non-default null options (the accumulate
    fallback)."""
    t = _table(300, 4)
    opts = None

    def plan(P, tt):
        aggs = [P.acero.AggregateSpec(fn, tgt) for fn, tgt in AGGS]
        if case == "min_count":
            from arrow_tpu_torch.ops.agg_options import \
                ScalarAggregateOptions as TSO
            from arrow_tpu.ops.agg_options import \
                ScalarAggregateOptions as JSO
            so = (TSO if P is PORT else JSO)(min_count=400)
            aggs[0] = P.acero.AggregateSpec("sum", "v", so)
        decls = []
        if case == "empty":
            decls.append(P.acero.Declaration("filter", P.acero.FilterNodeOptions(
                P.field("k") > P.literal(1000))))
        decls.append(P.acero.Declaration(
            "aggregate", P.acero.AggregateNodeOptions(aggs)))
        return _seq(P, tt, *decls)

    got, want = _both(plan, t)
    assert got.num_rows == want.num_rows == 1
    assert got.schema.types == want.schema.types
    for name in got.column_names:
        g, w = got[name][0].as_py(), want[name][0].as_py()
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-6, abs=1e-6), name
        else:
            assert g == w, name
    if case == "empty":
        assert got["count_all"][0].as_py() == 0 and \
            got["v_sum"][0].as_py() is None


def test_aggregate_group_table_doubles_and_replays():
    """More groups than ``max_groups``: the node doubles the group table
    and replays the kept batches, as the JAX node does; the group order is
    the same."""
    rng = np.random.default_rng(5)
    # float64 values (integers: sums exact in any order) keep the JAX side
    # off its dense route, whose interpret-mode replay crashes XLA:CPU
    t = pa.table({"k": pa.array(rng.integers(0, 700, 2000)),
                  "v": pa.array(rng.integers(-9, 9, 2000).astype(float))})

    def plan(P, tt):
        return _seq(P, tt, P.acero.Declaration(
            "aggregate", P.acero.AggregateNodeOptions(
                [P.acero.AggregateSpec("sum", "v")], keys=["k"],
                max_groups=256)))

    got = _run(PORT, plan, t, rows=1024)
    want = _run(JAX, plan, t, rows=1024)
    _assert_equal(got, want)
    assert got.num_rows > 600
    node = plan(PORT, PORT.table(t, 1024))._build()
    list(node.batches())
    assert node.ha.max_groups == 1024


def test_aggregate_replay_budget_exhausted_raises(monkeypatch):
    rng = np.random.default_rng(6)
    t = pa.table({"k": pa.array(rng.integers(0, 500, 1000)),
                  "v": pa.array(rng.integers(-9, 9, 1000))})
    monkeypatch.setenv("ARROW_TPU_AGG_REPLAY_BYTES", "1")
    decl = _seq(PORT, PORT.table(t), PORT.acero.Declaration(
        "aggregate", PORT.acero.AggregateNodeOptions(
            [PORT.acero.AggregateSpec("sum", "v")], keys=["k"],
            max_groups=64)))
    with pytest.raises(RuntimeError, match="group table overflow"):
        decl.to_table()


# ---- order_by, fetch -----------------------------------------------------------

def _order_by(P, keys=(("g", "descending"), ("w", "ascending"))):
    return P.acero.Declaration("order_by", P.acero.OrderByNodeOptions(
        list(keys), null_placement="at_start"))


@pytest.mark.parametrize("fetch", [None, (0, 10), (70, 25)])
def test_order_by_and_fetch_vs_jax(fetch):
    """order_by alone, and order_by + fetch (``fuse_topk``: the streaming
    top-k of offset + count rows)."""
    t = _table(300, 7)

    def plan(P, tt):
        decls = [_order_by(P)]
        if fetch is not None:
            decls.append(P.acero.Declaration(
                "fetch", P.acero.FetchNodeOptions(*fetch)))
        return _seq(P, tt, *decls)

    got, want = _both(plan, t)
    _assert_equal(got, want)
    if fetch is not None:
        root = tacero.plan.fuse_topk(plan(PORT, PORT.table(t)))
        assert root.inputs[0].options._limit == sum(fetch)


@pytest.mark.parametrize("offset,count", [(0, 5), (60, 10), (100, 500),
                                          (400, 3)])
def test_fetch_node_vs_jax(offset, count):
    t = _table(300, 8)

    def plan(P, tt):
        return _seq(P, tt, P.acero.Declaration(
            "fetch", P.acero.FetchNodeOptions(offset, count)))

    got, want = _both(plan, t)
    _assert_equal(got, want)
    assert got.num_rows == max(0, min(count, 300 - offset))


# ---- joins ---------------------------------------------------------------------

def _join_tables(n_probe, n_build, seed, wide):
    """Probe (k[, k2], lv, lx with nulls) and build (k[, k2], rv): build keys
    over 3/4 of [0, 60) with duplicates, probe keys uniform in [0, 80) with
    5 % nulls; ``wide`` adds k2 = k * a 62-bit odd constant, so no 30-bit
    window holds the keys and the join takes the "sort" route."""
    rng = np.random.default_rng(seed)
    c = np.int64(0x2545F4914F6CDD1D)
    pk = rng.integers(0, 80, n_probe)
    bk = rng.choice(rng.permutation(60)[:45], n_build)
    with np.errstate(over="ignore"):
        probe = {"k": pa.array(pk, mask=rng.random(n_probe) < .05),
                 "k2": pa.array(pk * c),
                 "lv": pa.array(rng.standard_normal(n_probe)),
                 "lx": pa.array(rng.integers(0, 9, n_probe),
                                mask=rng.random(n_probe) < .1)}
        build = {"k": pa.array(bk), "k2": pa.array(bk * c),
                 "rv": pa.array(rng.standard_normal(n_build))}
    if not wide:
        del probe["k2"], build["k2"]
    return pa.table(probe), pa.table(build)


def _join_plan(P, lt, rt, join_type, keys, bloom=True, **kw):
    # a build capacity near the build's keys (the default, 2^20, sizes
    # every build array and the Bloom bits)
    kw.setdefault("max_build_rows", 128)
    return P.acero.Declaration("hashjoin", P.acero.HashJoinNodeOptions(
        join_type, left_keys=keys, right_keys=keys,
        disable_bloom_filter=not bloom, **kw),
        [_source(P, lt), _source(P, rt)])


def test_bloom_pushdown_runs_on_the_sort_route_only(monkeypatch):
    """The Bloom bits are built for a join whose probe takes the "sort"
    route and not for the packed routes (``nodes.py`` of both packages);
    a left anti join emits the rows the mask rejects directly."""
    built = []
    inner = tjoin.HashJoin.bloom_build
    monkeypatch.setattr(tjoin.HashJoin, "bloom_build",
                        lambda self, bs: built.append(1) or inner(self, bs))
    for wide, n in ((False, 0), (True, 1)):
        lt, rt = _join_tables(300, 120, 10, wide)
        keys = ["k", "k2"] if wide else ["k"]
        for jt in ("inner", "left anti"):
            built.clear()
            got = _run(PORT, _join_plan, lt, rt, join_type=jt, keys=keys)
            assert len(built) == n, (wide, jt)
            want = _run(PORT, _join_plan, lt, rt, join_type=jt, keys=keys,
                        bloom=False)
            assert _rows(got) == _rows(want)


def test_hashjoin_fanout_and_build_capacity_double():
    """A fanout capacity far below the output, and a build capacity below
    the build's distinct keys: the node retries at doubled capacities and
    gives the JAX package's rows."""
    lt, rt = _join_tables(300, 200, 11, False)
    got, want = _both(_join_plan, lt, rt, join_type="inner", keys=["k"],
                      fanout_capacity=8, max_build_rows=16)
    assert _rows(got) == _rows(want) and got.num_rows > 300


# ---- union, cross join ---------------------------------------------------------

def test_union_and_cross_join_vs_jax():
    a, b = _table(100, 12), _table(70, 13)

    def union(P, ta, tb):
        return P.acero.Declaration("union", P.acero.UnionNodeOptions(),
                                   [_source(P, ta), _source(P, tb)])

    got, want = _both(union, a, b)
    _assert_equal(got, want)
    left = pa.table({"a": pa.array(np.arange(20)),
                     "b": pa.array(np.arange(20) * 0.5)})
    right = pa.table({"c": pa.array(np.arange(7, dtype=np.int32),
                                    mask=np.arange(7) == 3)})

    def cross(P, tl, tr):
        return P.acero.Declaration("cross_join", None,
                                   [_source(P, tl), _source(P, tr)])

    got, want = _both(cross, left, right)
    assert _rows(got) == _rows(want) and got.num_rows == 140


# ---- compaction ----------------------------------------------------------------

def test_maybe_compact_slices_sparse_batches(monkeypatch):
    monkeypatch.setenv("ARROW_TPU_COMPACT_MIN", "0")
    monkeypatch.setenv("ARROW_TPU_COMPACT_MIN_BYTES", "0")
    b = att.batch_from_numpy({"a": np.arange(10), "b": np.ones(10)},
                             device="cpu", capacity=4096)
    b = b.with_length(torch.tensor(10))
    out = tnodes.maybe_compact(b)
    assert out.capacity == 16 and len(out) == 10 and out._compacted
    assert torch.equal(out.column("a").values[:10], torch.arange(10))
    assert tnodes.maybe_compact(out) is out
    full = b.with_length(3000)
    out = tnodes.maybe_compact(full)
    assert out.capacity == 4096 and out._compacted
    # a whole plan through compaction at every step equals the JAX package
    t = _table(600, 14)

    def plan(P, tt):
        return _seq(P, tt, P.acero.Declaration(
            "filter", P.acero.FilterNodeOptions(P.field("w") > P.literal(800))),
            _order_by(P))

    got, want = _both(plan, t)
    _assert_equal(got, want)


def test_source_nodes_and_plan_surface():
    """``source`` (a generator of Batches) and ``record_batch_source`` (an
    iterable of Batches) feed a filter as a table_source does; the plan's
    string, repr, reader and pyarrow forms."""
    t = _table(200, 15)
    tt = PORT.table(t)

    def filt(P):
        return P.acero.Declaration("filter", P.acero.FilterNodeOptions(
            P.field("w") > P.literal(0)))

    want = _run(PORT, lambda P, x: _seq(P, x, filt(P)), t)
    for name, opts in (
            ("source", tacero.SourceNodeOptions(
                tt.schema, lambda: iter(tt.batches))),
            ("record_batch_source", tacero.RecordBatchSourceNodeOptions(
                tt.schema, tt.batches))):
        decl = tacero.Declaration.from_sequence([
            tacero.Declaration(name, opts), filt(PORT)])
        _assert_equal(decl.to_pyarrow(), want)
        assert sum(len(b) for b in decl.to_reader()) == want.num_rows
    decl = _seq(PORT, tt, filt(PORT))
    assert repr(decl) == "filter(table_source)"
    assert decl.to_string() == ("filter [FilterNodeOptions]\n"
                                "  table_source [TableSourceNodeOptions]")
    assert tacero.declaration_to_table(decl).num_rows == want.num_rows
    with pytest.raises(KeyError, match="no exec node factory"):
        tacero.Declaration("no_such_node").to_table()
    # dist= runs over a context's logical shards (test_torch_acero_dist.py
    # holds it against the JAX package)
    from arrow_tpu_torch.parallel import DistContext
    got, exp = (tacero.Declaration("aggregate", tacero.AggregateNodeOptions(
        [("min", "w"), ("count_all",)], keys=["k"], dist=d),
        [_source(PORT, tt)]).to_pyarrow().sort_by("k")
        for d in (DistContext(devices=["cpu"] * 2), None))
    assert got.to_pydict() == exp.to_pydict()
