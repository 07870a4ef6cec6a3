"""The port's Substrait consumer and producer (``arrow_tpu_torch.engine``)
held against the JAX package's on the CPU.

Each plan of ``tests/test_substrait.py`` runs through both packages'
``run_query`` and the tables must be equal (rows sorted where the plan
leaves their order free; float sums within ROADMAP C5's f64 tolerance).
The producer's JSON and binary plans for the same Declaration, built in
both packages, must be equal byte for byte, and ``substrait_pb`` must
encode and decode as the JAX copy does. ``pyarrow.substrait`` runs the
binary plans where ``tests/test_substrait.py`` holds them against it.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow_tpu.acero as ja
import arrow_tpu.engine as je
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as ta
import arrow_tpu_torch.engine as te
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.engine import substrait_pb as jpb
from arrow_tpu_torch.compute.expressions import field as tfield
from arrow_tpu_torch.engine import substrait_pb as tpb

_CMP_URI = ("https://github.com/substrait-io/substrait/blob/main/"
            "extensions/functions_comparison.yaml")
_ARITH_URI = ("https://github.com/substrait-io/substrait/blob/main/"
              "extensions/functions_arithmetic.yaml")
_I64 = {"i64": {"nullability": 1}}


def _sel(i):
    return {"selection": {"directReference": {"structField": {"field": i}},
                          "rootReference": {}}}


def _fn_ext(anchor, name):
    return {"extensionFunction": {"functionAnchor": anchor, "name": name}}


def _read(name, names, types=None):
    base = {"names": names}
    if types:
        base["struct"] = {"types": types}
    return {"read": {"baseSchema": base, "namedTable": {"names": [name]}}}


def _root(rel, names, extensions=None, uris=None):
    plan = {"version": {"minorNumber": 44},
            "relations": [{"root": {"input": rel, "names": names}}]}
    if extensions:
        plan["extensions"] = extensions
    if uris:
        plan["extensionUris"] = uris
    return plan


def _rows(t: pa.Table, order_free: bool):
    rows = list(zip(*[t.column(i).to_pylist()
                      for i in range(t.num_columns)]))
    return sorted(rows, key=repr) if order_free else rows


def _assert_tables(got: pa.Table, want: pa.Table, order_free=False):
    assert got.column_names == want.column_names
    g, w = _rows(got, order_free), _rows(want, order_free)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(b, float) and a is not None:
                # C5: f64 sums differ in order; 1e-12 of the magnitudes
                assert abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1.0) * 64
            else:
                assert a == b, (rg, rw)


def _both(plan, tables=None):
    """(port result, JAX result) as pyarrow Tables."""
    got = te.run_query(plan, named_tables=tables, device="cpu").to_pyarrow()
    want = je.run_query(plan, named_tables=tables).to_pyarrow()
    return got, want


def _plan_filter_project(rng):
    t = pa.table({"a": pa.array(rng.integers(0, 100, 500)),
                  "b": pa.array(rng.standard_normal(500))})
    plan = _root({"project": {
        "common": {"emit": {"outputMapping": [0, 2]}},
        "input": {"filter": {
            "input": _read("t", ["a", "b"]),
            "condition": {"scalarFunction": {
                "functionReference": 1,
                "arguments": [{"value": _sel(0)},
                              {"value": {"literal": {"i64": "50"}}}]}}}},
        "expressions": [{"scalarFunction": {
            "functionReference": 2,
            "arguments": [{"value": _sel(0)},
                          {"value": {"literal": {"i64": "1"}}}]}}]}},
        ["a", "a_plus_1"],
        [_fn_ext(1, "gt:any_any"), _fn_ext(2, "add:i64_i64")])
    return plan, {"t": t}, False


def _plan_aggregate_sort(rng):
    t = pa.table({"k": pa.array(rng.integers(0, 8, 400)),
                  "v": pa.array(rng.standard_normal(400))})
    plan = _root({"sort": {
        "input": {"aggregate": {
            "input": _read("t", ["k", "v"]),
            "groupings": [{"groupingExpressions": [_sel(0)]}],
            "measures": [{"measure": {
                "functionReference": 7,
                "arguments": [{"value": _sel(1)}]}}]}},
        "sorts": [{"expr": _sel(0),
                   "direction": "SORT_DIRECTION_ASC_NULLS_LAST"}]}},
        ["k", "v_sum"], [_fn_ext(7, "sum:fp64")])
    return plan, {"t": t}, False


def _plan_join(rng):
    l = pa.table({"k": pa.array([1, 2, 3, 4]),
                  "lv": pa.array([10, 20, 30, 40])})
    r = pa.table({"k2": pa.array([2, 4]), "rv": pa.array([200, 400])})
    plan = _root({"join": {
        "left": _read("l", ["k", "lv"]), "right": _read("r", ["k2", "rv"]),
        "type": "JOIN_TYPE_INNER",
        "expression": {"scalarFunction": {
            "functionReference": 3,
            "arguments": [{"value": _sel(0)}, {"value": _sel(2)}]}}}},
        ["k", "lv", "k2", "rv"], [_fn_ext(3, "equal:any_any")])
    return plan, {"l": l, "r": r}, True


def _binary_filter_plan():
    return _root({"filter": {
        "input": _read("t", ["a", "b"], [_I64, {"fp64": {"nullability": 1}}]),
        "condition": {"scalarFunction": {
            "functionReference": 1,
            "outputType": {"bool": {"nullability": 1}},
            "arguments": [{"value": _sel(0)},
                          {"value": {"literal": {"i64": 90}}}]}}}},
        ["a", "b"],
        [{"extensionFunction": {"extensionUriReference": 1,
                                "functionAnchor": 1, "name": "gt"}}],
        [{"extensionUriAnchor": 1, "uri": _CMP_URI}])


def _plan_binary_filter(rng):
    t = pa.table({"a": pa.array(np.arange(100, dtype=np.int64)),
                  "b": pa.array(np.arange(100, dtype=np.float64))})
    return tpb.encode_plan(_binary_filter_plan()), {"t": t}, False


def _plan_binary_aggregate(rng):
    t = pa.table({"k": pa.array(rng.integers(0, 8, 400)),
                  "v": pa.array(rng.standard_normal(400))})
    plan = _root({"aggregate": {
        "input": _read("t", ["k", "v"], [_I64, {"fp64": {"nullability": 1}}]),
        "groupings": [{"groupingExpressions": [_sel(0)]}],
        "measures": [{"measure": {
            "functionReference": 7,
            "phase": "AGGREGATION_PHASE_INITIAL_TO_RESULT",
            "outputType": {"fp64": {"nullability": 1}},
            "arguments": [{"value": _sel(1)}]}}]}},
        ["k", "v_sum"],
        [{"extensionFunction": {"extensionUriReference": 1,
                                "functionAnchor": 7, "name": "sum"}}],
        [{"extensionUriAnchor": 1, "uri": _ARITH_URI}])
    return tpb.encode_plan(plan), {"t": t}, True


def _ab():
    return pa.table({"x": pa.array([1, 2, 3])}), \
        pa.table({"y": pa.array([10, 20])})


def _plan_cross(rng):
    a, b = _ab()
    plan = _root({"cross": {"left": _read("a", ["x"], [_I64]),
                            "right": _read("b", ["y"], [_I64])}}, ["x", "y"])
    return tpb.encode_plan(plan), {"a": a, "b": b}, True


def _set_plan(op):
    a, _ = _ab()
    c = pa.table({"x": pa.array([2, 3, 4])})
    plan = _root({"set": {"inputs": [_read("a", ["x"], [_I64]),
                                     _read("c", ["x"], [_I64])],
                          "op": op}}, ["x"])
    return tpb.encode_plan(plan), {"a": a, "c": c}, True


def _plan_union_all(rng):
    return _set_plan("SET_OP_UNION_ALL")


def _plan_union_distinct(rng):
    return _set_plan("SET_OP_UNION_DISTINCT")


def _plan_virtual_table(rng):
    plan = _root({"read": {
        "baseSchema": {"names": ["a", "b"], "struct": {"types": [
            _I64, {"string": {"nullability": 1}}]}},
        "virtualTable": {"values": [
            {"fields": [{"i64": 1}, {"string": "x"}]},
            {"fields": [{"i64": 2}, {"string": "y"}]}]}}}, ["a", "b"])
    return tpb.encode_plan(plan), None, False


def _plan_emit_on_filter(rng):
    t = pa.table({"a": pa.array([1, 5, 9]), "b": pa.array([2., 4., 6.])})
    plan = _root({"filter": {
        "common": {"emit": {"outputMapping": [1]}},
        "input": _read("t", ["a", "b"]),
        "condition": {"scalarFunction": {
            "functionReference": 1,
            "arguments": [{"value": _sel(0)},
                          {"value": {"literal": {"i64": "2"}}}]}}}},
        ["bb"], [_fn_ext(1, "gt:any_any")])
    return plan, {"t": t}, False


_PLANS = {
    "filter_project": _plan_filter_project,
    "aggregate_sort": _plan_aggregate_sort,
    "join": _plan_join,
    "binary_filter": _plan_binary_filter,
    "binary_aggregate": _plan_binary_aggregate,
    "cross": _plan_cross,
    "union_all": _plan_union_all,
    "union_distinct": _plan_union_distinct,
    "virtual_table": _plan_virtual_table,
    "emit_on_filter": _plan_emit_on_filter,
}


@pytest.mark.parametrize("name", list(_PLANS))
def test_run_query_matches_jax(name, rng):
    plan, tables, order_free = _PLANS[name](rng)
    got, want = _both(plan, tables)
    _assert_tables(got, want, order_free)


@pytest.mark.parametrize("name", ["binary_filter", "binary_aggregate"])
def test_binary_plans_match_pyarrow(name, rng):
    import pyarrow.substrait as ps
    plan, tables, order_free = _PLANS[name](rng)
    t = tables["t"]
    want = ps.run_query(plan, table_provider=lambda names, *_: t).read_all()
    got = te.run_query(plan, named_tables=tables, device="cpu").to_pyarrow()
    _assert_tables(got, want.rename_columns(got.column_names), order_free)


def test_json_and_bytes_forms_agree(rng):
    """A plan as a dict, a JSON string, JSON bytes and protobuf bytes."""
    plan, tables, _ = _plan_aggregate_sort(rng)
    want = te.run_query(plan, tables, device="cpu").to_pyarrow()
    for form in (json.dumps(plan), json.dumps(plan).encode(),
                 memoryview(tpb.encode_plan(plan))):
        got = te.run_query(form, tables, device="cpu").to_pyarrow()
        assert got.equals(want)


def _register_udf(engine_mod):
    engine_mod.substrait.register_substrait_function(
        "my_square_root", "sqrt", uri="urn:example:my_udfs.yaml")


def test_register_udf_uri_matches_jax():
    t = pa.table({"x": pa.array([1.0, 4.0, 9.0, None])})
    plan = _root({"project": {
        "common": {"emit": {"outputMapping": [1]}},
        "input": _read("t", ["x"]),
        "expressions": [{"scalarFunction": {
            "functionReference": 9,
            "arguments": [{"value": _sel(0)}]}}]}},
        ["sx"],
        [{"extensionFunction": {"extensionUriReference": 3,
                                "functionAnchor": 9,
                                "name": "my_square_root:fp64"}}],
        [{"extensionUriAnchor": 3, "uri": "urn:example:my_udfs.yaml"}])
    with pytest.raises(NotImplementedError, match="register_substrait"):
        te.run_query(plan, {"t": t}, device="cpu")
    for mod in (te, je):
        _register_udf(mod)
    try:
        got, want = _both(plan, {"t": t})
        _assert_tables(got, want)
        assert got["sx"].to_pylist()[:3] == [1.0, 2.0, 3.0]
    finally:
        te.substrait._USER_FUNCTIONS.clear()
        je.substrait._USER_FUNCTIONS.clear()


# ---- the producer ---------------------------------------------------------

def _producer_decls(pkg, field, rng, stage):
    """Q-shaped Declarations of one package: a filter + project over one
    table, and a join -> aggregate -> order_by -> fetch."""
    a = pa.table({"a": pa.array(rng.integers(0, 100, 300)),
                  "b": pa.array(rng.standard_normal(300))})
    l = pa.table({"k": pa.array(rng.integers(0, 20, 400)),
                  "v": pa.array(rng.standard_normal(400))})
    r = pa.table({"k2": pa.array(np.arange(20)),
                  "w": pa.array(np.arange(20) * 10.0)})
    src = lambda t: pkg.Declaration("table_source",
                                    pkg.TableSourceNodeOptions(stage(t)))
    d1 = pkg.Declaration.from_sequence([
        src(a),
        pkg.Declaration("filter", pkg.FilterNodeOptions(field("a") > 40)),
        pkg.Declaration("project", pkg.ProjectNodeOptions(
            [field("a"), field("b") * 2.0], ["a", "b2"]))])
    d2 = pkg.Declaration.from_sequence([
        pkg.Declaration("hashjoin", pkg.HashJoinNodeOptions(
            "inner", left_keys=["k"], right_keys=["k2"],
            left_output=["k", "v"], right_output=["w"]),
            inputs=[src(l), src(r)]),
        pkg.Declaration("aggregate", pkg.AggregateNodeOptions(
            [pkg.AggregateSpec("sum", "v", name="v_sum"),
             pkg.AggregateSpec("max", "w", name="w_max")], keys=["k"])),
        pkg.Declaration("order_by",
                        pkg.OrderByNodeOptions([("k", "ascending")])),
        pkg.Declaration("fetch", pkg.FetchNodeOptions(0, 10))])
    return [d1, d2]


@pytest.mark.parametrize("which", [0, 1])
def test_producer_output_equals_jax(which):
    tdecl = _producer_decls(
        ta, tfield, np.random.default_rng(3),
        lambda t: tat.Table.from_pyarrow(t, max_rows_per_batch=1 << 15,
                                         device="cpu"))[which]
    jdecl = _producer_decls(ja, jfield, np.random.default_rng(3),
                            lambda t: t)[which]
    tplan, ttables = te.declaration_to_substrait(tdecl)
    jplan, jtables = je.declaration_to_substrait(jdecl)
    assert json.dumps(tplan, sort_keys=True) == \
        json.dumps(jplan, sort_keys=True)
    assert sorted(ttables) == sorted(jtables)
    tbuf, _ = te.declaration_to_substrait(tdecl, binary=True)
    jbuf, _ = je.declaration_to_substrait(jdecl, binary=True)
    assert tbuf == jbuf
    # the port's plan runs in the port and in the JAX package alike
    got = te.run_query(tbuf, ttables, device="cpu").to_pyarrow()
    want = je.run_query(jbuf, jtables).to_pyarrow()
    _assert_tables(got, want)


def test_producer_plan_runs_in_pyarrow():
    import pyarrow.substrait as ps
    tdecl = _producer_decls(
        ta, tfield, np.random.default_rng(4),
        lambda t: tat.Table.from_pyarrow(t, device="cpu"))[0]
    buf, tables = te.declaration_to_substrait(tdecl, binary=True)
    pa_tables = {k: v.to_pyarrow() for k, v in tables.items()}
    want = ps.run_query(buf, table_provider=lambda names, *_:
                        pa_tables[names[0]]).read_all()
    got = te.run_query(buf, tables, device="cpu").to_pyarrow()
    _assert_tables(got, want)


def test_substrait_pb_bytes_equal_jax():
    plans = [_binary_filter_plan(), _plan_cross(None)[0],
             _plan_virtual_table(None)[0]]
    for p in plans[:1]:
        assert tpb.encode_plan(p) == jpb.encode_plan(p)
    for buf in [tpb.encode_plan(plans[0])] + plans[1:]:
        dec = tpb.decode_plan(buf)
        assert dec == jpb.decode_plan(buf)
        assert tpb.encode_plan(dec) == jpb.encode_plan(dec) == buf


def test_extended_expression_decode_matches_jax():
    import pyarrow.substrait as ps
    schema = pa.schema([("x", pa.int64()), ("y", pa.float64())])
    buf = bytes(ps.serialize_expressions([pc.field("y") > 2.5], ["gt_y"],
                                         schema))
    assert tpb.decode_message(buf, "ExtendedExpression") == \
        jpb.decode_message(buf, "ExtendedExpression")


def test_local_files_read_through_scan(tmp_path):
    """A ReadRel of local files runs through the port's ``scan`` node."""
    import pyarrow.parquet as pq
    t = pa.table({"a": pa.array(np.arange(50, dtype=np.int64))})
    path = str(tmp_path / "part.parquet")
    pq.write_table(t, path)
    plan = _root({"read": {"baseSchema": {"names": ["a"]},
                           "localFiles": {"items": [
                               {"uriFile": "file://" + path}]}}}, ["a"])
    decl = te.substrait_to_declaration(plan, device="cpu")
    assert decl.inputs[0].factory_name == "scan"
    got, want = _both(plan)
    _assert_tables(got, want)
