"""Substrait plan consumer and producer; the counterpart of the JAX
package's ``engine/substrait.py``.

Reference: ``cpp/src/arrow/engine/substrait/serde.cc`` (DeserializePlan,
SerializePlan) and ``relation_internal.cc`` (rel <-> acero Declaration).
Plans are consumed in the **protobuf JSON form** (the canonical text
encoding) or as binary protobuf, decoded to that form by
``engine/substrait_pb.py`` (no protoc bindings are needed). Supported rels:
read (named table, virtual table, local files through the ``scan`` node),
filter, project, aggregate, sort, fetch, join, cross, set; expressions:
field selections, literals, casts and scalar functions mapped through the
standard extension URIs (functions_comparison / arithmetic / boolean) or
``register_substrait_function``.

``run_query(plan, named_tables, device=None)`` stages pyarrow named
tables, virtual tables and scanned files on ``device`` (None: the default
device, the card); Tables of this package are used where they lie. The
plan then runs through ``Declaration.to_table`` and its default driver.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..acero import (AggregateNodeOptions, AggregateSpec, Declaration,
                     ExecNodeOptions, FetchNodeOptions, FilterNodeOptions,
                     HashJoinNodeOptions, OrderByNodeOptions,
                     ProjectNodeOptions, ScanNodeOptions,
                     TableSourceNodeOptions)
from ..compute.expressions import Expression, call, field as field_ref, \
    literal
from ..core import datatype as dt
from ..core.array import resolve_device
from ..core.batch import Table

__all__ = ["substrait_to_declaration", "run_query",
           "register_substrait_function", "declaration_to_substrait"]

# substrait function name -> registry function (standard extension yamls)
_FUNCTION_MAP = {
    "gt": "greater", "gte": "greater_equal", "lt": "less",
    "lte": "less_equal", "equal": "equal", "not_equal": "not_equal",
    "and": "and_kleene", "or": "or_kleene", "not": "invert",
    "add": "add", "subtract": "subtract", "multiply": "multiply",
    "divide": "divide", "modulus": "mod", "power": "power",
    "abs": "abs", "negate": "negate",
    "is_null": "is_null", "is_not_null": "is_valid",
    "sum": "sum", "min": "min", "max": "max", "avg": "mean",
    "count": "count", "count_all": "count_all", "any_value": "one",
}


# user-registered extension functions: (uri, substrait-name) -> registry
# function. ``uri="*"`` matches any URI (reference:
# ``engine/substrait/extension_set.cc`` ExtensionIdRegistry — consumers
# register UDF mappings keyed by (uri, name); name-only matching is the
# default-URI shortcut).
_USER_FUNCTIONS: Dict = {}


def register_substrait_function(substrait_name: str, registry_name: str,
                                uri: str = "*") -> None:
    """Map a Substrait extension function (by URI + name) to a function
    in this engine's registry — the UDF-URI hook the reference exposes
    through ExtensionIdRegistry (``extension_set.cc``). ``uri="*"``
    registers a URI-agnostic fallback."""
    _USER_FUNCTIONS[(uri, substrait_name)] = registry_name


class _Ctx:
    def __init__(self, plan: dict, named_tables: Dict, device=None):
        self.named_tables = named_tables or {}
        self.device = resolve_device(device)
        self.functions: Dict[int, str] = {}
        uris = {int(u.get("extensionUriAnchor", 0)): u.get("uri", "")
                for u in plan.get("extensionUris", [])}
        for ext in plan.get("extensions", []):
            f = ext.get("extensionFunction")
            if f:
                name = f.get("name", "")
                base = name.split(":", 1)[0]
                uri = uris.get(int(f.get("extensionUriReference", 0)), "")
                self.functions[int(f.get("functionAnchor", 0))] = \
                    (uri, base)

    def source(self, table) -> Declaration:
        """A table_source of ``table``: a pyarrow Table staged on the
        plan's device, a Table of this package as it is."""
        if not isinstance(table, Table):
            table = Table.from_pyarrow(table, max_rows_per_batch=1 << 15,
                                       device=self.device)
        return Declaration("table_source", TableSourceNodeOptions(table))

    def resolve(self, anchor: int) -> Optional[str]:
        """Registry function for a function anchor: user registrations
        (exact URI, then any-URI) take precedence over the built-in
        standard-extension map."""
        entry = self.functions.get(anchor)
        if entry is None:
            return None
        uri, base = entry
        for key in ((uri, base), ("*", base)):
            if key in _USER_FUNCTIONS:
                return _USER_FUNCTIONS[key]
        return _FUNCTION_MAP.get(base)


def _literal_value(lit: dict):
    for k in ("boolean", "i8", "i16", "i32", "i64", "fp32", "fp64",
              "string", "date"):
        if k in lit:
            v = lit[k]
            if k.startswith("i") and isinstance(v, str):
                v = int(v)
            return v
    if "null" in lit:
        return None
    raise NotImplementedError(f"substrait literal {sorted(lit)}")


def _expr(e: dict, ctx: _Ctx, input_fields: List[str]) -> Expression:
    if "selection" in e:
        sel = e["selection"]
        idx = int(sel.get("directReference", {}).get("structField", {})
                  .get("field", 0))
        return field_ref(input_fields[idx])
    if "literal" in e:
        return literal(_literal_value(e["literal"]))
    if "scalarFunction" in e:
        f = e["scalarFunction"]
        anchor = int(f.get("functionReference", 0))
        fn = ctx.resolve(anchor)
        if fn is None:
            raise NotImplementedError(
                f"substrait function anchor {anchor} "
                f"({ctx.functions.get(anchor)!r}) — register_"
                f"substrait_function() maps custom URIs/names")
        args = [_expr(a["value"], ctx, input_fields)
                for a in f.get("arguments", []) if "value" in a]
        return call(fn, args)
    if "cast" in e:
        from ..ops.scalar_cast import CastOptions
        c = e["cast"]
        inner = _expr(c["input"], ctx, input_fields)
        t = _substrait_type(c["type"])
        return call("cast", [inner], options=CastOptions(t))
    raise NotImplementedError(f"substrait expression {sorted(e)}")


def _substrait_type(t: dict):
    mapping = {"bool": dt.bool_, "i8": dt.int8, "i16": dt.int16,
               "i32": dt.int32, "i64": dt.int64, "fp32": dt.float32,
               "fp64": dt.float64, "string": dt.string, "date": dt.date32}
    for k, v in mapping.items():
        if k in t:
            return v
    raise NotImplementedError(f"substrait type {sorted(t)}")


def _emit_of(body: dict) -> Optional[List[int]]:
    """RelCommon.emit.output_mapping of a rel body (None = direct)."""
    emit = body.get("common", {}).get("emit", {}).get("outputMapping")
    return [int(i) for i in emit] if emit else None


def _rel_fields(rel: dict, ctx: _Ctx) -> List[str]:
    """Output field names of a rel (for positional field references),
    emit/output_mapping applied (every rel carries RelCommon — the
    reference honors emit on all rels, ``relation_internal.cc``)."""
    names = _rel_fields_direct(rel, ctx)
    if "project" in rel:  # project applies emit itself (expr outputs)
        return names
    kind = next((k for k in rel if k != "common"), None)
    emit = _emit_of(rel.get(kind, {})) if kind else None
    return [names[i] for i in emit] if emit else names


def _rel_fields_direct(rel: dict, ctx: _Ctx) -> List[str]:
    if "read" in rel:
        return list(rel["read"]["baseSchema"]["names"])
    if "filter" in rel:
        return _rel_fields(rel["filter"]["input"], ctx)
    if "fetch" in rel:
        return _rel_fields(rel["fetch"]["input"], ctx)
    if "sort" in rel:
        return _rel_fields(rel["sort"]["input"], ctx)
    if "project" in rel:
        base = _rel_fields(rel["project"]["input"], ctx)
        n = len(rel["project"].get("expressions", []))
        names = base + [f"expr{i}" for i in range(n)]
        emit = rel["project"].get("common", {}).get("emit", {}) \
            .get("outputMapping")
        return [names[i] for i in emit] if emit else names
    if "aggregate" in rel:
        agg = rel["aggregate"]
        base = _rel_fields(agg["input"], ctx)
        names = []
        for g in agg.get("groupings", []):
            for ge in g.get("groupingExpressions", []):
                idx = int(ge.get("selection", {})
                          .get("directReference", {})
                          .get("structField", {}).get("field", 0))
                names.append(base[idx])
        for i, _m in enumerate(agg.get("measures", [])):
            names.append(f"agg{i}")
        return names
    if "join" in rel:
        j = rel["join"]
        return _rel_fields(j["left"], ctx) + _rel_fields(j["right"], ctx)
    if "cross" in rel:
        c = rel["cross"]
        return _rel_fields(c["left"], ctx) + _rel_fields(c["right"], ctx)
    if "set" in rel:
        return _rel_fields(rel["set"]["inputs"][0], ctx)
    raise NotImplementedError(f"substrait rel {sorted(rel)}")


def _rel(rel: dict, ctx: _Ctx) -> Declaration:
    """Rel -> Declaration with RelCommon.emit applied (the reference
    honors emit on every rel; project handles it natively here, other
    rels get a name-selecting projection)."""
    decl = _rel_direct(rel, ctx)
    if "project" not in rel:
        kind = next((k for k in rel if k != "common"), None)
        emit = _emit_of(rel.get(kind, {})) if kind else None
        if emit:
            names = _rel_fields_direct(rel, ctx)
            decl = Declaration("project", ProjectNodeOptions(
                [field_ref(names[i]) for i in emit],
                [names[i] for i in emit]), [decl])
    return decl


def _rel_direct(rel: dict, ctx: _Ctx) -> Declaration:
    if "read" in rel:
        r = rel["read"]
        if "namedTable" in r:
            name = r["namedTable"]["names"][0]
            return ctx.source(ctx.named_tables[name])
        if "virtualTable" in r:
            import pyarrow as pa
            names = list(r["baseSchema"]["names"])
            rows = []
            for sl in r["virtualTable"].get("values", []):
                rows.append([_literal_value(f)
                             for f in sl.get("fields", [])])
            cols = {n: [row[i] if i < len(row) else None for row in rows]
                    for i, n in enumerate(names)}
            return ctx.source(pa.table(cols))
        if "localFiles" in r:
            from .. import dataset as ds
            items = r["localFiles"]["items"]
            paths = [i["uriFile"].replace("file://", "") for i in items]
            frags = []
            for p in paths:
                ext = p.rsplit(".", 1)[-1]
                frags.append(ds.Fragment(p, ext))
            d = ds.FileSystemDataset(frags)
            return Declaration("scan", ScanNodeOptions(d,
                                                       device=ctx.device))
        raise NotImplementedError("substrait read kind")
    if "filter" in rel:
        f = rel["filter"]
        inp = _rel(f["input"], ctx)
        fields = _rel_fields(f["input"], ctx)
        return Declaration("filter", FilterNodeOptions(
            _expr(f["condition"], ctx, fields)), [inp])
    if "project" in rel:
        p = rel["project"]
        inp = _rel(p["input"], ctx)
        fields = _rel_fields(p["input"], ctx)
        exprs = [field_ref(n) for n in fields]
        exprs += [_expr(e, ctx, fields) for e in p.get("expressions", [])]
        names = fields + [f"expr{i}"
                          for i in range(len(p.get("expressions", [])))]
        emit = p.get("common", {}).get("emit", {}).get("outputMapping")
        if emit:
            exprs = [exprs[i] for i in emit]
            names = [names[i] for i in emit]
        return Declaration("project", ProjectNodeOptions(exprs, names),
                           [inp])
    if "aggregate" in rel:
        a = rel["aggregate"]
        inp = _rel(a["input"], ctx)
        fields = _rel_fields(a["input"], ctx)
        keys = []
        for g in a.get("groupings", []):
            for ge in g.get("groupingExpressions", []):
                idx = int(ge.get("selection", {}).get("directReference", {})
                          .get("structField", {}).get("field", 0))
                keys.append(fields[idx])
        specs = []
        for i, m in enumerate(a.get("measures", [])):
            mf = m["measure"]
            anchor = int(mf.get("functionReference", 0))
            fn = ctx.resolve(anchor)
            if fn is None:
                raise NotImplementedError(
                    f"substrait measure {ctx.functions.get(anchor)!r}")
            args = mf.get("arguments", [])
            target = None
            if args:
                idx = int(args[0]["value"].get("selection", {})
                          .get("directReference", {})
                          .get("structField", {}).get("field", 0))
                target = fields[idx]
            specs.append(AggregateSpec(fn, target, name=f"agg{i}"))
        return Declaration("aggregate",
                           AggregateNodeOptions(specs, keys), [inp])
    if "sort" in rel:
        s = rel["sort"]
        inp = _rel(s["input"], ctx)
        fields = _rel_fields(s["input"], ctx)
        keys = []
        for sf in s.get("sorts", []):
            idx = int(sf["expr"].get("selection", {})
                      .get("directReference", {})
                      .get("structField", {}).get("field", 0))
            direction = sf.get("direction",
                               "SORT_DIRECTION_ASC_NULLS_LAST")
            order = "descending" if (direction in (3, 4) or
                                     "DESC" in str(direction)) \
                else "ascending"
            keys.append((fields[idx], order))
        return Declaration("order_by", OrderByNodeOptions(keys), [inp])
    if "fetch" in rel:
        f = rel["fetch"]
        inp = _rel(f["input"], ctx)
        return Declaration("fetch", FetchNodeOptions(
            int(f.get("offset", 0)), int(f.get("count", 0))), [inp])
    if "join" in rel:
        j = rel["join"]
        left = _rel(j["left"], ctx)
        right = _rel(j["right"], ctx)
        lf = _rel_fields(j["left"], ctx)
        rf = _rel_fields(j["right"], ctx)
        jt = {"JOIN_TYPE_INNER": "inner", "JOIN_TYPE_LEFT": "left outer",
              "JOIN_TYPE_RIGHT": "right outer",
              "JOIN_TYPE_OUTER": "full outer",
              "JOIN_TYPE_LEFT_SEMI": "left semi",
              "JOIN_TYPE_LEFT_ANTI": "left anti",
              1: "inner", 2: "full outer", 3: "left outer",
              4: "right outer", 5: "left semi", 6: "left anti"}[
            j.get("type", "JOIN_TYPE_INNER")]
        # equality condition: equal(field_l, field_r)
        cond = j["expression"]["scalarFunction"]["arguments"]
        all_fields = lf + rf
        lidx = int(cond[0]["value"]["selection"]["directReference"]
                   ["structField"].get("field", 0))
        ridx = int(cond[1]["value"]["selection"]["directReference"]
                   ["structField"].get("field", 0))
        lkey, rkey = all_fields[lidx], all_fields[ridx]
        return Declaration("hashjoin", HashJoinNodeOptions(
            jt, [lkey], [rkey]), [left, right])
    if "cross" in rel:
        c = rel["cross"]
        return Declaration("cross_join", ExecNodeOptions(),
                           [_rel(c["left"], ctx), _rel(c["right"], ctx)])
    if "set" in rel:
        s = rel["set"]
        inputs = [_rel(r, ctx) for r in s["inputs"]]
        op = s.get("op", "SET_OP_UNION_ALL")
        if isinstance(op, int):
            op = {5: "SET_OP_UNION_DISTINCT", 6: "SET_OP_UNION_ALL"}.get(
                op, op)
        union = Declaration("union", None, inputs)
        if op == "SET_OP_UNION_ALL" or op == 6:
            return union
        if op == "SET_OP_UNION_DISTINCT" or op == 5:
            names = _rel_fields(s["inputs"][0], ctx)
            return Declaration("aggregate",
                               AggregateNodeOptions([], keys=names),
                               [union])
        raise NotImplementedError(f"substrait set op {op!r}")
    raise NotImplementedError(f"substrait rel {sorted(rel)}")


def substrait_to_declaration(plan, named_tables: Optional[Dict] = None,
                             device=None) -> Declaration:
    """Substrait plan (binary protobuf / JSON string / dict / bytes)
    -> Declaration. Binary wire-format plans (the ecosystem's native
    encoding, ``serde.cc`` DeserializePlan) decode through
    engine/substrait_pb.py into the same JSON form. Sources are staged on
    ``device`` (None: the default device)."""
    if isinstance(plan, memoryview):
        plan = bytes(plan)
    if isinstance(plan, (bytes, bytearray)):
        if plan.lstrip()[:1] == b"{":
            plan = plan.decode()
        else:
            from .substrait_pb import decode_plan
            plan = decode_plan(bytes(plan))
    if isinstance(plan, str):
        plan = json.loads(plan)
    ctx = _Ctx(plan, named_tables, device)
    rels = plan.get("relations", [])
    if not rels:
        raise ValueError("substrait plan has no relations")
    root = rels[0].get("root", rels[0].get("rel"))
    rel = root.get("input", root) if "input" in root else root
    decl = _rel(rel, ctx)
    names = root.get("names")
    if names:
        fields = _rel_fields(rel, ctx)
        decl = Declaration("project", ProjectNodeOptions(
            [field_ref(f) for f in fields], list(names)), [decl])
    return decl


def run_query(plan, named_tables: Optional[Dict] = None, device=None):
    """DeserializePlan + execute -> Table (pyarrow.substrait.run_query
    analog), on ``device`` (None: the default device, the card)."""
    return substrait_to_declaration(plan, named_tables, device).to_table()


# ---- producer (Declaration -> Substrait) -------------------------------------
#
# Reference: ``engine/substrait/serde.cc`` SerializePlan +
# ``relation_internal.cc`` ToProto — the reference is a producer as well
# as a consumer; round-tripping our Declarations through the wire form
# lets external engines (including pyarrow.substrait itself — oracle in
# tests) execute plans this engine built.

_URI_BASE = ("https://github.com/substrait-io/substrait/blob/main/"
             "extensions/")

# registry function -> (substrait name, extension yaml)
_PRODUCE_FN = {
    "greater": ("gt", "functions_comparison.yaml"),
    "greater_equal": ("gte", "functions_comparison.yaml"),
    "less": ("lt", "functions_comparison.yaml"),
    "less_equal": ("lte", "functions_comparison.yaml"),
    "equal": ("equal", "functions_comparison.yaml"),
    "not_equal": ("not_equal", "functions_comparison.yaml"),
    "is_null": ("is_null", "functions_comparison.yaml"),
    "is_valid": ("is_not_null", "functions_comparison.yaml"),
    "and_kleene": ("and", "functions_boolean.yaml"),
    "or_kleene": ("or", "functions_boolean.yaml"),
    "invert": ("not", "functions_boolean.yaml"),
    "add": ("add", "functions_arithmetic.yaml"),
    "subtract": ("subtract", "functions_arithmetic.yaml"),
    "multiply": ("multiply", "functions_arithmetic.yaml"),
    "divide": ("divide", "functions_arithmetic.yaml"),
    "abs": ("abs", "functions_arithmetic.yaml"),
    "negate": ("negate", "functions_arithmetic.yaml"),
    "power": ("power", "functions_arithmetic.yaml"),
    "sum": ("sum", "functions_arithmetic.yaml"),
    "min": ("min", "functions_arithmetic.yaml"),
    "max": ("max", "functions_arithmetic.yaml"),
    "mean": ("avg", "functions_arithmetic.yaml"),
    "count": ("count", "functions_aggregate_generic.yaml"),
    "count_all": ("count", "functions_aggregate_generic.yaml"),
}


class _Producer:
    def __init__(self):
        self.uris: Dict[str, int] = {}
        self.fns: Dict[str, int] = {}
        self.named_tables: Dict[str, object] = {}

    def function_anchor(self, registry_name: str) -> int:
        if registry_name.startswith("hash_"):
            registry_name = registry_name[5:]
        if registry_name in self.fns:
            return self.fns[registry_name]
        if registry_name not in _PRODUCE_FN:
            raise NotImplementedError(
                f"declaration_to_substrait: no substrait mapping for "
                f"function {registry_name!r}")
        name, yaml = _PRODUCE_FN[registry_name]
        uri = _URI_BASE + yaml
        if uri not in self.uris:
            self.uris[uri] = len(self.uris) + 1
        anchor = len(self.fns) + 1
        self.fns[registry_name] = anchor
        self._ext = getattr(self, "_ext", [])
        self._ext.append({"extensionFunction": {
            "extensionUriReference": self.uris[uri],
            "functionAnchor": anchor, "name": name}})
        return anchor

    def table_name(self, table) -> str:
        for k, v in self.named_tables.items():
            if v is table:
                return k
        name = f"t{len(self.named_tables)}"
        self.named_tables[name] = table
        return name


def _type_to_substrait(t) -> dict:
    m = {dt.bool_: "bool", dt.int8: "i8", dt.int16: "i16",
         dt.int32: "i32", dt.int64: "i64", dt.float32: "fp32",
         dt.float64: "fp64", dt.string: "string", dt.binary: "binary",
         dt.date32: "date"}
    for k, v in m.items():
        if t == k:
            return {v: {"nullability":
                        "NULLABILITY_NULLABLE"}}
    raise NotImplementedError(f"substrait producer: type {t}")


def _expr_to_substrait(e, fields: List[str], prod: _Producer,
                       schema=None) -> dict:
    if e.kind == Expression.KIND_FIELD:
        return {"selection": {
            "directReference": {"structField": {
                "field": fields.index(e.name)}},
            "rootReference": {}}}
    if e.kind == Expression.KIND_LITERAL:
        v = e.value
        if hasattr(v, "as_py"):
            v = v.as_py()
        if isinstance(v, bool):
            return {"literal": {"boolean": v}}
        if isinstance(v, int):
            return {"literal": {"i64": v}}
        if isinstance(v, float):
            return {"literal": {"fp64": v}}
        if isinstance(v, str):
            return {"literal": {"string": v}}
        import datetime as _dtm
        if isinstance(v, _dtm.date):
            return {"literal": {
                "date": (v - _dtm.date(1970, 1, 1)).days}}
        raise NotImplementedError(f"substrait literal {type(v)}")
    if e.kind == Expression.KIND_CALL:
        if e.function == "cast":
            return {"cast": {
                "input": _expr_to_substrait(e.args[0], fields, prod),
                "type": _type_to_substrait(e.options.target_type),
                "failureBehavior":
                    "FAILURE_BEHAVIOR_THROW_EXCEPTION"}}
        anchor = prod.function_anchor(e.function)
        out_t = {"bool": {"nullability": "NULLABILITY_NULLABLE"}} \
            if e.function in ("greater", "greater_equal", "less",
                              "less_equal", "equal", "not_equal",
                              "and_kleene", "or_kleene", "invert",
                              "is_null", "is_valid") \
            else {"fp64": {"nullability": "NULLABILITY_NULLABLE"}}
        return {"scalarFunction": {
            "functionReference": anchor,
            "outputType": out_t,
            "arguments": [
                {"value": _expr_to_substrait(a, fields, prod)}
                for a in e.args]}}
    raise NotImplementedError(f"substrait producer: expression kind "
                              f"{e.kind}")


def _decl_names(decl: Declaration) -> List[str]:
    node = decl._build_raw()
    return [f.name for f in node.output_schema().fields]


def _decl_to_rel(decl: Declaration, prod: _Producer) -> dict:
    f = decl.factory_name
    o = decl.options
    if f == "table_source":
        table = o.table
        cols = list(table.column_names)
        sch = table.schema
        sch_fields = list(sch.fields) if hasattr(sch, "fields") \
            else list(sch)  # a Schema of this package vs pyarrow's
        types = []
        for fl in sch_fields:
            try:
                t = fl.type
                if not isinstance(t, dt.DataType):  # a pyarrow type
                    t = dt.from_pyarrow_type(t)
                types.append(_type_to_substrait(t))
            except NotImplementedError:
                types.append({"i64": {"nullability":
                                      "NULLABILITY_NULLABLE"}})
        base = {"names": cols}
        if types:
            base["struct"] = {"types": types}
        return {"read": {"baseSchema": base,
                         "namedTable": {"names":
                                        [prod.table_name(table)]}}}
    if f == "filter":
        fields = _decl_names(decl.inputs[0])
        return {"filter": {
            "input": _decl_to_rel(decl.inputs[0], prod),
            "condition": _expr_to_substrait(o.filter_expression, fields,
                                            prod)}}
    if f == "project":
        fields = _decl_names(decl.inputs[0])
        n_in = len(fields)
        exprs = [_expr_to_substrait(e, fields, prod)
                 for e in o.expressions]
        return {"project": {
            "common": {"emit": {"outputMapping":
                                [n_in + i for i in range(len(exprs))]}},
            "input": _decl_to_rel(decl.inputs[0], prod),
            "expressions": exprs}}
    if f == "aggregate":
        fields = _decl_names(decl.inputs[0])
        sel = lambda name: {"selection": {
            "directReference": {"structField": {
                "field": fields.index(name)}}, "rootReference": {}}}
        measures = []
        for spec in o.aggregates:
            anchor = prod.function_anchor(spec.function)
            m = {"functionReference": anchor,
                 "phase": "AGGREGATION_PHASE_INITIAL_TO_RESULT",
                 "outputType": {"fp64": {"nullability":
                                         "NULLABILITY_NULLABLE"}}}
            if spec.targets:
                m["arguments"] = [{"value": sel(t)}
                                  for t in spec.targets]
            measures.append({"measure": m})
        return {"aggregate": {
            "input": _decl_to_rel(decl.inputs[0], prod),
            "groupings": [{"groupingExpressions":
                           [sel(k) for k in o.keys]}] if o.keys else [],
            "measures": measures}}
    if f == "order_by":
        fields = _decl_names(decl.inputs[0])
        sorts = []
        for k in o.sort_keys:
            d = "SORT_DIRECTION_DESC_NULLS_LAST" \
                if k.order.startswith("desc") else \
                "SORT_DIRECTION_ASC_NULLS_LAST"
            sorts.append({"expr": {"selection": {
                "directReference": {"structField": {
                    "field": fields.index(k.name)}},
                "rootReference": {}}}, "direction": d})
        return {"sort": {"input": _decl_to_rel(decl.inputs[0], prod),
                         "sorts": sorts}}
    if f == "fetch":
        return {"fetch": {"input": _decl_to_rel(decl.inputs[0], prod),
                          "offset": int(o.offset),
                          "count": int(o.count)}}
    if f == "hashjoin":
        lf = _decl_names(decl.inputs[0])
        rf = _decl_names(decl.inputs[1])
        allf = lf + rf
        anchor_eq = prod.function_anchor("equal")
        conds = []
        for lk, rk in zip(o.left_keys, o.right_keys):
            conds.append({"scalarFunction": {
                "functionReference": anchor_eq,
                "outputType": {"bool": {"nullability":
                                        "NULLABILITY_NULLABLE"}},
                "arguments": [
                    {"value": {"selection": {"directReference": {
                        "structField": {"field": lf.index(lk)}},
                        "rootReference": {}}}},
                    {"value": {"selection": {"directReference": {
                        "structField": {"field":
                                        len(lf) + rf.index(rk)}},
                        "rootReference": {}}}}]}})
        cond = conds[0]
        for c in conds[1:]:
            anchor_and = prod.function_anchor("and_kleene")
            cond = {"scalarFunction": {
                "functionReference": anchor_and,
                "outputType": {"bool": {"nullability":
                                        "NULLABILITY_NULLABLE"}},
                "arguments": [{"value": cond}, {"value": c}]}}
        jt = {"inner": "JOIN_TYPE_INNER", "left outer": "JOIN_TYPE_LEFT",
              "right outer": "JOIN_TYPE_RIGHT",
              "full outer": "JOIN_TYPE_OUTER",
              "left semi": "JOIN_TYPE_LEFT_SEMI",
              "left anti": "JOIN_TYPE_LEFT_ANTI"}.get(o.join_type)
        if jt is None:
            raise NotImplementedError(
                f"substrait producer: join type {o.join_type!r}")
        body = {"left": _decl_to_rel(decl.inputs[0], prod),
                "right": _decl_to_rel(decl.inputs[1], prod),
                "expression": cond, "type": jt}
        louts = o.left_output if o.left_output is not None else lf
        routs = o.right_output if o.right_output is not None else rf
        emit = [allf.index(n) for n in louts] + \
            [len(lf) + rf.index(n) for n in routs]
        if emit != list(range(len(allf))):
            body["common"] = {"emit": {"outputMapping": emit}}
        return {"join": body}
    if f == "union":
        return {"set": {"inputs": [_decl_to_rel(i, prod)
                                   for i in decl.inputs],
                        "op": "SET_OP_UNION_ALL"}}
    if f == "cross_join":
        return {"cross": {"left": _decl_to_rel(decl.inputs[0], prod),
                          "right": _decl_to_rel(decl.inputs[1], prod)}}
    raise NotImplementedError(
        f"substrait producer: node {f!r}")


def declaration_to_substrait(decl: Declaration, binary: bool = False):
    """Serialize a Declaration graph to a Substrait plan.

    Returns ``(plan, named_tables)`` where ``plan`` is the JSON-form
    dict (or binary protobuf bytes with ``binary=True``, via
    engine/substrait_pb.py) and ``named_tables`` maps the generated
    table names back to the source tables — pass both to ``run_query``
    (ours or ``pyarrow.substrait``'s with a table_provider) to execute.
    Reference: ``serde.cc`` SerializePlan."""
    prod = _Producer()
    rel = _decl_to_rel(decl, prod)
    names = _decl_names(decl)
    plan = {
        "extensionUris": [{"extensionUriAnchor": a, "uri": u}
                          for u, a in prod.uris.items()],
        "extensions": getattr(prod, "_ext", []),
        "version": {"minorNumber": 44},
        "relations": [{"root": {"input": rel, "names": names}}],
    }
    if not plan["extensions"]:
        plan.pop("extensions")
        plan.pop("extensionUris")
    if binary:
        from .substrait_pb import encode_plan
        return encode_plan(plan), prod.named_tables
    return plan, prod.named_tables
