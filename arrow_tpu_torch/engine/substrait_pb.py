"""Binary (protobuf wire format) Substrait codec.

Reference: ``cpp/src/arrow/engine/substrait/serde.cc`` deserializes binary
``substrait.Plan`` messages through protoc-generated bindings. The
substrait ``.proto`` files aren't vendored in this image, so this module
implements the protobuf *wire format* directly (varint / 64-bit / length-
delimited / 32-bit groups — the whole format is four wire types) against
declarative per-message field tables for the Plan subset the engine
executes, converting to/from the **protobuf JSON form** dicts that
``engine/substrait.py`` already consumes.

Field numbers were verified empirically against real Substrait emitted by
``pyarrow.substrait.serialize_expressions`` (Expression / Literal / Type /
FieldReference / extensions), and the encoder side is oracle-tested by
feeding encoded plans to ``pyarrow.substrait.run_query`` (whose generated
bindings reject any wrong field number) — see tests/test_substrait.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

__all__ = ["decode_plan", "encode_plan", "decode_message",
           "encode_message"]

# ---- wire primitives ------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    x = s = 0
    while True:
        b = buf[i]
        i += 1
        x |= (b & 0x7F) << s
        s += 7
        if not b & 0x80:
            return x, i


def _write_varint(out: bytearray, x: int) -> None:
    x &= (1 << 64) - 1
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


# ---- message field tables ---------------------------------------------------
# {message: {field_no: (json_name, kind)}}. kind: one of
#   'msg:<Message>'  nested message        'str'   utf-8 string
#   'u'   unsigned varint                  'i'     int64 varint (two's compl.)
#   'si'  zigzag varint                    'bool'  varint 0/1
#   'f64' / 'f32'    fixed float           'bytes' raw
#   'enum:<name>'    varint -> enum string via _ENUMS
# A '*' suffix on json_name marks a repeated field (JSON form: list).

_ENUMS: Dict[str, Dict[int, str]] = {
    "JoinType": {
        0: "JOIN_TYPE_UNSPECIFIED", 1: "JOIN_TYPE_INNER",
        2: "JOIN_TYPE_OUTER", 3: "JOIN_TYPE_LEFT", 4: "JOIN_TYPE_RIGHT",
        5: "JOIN_TYPE_LEFT_SEMI", 6: "JOIN_TYPE_LEFT_ANTI",
        7: "JOIN_TYPE_LEFT_SINGLE", 8: "JOIN_TYPE_RIGHT_SEMI",
        9: "JOIN_TYPE_RIGHT_ANTI", 10: "JOIN_TYPE_RIGHT_SINGLE",
    },
    "SortDirection": {
        0: "SORT_DIRECTION_UNSPECIFIED",
        1: "SORT_DIRECTION_ASC_NULLS_FIRST",
        2: "SORT_DIRECTION_ASC_NULLS_LAST",
        3: "SORT_DIRECTION_DESC_NULLS_FIRST",
        4: "SORT_DIRECTION_DESC_NULLS_LAST",
        5: "SORT_DIRECTION_CLUSTERED",
    },
    "SetOp": {
        0: "SET_OP_UNSPECIFIED", 1: "SET_OP_MINUS_PRIMARY",
        2: "SET_OP_MINUS_MULTISET", 3: "SET_OP_INTERSECTION_PRIMARY",
        4: "SET_OP_INTERSECTION_MULTISET", 5: "SET_OP_UNION_DISTINCT",
        6: "SET_OP_UNION_ALL",
    },
    "AggregationPhase": {
        0: "AGGREGATION_PHASE_UNSPECIFIED",
        1: "AGGREGATION_PHASE_INITIAL_TO_INTERMEDIATE",
        2: "AGGREGATION_PHASE_INTERMEDIATE_TO_INTERMEDIATE",
        3: "AGGREGATION_PHASE_INITIAL_TO_RESULT",
        4: "AGGREGATION_PHASE_INTERMEDIATE_TO_RESULT",
    },
}

_SCHEMAS: Dict[str, Dict[int, Tuple[str, str]]] = {
    # plan.proto
    "Plan": {
        1: ("extensionUris*", "msg:SimpleExtensionURI"),
        2: ("extensions*", "msg:SimpleExtensionDeclaration"),
        3: ("relations*", "msg:PlanRel"),
        6: ("version", "msg:Version"),
    },
    "Version": {1: ("majorNumber", "u"), 2: ("minorNumber", "u"),
                3: ("patchNumber", "u"), 4: ("gitHash", "str"),
                5: ("producer", "str")},
    "PlanRel": {1: ("rel", "msg:Rel"), 2: ("root", "msg:RelRoot")},
    "RelRoot": {1: ("input", "msg:Rel"), 2: ("names*", "str")},
    # algebra.proto rels
    "Rel": {
        1: ("read", "msg:ReadRel"), 2: ("filter", "msg:FilterRel"),
        3: ("fetch", "msg:FetchRel"), 4: ("aggregate", "msg:AggregateRel"),
        5: ("sort", "msg:SortRel"), 6: ("join", "msg:JoinRel"),
        7: ("project", "msg:ProjectRel"), 8: ("set", "msg:SetRel"),
        12: ("cross", "msg:CrossRel"),
    },
    "RelCommon": {1: ("direct", "msg:Empty"), 2: ("emit", "msg:Emit"),
                  },
    "Emit": {1: ("outputMapping*", "i")},
    "Empty": {},
    "ReadRel": {
        1: ("common", "msg:RelCommon"),
        2: ("baseSchema", "msg:NamedStruct"),
        3: ("filter", "msg:Expression"),
        5: ("virtualTable", "msg:VirtualTable"),
        6: ("localFiles", "msg:LocalFiles"),
        7: ("namedTable", "msg:NamedTable"),
    },
    "NamedTable": {1: ("names*", "str")},
    "VirtualTable": {1: ("values*", "msg:StructLiteral")},
    "LocalFiles": {1: ("items*", "msg:FileOrFiles")},
    "FileOrFiles": {1: ("uriPath", "str"), 2: ("uriPathGlob", "str"),
                    3: ("uriFile", "str"), 4: ("uriFolder", "str"),
                    6: ("partitionIndex", "u"), 7: ("start", "u"),
                    8: ("length", "u"),
                    9: ("parquet", "msg:Empty"),
                    10: ("arrow", "msg:Empty"), 11: ("orc", "msg:Empty")},
    "FilterRel": {1: ("common", "msg:RelCommon"), 2: ("input", "msg:Rel"),
                  3: ("condition", "msg:Expression")},
    "FetchRel": {1: ("common", "msg:RelCommon"), 2: ("input", "msg:Rel"),
                 3: ("offset", "i"), 4: ("count", "i")},
    "ProjectRel": {1: ("common", "msg:RelCommon"),
                   2: ("input", "msg:Rel"),
                   3: ("expressions*", "msg:Expression")},
    "SortRel": {1: ("common", "msg:RelCommon"), 2: ("input", "msg:Rel"),
                3: ("sorts*", "msg:SortField")},
    "SortField": {1: ("expr", "msg:Expression"),
                  2: ("direction", "enum:SortDirection"),
                  3: ("comparisonFunctionReference", "u")},
    "JoinRel": {1: ("common", "msg:RelCommon"), 2: ("left", "msg:Rel"),
                3: ("right", "msg:Rel"),
                4: ("expression", "msg:Expression"),
                5: ("postJoinFilter", "msg:Expression"),
                6: ("type", "enum:JoinType")},
    "SetRel": {1: ("common", "msg:RelCommon"), 2: ("inputs*", "msg:Rel"),
               3: ("op", "enum:SetOp")},
    "CrossRel": {1: ("common", "msg:RelCommon"), 2: ("left", "msg:Rel"),
                 3: ("right", "msg:Rel")},
    "AggregateRel": {1: ("common", "msg:RelCommon"),
                     2: ("input", "msg:Rel"),
                     3: ("groupings*", "msg:Grouping"),
                     4: ("measures*", "msg:Measure")},
    "Grouping": {1: ("groupingExpressions*", "msg:Expression")},
    "Measure": {1: ("measure", "msg:AggregateFunction"),
                2: ("filter", "msg:Expression")},
    "AggregateFunction": {1: ("functionReference", "u"),
                          3: ("sorts*", "msg:SortField"),
                          4: ("phase", "enum:AggregationPhase"),
                          5: ("outputType", "msg:Type"),
                          6: ("invocation", "u"),
                          7: ("arguments*", "msg:FunctionArgument")},
    # expressions (field numbers verified vs serialize_expressions)
    "Expression": {
        1: ("literal", "msg:Literal"),
        2: ("selection", "msg:FieldReference"),
        3: ("scalarFunction", "msg:ScalarFunction"),
        6: ("ifThen", "msg:IfThen"),
        11: ("cast", "msg:Cast"),
    },
    "IfThen": {1: ("ifs*", "msg:IfClause"), 2: ("else", "msg:Expression")},
    "IfClause": {1: ("if", "msg:Expression"),
                 2: ("then", "msg:Expression")},
    "Cast": {1: ("type", "msg:Type"), 2: ("input", "msg:Expression"),
             3: ("failureBehavior", "u")},
    "ScalarFunction": {1: ("functionReference", "u"),
                       3: ("outputType", "msg:Type"),
                       4: ("arguments*", "msg:FunctionArgument")},
    "FunctionArgument": {1: ("enum", "str"), 2: ("type", "msg:Type"),
                         3: ("value", "msg:Expression")},
    "FieldReference": {1: ("directReference", "msg:ReferenceSegment"),
                       4: ("rootReference", "msg:Empty")},
    "ReferenceSegment": {1: ("mapKey", "msg:MapKey"),
                         2: ("structField", "msg:StructField"),
                         3: ("listElement", "msg:ListElement")},
    "StructField": {1: ("field", "i"),
                    2: ("child", "msg:ReferenceSegment")},
    "MapKey": {1: ("mapKey", "msg:Literal"),
               2: ("child", "msg:ReferenceSegment")},
    "ListElement": {1: ("offset", "i"),
                    2: ("child", "msg:ReferenceSegment")},
    # literal / type: oneof numbers are PARALLEL in substrait by design
    "Literal": {
        1: ("boolean", "bool"), 2: ("i8", "i"), 3: ("i16", "i"),
        5: ("i32", "i"), 7: ("i64", "i"), 10: ("fp32", "f32"),
        11: ("fp64", "f64"), 12: ("string", "str"), 13: ("binary",
                                                         "bytes"),
        16: ("date", "i"), 17: ("time", "i"),
        25: ("struct", "msg:StructLiteral"),
        29: ("null", "msg:Type"), 50: ("nullable", "bool"),
    },
    "StructLiteral": {1: ("fields*", "msg:Literal")},
    "Type": {
        1: ("bool", "msg:TypeUnit"), 2: ("i8", "msg:TypeUnit"),
        3: ("i16", "msg:TypeUnit"), 5: ("i32", "msg:TypeUnit"),
        7: ("i64", "msg:TypeUnit"), 10: ("fp32", "msg:TypeUnit"),
        11: ("fp64", "msg:TypeUnit"), 12: ("string", "msg:TypeUnit"),
        13: ("binary", "msg:TypeUnit"), 14: ("timestamp", "msg:TypeUnit"),
        16: ("date", "msg:TypeUnit"), 17: ("time", "msg:TypeUnit"),
        25: ("struct", "msg:TypeStruct"),
    },
    "TypeUnit": {1: ("typeVariationReference", "u"),
                 2: ("nullability", "u")},
    "TypeStruct": {1: ("types*", "msg:Type"),
                   2: ("typeVariationReference", "u"),
                   3: ("nullability", "u")},
    "NamedStruct": {1: ("names*", "str"), 2: ("struct", "msg:TypeStruct")},
    # extensions.proto
    "SimpleExtensionURI": {1: ("extensionUriAnchor", "u"),
                           2: ("uri", "str")},
    "SimpleExtensionDeclaration": {
        1: ("extensionType", "msg:Empty"),
        2: ("extensionTypeVariation", "msg:Empty"),
        3: ("extensionFunction", "msg:ExtensionFunction"),
    },
    "ExtensionFunction": {1: ("extensionUriReference", "u"),
                          2: ("functionAnchor", "u"), 3: ("name", "str")},
    # extended_expression.proto
    "ExtendedExpression": {
        1: ("extensionUris*", "msg:SimpleExtensionURI"),
        2: ("extensions*", "msg:SimpleExtensionDeclaration"),
        3: ("referredExpr*", "msg:ExpressionReference"),
        4: ("baseSchema", "msg:NamedStruct"),
        7: ("version", "msg:Version"),
    },
    "ExpressionReference": {1: ("expression", "msg:Expression"),
                            3: ("outputNames*", "str")},
}


# enum NAMES -> numbers (substrait .proto enum values), so JSON-form
# plans written with symbolic enums (the protobuf JSON convention)
# binary-encode without callers pre-translating
_ENUM_NAMES = {
    "NULLABILITY_UNSPECIFIED": 0, "NULLABILITY_NULLABLE": 1,
    "NULLABILITY_REQUIRED": 2,
    "SORT_DIRECTION_UNSPECIFIED": 0,
    "SORT_DIRECTION_ASC_NULLS_FIRST": 1,
    "SORT_DIRECTION_ASC_NULLS_LAST": 2,
    "SORT_DIRECTION_DESC_NULLS_FIRST": 3,
    "SORT_DIRECTION_DESC_NULLS_LAST": 4,
    "JOIN_TYPE_UNSPECIFIED": 0, "JOIN_TYPE_INNER": 1,
    "JOIN_TYPE_OUTER": 2, "JOIN_TYPE_LEFT": 3, "JOIN_TYPE_RIGHT": 4,
    "JOIN_TYPE_LEFT_SEMI": 5, "JOIN_TYPE_LEFT_ANTI": 6,
    "JOIN_TYPE_LEFT_SINGLE": 7,
    "AGGREGATION_PHASE_UNSPECIFIED": 0,
    "AGGREGATION_PHASE_INITIAL_TO_INTERMEDIATE": 1,
    "AGGREGATION_PHASE_INTERMEDIATE_TO_INTERMEDIATE": 2,
    "AGGREGATION_PHASE_INITIAL_TO_RESULT": 3,
    "AGGREGATION_PHASE_INTERMEDIATE_TO_RESULT": 4,
    "SET_OP_UNSPECIFIED": 0, "SET_OP_MINUS_PRIMARY": 1,
    "SET_OP_MINUS_MULTISET": 2, "SET_OP_INTERSECTION_PRIMARY": 3,
    "SET_OP_INTERSECTION_MULTISET": 4, "SET_OP_UNION_DISTINCT": 5,
    "SET_OP_UNION_ALL": 6,
    "FAILURE_BEHAVIOR_UNSPECIFIED": 0,
    "FAILURE_BEHAVIOR_RETURN_NULL": 1,
    "FAILURE_BEHAVIOR_THROW_EXCEPTION": 2,
}


def _to_signed64(x: int) -> int:
    return x - (1 << 64) if x >= (1 << 63) else x


def decode_message(buf: bytes, message: str) -> dict:
    """Wire bytes -> protobuf-JSON-form dict (unknown fields skipped)."""
    schema = _SCHEMAS[message]
    out: dict = {}
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        spec = schema.get(fno)
        if wt == 0:
            v, i = _read_varint(buf, i)
            raw = v
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            raw = buf[i:i + ln]
            i += ln
        elif wt == 5:
            raw = buf[i:i + 4]
            i += 4
        elif wt == 1:
            raw = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt} in {message}")
        if spec is None:
            continue
        name, kind = spec
        rep = name.endswith("*")
        if rep:
            name = name[:-1]
        if kind.startswith("msg:"):
            sub = _SCHEMAS  # noqa: F841  (kind table sanity)
            val = decode_message(bytes(raw), kind[4:])
        elif kind == "str":
            if isinstance(raw, int):   # packed misuse guard
                raise ValueError(f"{message}.{name}: varint for string")
            val = raw.decode("utf-8")
        elif kind == "bytes":
            val = bytes(raw)
        elif kind == "bool":
            val = bool(raw)
        elif kind == "u":
            val = int(raw)
        elif kind == "i":
            if wt == 2:   # packed repeated varints
                vals, j = [], 0
                while j < len(raw):
                    v, j = _read_varint(raw, j)
                    vals.append(_to_signed64(v))
                if rep:
                    out.setdefault(name, []).extend(vals)
                    continue
                val = vals[0]
            else:
                val = _to_signed64(int(raw))
        elif kind == "f64":
            val = struct.unpack("<d", raw)[0]
        elif kind == "f32":
            val = struct.unpack("<f", raw)[0]
        elif kind.startswith("enum:"):
            val = _ENUMS[kind[5:]].get(int(raw), int(raw))
        else:
            raise AssertionError(kind)
        if rep:
            out.setdefault(name, []).append(val)
        else:
            out[name] = val
    return out


def encode_message(obj: dict, message: str) -> bytes:
    """protobuf-JSON-form dict -> wire bytes (inverse of decode)."""
    schema = _SCHEMAS[message]
    by_name = {}
    for fno, (name, kind) in schema.items():
        by_name[name.rstrip("*")] = (fno, kind, name.endswith("*"))
    out = bytearray()
    for key, val in obj.items():
        if key not in by_name:
            raise KeyError(f"{message}: unknown JSON field {key!r}")
        fno, kind, rep = by_name[key]
        vals = val if rep else [val]
        for v in vals:
            if kind.startswith("msg:"):
                sub = encode_message(v, kind[4:])
                _write_varint(out, (fno << 3) | 2)
                _write_varint(out, len(sub))
                out.extend(sub)
            elif kind == "str":
                raw = v.encode("utf-8")
                _write_varint(out, (fno << 3) | 2)
                _write_varint(out, len(raw))
                out.extend(raw)
            elif kind == "bytes":
                _write_varint(out, (fno << 3) | 2)
                _write_varint(out, len(v))
                out.extend(v)
            elif kind in ("u", "i", "bool"):
                x = _ENUM_NAMES[v] if isinstance(v, str) and \
                    v in _ENUM_NAMES else int(v)
                _write_varint(out, fno << 3)
                _write_varint(out, x)
            elif kind == "f64":
                _write_varint(out, (fno << 3) | 1)
                out.extend(struct.pack("<d", float(v)))
            elif kind == "f32":
                _write_varint(out, (fno << 3) | 5)
                out.extend(struct.pack("<f", float(v)))
            elif kind.startswith("enum:"):
                rev = {s: n for n, s in _ENUMS[kind[5:]].items()}
                _write_varint(out, fno << 3)
                _write_varint(out, rev[v] if isinstance(v, str) else int(v))
            else:
                raise AssertionError(kind)
    return bytes(out)


def decode_plan(buf: bytes) -> dict:
    return decode_message(bytes(buf), "Plan")


def encode_plan(plan: dict) -> bytes:
    return encode_message(plan, "Plan")
