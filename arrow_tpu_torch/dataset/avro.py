"""Avro Object Container File adapter (reference:
``cpp/src/arrow/adapters/avro``; pyarrow itself does not expose Avro, so
this is a self-contained reader/writer at the host edge). The JAX
package's ``dataset/avro.py``, copied: it imports neither JAX nor torch,
and the files of the two packages are equal but for the 16-byte sync
marker that ``write_avro`` draws at random.

Scope matches the adapter's role in the reference: batch ingest of Avro
container files into columnar batches (and a writer for round-trips).
Supported schema: records of null / boolean / int / long / float /
double / bytes / string / enum / fixed / array<primitive> /
map<primitive> / ["null", T] unions, with ``null`` and ``deflate``
codecs. Logical types date / timestamp-millis / timestamp-micros /
decimal(bytes) map to the corresponding arrow types.

Device compute never touches Avro bytes — files decode host-side to
pyarrow and enter the engine through ``Batch.from_pyarrow`` like every
other format edge (SURVEY §2.6: formats are adapters, not kernels).
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["read_avro", "write_avro", "AvroFile"]

_MAGIC = b"Obj\x01"


# ---- binary primitives -------------------------------------------------------

def _read_long(buf: io.BytesIO) -> int:
    """Zigzag varint (Avro spec 'Primitive Types: long')."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: bytearray, v: int) -> None:
    v = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


# ---- schema ------------------------------------------------------------------

class _SchemaNode:
    """Resolved Avro schema node: kind + params (flattened union info)."""

    def __init__(self, kind: str, **kw):
        self.kind = kind
        self.__dict__.update(kw)


def _parse_schema(s, named: Dict[str, _SchemaNode]) -> _SchemaNode:
    if isinstance(s, str):
        if s in named:
            return named[s]
        return _SchemaNode(s)
    if isinstance(s, list):  # union
        branches = [_parse_schema(x, named) for x in s]
        kinds = [b.kind for b in branches]
        if "null" in kinds and len(branches) == 2:
            other = branches[1 - kinds.index("null")]
            return _SchemaNode("nullable", null_index=kinds.index("null"),
                              inner=other)
        return _SchemaNode("union", branches=branches)
    t = s["type"]
    logical = s.get("logicalType")
    if t == "record":
        node = _SchemaNode("record", name=s.get("name", ""), fields=[])
        if s.get("name"):
            named[s["name"]] = node
        node.fields = [(f["name"], _parse_schema(f["type"], named))
                       for f in s["fields"]]
        return node
    if t == "enum":
        node = _SchemaNode("enum", symbols=list(s["symbols"]))
        if s.get("name"):
            named[s["name"]] = node
        return node
    if t == "fixed":
        node = _SchemaNode("fixed", size=int(s["size"]))
        if logical == "decimal":
            node = _SchemaNode("decimal", size=int(s["size"]),
                               precision=int(s["precision"]),
                               scale=int(s.get("scale", 0)))
        if s.get("name"):
            named[s["name"]] = node
        return node
    if t == "array":
        return _SchemaNode("array", items=_parse_schema(s["items"], named))
    if t == "map":
        return _SchemaNode("map", values=_parse_schema(s["values"], named))
    if t in ("bytes",) and logical == "decimal":
        return _SchemaNode("decimal", size=None,
                           precision=int(s["precision"]),
                           scale=int(s.get("scale", 0)))
    if t in ("int", "long") and logical in (
            "date", "timestamp-millis", "timestamp-micros",
            "time-millis", "time-micros"):
        return _SchemaNode(t, logical=logical)
    return _parse_schema(t, named)


def _decode(node: _SchemaNode, buf: io.BytesIO) -> Any:
    k = node.kind
    if k == "null":
        return None
    if k == "boolean":
        return buf.read(1) == b"\x01"
    if k in ("int", "long"):
        return _read_long(buf)
    if k == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if k == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if k == "bytes":
        return _read_bytes(buf)
    if k == "string":
        return _read_bytes(buf).decode("utf-8")
    if k == "nullable":
        idx = _read_long(buf)
        if idx == node.null_index:
            return None
        return _decode(node.inner, buf)
    if k == "union":
        return _decode(node.branches[_read_long(buf)], buf)
    if k == "enum":
        return node.symbols[_read_long(buf)]
    if k == "fixed":
        return buf.read(node.size)
    if k == "decimal":
        raw = buf.read(node.size) if node.size is not None \
            else _read_bytes(buf)
        return int.from_bytes(raw, "big", signed=True)
    if k == "record":
        return {name: _decode(f, buf) for name, f in node.fields}
    if k == "array":
        out = []
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:  # block with byte size prefix
                n = -n
                _read_long(buf)
            for _ in range(n):
                out.append(_decode(node.items, buf))
    if k == "map":
        out = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                return out
            if n < 0:
                n = -n
                _read_long(buf)
            for _ in range(n):
                key = _read_bytes(buf).decode("utf-8")
                out[key] = _decode(node.values, buf)
    raise NotImplementedError(f"avro type {k!r}")


def _to_pyarrow_type(node: _SchemaNode):
    import pyarrow as pa
    k = node.kind
    if k == "nullable":
        return _to_pyarrow_type(node.inner)
    logical = getattr(node, "logical", None)
    if logical == "date":
        return pa.date32()
    if logical == "timestamp-millis":
        return pa.timestamp("ms")
    if logical == "timestamp-micros":
        return pa.timestamp("us")
    if logical == "time-millis":
        return pa.time32("ms")
    if logical == "time-micros":
        return pa.time64("us")
    m = {"null": pa.null(), "boolean": pa.bool_(), "int": pa.int32(),
         "long": pa.int64(), "float": pa.float32(),
         "double": pa.float64(), "bytes": pa.binary(),
         "string": pa.string()}
    if k in m:
        return m[k]
    if k == "enum":
        return pa.dictionary(pa.int32(), pa.string())
    if k == "fixed":
        return pa.binary(node.size)
    if k == "decimal":
        return pa.decimal128(node.precision, node.scale)
    if k == "array":
        return pa.list_(_to_pyarrow_type(node.items))
    if k == "map":
        return pa.map_(pa.string(), _to_pyarrow_type(node.values))
    if k == "record":
        return pa.struct([(n, _to_pyarrow_type(f))
                          for n, f in node.fields])
    raise NotImplementedError(f"avro type {k!r}")


def _convert_cell(node: _SchemaNode, v):
    """Python decode value -> pyarrow-compatible cell."""
    if v is None:
        return None
    k = node.kind
    if k == "nullable":
        return _convert_cell(node.inner, v)
    logical = getattr(node, "logical", None)
    if logical == "date":
        import datetime
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
    if k == "decimal":
        import decimal
        return decimal.Decimal(v).scaleb(-node.scale)
    if k == "array":
        return [_convert_cell(node.items, x) for x in v]
    if k == "map":
        return [(key, _convert_cell(node.values, val))
                for key, val in v.items()]
    if k == "record":
        return {n: _convert_cell(f, v[n]) for n, f in node.fields}
    return v


# ---- container file ----------------------------------------------------------

class AvroFile:
    """Avro OCF reader (header + deflate/null blocks + sync markers)."""

    def __init__(self, path_or_file):
        self._own = isinstance(path_or_file, (str, os.PathLike))
        self._f = open(path_or_file, "rb") if self._own else path_or_file
        if self._f.read(4) != _MAGIC:
            raise ValueError("not an Avro object container file")
        meta_node = _SchemaNode("map", values=_SchemaNode("bytes"))
        # header metadata is an avro map<bytes>
        hdr = self._f.read()  # small files: read fully, rewind via BytesIO
        buf = io.BytesIO(hdr)
        self.metadata = _decode(meta_node, buf)
        self.sync = buf.read(16)
        self._body = buf
        self.codec = self.metadata.get("avro.codec", b"null").decode()
        if self.codec not in ("null", "deflate"):
            raise NotImplementedError(f"avro codec {self.codec!r}")
        schema_json = json.loads(self.metadata["avro.schema"])
        self.schema = _parse_schema(schema_json, {})
        if self.schema.kind != "record":
            raise NotImplementedError("top-level avro schema must be a "
                                      "record")

    def _blocks(self):
        body = self._body
        while True:
            head = body.read(1)
            if not head:
                return
            body.seek(-1, 1)
            count = _read_long(body)
            raw = _read_bytes(body)
            if body.read(16) != self.sync:
                raise ValueError("avro block sync mismatch")
            if self.codec == "deflate":
                raw = zlib.decompress(raw, -15)
            yield count, io.BytesIO(raw)

    def read(self):
        """Decode the whole file into a pyarrow Table."""
        import pyarrow as pa
        names = [n for n, _ in self.schema.fields]
        cols: List[List[Any]] = [[] for _ in names]
        for count, buf in self._blocks():
            for _ in range(count):
                for i, (_, fnode) in enumerate(self.schema.fields):
                    cols[i].append(_convert_cell(fnode, _decode(fnode,
                                                                buf)))
        arrays = []
        for (name, fnode), data in zip(self.schema.fields, cols):
            arrays.append(pa.array(data, type=_to_pyarrow_type(fnode)))
        t = pa.table(dict(zip(names, arrays)))
        if self._own:
            self._f.close()
        return t


def read_avro(path_or_file):
    """Read an Avro container file into a pyarrow Table."""
    return AvroFile(path_or_file).read()


# ---- writer (round-trip support) ---------------------------------------------

def _avro_schema_of(pa_type, name: str):
    import pyarrow as pa
    if pa.types.is_boolean(pa_type):
        return "boolean"
    if pa.types.is_int32(pa_type) or pa.types.is_int16(pa_type) \
            or pa.types.is_int8(pa_type):
        return "int"
    if pa.types.is_integer(pa_type):
        return "long"
    if pa.types.is_float32(pa_type):
        return "float"
    if pa.types.is_floating(pa_type):
        return "double"
    if pa.types.is_string(pa_type) or pa.types.is_large_string(pa_type):
        return "string"
    if pa.types.is_binary(pa_type):
        return "bytes"
    if pa.types.is_date32(pa_type):
        return {"type": "int", "logicalType": "date"}
    if pa.types.is_timestamp(pa_type):
        unit = {"ms": "timestamp-millis", "us": "timestamp-micros"}.get(
            pa_type.unit)
        if unit:
            return {"type": "long", "logicalType": unit}
    if pa.types.is_list(pa_type):
        return {"type": "array",
                "items": _avro_schema_of(pa_type.value_type, name)}
    raise NotImplementedError(f"write_avro: no avro mapping for "
                              f"{pa_type}")


def _encode_cell(schema, v, out: bytearray) -> None:
    if isinstance(schema, dict):
        logical = schema.get("logicalType")
        if logical == "date":
            import datetime
            _write_long(out, (v - datetime.date(1970, 1, 1)).days)
            return
        if logical in ("timestamp-millis", "timestamp-micros"):
            if not isinstance(v, int):  # datetime from to_pylist()
                import datetime
                epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
                micros = round((v - epoch).total_seconds() * 1_000_000)
                v = micros // 1000 if logical == "timestamp-millis" \
                    else micros
            _write_long(out, v)
            return
        if schema["type"] == "array":
            if v:
                _write_long(out, len(v))
                for x in v:
                    _encode_cell(schema["items"], x, out)
            _write_long(out, 0)
            return
        raise NotImplementedError(str(schema))
    if schema == "boolean":
        out.append(1 if v else 0)
    elif schema in ("int", "long"):
        _write_long(out, int(v))
    elif schema == "float":
        out.extend(struct.pack("<f", v))
    elif schema == "double":
        out.extend(struct.pack("<d", v))
    elif schema == "string":
        raw = v.encode("utf-8")
        _write_long(out, len(raw))
        out.extend(raw)
    elif schema == "bytes":
        _write_long(out, len(v))
        out.extend(v)
    else:
        raise NotImplementedError(schema)


def write_avro(table, path: str, codec: str = "deflate",
               block_rows: int = 16384) -> None:
    """Write a pyarrow Table as an Avro container file."""
    import secrets

    fields = []
    for f in table.schema:
        base = _avro_schema_of(f.type, f.name)
        fields.append({"name": f.name,
                       "type": ["null", base] if f.nullable else base})
    schema_json = json.dumps({"type": "record", "name": "root",
                              "fields": fields})
    sync = secrets.token_bytes(16)
    with open(path, "wb") as out:
        out.write(_MAGIC)
        meta = bytearray()
        _write_long(meta, 2)
        for k, v in (("avro.schema", schema_json.encode()),
                     ("avro.codec", codec.encode())):
            kb = k.encode()
            _write_long(meta, len(kb))
            meta.extend(kb)
            _write_long(meta, len(v))
            meta.extend(v)
        _write_long(meta, 0)
        out.write(bytes(meta))
        out.write(sync)
        cols = [table.column(i).to_pylist() for i in
                range(table.num_columns)]
        n = table.num_rows
        for start in range(0, max(n, 1), block_rows):
            stop = min(start + block_rows, n)
            if stop <= start:
                break
            block = bytearray()
            for row in range(start, stop):
                for (fs, col, f) in zip(fields, cols, table.schema):
                    v = col[row]
                    t = fs["type"]
                    if isinstance(t, list):  # ["null", base]
                        if v is None:
                            _write_long(block, 0)
                            continue
                        _write_long(block, 1)
                        t = t[1]
                    elif v is None:
                        raise ValueError(
                            f"null in non-nullable column {f.name}")
                    _encode_cell(t, v, block)
            payload = bytes(block)
            if codec == "deflate":
                payload = zlib.compress(payload)[2:-4]  # raw deflate
            head = bytearray()
            _write_long(head, stop - start)
            _write_long(head, len(payload))
            out.write(bytes(head))
            out.write(payload)
            out.write(sync)
