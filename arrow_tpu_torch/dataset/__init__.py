"""arrow_tpu_torch.dataset: partitioned datasets and their scanner.

Reference: ``cpp/src/arrow/dataset`` (Dataset / Fragment discovery, hive
and directory partitioning with expression guarantees, Scanner, ScanNode
with readahead, partitioned write through DatasetWriter); the counterpart
of the JAX package's ``dataset/__init__.py``.

Fragments are files: the native ATB format (``native.py``, the engine's
own), parquet / ipc / feather / csv / json / orc read through pyarrow at
the edges (pyarrow is imported only inside functions), or Avro container
files decoded on the host by ``dataset/avro.py``. Each fragment
carries a partition GUARANTEE (field = value conjunction from its path);
the scanner splits the filter into partition-only conjuncts, evaluated on
the host to prune whole fragments (the reference's SimplifyWithGuarantee,
``expression.h:224``), and a residual that runs on the scanner's device
(the compaction kernel through ``filter_batch``).

Partition values are written as pyarrow writes them: hive and directory
segments percent-escaped (``REG AIR`` -> ``REG%20AIR``) and unescaped on
read, a null hive value as ``__HIVE_DEFAULT_PARTITION__``, read back as
null. A partition field's type is inferred from all its fragments' values:
int64 (pyarrow's discovery infers int32), else float64, else string.
"""

from __future__ import annotations

import os
import re
import time
import urllib.parse
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..compute.expressions import Expression, call
from ..core.batch import Batch, Table

__all__ = ["HivePartitioning", "DirectoryPartitioning", "Fragment",
           "FileSystemDataset", "Scanner", "dataset", "write_dataset",
           "split_filter", "STATS", "reset_stats"]

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"

# what the scans of this process did: fragments read and pruned, their
# bytes on disk and rows, seconds reading and staging them
STATS: Dict[str, float] = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(read=0, pruned=0, bytes_read=0, rows_read=0,
                 read_s=0.0)


reset_stats()


def _escape(v) -> str:
    return urllib.parse.quote(str(v), safe="")


def _unescape(s: str) -> str:
    return urllib.parse.unquote(s)


# ---- partitioning schemes -------------------------------------------------

class HivePartitioning:
    """key=value path segments (``dataset/partition.h``
    HivePartitioning)."""

    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)

    def parse(self, relpath: str) -> Dict[str, Optional[str]]:
        out = {}
        for seg in relpath.replace(os.sep, "/").split("/"):
            if "=" in seg:
                k, v = seg.split("=", 1)
                if k in self.fields:
                    out[k] = None if v == HIVE_NULL else _unescape(v)
        return out

    def format(self, values: Dict) -> str:
        return "/".join(
            f"{k}={HIVE_NULL if values[k] is None else _escape(values[k])}"
            for k in self.fields)


class DirectoryPartitioning:
    """Positional path segments (``DirectoryPartitioning``)."""

    def __init__(self, fields: Sequence[str]):
        self.fields = list(fields)

    def parse(self, relpath: str) -> Dict[str, str]:
        segs = relpath.replace(os.sep, "/").split("/")[:-1]  # the file
        return {k: _unescape(v) for k, v in zip(self.fields, segs)}

    def format(self, values: Dict) -> str:
        for k in self.fields:
            if values[k] is None:
                raise ValueError(f"directory partitioning cannot write a "
                                 f"null value of {k!r}")
        return "/".join(_escape(values[k]) for k in self.fields)


# ---- fragments / dataset ----------------------------------------------------

class Fragment:
    def __init__(self, path: str, fmt: str,
                 partition_values: Optional[Dict] = None,
                 filesystem=None):
        self.path = path
        self.format = fmt
        self.partition_values = partition_values or {}
        self.filesystem = filesystem  # a pyarrow.fs.FileSystem, None: local

    def _check_format(self) -> None:
        if self.format == "atb" and self.filesystem is not None:
            raise ValueError("atb fragments are local-mmap only; use "
                             "parquet/ipc on remote filesystems")
        if self.format not in _FORMATS:
            raise ValueError(f"unknown fragment format {self.format!r}")

    def _open(self, stream: bool = False):
        fs = self.filesystem
        if fs is None:
            return open(self.path, "rb")
        return fs.open_input_stream(self.path) if stream else \
            fs.open_input_file(self.path)

    def read_pyarrow(self):
        """The file as a pyarrow Table (without its partition columns)."""
        import pyarrow as pa
        self._check_format()
        fmt = self.format
        if fmt == "parquet":
            import pyarrow.parquet as pq
            # the file alone: no partition keys from its path (the
            # scanner appends them, typed over the whole dataset)
            return pq.read_table(self.path, filesystem=self.filesystem,
                                 partitioning=None)
        if fmt in ("ipc", "feather", "arrow"):
            with self._open() as f:
                return pa.ipc.open_file(f).read_all()
        if fmt == "csv":
            import pyarrow.csv as pcsv
            with self._open(stream=True) as f:
                return pcsv.read_csv(f)
        if fmt == "json":
            import pyarrow.json as pjson
            with self._open(stream=True) as f:
                return pjson.read_json(f)
        if fmt == "orc":
            import pyarrow.orc as porc
            with self._open() as f:
                return porc.ORCFile(f).read()
        if fmt == "avro":
            from .avro import read_avro
            if self.filesystem is None:
                return read_avro(self.path)
            with self._open() as f:
                return read_avro(f)
        from .. import native
        cols, nrows = native.read_atb(self.path)
        return pa.table({name: _atb_col_to_pa(c, nrows)
                         for name, c in cols.items()})

    def physical_schema(self):
        """The file's pyarrow schema from its metadata alone (parquet's
        footer, the IPC schema message, ORC's footer, the ATB header, the
        Avro header's schema); csv and json carry none, so those files are
        read."""
        import pyarrow as pa
        self._check_format()
        fmt = self.format
        if fmt == "parquet":
            import pyarrow.parquet as pq
            return pq.read_schema(self.path, filesystem=self.filesystem)
        if fmt in ("ipc", "feather", "arrow"):
            with self._open() as f:
                return pa.ipc.open_file(f).schema
        if fmt == "orc":
            import pyarrow.orc as porc
            with self._open() as f:
                return porc.ORCFile(f).schema
        if fmt == "avro":
            from .avro import AvroFile, _to_pyarrow_type
            with self._open() as f:
                fields = AvroFile(f).schema.fields
            return pa.schema([(name, _to_pyarrow_type(node))
                              for name, node in fields])
        if fmt == "atb":
            from .. import native
            with native.open_atb(self.path) as f:
                return pa.schema([
                    (name, pa.string() if "offsets" in c else
                     pa.from_numpy_dtype(c["data"].dtype))
                    for name, c in f.columns.items()])
        return self.read_pyarrow().schema

    def __repr__(self):
        return f"Fragment({self.path!r}, {self.partition_values})"


def _atb_col_to_pa(col, nrows):
    """An ATB column as a pyarrow array of its storage type, its validity
    the null mask."""
    import pyarrow as pa
    valid = col.get("validity")
    if "offsets" in col:
        bits = None if valid is None else \
            pa.py_buffer(np.packbits(valid, bitorder="little"))
        return pa.StringArray.from_buffers(
            nrows, pa.py_buffer(col["offsets"]), pa.py_buffer(col["data"]),
            bits, -1 if valid is None else int(nrows - valid.sum()))
    return pa.array(col["data"], mask=None if valid is None else ~valid)


_EXT_FORMAT = {".parquet": "parquet", ".feather": "feather",
               ".arrow": "ipc", ".ipc": "ipc", ".csv": "csv",
               ".json": "json", ".orc": "orc", ".atb": "atb",
               ".avro": "avro"}
_FORMATS = {"parquet", "feather", "ipc", "arrow", "csv", "json", "orc",
            "atb", "avro"}


class FileSystemDataset:
    """Discovered set of fragments with partition guarantees."""

    def __init__(self, fragments: List[Fragment], partitioning=None):
        self.fragments = fragments
        self.partitioning = partitioning
        self._partition_types = None

    @staticmethod
    def discover(root: str, partitioning=None,
                 format: Optional[str] = None,
                 filesystem=None) -> "FileSystemDataset":
        if filesystem is None and _is_uri(root):
            # "s3://bucket/..." and friends resolve through pyarrow.fs
            from pyarrow import fs as pafs
            filesystem, root = pafs.FileSystem.from_uri(root)
        frags = []
        if filesystem is not None:
            from pyarrow import fs as pafs
            infos = filesystem.get_file_info(
                pafs.FileSelector(root, recursive=True))
            for info in sorted(infos, key=lambda i: i.path):
                if info.type != pafs.FileType.File:
                    continue
                fmt = format or _EXT_FORMAT.get(
                    os.path.splitext(info.path)[1])
                if fmt is None:
                    continue
                rel = os.path.relpath(info.path, root)
                pv = partitioning.parse(rel) if partitioning else {}
                frags.append(Fragment(info.path, fmt, pv,
                                      filesystem=filesystem))
            return FileSystemDataset(frags, partitioning)
        for dirpath, dirs, files in os.walk(root):
            dirs.sort()
            for f in sorted(files):
                fmt = format or _EXT_FORMAT.get(os.path.splitext(f)[1])
                if fmt is None:
                    continue
                path = os.path.join(dirpath, f)
                rel = os.path.relpath(path, root)
                pv = partitioning.parse(rel) if partitioning else {}
                frags.append(Fragment(path, fmt, pv))
        return FileSystemDataset(frags, partitioning)

    def partition_types(self) -> Dict[str, object]:
        """Each partition field's pyarrow type, inferred from every
        fragment's value: int64 if all non-null values parse as ints, else
        float64 if as floats, else string."""
        if self._partition_types is None:
            import pyarrow as pa
            fields = self.partitioning.fields if self.partitioning else []
            out = {}
            for k in fields:
                vals = [f.partition_values[k] for f in self.fragments
                        if f.partition_values.get(k) is not None]
                t = pa.string()
                for conv, pt in ((int, pa.int64()), (float, pa.float64())):
                    try:
                        for v in vals:
                            conv(v)
                    except ValueError:
                        continue
                    t = pt
                    break
                out[k] = t
            self._partition_types = out
        return self._partition_types

    def scanner(self, columns=None, filter=None,
                batch_rows: int = 1 << 15, device=None) -> "Scanner":
        return Scanner(self, columns=columns, filter=filter,
                       batch_rows=batch_rows, device=device)

    def to_table(self, **kw) -> Table:
        return self.scanner(**kw).to_table()


def _is_uri(path: str) -> bool:
    return bool(re.match(r"^[a-zA-Z][a-zA-Z0-9+.-]*://", path))


def dataset(root: str, partitioning=None, format=None,
            filesystem=None) -> FileSystemDataset:
    """``pyarrow.dataset.dataset`` analog. ``filesystem`` takes a
    pyarrow.fs.FileSystem (S3 / GCS / Azure / HDFS / local / mock); URIs
    like "s3://bucket/path" resolve through pyarrow.fs. A list of field
    names is hive partitioning."""
    if isinstance(partitioning, (list, tuple)):
        partitioning = HivePartitioning(list(partitioning))
    return FileSystemDataset.discover(root, partitioning, format,
                                      filesystem=filesystem)


# ---- filter splitting (guarantee simplification) ----------------------------

def _conjuncts(expr: Optional[Expression]) -> List[Expression]:
    if expr is None:
        return []
    if expr.kind == Expression.KIND_CALL and expr.function in (
            "and", "and_kleene"):
        return _conjuncts(expr.args[0]) + _conjuncts(expr.args[1])
    return [expr]


def _recombine(conjs: List[Expression]) -> Optional[Expression]:
    if not conjs:
        return None
    out = conjs[0]
    for c in conjs[1:]:
        out = call("and_kleene", [out, c])
    return out


def split_filter(expr: Optional[Expression],
                 partition_fields: Sequence[str]
                 ) -> Tuple[List[Expression], Optional[Expression]]:
    """(partition-only conjuncts, residual expression): the pruning split
    of SimplifyWithGuarantee (``expression.h:224``); a conjunct whose
    fields are all partition fields evaluates on the host per
    fragment."""
    pf = set(partition_fields)
    part, rest = [], []
    for c in _conjuncts(expr):
        (part if c.field_names() and set(c.field_names()) <= pf
         else rest).append(c)
    return part, _recombine(rest)


def _partition_array(v, t, n: int):
    """``n`` rows of partition value ``v`` (None: nulls) as a pyarrow
    array of type ``t``."""
    import pyarrow as pa
    if v is None:
        return pa.nulls(n, t)
    return pa.array([v], pa.string()).cast(t).take(
        pa.array(np.zeros((n,), np.int64)))


def _fragment_matches(frag: Fragment, part_conjs: List[Expression],
                      schema_types: Dict[str, object]) -> bool:
    """Evaluate partition-only conjuncts against this fragment's values (a
    1-row batch on the host through the real kernels; a null answer
    prunes). ``schema_types``: the partition fields' pyarrow types."""
    if not part_conjs:
        return True
    import pyarrow as pa
    from ..compute.expressions import execute_scalar_expression
    cols = {k: _partition_array(v, schema_types.get(k, pa.string()), 1)
            for k, v in frag.partition_values.items()}
    b = Batch.from_pyarrow(pa.record_batch(cols), device="cpu")
    for c in part_conjs:
        r = execute_scalar_expression(c, b)
        if not (bool(r.values[0]) and (r.validity is None or
                                       bool(r.validity[0]))):
            return False
    return True


# ---- scanner -------------------------------------------------------------------

class Scanner:
    """Prune -> read -> stage -> device filter / project
    (``dataset/scanner.h``). Each selected fragment is read through
    pyarrow (ATB through the native runtime), its partition columns
    appended, staged on ``device`` in batches of ``batch_rows`` rows
    (without the transparent dictionary ingest, so that every fragment's
    batches have the dataset's schema); the residual filter runs there
    (``filter_batch``), then the projection."""

    def __init__(self, ds: FileSystemDataset, columns=None, filter=None,
                 batch_rows: int = 1 << 15, device=None):
        from ..core.array import resolve_device
        self.dataset = ds
        self.columns = columns
        self.filter = filter
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        pf = ds.partitioning.fields if ds.partitioning else []
        self._part_conjs, self._residual = split_filter(filter, pf)

    def _selected_fragments(self) -> List[Fragment]:
        types = self.dataset.partition_types()
        return [f for f in self.dataset.fragments
                if _fragment_matches(f, self._part_conjs, types)]

    def _with_partitions(self, frag: Fragment, t):
        """``t`` with the fragment's partition columns appended (those the
        file does not hold)."""
        types = self.dataset.partition_types()
        for k, v in frag.partition_values.items():
            if k not in t.column_names:
                t = t.append_column(k, _partition_array(v, types[k],
                                                        t.num_rows))
        return t

    def dataset_schema(self):
        """The first selected fragment's physical schema (its metadata
        alone) with the partition columns appended; None when no fragment
        is selected."""
        import pyarrow as pa
        frags = self._selected_fragments()
        if not frags:
            return None
        sch = frags[0].physical_schema()
        types = self.dataset.partition_types()
        for k in frags[0].partition_values:
            if k not in sch.names:
                sch = sch.append(pa.field(k, types[k]))
        return sch

    def to_batches(self) -> Iterator[Batch]:
        """Each selected fragment read, staged and filtered (``STATS``
        counts the fragments, bytes, rows and the seconds of reading and
        staging; ``metrics`` records ``scan:read``)."""
        from ..compute.expressions import execute_scalar_expression
        from ..core.interop import table_from_pyarrow
        from ..ops.selection import filter_batch
        from ..utils.tracing import metrics, trace_span
        selected = self._selected_fragments()
        STATS["pruned"] += len(self.dataset.fragments) - len(selected)
        for frag in selected:
            t0 = time.perf_counter()
            with trace_span("scan:read"):
                t = self._with_partitions(frag, frag.read_pyarrow())
                staged = table_from_pyarrow(t, self.batch_rows,
                                            device=self.device,
                                            dictionary_ingest=False)
            secs = time.perf_counter() - t0
            STATS["read"] += 1
            STATS["bytes_read"] += _file_size(frag)
            STATS["rows_read"] += t.num_rows
            STATS["read_s"] += secs
            metrics.record("scan:read", t.num_rows, secs)
            del t
            for b in staged.batches:
                if self._residual is not None:
                    b = filter_batch(
                        b, execute_scalar_expression(self._residual, b))
                if self.columns is not None:
                    b = b.select(self.columns)
                yield b

    def to_table(self) -> Table:
        batches = [b for b in self.to_batches() if len(b) > 0]
        if not batches:
            raise ValueError("scan produced no rows; empty dataset?")
        return Table(batches[0].schema, batches)


def _file_size(frag: Fragment) -> int:
    if frag.filesystem is None:
        return os.path.getsize(frag.path)
    return frag.filesystem.get_file_info(frag.path).size


# ---- partitioned write -------------------------------------------------------

def write_dataset(table, root: str, partitioning=None,
                  format: str = "parquet", basename: str = "part-{i}",
                  filesystem=None):
    """Partitioned write (``dataset/dataset_writer.cc``'s role): one file
    a partition (values escaped, a null hive value under
    ``__HIVE_DEFAULT_PARTITION__``), the partition columns dropped from
    the files. ``filesystem`` takes a pyarrow.fs.FileSystem; URIs resolve
    through pyarrow.fs (atb stays local-only)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(table, Table):
        table = table.to_pyarrow()
    if isinstance(partitioning, (list, tuple)):
        partitioning = HivePartitioning(list(partitioning))
    if filesystem is None and _is_uri(root):
        from pyarrow import fs as pafs
        filesystem, root = pafs.FileSystem.from_uri(root)
    if filesystem is not None and format == "atb":
        raise ValueError("atb writes are local-mmap only")
    name = basename.format(i=0) + f".{_ext(format)}"
    _mkdir(root, filesystem)
    if partitioning is None:
        _write_one(table, _join(root, name, filesystem), format, filesystem)
        return
    keys = partitioning.fields
    combos = table.select(keys).group_by(keys).aggregate([])

    def write_partition(i: int) -> None:
        values = {k: combos[k][i].as_py() for k in keys}
        mask = None
        for k, v in values.items():
            m = pc.is_null(table[k]) if v is None else pc.equal(table[k], v)
            mask = m if mask is None else pc.and_(mask, m)
        part = table.filter(mask).drop_columns(keys)
        d = _join(root, partitioning.format(values), filesystem)
        _mkdir(d, filesystem)
        _write_one(part, _join(d, name, filesystem), format, filesystem)
    # the partitions' filters and writes run in pyarrow and native code,
    # which release the interpreter lock: a few threads write them at once
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        for f in [ex.submit(write_partition, i)
                  for i in range(combos.num_rows)]:
            f.result()


def _mkdir(path: str, filesystem=None):
    if filesystem is not None:
        filesystem.create_dir(path, recursive=True)
    else:
        os.makedirs(path, exist_ok=True)


def _join(root: str, name: str, filesystem=None) -> str:
    if filesystem is not None:
        return f"{root.rstrip('/')}/{name}"
    return os.path.join(root, *name.split("/"))


def _ext(fmt: str) -> str:
    try:
        return {"parquet": "parquet", "ipc": "arrow", "feather": "feather",
                "csv": "csv", "atb": "atb"}[fmt]
    except KeyError:
        raise ValueError(f"write_dataset cannot write format {fmt!r}") \
            from None


def _write_one(t, path: str, fmt: str, filesystem=None):
    if fmt == "parquet":
        import pyarrow.parquet as pq
        pq.write_table(t, path, filesystem=filesystem)
    elif fmt in ("ipc", "feather"):
        import pyarrow as pa
        with (filesystem.open_output_stream(path) if filesystem is not None
              else pa.OSFile(path, "wb")) as f:
            with pa.ipc.new_file(f, t.schema) as w:
                w.write_table(t)
    elif fmt == "csv":
        import pyarrow.csv as pcsv
        if filesystem is not None:
            with filesystem.open_output_stream(path) as f:
                pcsv.write_csv(t, f)
        else:
            pcsv.write_csv(t, path)
    else:
        from .. import native
        native.write_atb(path, {name: _atb_column(name, t[name])
                                for name in t.column_names}, t.num_rows)


def _atb_column(name: str, arr) -> dict:
    """A pyarrow column as an ATB column: its storage values as they are
    (a null slot's value zero), its validity where it has nulls; strings
    and binaries as offsets and a byte pool. A type ATB cannot carry
    raises."""
    import pyarrow as pa
    import pyarrow.types as pt
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    t = arr.type
    if pt.is_large_string(t) or pt.is_string_view(t):
        arr = arr.cast(pa.string())
    elif pt.is_large_binary(t) or pt.is_binary_view(t):
        arr = arr.cast(pa.binary())
    t = arr.type
    col = {}
    if pt.is_string(t) or pt.is_binary(t):
        n = len(arr)
        obuf = arr.buffers()[1]
        off = np.zeros((1,), np.int32) if obuf is None else np.frombuffer(
            obuf, np.int32, count=n + 1 + arr.offset)[arr.offset:]
        dbuf = arr.buffers()[2]
        data = np.frombuffer(dbuf, np.uint8) if dbuf is not None \
            else np.zeros((0,), np.uint8)
        base = int(off[0])
        col["offsets"] = off - base
        col["data"] = data[base:int(off[-1])]
    elif pt.is_integer(t) or pt.is_floating(t) or pt.is_boolean(t):
        filled = arr.fill_null(False if pt.is_boolean(t) else 0) \
            if arr.null_count else arr
        col["data"] = filled.to_numpy(zero_copy_only=False)
    else:
        raise NotImplementedError(
            f"format='atb' cannot carry column {name!r} of type {t}: it "
            "holds fixed-width numbers, bools and strings (write parquet "
            "or ipc)")
    if arr.null_count:
        col["validity"] = np.asarray(arr.is_valid())
    return col
