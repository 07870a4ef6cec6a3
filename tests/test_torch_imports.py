"""The port runs without JAX and without pyarrow: in a fresh process (this
test process has imported jax through conftest), import arrow_tpu_torch,
run the slices on the CPU (the distributed one on 8 logical shards, which
loads ``parallel/*`` and ``ops/hashing``; sort and join, which load
``ops/sorting``, ``ops/join``, ``ops/planes`` and ``acero/options``; the
Q3-shaped plan, which loads ``acero/plan`` and ``acero/nodes``; the string
slice's three, which load ``ops/strings`` and the string paths of the
rest; a Unicode case map, which loads ``ops/unicode_text`` and its tables;
and ``ops/strings_regex`` and ``utils/tpch``, which import pyarrow only
when they run; a cast, a local-time field of a zoned timestamp, ``is_in``,
a cumulative sum and a checked add, which load the five modules of the
casts, temporal, set-lookup, vector_misc and checked functions; a
whitespace split, a list function, a run-end encoding and a sparse matrix,
which load ``ops/nested``, ``ops/ree``, ``ops/pivot`` and
``core/tensor``; ``parallel/multihost`` and its collectives; the native
host runtime, ``acero/spill``, ``dataset`` and the cancellation, config and
tracing utilities; the Q3 plan through Substrait, protobuf and JSON, and
through the fused and lazy drivers, which load ``engine``,
``engine/substrait_pb`` and ``acero/fuse``; and ``dataset/avro``, which
imports pyarrow only when it reads or writes), and check which modules
got loaded. And the default-device rule: an entry point given
no device takes the card."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import sys
import arrow_tpu_torch
from arrow_tpu_torch.entry import entry, entry_distributed, entry_generic
for make in (entry, entry_generic):
    step, args = make("cpu", 1024, 16, 0)
    out = step(*args)
    assert 0 < len(out) <= 16, len(out)
step, args = entry_distributed("cpu", 8, 1024, 16, 64, 0)
table = step(*args)
assert 0 < table.num_rows <= 16, table
from arrow_tpu_torch.entry import entry_join, entry_sort
step, args = entry_sort("cpu", 1024, 0, 16)
idx, out = step(*args)
assert len(idx) == len(out) == 1024
for kw in ({}, {"build_keys": 32, "fanout_capacity": 8192}, {"wide": True}):
    step, args = entry_join("cpu", 128, 1024, 0, "full outer", **kw)
    out, tail = step(*args)
    assert len(out) >= 1024 and tail is not None
from arrow_tpu_torch.entry import entry_q3
step, args = entry_q3("cpu")
table = step(*args)
assert table.num_rows == 10 and table.column_names == (
    "l_orderkey", "o_date", "revenue"), table
from arrow_tpu_torch.entry import entry_q3s, entry_sort_dict, entry_strings
step, args = entry_sort_dict("cpu", 1024, 0, 50)
idx, out = step(*args)
assert len(idx) == len(out) == 1024
step, args = entry_q3s("cpu")
assert step(*args).num_rows == 10
step, args = entry_strings("cpu", 1024, 30, 0, 64)
out = step(*args)
assert 0 < len(out) <= 30 and out.column("name").offsets is not None
import arrow_tpu_torch.acero, arrow_tpu_torch.ops.bloom
import arrow_tpu_torch.ops.concat
import arrow_tpu_torch.ops.strings_regex, arrow_tpu_torch.ops.unicode_text
import arrow_tpu_torch.utils.tpch
import numpy as np
from arrow_tpu_torch.compute import call_function
from arrow_tpu_torch.core.array import varlen_from_numpy
up = call_function("utf8_upper", [varlen_from_numpy(np.array(["ßé", "x"]),
                                                    device="cpu")])
assert bytes(up.values[:int(up.offsets[2])].tolist()).decode() == "ẞÉX"
assert {"arrow_tpu_torch.ops.strings_regex", "arrow_tpu_torch.ops.unicode_text",
        "arrow_tpu_torch.utils.tpch"} <= set(sys.modules)
assert {"arrow_tpu_torch.ops.sorting", "arrow_tpu_torch.ops.join",
        "arrow_tpu_torch.ops.planes", "arrow_tpu_torch.acero.options",
        "arrow_tpu_torch.acero.plan", "arrow_tpu_torch.acero.nodes",
        "arrow_tpu_torch.ops.scalar_arithmetic",
        "arrow_tpu_torch.ops.strings"} <= set(sys.modules)
from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.array import array_from_numpy
ts = array_from_numpy(np.array([0, 86_400_000_001, -1]),
                      type=dt.timestamp("us", "Europe/Paris"), device="cpu")
assert call_function("hour", [ts]).values.tolist() == [1, 1, 0]
k = array_from_numpy(np.array([3, 1, 2]), device="cpu")
assert call_function("cast", [k], target_type=dt.int8).values.tolist() == \
    [3, 1, 2]
assert call_function("is_in", [k], value_set=[1, 2]).values.tolist() == \
    [False, True, True]
assert call_function("cumulative_sum", [k]).values.tolist() == [3, 4, 6]
assert call_function("add_checked", [k, k]).values.tolist() == [6, 2, 4]
assert {"arrow_tpu_torch.ops.scalar_cast", "arrow_tpu_torch.ops.temporal",
        "arrow_tpu_torch.ops.set_lookup", "arrow_tpu_torch.ops.vector_misc",
        "arrow_tpu_torch.ops.scalar_checked",
        "arrow_tpu_torch.utils.errors"} <= set(sys.modules)
from arrow_tpu_torch.core.interop import array_from_pyarrow
from arrow_tpu_torch.core.array import Array
from arrow_tpu_torch.core.tensor import SparseCSRMatrix
s = varlen_from_numpy(np.array(["a b", " c"]), device="cpu")
parts = call_function("utf8_split_whitespace", [s])
assert call_function("list_value_length", [parts]).values.tolist() == [2, 2]
assert call_function("list_element", [parts, 1]).offsets.tolist() == \
    [0, 1, 2]
enc = call_function("run_end_encode", [array_from_numpy(
    np.array([4, 4, 5]), device="cpu")])
assert enc.offsets[1:3].tolist() == [2, 3]
m = SparseCSRMatrix(np.array([2.0]), np.array([0, 1, 1]), np.array([1]),
                    (2, 2), device="cpu")
assert m.to_dense().tolist() == [[0.0, 2.0], [0.0, 0.0]]
from arrow_tpu_torch.entry import entry_baskets, entry_wordcount
assert {"arrow_tpu_torch.ops.nested", "arrow_tpu_torch.ops.ree",
        "arrow_tpu_torch.ops.pivot", "arrow_tpu_torch.core.tensor"} <= \
    set(sys.modules)
import arrow_tpu_torch.parallel.context, arrow_tpu_torch.parallel.dist_agg
import arrow_tpu_torch.parallel.shuffle, arrow_tpu_torch.ops.hashing
from arrow_tpu_torch.parallel import multihost
assert not multihost.is_initialized()
assert {"arrow_tpu_torch.parallel.shuffle", "arrow_tpu_torch.ops.hashing",
        "arrow_tpu_torch.parallel.dist_agg",
        "arrow_tpu_torch.parallel.multihost",
        "arrow_tpu_torch.parallel.collective"} <= set(sys.modules)
from arrow_tpu_torch import native
from arrow_tpu_torch.acero import spill
from arrow_tpu_torch.utils import cancel, config, tracing
import arrow_tpu_torch.dataset
assert native.available(), native.build_error()
assert set(config.build_info()) >= {"version", "native_runtime"}
with tracing.trace_span("imports"):
    stop = cancel.StopSource()
assert not stop.token().stop_requested
assert spill.spill_supported(table.batches[0].schema)
assert {"arrow_tpu_torch.native", "arrow_tpu_torch.acero.spill",
        "arrow_tpu_torch.utils.cancel", "arrow_tpu_torch.utils.config",
        "arrow_tpu_torch.utils.tracing", "arrow_tpu_torch.dataset"} <= \
    set(sys.modules)
from arrow_tpu_torch.entry import entry_fused_q3
from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                   TableSourceNodeOptions)
from arrow_tpu_torch.compute.expressions import field
from arrow_tpu_torch.engine import declaration_to_substrait, run_query
import arrow_tpu_torch.dataset.avro
decl = Declaration.from_sequence([
    Declaration("table_source", TableSourceNodeOptions(
        arrow_tpu_torch.table({"a": np.arange(8)}, device="cpu"))),
    Declaration("filter", FilterNodeOptions(field("a") > 3))])
for binary in (True, False):
    plan, named = declaration_to_substrait(decl, binary=binary)
    assert run_query(plan, named, device="cpu").num_rows == 4
for driver in ("fused", "lazy"):
    step, args = entry_fused_q3("cpu", driver=driver)
    assert step(*args).num_rows == 10
assert {"arrow_tpu_torch.engine", "arrow_tpu_torch.engine.substrait",
        "arrow_tpu_torch.engine.substrait_pb", "arrow_tpu_torch.acero.fuse",
        "arrow_tpu_torch.dataset.avro"} <= set(sys.modules)
bad = sorted(m for m in ("jax", "jaxlib", "pyarrow", "arrow_tpu")
             if m in sys.modules)
print("LOADED", bad)
"""


def test_port_imports_neither_jax_nor_pyarrow():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_no_device_means_the_card():
    """The resolver every entry point and constructor passes ``device``
    through: none given -> cuda; a named device is kept."""
    import importlib
    import inspect

    import torch

    import arrow_tpu_torch as att
    from arrow_tpu_torch import entry as entry_mod
    from arrow_tpu_torch.core import interop
    # (core/__init__ binds the names ``array`` and ``batch`` to functions)
    array_mod = importlib.import_module("arrow_tpu_torch.core.array")
    batch_mod = importlib.import_module("arrow_tpu_torch.core.batch")

    assert att.default_device() == torch.device("cuda")
    assert array_mod.resolve_device(None) == torch.device("cuda")
    assert array_mod.resolve_device("cpu") == torch.device("cpu")
    assert array_mod.resolve_device(torch.device("cuda:0")) == \
        torch.device("cuda:0")
    for fn in (entry_mod.entry, entry_mod.entry_generic,
               entry_mod.entry_distributed, entry_mod.entry_sort,
               entry_mod.entry_join, entry_mod.entry_q3,
               entry_mod.entry_sort_dict, entry_mod.entry_q3s,
               entry_mod.entry_strings, entry_mod.entry_q13,
               entry_mod.entry_q22, entry_mod.entry_host_boundary,
               entry_mod.entry_q12, entry_mod.entry_q7,
               entry_mod.entry_wordcount, entry_mod.entry_baskets,
               entry_mod.entry_ree_keys, entry_mod.entry_scan_q12,
               entry_mod.entry_disk_sort, entry_mod.entry_partitioned_join,
               entry_mod.entry_substrait_q3, entry_mod.entry_avro_scan,
               entry_mod.entry_fused_q3,
               array_mod.varlen_from_numpy,
               array_mod.dictionary_from_numpy,
               entry_mod.table_from_numpy, batch_mod.empty_batch,
               batch_mod.table, batch_mod.Table.from_pyarrow,
               batch_mod.batch_from_numpy, batch_mod.batch,
               interop.batch_from_pyarrow, interop.array_from_pyarrow,
               att.array, att.array_from_numpy, att.nulls, att.full):
        assert inspect.signature(fn).parameters["device"].default is None, fn


def test_port_sources_name_neither_jax_nor_the_jax_package():
    """No module of the port, the exchange and the hashing included,
    imports ``jax`` or ``arrow_tpu``."""
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|arrow_tpu)(\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "arrow_tpu_torch").rglob("*.py"))
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"arrow_tpu_torch/parallel/__init__.py",
            "arrow_tpu_torch/parallel/context.py",
            "arrow_tpu_torch/parallel/dist_agg.py",
            "arrow_tpu_torch/parallel/shuffle.py",
            "arrow_tpu_torch/parallel/dist_join.py",
            "arrow_tpu_torch/parallel/multihost.py",
            "arrow_tpu_torch/parallel/collective.py",
            "arrow_tpu_torch/ops/hashing.py",
            "arrow_tpu_torch/ops/sorting.py", "arrow_tpu_torch/ops/concat.py",
            "arrow_tpu_torch/ops/planes.py", "arrow_tpu_torch/ops/bloom.py",
            "arrow_tpu_torch/ops/join.py",
            "arrow_tpu_torch/acero/options.py",
            "arrow_tpu_torch/acero/nodes.py", "arrow_tpu_torch/acero/plan.py",
            "arrow_tpu_torch/ops/scalar_arithmetic.py",
            "arrow_tpu_torch/ops/strings.py",
            "arrow_tpu_torch/ops/strings_regex.py",
            "arrow_tpu_torch/ops/unicode_text.py",
            "arrow_tpu_torch/utils/tpch.py",
            "arrow_tpu_torch/utils/errors.py",
            "arrow_tpu_torch/ops/scalar_cast.py",
            "arrow_tpu_torch/ops/temporal.py",
            "arrow_tpu_torch/ops/scalar_checked.py",
            "arrow_tpu_torch/ops/vector_misc.py",
            "arrow_tpu_torch/ops/set_lookup.py",
            "arrow_tpu_torch/ops/nested.py", "arrow_tpu_torch/ops/ree.py",
            "arrow_tpu_torch/ops/pivot.py",
            "arrow_tpu_torch/core/tensor.py",
            "arrow_tpu_torch/utils/cancel.py",
            "arrow_tpu_torch/utils/config.py",
            "arrow_tpu_torch/utils/tracing.py",
            "arrow_tpu_torch/native.py", "arrow_tpu_torch/acero/spill.py",
            "arrow_tpu_torch/dataset/__init__.py",
            "arrow_tpu_torch/dataset/avro.py",
            "arrow_tpu_torch/engine/__init__.py",
            "arrow_tpu_torch/engine/substrait.py",
            "arrow_tpu_torch/engine/substrait_pb.py",
            "arrow_tpu_torch/acero/fuse.py"} <= names
    for f in files + [ROOT / "chip_smoke.py"]:
        assert not pat.search(f.read_text()), f


def test_dist_context_without_devices_wants_a_card():
    """``DistContext()`` with no mesh takes the cards; where there is none
    it raises and does not quietly take the CPU."""
    import pytest
    import torch

    from arrow_tpu_torch.parallel import DistContext, Mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistContext()
    ctx = DistContext(mesh=Mesh(["cpu", "cpu"], axis="x"))
    assert (ctx.n, ctx.axis) == (2, "x")
    assert ctx.mesh.shape == {"x": 2}
