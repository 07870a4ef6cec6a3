"""The slice as a whole on the CPU, at TPC-H SF 0.005-0.01: the three entry
points of the out-of-core and dataset layer (``entry.entry_scan_q12``,
``entry_disk_sort``, ``entry_partitioned_join``), each against its
in-memory counterpart, pyarrow or numpy, and the JAX package where it runs
the same plan."""

import os

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as jat
import arrow_tpu.acero as jacero
from arrow_tpu_torch import dataset as tds
from arrow_tpu_torch import entry as E
from arrow_tpu_torch.acero import spill
from arrow_tpu_torch.utils.cancel import CancelledError


def test_q12_over_scans_equals_the_in_memory_plan_and_pyarrow():
    step, (li, od) = E.entry_scan_q12("cpu", 0.01, max_batch_rows=4096)
    try:
        assert len(li.fragments) == 7 and len(od.fragments) == 1
        tds.reset_stats()
        got = step(li, od).to_pydict()
        # 5 of 7 ship modes pruned on the host; the orders file read
        assert tds.STATS["pruned"] == 5 and tds.STATS["read"] == 3
        want = E.q12_pyarrow(step.source).to_pydict()
        assert got == want and got["l_shipmode"] == ["MAIL", "SHIP"]
        mem, tables = E.entry_q12("cpu", 0.01, source=step.source)
        assert mem(*tables).to_pydict() == got
    finally:
        step.cleanup()
    assert not os.path.exists(step.root)


def test_disk_sort_entry_against_numpy_memory_and_the_jax_package():
    step, (rbs,) = E.entry_disk_sort("cpu", 0.005, max_batch_rows=4096)
    assert step.spill_bytes * 8 <= step.input_bytes < \
        (step.spill_bytes + 1) * 8
    spill.reset_stats()
    got = step(rbs)
    assert spill.STATS["runs"] == len(rbs) > 4
    mem = step(rbs, spill_bytes=None)
    assert E.same_rows(got, mem) == []
    assert E.disk_sort_differ(got, step.source,
                              E.disk_sort_order(step.source)) == []
    src = step.source["lineitem"]
    want = jacero.Declaration.from_sequence([
        jacero.Declaration("table_source", jacero.TableSourceNodeOptions(
            jat.Table.from_pyarrow(src, max_rows_per_batch=4096))),
        jacero.Declaration("order_by", jacero.OrderByNodeOptions(
            list(E.DISK_SORT_KEYS), spill_bytes=step.spill_bytes))]
    ).to_table().to_pyarrow()
    assert got.to_pyarrow().equals(want)
    spill.reset_stats()
    with pytest.raises(CancelledError):
        step(rbs, stop_after=1)
    assert spill.STATS["runs"] == len(rbs)
    assert not os.path.exists(spill.STATS["last_dir"])


def test_partitioned_join_entry_against_memory_and_the_jax_package():
    step, (li, od) = E.entry_partitioned_join("cpu", 0.005,
                                              max_batch_rows=4096)
    spill.reset_stats()
    got = step(li, od)
    assert spill.STATS["partition_files"] > 16
    mem = step(li, od, spill_bytes=None)
    assert got.num_rows == li.num_rows
    assert E.tables_differ(got, mem, ["l_orderkey", "l_linenumber"]) == []
    src = step.source
    want = jacero.Declaration("hashjoin", jacero.HashJoinNodeOptions(
        "inner", ["l_orderkey"], ["o_orderkey"]), [
        jacero.Declaration("table_source", jacero.TableSourceNodeOptions(
            jat.Table.from_pyarrow(src["lineitem"],
                                   max_rows_per_batch=1 << 15))),
        jacero.Declaration("table_source", jacero.TableSourceNodeOptions(
            jat.Table.from_pyarrow(src["orders"],
                                   max_rows_per_batch=1 << 15)))]
    ).to_table().to_pyarrow()
    keys = [("l_orderkey", "ascending"), ("l_linenumber", "ascending")]
    assert got.to_pyarrow().sort_by(keys).equals(
        want.select(got.column_names).sort_by(keys))
    ls, os_ = E.pjoin_slices(src, "cpu", 4096)
    anti = step(ls, os_, "left anti")
    full = step(ls, os_, "full outer")
    assert E.tables_differ(anti, step(ls, os_, "left anti", None),
                           ["l_orderkey", "l_linenumber"]) == []
    assert E.tables_differ(full, step(ls, os_, "full outer", None),
                           ["l_orderkey", "l_linenumber",
                            "o_orderkey"]) == []
    f = full.to_pyarrow()
    unmatched_l = f["o_orderkey"].null_count
    unmatched_o = f["l_orderkey"].null_count
    assert unmatched_l == anti.num_rows > 0 and unmatched_o > 0
    want_full = src["lineitem"].slice(len(src["lineitem"]) // 20,
                                      len(src["lineitem"]) // 10).join(
        src["orders"].slice(0, len(src["orders"]) // 10), "l_orderkey",
        "o_orderkey", join_type="full outer", coalesce_keys=False)
    assert want_full.num_rows == f.num_rows
    np.testing.assert_array_equal(
        np.sort(f["o_totalprice"].drop_null().to_numpy()),
        np.sort(want_full["o_totalprice"].drop_null().to_numpy()))
