"""The port's external sort (``acero/spill.py``'s ``SpillSorter`` behind
``order_by`` past its budget) against the JAX package's, row for row: keys
with nulls, NaN and strings, ascending and descending, nulls at the start
and at the end, 20,000 rows in 2,048-row batches with a budget of
100,000 bytes (about ten sorted runs on disk). The budget from the
``ARROW_TPU_SPILL_BYTES`` environment variable reaches the sort and the
hash join (ROADMAP C39); runs are ATB files either package reads; a
stopped sort removes its runs; a dictionary column keeps the sort in
memory, as in the JAX package."""

import os

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as jat
import arrow_tpu.acero as jacero
import arrow_tpu.acero.spill as jspill
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.acero import spill
from arrow_tpu_torch.utils.cancel import CancelledError, StopSource

N = 20_000
BUDGET = 100_000


@pytest.fixture(scope="module")
def source():
    rng = np.random.default_rng(7)
    k = rng.integers(0, 500, N)
    f = rng.normal(size=N)
    f[rng.random(N) < 0.05] = np.nan
    return pa.table({
        "k": pa.array(k, mask=rng.random(N) < 0.1),
        "f": pa.array(f, mask=rng.random(N) < 0.03),
        "s": pa.array([f"s{(i * 7919) % 41:03d}" + "x" * (i % 3)
                       for i in range(N)]),
        "i": np.arange(N)})


def _plan(mod, table, keys, npl, budget):
    return mod.Declaration.from_sequence([
        mod.Declaration("table_source", mod.TableSourceNodeOptions(table)),
        mod.Declaration("order_by", mod.OrderByNodeOptions(
            keys, npl, spill_bytes=budget))])


def _port(source, keys, npl, budget):
    t = tat.Table.from_pyarrow(source, max_rows_per_batch=2048,
                               device="cpu")
    spill.reset_stats()
    out = _plan(tacero, t, keys, npl, budget).to_table().to_pyarrow()
    return out, dict(spill.STATS)


def _same_rows(a: pa.Table, b: pa.Table) -> None:
    assert a.num_rows == b.num_rows
    for name in a.column_names:
        x, y = a[name].combine_chunks(), b[name].combine_chunks()
        if pa.types.is_floating(x.type):
            assert x.is_null().equals(y.is_null()), name
            np.testing.assert_array_equal(
                x.fill_null(0).to_numpy().view(np.int64),
                y.fill_null(0).to_numpy().view(np.int64), err_msg=name)
        else:
            assert x.equals(y), name


CASES = [([("k", "descending")], "at_end"),
         ([("k", "ascending")], "at_start"),
         ([("f", "ascending")], "at_end"),
         ([("f", "descending"), ("k", "ascending")], "at_start"),
         ([("s", "descending"), ("k", "descending")], "at_end")]


@pytest.mark.parametrize("keys,npl", CASES,
                         ids=["k-desc-end", "k-asc-start", "f-asc-end",
                              "f-desc-k-start", "s-desc-k-end"])
def test_disk_sort_equals_the_jax_packages_row_for_row(source, keys, npl):
    got, stats = _port(source, keys, npl, BUDGET)
    assert stats["runs"] >= 8 and stats["bytes_read"] == \
        stats["bytes_written"] > 0
    assert not os.path.exists(stats["last_dir"])
    jt = jat.Table.from_pyarrow(source, max_rows_per_batch=2048)
    want = _plan(jacero, jt, keys, npl, BUDGET).to_table().to_pyarrow()
    _same_rows(got, want)
    # and the port's own sort in memory, which pyarrow's stable sort
    # orders the same
    in_memory, stats = _port(source, keys, npl, None)
    assert stats["runs"] == 0
    _same_rows(got, in_memory)
    if npl == "at_end" and len(keys) == 1 and keys[0][0] == "k":
        _same_rows(got, source.sort_by([(keys[0][0], keys[0][1])]))


def test_budget_from_the_environment_reaches_the_sort_and_the_join(
        source, monkeypatch):
    """C39: with no ``spill_bytes`` the budget is ARROW_TPU_SPILL_BYTES."""
    monkeypatch.setenv("ARROW_TPU_SPILL_BYTES", str(BUDGET))
    assert spill.spill_budget_bytes(tacero.OrderByNodeOptions([("k",
                                                                "ascending")]))\
        == BUDGET == jspill.spill_budget_bytes(None)
    got, stats = _port(source, [("k", "ascending")], "at_end", None)
    assert stats["runs"] >= 8
    monkeypatch.delenv("ARROW_TPU_SPILL_BYTES")
    want, stats = _port(source, [("k", "ascending")], "at_end", None)
    assert stats["runs"] == 0
    _same_rows(got, want)

    left = tat.Table.from_pyarrow(source, max_rows_per_batch=4096,
                                  device="cpu")
    right = tat.Table.from_pyarrow(
        source.slice(0, 6000).rename_columns(["rk", "rf", "rs", "ri"]),
        max_rows_per_batch=1024, device="cpu")

    def join():
        spill.reset_stats()
        out = tacero.Declaration("hashjoin", tacero.HashJoinNodeOptions(
            "inner", ["k"], ["rk"]), [
            tacero.Declaration("table_source",
                               tacero.TableSourceNodeOptions(left)),
            tacero.Declaration("table_source",
                               tacero.TableSourceNodeOptions(right))]
        ).to_table().to_pyarrow()
        return out.sort_by([("i", "ascending"), ("ri", "ascending")]), \
            spill.STATS["partition_files"]
    monkeypatch.setenv("ARROW_TPU_SPILL_BYTES", "20000")
    got, files = join()
    assert files > 16
    monkeypatch.delenv("ARROW_TPU_SPILL_BYTES")
    want, files = join()
    assert files == 0
    _same_rows(got, want)


def test_runs_are_atb_files_the_jax_package_reads(source, tmp_path):
    """A run the port writes streams back through the JAX package's
    ``read_run`` (and the other way round) in morsels of the same
    capacities."""
    t = tat.Table.from_pyarrow(source, max_rows_per_batch=3000,
                               device="cpu")
    b = t.batches[1]
    path = str(tmp_path / "run.atb")
    spill.write_run(path, b)
    jschema = jat.Schema.from_pyarrow(source.schema)
    jb = list(jspill.read_run(path, jschema, morsel_rows=1000))
    tb = list(spill.read_run(path, b.schema, morsel_rows=1000,
                             device="cpu"))
    assert [x.capacity for x in jb] == [x.capacity for x in tb] == \
        [1024, 1024, 1024]
    want = source.slice(3000, 3000)
    _same_rows(pa.concat_tables([pa.Table.from_batches([x.to_pyarrow()])
                                 for x in jb]), want)
    _same_rows(pa.concat_tables([pa.Table.from_batches([x.to_pyarrow()])
                                 for x in tb]), want)
    jpath = str(tmp_path / "jrun.atb")
    jspill.write_run(jpath, jat.Table.from_pyarrow(
        want, max_rows_per_batch=3000).batches[0])
    back = list(spill.read_run(jpath, b.schema, device="cpu"))
    _same_rows(pa.Table.from_batches([back[0].to_pyarrow()]), want)


def test_a_stopped_sort_removes_its_runs(source):
    t = tat.Table.from_pyarrow(source, max_rows_per_batch=2048,
                               device="cpu")
    stop = StopSource()
    spill.reset_stats()
    it = _plan(tacero, t, [("k", "ascending")], "at_end",
               BUDGET).to_batches(stop_token=stop.token())
    first = next(it)
    assert len(first) > 0 and os.path.isdir(spill.STATS["last_dir"])
    stop.request_stop("enough")
    with pytest.raises(CancelledError, match="enough"):
        next(it)
    assert not os.path.exists(spill.STATS["last_dir"])


def test_dictionary_columns_sort_in_memory_as_in_the_jax_package(source):
    d = source.set_column(2, "s", source["s"].dictionary_encode())
    assert not spill.spill_supported(tat.Schema.from_pyarrow(d.schema))
    assert not jspill.spill_supported(jat.Schema.from_pyarrow(d.schema))
    got, stats = _port(d, [("k", "ascending")], "at_end", BUDGET)
    assert stats["runs"] == 0
    want, _ = _port(source, [("k", "ascending")], "at_end", None)
    _same_rows(got.set_column(2, "s", got["s"].cast(pa.string())), want)


@pytest.mark.parametrize("compact_min", [None, "0"])
def test_merged_batches_own_their_buffers(source, monkeypatch, compact_min):
    """A merged batch is a prefix of its round's sorted batch, and a
    round's batch may hold many times the rows it emits; the consumer
    keeps every batch, so the output is gathered into batches of at
    least an input batch's rows that own buffers of exactly their rows
    (with or without ``maybe_compact``'s floors), and a column with no
    validity in the input gains none."""
    if compact_min is not None:
        monkeypatch.setenv("ARROW_TPU_COMPACT_MIN", compact_min)
        monkeypatch.setenv("ARROW_TPU_COMPACT_MIN_BYTES", compact_min)
    t = tat.Table.from_pyarrow(source, max_rows_per_batch=2048,
                               device="cpu")
    out = _plan(tacero, t, [("k", "ascending")], "at_end",
                BUDGET).to_table()
    assert len(out.batches) > 1
    assert all(len(b) >= 2048 for b in out.batches[:-1])
    for b in out.batches:
        assert b.capacity == len(b)
        for a, f in zip(b.arrays, source.schema):
            if source[f.name].null_count == 0:
                assert a.validity is None, f.name
            for x in (a.values, a.validity, a.offsets):
                if x is not None:
                    assert x.untyped_storage().nbytes() == x.nbytes
    want, _ = _port(source, [("k", "ascending")], "at_end", None)
    _same_rows(out.to_pyarrow(), want)
