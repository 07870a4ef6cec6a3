"""The port's Grace hash join against the JAX package's own Grace path, at
the smallest sizes that still give more than one partition file (the JAX
path compiles a build and a probe per partition shape on the CPU): an
inner join equal as a multiset; and ROADMAP C40 (e) kept on record: a
full outer join with string payloads, where each JAX partition sizes its
string pool from its own small batches and raises "varlen byte-pool
overflow", while the port answers as its in-memory join and pyarrow
do."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as jat
import arrow_tpu.acero as jacero
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch.acero import spill


def _run(mod, table_of, left, right, join_type, rows, budget, **kw):
    L, R = (table_of(t, rows) for t in (left, right))
    return mod.Declaration("hashjoin", mod.HashJoinNodeOptions(
        join_type, ["k"], ["rk"], spill_bytes=budget, **kw), [
        mod.Declaration("table_source", mod.TableSourceNodeOptions(L)),
        mod.Declaration("table_source", mod.TableSourceNodeOptions(R))]
    ).to_table().to_pyarrow()


def _jax_table(t, rows):
    return jat.Table.from_pyarrow(t, max_rows_per_batch=rows)


def _port_table(t, rows):
    return tat.Table.from_pyarrow(t, max_rows_per_batch=rows, device="cpu")


def _canon(t: pa.Table) -> pa.Table:
    t = t.select(sorted(t.column_names))
    return t.sort_by([(c, "ascending") for c in t.column_names])


def test_partitioned_inner_join_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    left = pa.table({"k": rng.integers(0, 80, 200), "lv": np.arange(200)})
    right = pa.table({"rk": rng.integers(0, 80, 100),
                      "rv": rng.random(100)})
    spill.reset_stats()
    got = _run(tacero, _port_table, left, right, "inner", 64, 500)
    assert spill.STATS["partition_files"] > 16
    want = _run(jacero, _jax_table, left, right, "inner", 64, 500,
                max_build_rows=128)
    assert got.num_rows == want.num_rows > 0
    assert _canon(got).equals(_canon(want))


def test_c40e_full_outer_string_payloads_where_the_jax_path_raises():
    rng = np.random.default_rng(1)
    nl, nr = 120, 60
    left = pa.table({
        "k": pa.array(rng.integers(0, 40, nl), mask=rng.random(nl) < 0.05),
        "lv": np.arange(nl), "ls": [f"l{i % 13}" for i in range(nl)]})
    right = pa.table({"rk": rng.integers(0, 40, nr), "rv": rng.random(nr),
                      "rs": [f"r{i % 7}" for i in range(nr)]})
    spill.reset_stats()
    got = _run(tacero, _port_table, left, right, "full outer", 32, 300)
    assert spill.STATS["partition_files"] > 16
    mem = _run(tacero, _port_table, left, right, "full outer", 32, None)
    assert _canon(got).equals(_canon(mem))
    want = left.join(right, "k", "rk", join_type="full outer",
                     coalesce_keys=False)
    assert _canon(got).equals(_canon(want.select(got.column_names)))
    with pytest.raises(ValueError, match="byte-pool overflow"):
        _run(jacero, _jax_table, left, right, "full outer", 32, 300,
             max_build_rows=256)
