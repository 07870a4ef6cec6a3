"""The port's Grace hash join (``HashJoinNode._batches_grace``: past its
budget both sides go to 16 partitions of ATB files, joined partition by
partition) against the port's own in-memory join and pyarrow's
``Table.join``, for all eight join types at a few thousand rows with
string payloads and null keys, the full outer one included (the JAX
package's Grace path raises there: ROADMAP C40 (e),
``test_torch_partitioned_join_jax.py``). And the split itself: the port's
partition ids are the JAX package's ``HashJoin.partition_ids``, and each
of the K files holds its partition's rows in arrival order, as the JAX
package's K boolean masks give them."""

import os

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as jat
import arrow_tpu.acero.options as jopts
import arrow_tpu.ops.join as jjoin
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as tacero
import arrow_tpu_torch.ops.join as tjoin
from arrow_tpu_torch.acero import spill
from arrow_tpu_torch.ops import cuda_kernels as ck

JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti"]
BUDGET = 10_000


@pytest.fixture(scope="module")
def sides():
    rng = np.random.default_rng(1)
    nl, nr = 6000, 3000
    left = pa.table({
        "k": pa.array(rng.integers(0, 2000, nl), mask=rng.random(nl) < 0.05),
        "lv": np.arange(nl),
        "ls": [f"l{i % 13}" + "y" * (i % 5) for i in range(nl)]})
    right = pa.table({
        "rk": pa.array(rng.integers(0, 2000, nr), mask=rng.random(nr) < 0.02),
        "rv": rng.random(nr),
        "rs": [f"r{i % 7}" for i in range(nr)]})
    return left, right


def _join(left, right, join_type, budget):
    L = tat.Table.from_pyarrow(left, max_rows_per_batch=1024, device="cpu")
    R = tat.Table.from_pyarrow(right, max_rows_per_batch=1024,
                               device="cpu")
    spill.reset_stats()
    out = tacero.Declaration("hashjoin", tacero.HashJoinNodeOptions(
        join_type, ["k"], ["rk"], spill_bytes=budget), [
        tacero.Declaration("table_source", tacero.TableSourceNodeOptions(L)),
        tacero.Declaration("table_source", tacero.TableSourceNodeOptions(R))]
    ).to_table().to_pyarrow()
    return out, dict(spill.STATS)


def _canon(t: pa.Table) -> pa.Table:
    t = t.select(sorted(t.column_names))
    return t.sort_by([(c, "ascending") for c in t.column_names])


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_partitioned_join_equals_in_memory_and_pyarrow(sides, join_type):
    left, right = sides
    got, stats = _join(left, right, join_type, BUDGET)
    assert stats["partition_files"] > 16, stats
    assert stats["bytes_read"] == stats["bytes_written"]
    mem, stats = _join(left, right, join_type, None)
    assert stats["partition_files"] == 0
    assert _canon(got).equals(_canon(mem))
    want = left.join(right, "k", "rk", join_type=join_type,
                     coalesce_keys=False)
    assert _canon(got).equals(_canon(want.select(got.column_names)))


def test_partition_ids_are_the_jax_packages(sides):
    left, right = sides
    for side, t, key in (("probe", left, "k"), ("build", right, "rk")):
        tb = tat.Table.from_pyarrow(t, max_rows_per_batch=8192,
                                    device="cpu").batches[0]
        jb = jat.Table.from_pyarrow(t, max_rows_per_batch=8192).batches[0]
        thj = tjoin.HashJoin(tat.Schema.from_pyarrow(left.schema),
                             tat.Schema.from_pyarrow(right.schema),
                             tacero.HashJoinNodeOptions(
                                 "inner", ["k"], ["rk"]))
        jhj = jjoin.HashJoin(jat.Schema.from_pyarrow(left.schema),
                             jat.Schema.from_pyarrow(right.schema),
                             jopts.HashJoinNodeOptions(
                                 "inner", ["k"], ["rk"]))
        got = thj.partition_ids(tb, side, 16)[:t.num_rows].numpy()
        want = np.asarray(jhj.partition_ids(jb, side, 16))[:t.num_rows]
        np.testing.assert_array_equal(got, want, err_msg=side)
        assert len(np.unique(got)) == 16


def test_each_partition_file_holds_its_rows_in_arrival_order(sides,
                                                            tmp_path):
    left, _ = sides
    b = tat.Table.from_pyarrow(left.slice(0, 5000), max_rows_per_batch=8192,
                               device="cpu").batches[0]
    assert b.capacity > 5000            # padding rows are dropped
    pids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 16, b.capacity).astype(np.int32))
    before = dict(ck.LAUNCHES)
    gp = spill.GracePartitioner(b.schema, 16, "probe", str(tmp_path))
    gp.add(b, pids)
    assert dict(ck.LAUNCHES) == before  # the CPU takes the plain versions
    mask_of = pids[:5000].numpy()
    assert sum(gp.rows) == 5000
    for p in range(16):
        want = left.slice(0, 5000).filter(pa.array(mask_of == p))
        assert gp.rows[p] == want.num_rows
        (path,) = gp.files[p]
        assert os.path.basename(path) == f"p{p}_0.atb"
        got = pa.Table.from_batches(
            [x.to_pyarrow() for x in gp.read_partition(p, device="cpu")])
        assert got.equals(want), p
        # the JAX package's split of the same rows: a mask per partition
        mask_path = str(tmp_path / f"mask{p}.atb")
        spill.write_run_masked(mask_path, b, np.pad(
            mask_of == p, (0, b.capacity - 5000)))
        with open(mask_path, "rb") as f1, open(path, "rb") as f2:
            assert f1.read() == f2.read(), p


def test_partition_order_is_stable_and_drops_padding():
    b = tat.batch_from_numpy({"x": np.arange(40)}, device="cpu")
    b = b.with_length(37)
    pids = torch.tensor([i % 3 for i in range(b.capacity)],
                        dtype=torch.int32)
    order, counts = spill.partition_order(b, pids, 4)
    assert counts.tolist() == [13, 12, 12, 0]
    live = np.arange(37)
    want = np.concatenate([live[live % 3 == p] for p in range(3)])
    np.testing.assert_array_equal(order[:37].numpy(), want)
