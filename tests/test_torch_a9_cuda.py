"""The out-of-core and dataset layer on the card (ROADMAP A9a), on tensors
only (the card's machine may lack pyarrow's export):

* a run leaves the card through pinned host buffers and comes back in
  morsels on the card, equal to the batch it was written from, and the
  same ATB bytes as the run of the same batch on the CPU;
* the Grace split on the card (B4 ``partition_histogram_segments`` and
  ``partition_positions``, one launch each a batch) equals its plain
  version on the CPU, and its K partition files are byte for byte the
  files of the CPU's masks;
* the external sort and the Grace join on the card equal the same plans
  in memory on the card and past their budget on the CPU;
* ``to_batches_prefetched`` whose consumer runs on a side stream: the
  producer queues its work on that stream, and every batch equals the
  CPU's.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a9_cuda.py -m cuda -q --noconftest
"""

import os

import numpy as np
import pytest
import torch

from arrow_tpu_torch.acero import (Declaration, HashJoinNodeOptions,
                                   OrderByNodeOptions, SourceNodeOptions,
                                   TableSourceNodeOptions, spill)
from arrow_tpu_torch.core.array import array_from_numpy, varlen_from_numpy
from arrow_tpu_torch.core.batch import Batch, Table
from arrow_tpu_torch.core.schema import Field, Schema
from arrow_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _batch(n: int, seed: int, device, base: int = 0) -> Batch:
    """int64 key with nulls, float64 with NaN, a string column with nulls,
    an int32 id from ``base``."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 300, n)
    f = rng.normal(size=n)
    f[rng.random(n) < 0.05] = np.nan
    words = np.array([f"w{i % 23}" + "z" * (i % 4) for i in range(n)])
    arrays = [array_from_numpy(k, validity=rng.random(n) >= 0.1,
                               device=device),
              array_from_numpy(f, device=device),
              varlen_from_numpy(words, validity=rng.random(n) >= 0.1,
                                device=device),
              array_from_numpy(np.arange(base, base + n, dtype=np.int32),
                               device=device)]
    schema = Schema(tuple(Field(name, a.type, True) for name, a in
                          zip(("k", "f", "s", "i"), arrays)))
    return Batch(schema, arrays, n)


def _columns_equal(a: Batch, b: Batch) -> bool:
    n = int(a.length)
    if int(b.length) != n:
        return False
    for x, y in zip(a.arrays, b.arrays):
        vx, vy = x.validity_or_true()[:n].cpu(), y.validity_or_true()[:n].cpu()
        if not torch.equal(vx, vy):
            return False
        if x.offsets is not None:
            ox, oy = x.offsets[:n + 1].cpu().long(), y.offsets[:n + 1].cpu().long()
            if not (torch.equal(ox - ox[0], oy - oy[0]) and torch.equal(
                    x.values[int(ox[0]):int(ox[-1])].cpu(),
                    y.values[int(oy[0]):int(oy[-1])].cpu())):
                return False
        else:
            xv, yv = x.values[:n].cpu(), y.values[:n].cpu()
            if xv.is_floating_point():
                xv, yv = xv.view(torch.int64), yv.view(torch.int64)
            if not torch.equal(torch.where(vx, xv, 0),
                               torch.where(vy, yv, 0)):
                return False
    return True


def _concat(batches) -> Batch:
    from arrow_tpu_torch.ops.concat import concat_batches
    return concat_batches(list(batches))


def test_run_through_pinned_memory_on_card(cuda_device, tmp_path):
    b = _batch(5000, 0, cuda_device)
    c = _batch(5000, 0, "cpu")
    assert spill._to_host(b.arrays[0].values, True).is_pinned()
    spill.write_run(str(tmp_path / "card.atb"), b)
    spill.write_run(str(tmp_path / "cpu.atb"), c)
    assert (tmp_path / "card.atb").read_bytes() == \
        (tmp_path / "cpu.atb").read_bytes()
    back = list(spill.read_run(str(tmp_path / "card.atb"), b.schema,
                               morsel_rows=2048, device=cuda_device))
    assert [x.capacity for x in back] == [2048, 2048, 1024]
    assert all(x.device == cuda_device for x in back)
    assert _columns_equal(_concat(back), c)


def test_partition_split_on_card_equals_the_cpu_masks(cuda_device,
                                                      tmp_path):
    b = _batch(20000, 1, cuda_device)
    c = _batch(20000, 1, "cpu")
    pids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 16, b.capacity).astype(np.int32))
    ck.reset_launch_counts()
    order, counts = spill.partition_order(b, pids.to(cuda_device), 16)
    assert ck.LAUNCHES["partition_histogram"] == 1
    assert ck.LAUNCHES["partition_positions"] == 1
    o_cpu, c_cpu = spill.partition_order(c, pids, 16)
    assert torch.equal(counts.cpu(), c_cpu)
    assert torch.equal(order[:20000].cpu(), o_cpu[:20000])
    card = spill.GracePartitioner(b.schema, 16, "card", str(tmp_path))
    card.add(b, pids.to(cuda_device))
    for p in range(16):
        mask = np.zeros(b.capacity, bool)
        mask[:20000] = pids[:20000].numpy() == p
        path = str(tmp_path / f"mask{p}.atb")
        spill.write_run_masked(path, c, mask)
        (got,) = card.files[p]
        with open(got, "rb") as f1, open(path, "rb") as f2:
            assert f1.read() == f2.read(), p


def _sort_plan(batches, budget):
    t = Table(batches[0].schema, batches)
    return Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(t)),
        Declaration("order_by", OrderByNodeOptions(
            [("k", "descending"), ("f", "ascending")], "at_start",
            spill_bytes=budget))])


def test_disk_sort_on_card(cuda_device):
    parts = [_batch(3000, s, cuda_device) for s in range(6)]
    spill.reset_stats()
    got = _sort_plan(parts, 100_000).to_table()
    assert spill.STATS["runs"] == 6
    assert not os.path.exists(spill.STATS["last_dir"])
    mem = _sort_plan(parts, None).to_table()
    cpu = _sort_plan([_batch(3000, s, "cpu") for s in range(6)],
                     100_000).to_table()
    g = _concat(got.batches)
    assert _columns_equal(g, _concat(mem.batches))
    assert _columns_equal(g, _concat(cpu.batches))


def _join_plan(left, right, join_type, budget):
    return Declaration("hashjoin", HashJoinNodeOptions(
        join_type, ["k"], ["rk"], spill_bytes=budget), [
        Declaration("table_source", TableSourceNodeOptions(
            Table(left[0].schema, left))),
        Declaration("table_source", TableSourceNodeOptions(
            Table(right[0].schema, right)))])


def _rename(b: Batch, suffix: str) -> Batch:
    return Batch(Schema(tuple(
        Field("rk" if f.name == "k" else f.name + suffix, f.type, True)
        for f in b.schema)), b.arrays, b.length)


def _sorted_host(t: Table) -> dict:
    """Each column of a join output as host numpy, rows sorted by the two
    ids (unique per pair)."""
    b = _concat(t.batches) if len(t.batches) > 1 else t.batches[0]
    n = int(b.length)
    cols = {}
    for name in b.schema.names:
        a = b.column(name)
        if a.offsets is not None:
            continue
        v = a.values[:n].cpu().numpy()
        valid = a.validity_or_true()[:n].cpu().numpy()
        cols[name] = np.where(valid, v.view(np.int64) if v.dtype ==
                              np.float64 else v.astype(np.int64), -1)
    order = np.lexsort([cols.get("i", np.zeros(n, np.int64)),
                        cols.get("i_r", np.zeros(n, np.int64))])
    return {k: v[order] for k, v in cols.items()}


@pytest.mark.parametrize("join_type", ["inner", "full outer", "left anti"])
def test_partitioned_join_on_card(cuda_device, join_type):
    def sides(device):
        return ([_batch(4000, s, device, 4000 * s) for s in range(3)],
                [_rename(_batch(1500, 10 + s, device, 1500 * s), "_r")
                 for s in range(2)])
    left, right = sides(cuda_device)
    ck.reset_launch_counts()
    spill.reset_stats()
    got = _join_plan(left, right, join_type, 20_000).to_table()
    assert spill.STATS["partition_files"] > 16
    assert ck.LAUNCHES["partition_histogram"] == 5 == \
        ck.LAUNCHES["partition_positions"]
    mem = _join_plan(left, right, join_type, None).to_table()
    cpu = _join_plan(*sides("cpu"), join_type, 20_000).to_table()
    g = _sorted_host(got)
    for other in (mem, cpu):
        o = _sorted_host(other)
        assert g.keys() == o.keys()
        for name in g:
            np.testing.assert_array_equal(g[name], o[name], err_msg=name)


def test_prefetch_on_a_side_stream(cuda_device):
    parts = [_batch(50000, s, cuda_device) for s in range(4)]
    side = torch.cuda.Stream(cuda_device)

    def plan():
        gen = iter(parts)
        return Declaration.from_sequence([
            Declaration("source", SourceNodeOptions(
                parts[0].schema, lambda: gen)),
            Declaration("order_by", OrderByNodeOptions(
                [("f", "descending")], spill_bytes=500_000))])
    with torch.cuda.stream(side):
        got = list(plan().to_batches_prefetched(prefetch=2))
        # read at once on the side stream, no synchronise in between
        vals = torch.cat([b.column("i").values[:int(b.length)]
                          for b in got]).cpu()
    cpu = [_batch(50000, s, "cpu") for s in range(4)]
    gen = iter(cpu)
    want = Declaration.from_sequence([
        Declaration("source", SourceNodeOptions(cpu[0].schema,
                                                lambda: gen)),
        Declaration("order_by", OrderByNodeOptions(
            [("f", "descending")]))]).to_table()
    wv = torch.cat([b.column("i").values[:int(b.length)]
                    for b in want.batches])
    assert torch.equal(vals, wv)
