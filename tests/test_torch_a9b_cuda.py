"""The plan drivers on the card (ROADMAP A9c):

* ONE captured graph holding a B1 call and a B4 + ``partition_positions``
  pair, replayed on new data copied into its inputs: every replay's
  outputs equal the plain versions, and so does an eager B1 call on the
  default stream between replays (a captured B1 takes a scratch of its
  own); the capture adds no launches, each replay adds the graph's;
* the fused driver on the card against the eager and lazy drivers on the
  card and the eager driver on the CPU: a multi-morsel Q3 whose lineitem
  segment is captured once and replayed for the other morsels, the
  learned route, one host read at the end;
* a segment with no filter, project or probe, and a tail morsel, run as
  plain calls: only work that replays is captured;
* a capture that fails raises, through ``capture_graph`` and through the
  fused driver (a segment forced capturable whose take reads the host):
  nothing falls back.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a9b_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.acero import fuse
from arrow_tpu_torch.entry import (entry_q3, example_columns_q3,
                                   plan_driver, q3_declaration,
                                   table_from_numpy)
from arrow_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.fixture(autouse=True)
def _own_plan_store(tmp_path, monkeypatch):
    monkeypatch.setenv("ARROW_TPU_PLAN_CACHE", str(tmp_path / "plans.json"))
    monkeypatch.setattr(fuse, "_PLAN_OBS", {})
    monkeypatch.setattr(fuse, "_PLAN_IMPL", {})
    monkeypatch.setattr(fuse, "_PLAN_LOADED", True)


@pytest.mark.parametrize("cap", [1 << 16, (1 << 20) + 777])
def test_replayed_kernels_equal_plain(cuda_device, cap):
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(cap)
    P, B = 16, cap // 12
    sel = torch.empty(cap, dtype=torch.bool, device=dev)
    cols = [torch.empty(cap, dtype=torch.int64, device=dev),
            torch.empty(cap, dtype=torch.int16, device=dev),
            torch.empty((cap, 5), dtype=torch.uint8, device=dev)]
    dest = torch.empty(cap, dtype=torch.int32, device=dev)

    def fill(p):
        sel.copy_(torch.rand(cap, generator=gen, device=dev) < p)
        cols[0].copy_(torch.randint(-(1 << 40), 1 << 40, (cap,),
                                    generator=gen, device=dev))
        cols[1].copy_(torch.randint(-300, 300, (cap,), generator=gen,
                                    device=dev, dtype=torch.int16))
        cols[2].copy_(torch.randint(0, 256, (cap, 5), generator=gen,
                                    device=dev, dtype=torch.uint8))
        dest.copy_(torch.randint(-1, P + 2, (cap,), generator=gen,
                                 device=dev, dtype=torch.int32))

    def body():
        outs, n = ck.filter_compact_columns(sel, cols)
        counts, tiles = ck.partition_histogram_segments([dest], P)
        return outs, n, counts, ck.partition_positions([dest], P, B,
                                                       tiles)[0]

    fill(0.5)
    body()
    before = dict(ck.LAUNCHES)
    g = ck.capture_graph(body)
    assert ck.LAUNCHES == before
    for r, p in enumerate((0.1, 0.9, 0.0, 1.0, 0.37)):
        fill(p)
        outs, n, counts, pos = g.replay()
        want, wn = ck.filter_compact_columns_plain(sel, cols)
        k = int(wn)
        assert int(n) == k
        for o, w in zip(outs, want):
            assert torch.equal(o[:k], w[:k]), r
        assert torch.equal(counts,
                           ck.partition_histogram_segments_plain(
                               [dest], P)[0])
        assert torch.equal(pos, ck.partition_positions_plain(
            [dest], P, B)[0])
        eager, en = ck.filter_compact_columns(sel, cols)
        assert int(en) == k and all(torch.equal(e[:k], w[:k])
                                    for e, w in zip(eager, want))
    assert ck.LAUNCHES["partition_positions"] - \
        before["partition_positions"] == 5
    assert ck.LAUNCHES["filter_compact_chunks"] - \
        before["filter_compact_chunks"] == 10


def _q3_rows(t):
    b = t.batches[0]
    n = len(b)
    return [b.column(c).values[:n].cpu().numpy()
            for c in ("l_orderkey", "o_date", "revenue")]


def test_fused_q3_on_the_card(cuda_device):
    """Q3 at 2^18 lineitem rows in 2^14-row morsels: the fused driver's
    lineitem segment is captured once and replayed; its answer equals the
    eager and lazy drivers' on the card and the eager driver's on the
    CPU (revenue within 1e-12 of the value)."""
    n, rows = 1 << 18, 1 << 14
    step, cpu_tables = entry_q3("cpu", n, 3, 1 << 16, rows)
    want = _q3_rows(step(*cpu_tables))
    cols = example_columns_q3(n, 3)
    tables = [table_from_numpy(c, rows, cuda_device) for c in cols]
    got = {}
    for d in ("eager", "fused", "lazy", "fused"):
        fuse.reset_stats()
        got[d] = _q3_rows(plan_driver(q3_declaration(*tables, 1 << 16), d))
    # the second fused run: the learned route, one read, a graph replayed
    assert fuse.STATS["fused"] == 1 and fuse.STATS["host_reads"] == 1
    assert fuse.STATS["graphs"] >= 1 and fuse.STATS["replays"] >= 1
    for d, (k, o, r) in got.items():
        assert np.array_equal(k, want[0]) and np.array_equal(o, want[1]), d
        assert np.all(np.abs(r - want[2]) <= 1e-12 * np.abs(want[2])), d


def test_capture_only_segments_with_work(cuda_device):
    """A source -> aggregate plan over several morsels captures nothing
    (its segment is the bare source); with a filter between them the
    segment is captured once and replayed for each further morsel of the
    full shape, and the tail morsel, a shape met once, runs as plain
    calls. Each equals the eager driver's answer on the card."""
    from arrow_tpu_torch.acero import (AggregateNodeOptions, AggregateSpec,
                                       Declaration, FilterNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.compute.expressions import field, literal
    rng = np.random.default_rng(1)
    rows, n = 4096, 5 * 4096 + 100
    t = table_from_numpy({"k": rng.integers(0, 40, n),
                          "v": rng.integers(0, 1000, n)}, rows, cuda_device)

    def make(with_filter):
        stages = [Declaration("table_source", TableSourceNodeOptions(t))]
        if with_filter:
            stages.append(Declaration("filter", FilterNodeOptions(
                field("v") > literal(100))))
        stages.append(Declaration("aggregate", AggregateNodeOptions(
            [AggregateSpec("sum", "v"), AggregateSpec("count_all")],
            keys=["k"], max_groups=64)))
        return Declaration.from_sequence(stages)

    def rows_of(table):
        b = table.batches[0]
        n = len(b)
        cols = [b.column(c).values[:n].cpu().numpy()
                for c in ("k", "v_sum", "count_all")]
        return sorted(zip(*(c.tolist() for c in cols)))
    for with_filter, graphs, replays in ((False, 0, 0), (True, 1, 4)):
        fuse.reset_stats()
        got = rows_of(plan_driver(make(with_filter), "fused"))
        assert fuse.STATS["fused"] == 1
        assert (fuse.STATS["graphs"], fuse.STATS["replays"]) == \
            (graphs, replays), with_filter
        assert got == rows_of(plan_driver(make(with_filter), "eager"))


def test_failed_capture_raises(cuda_device):
    x = torch.ones(8, device=cuda_device)
    with pytest.raises(RuntimeError):
        ck.capture_graph(lambda: x.sum().item())
    torch.cuda.synchronize()
    # through the driver: a segment forced capturable whose join reads the
    # host (a string column's take sizes its pool) raises, with no fallback
    from arrow_tpu_torch.core.array import varlen_from_numpy
    from arrow_tpu_torch.core.batch import Batch, Table
    from arrow_tpu_torch.core.schema import Field, Schema
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.array import array_from_numpy
    from arrow_tpu_torch.acero import (Declaration, HashJoinNodeOptions,
                                       TableSourceNodeOptions)
    rng = np.random.default_rng(0)

    def table(keys, with_strings, parts):
        batches = []
        for ks in np.array_split(keys, parts):
            arrays = [array_from_numpy(ks, device=cuda_device)]
            fields = [Field("k", dt.int64, True)]
            if with_strings:
                arrays.append(varlen_from_numpy(
                    np.array([f"s{v}" for v in ks]), device=cuda_device))
                fields.append(Field("s", dt.string, True))
            batches.append(Batch(Schema(tuple(fields)), arrays, len(ks)))
        return Table(batches[0].schema, batches)
    probe = table(rng.integers(0, 50, 4096), False, 4)
    build = table(np.arange(50), True, 1)
    decl = Declaration("hashjoin", HashJoinNodeOptions(
        "inner", ["k"], ["k"], left_output=["k"], right_output=["s"]),
        [Declaration("table_source", TableSourceNodeOptions(probe)),
         Declaration("table_source", TableSourceNodeOptions(build))])
    real = fuse._capturable
    fuse._capturable = lambda node, impls: True
    try:
        with pytest.raises(RuntimeError):
            plan_driver(decl, "fused")
    finally:
        fuse._capturable = real
    torch.cuda.synchronize()
    assert plan_driver(decl, "eager").num_rows == 4096
