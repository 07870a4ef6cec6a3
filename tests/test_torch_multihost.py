"""The port's distributed operators across processes (``parallel/
multihost.py``; ROADMAP A8): 2 processes x 4 logical CPU shards over gloo,
one 8-shard global mesh, the multi-process analog of the JAX package's
``tests/test_multihost.py``.

The layout starts ONCE (``entry.launch_dist_workers``) and runs every case
of ``entry.DIST_CASES`` inside it: ``DistContext.group_by`` (the JAX test's
case), ``join``, ``sort_by`` with null keys at_end and at_start,
``group_by_raw_rows`` through its retry, a dictionary key, the Q3
Declaration with ``dist=``, ``dryrun_multichip``'s five checks, group
tables and a fanout too small (raising on every process), the Q3
Declaration with a fanout too small for its streaming join (raising on
every process) and a uint64 key across the exchange. Each process writes
its results; every process's must equal, bit for bit and in row order, the
single-controller port's over the same 8-shard mesh (``dist_case_tables``).
The group-by, raw-row retry and join results are also held against the
JAX package's 8-device run (the Q3 result in ``test_torch_multihost_4x2.py``) (f64 sums within 1e-12 * sum|x| + 1e-12 per
group, ROADMAP C5), the sorts, the raw-row groups and the keys against
pyarrow or numpy. The workers import neither jax nor the JAX package.
"""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.entry import (DIST_CASES, dist_case_tables,
                                   launch_dist_workers, table_host_arrays)
from arrow_tpu_torch.parallel import DistContext

N_SHARDS = 8
# seconds for a layout's processes: start-up, every case, the results
LAYOUT_TIMEOUT = 150


def run_layout(world: int) -> tuple:
    """(the single-controller port's arrays over 8 CPU shards, per process
    of ``world`` x 8 / world shards its arrays)."""
    want = table_host_arrays(dist_case_tables(
        DistContext(devices=["cpu"] * N_SHARDS)))
    got, _ = launch_dist_workers(world, ["cpu"] * (N_SHARDS // world),
                                 "gloo", DIST_CASES, timeout=LAYOUT_TIMEOUT,
                                 threads=2)
    return want, got


def assert_case_equal(want: dict, got: list, case: str) -> None:
    keys = [k for k in want if k.split(".")[0] == case]
    assert keys, case
    for rank, arrays in enumerate(got):
        assert sorted(k for k in arrays if k.split(".")[0] == case) == \
            sorted(keys), (rank, case)
        for k in keys:
            assert want[k].dtype == arrays[k].dtype, (rank, k)
            assert np.array_equal(want[k], arrays[k]), (rank, k)


@pytest.fixture(scope="module")
def layout():
    return run_layout(2)


@pytest.mark.parametrize("case", DIST_CASES)
def test_two_processes_equal_single_controller(layout, case):
    want, got = layout
    assert len(got) == 2
    assert_case_equal(want, got, case)


def test_two_process_workers_import_no_jax(layout):
    _, got = layout
    assert [bool(a["imported_jax"]) for a in got] == [False, False]


def _column(arrays, case, i):
    """A result column's values and validity, in row order."""
    return arrays[f"{case}.{i}.values"], arrays[f"{case}.{i}.validity"]


def test_two_process_group_by_vs_jax_and_pyarrow(layout):
    """The JAX package's multi-process test's case: the same shards hold
    the same groups in the same order as the JAX package's 8-device run;
    sums within the f64 tolerance; against pyarrow as a set."""
    _, got = layout
    rng = np.random.default_rng(0)
    t = pa.table({"k": pa.array(rng.integers(0, 37, 4096)),
                  "v": pa.array(rng.standard_normal(4096))})
    jout = JDistContext().group_by(
        at.Batch.from_pyarrow(t.to_batches()[0]), ["k"],
        [("sum", "v"), ("count_all",)], max_groups_per_shard=64)
    jlens = [len(b) for b in jout.batches]
    jt = jout.to_pyarrow()
    abs_sums = {}
    for k, v in zip(t["k"].to_pylist(), t["v"].to_pylist()):
        abs_sums[k] = abs_sums.get(k, 0.0) + abs(v)
    for arrays in got:
        assert arrays["group_by.lengths"].tolist() == jlens
        k, _ = _column(arrays, "group_by", 0)
        vsum, _ = _column(arrays, "group_by", 1)
        count, _ = _column(arrays, "group_by", 2)
        assert k.tolist() == jt["k"].to_pylist()
        assert count.tolist() == jt["count_all"].to_pylist()
        for key, a, b in zip(k.tolist(), vsum.tolist(),
                             jt["v_sum"].to_pylist()):
            assert abs(a - b) <= 1e-12 * abs_sums[key] + 1e-12, (key, a, b)
        exp = t.group_by("k").aggregate([("v", "sum"), ([], "count_all")])
        assert sorted(zip(k.tolist(), count.tolist())) == \
            sorted(zip(exp["k"].to_pylist(), exp["count_all"].to_pylist()))


def _host_table(arrays, case, names) -> pa.Table:
    """A case's columns from a process's arrays, nulls where invalid."""
    cols = {}
    for i, name in enumerate(names):
        v, ok = _column(arrays, case, i)
        cols[name] = pa.array(v, mask=~ok.astype(bool))
    return pa.table(cols)


def test_two_process_raw_rows_retry_vs_jax_and_pyarrow(layout,
                                                       monkeypatch):
    """``group_by_raw_rows`` through its retry (group tables of 4 a shard,
    buckets of one local capacity; the port retries at doubled
    capacities): every process's groups equal the JAX package's 8-device
    ``group_by`` with the same options, shard for shard and row for row,
    counts exactly, and pyarrow's as a set."""
    _, got = layout
    calls = []
    retried = DistContext.group_by_raw_rows

    def counted(self, *a, **kw):
        calls.append(kw.get("bucket_factor"))
        return retried(self, *a, **kw)
    monkeypatch.setattr(DistContext, "group_by_raw_rows", counted)
    from arrow_tpu_torch.entry import dist_case_step
    dist_case_step(DistContext(devices=["cpu"] * N_SHARDS),
                   "raw_rows_retry")()
    assert len(calls) > 1, calls        # the case does go through a retry
    rng = np.random.default_rng(0)
    t = pa.table({"k": rng.zipf(1.5, 4096) % 74,
                  "w": rng.integers(0, 50, 4096)})
    jout = JDistContext().group_by(
        at.Batch.from_pyarrow(t.to_batches()[0]), ["k"],
        [("count_distinct", "w"), ("count_all",)], max_groups_per_shard=4,
        bucket_factor=1)
    jt = jout.to_pyarrow()
    exp = t.group_by("k").aggregate([("w", "count_distinct"),
                                     ([], "count_all")])
    names = ["k", "w_count_distinct", "count_all"]
    for arrays in got:
        assert arrays["raw_rows_retry.lengths"].tolist() == \
            [len(b) for b in jout.batches]
        mine = _host_table(arrays, "raw_rows_retry", names)
        for name in names:
            assert mine[name].to_pylist() == jt[name].to_pylist(), name
        assert sorted(zip(*[mine[c].to_pylist() for c in names])) == \
            sorted(zip(*[exp[c].to_pylist() for c in names]))


def test_two_process_join_vs_jax(layout):
    """The full outer join: the rows of every process as a multiset equal
    the JAX package's 8-device run's (a null key matches nothing)."""
    _, got = layout
    from arrow_tpu_torch.entry import dist_case_step
    port = dist_case_step(DistContext(devices=["cpu"] * N_SHARDS), "join")()
    rng = np.random.default_rng(0)
    keys = rng.permutation(74)
    lk = rng.integers(0, 74, 4096)
    lvalid = rng.random(4096) >= 0.03
    lv = rng.integers(-1000, 1000, 4096)
    rk, rv = keys[:37], rng.standard_normal(37)
    left = pa.table({"k": pa.array(lk, mask=~lvalid), "lv": pa.array(lv)})
    right = pa.table({"k": pa.array(rk), "rv": pa.array(rv)})
    from arrow_tpu.acero.options import HashJoinNodeOptions as JOptions
    jout = JDistContext().join(
        at.Batch.from_pyarrow(left.to_batches()[0]),
        at.Batch.from_pyarrow(right.to_batches()[0]),
        JOptions("full outer", ["k"], ["k"], right_output=["k", "rv"],
                 output_suffix_for_right="_r", max_build_rows=74))
    want = sorted(zip(*[c.to_pylist() for c in jout.to_pyarrow().columns]),
                  key=repr)
    assert sorted(zip(*[c.to_pylist()
                        for c in port.to_pyarrow().columns]),
                  key=repr) == want
    for arrays in got:
        cols = []
        for i in range(4):
            v, ok = _column(arrays, "join", i)
            cols.append([x if o else None for x, o in zip(v.tolist(),
                                                           ok.tolist())])
        assert sorted(zip(*cols), key=repr) == want


@pytest.mark.parametrize("placement", ["at_end", "at_start"])
def test_two_process_sort_vs_pyarrow(layout, placement):
    """The rows of every process in order equal pyarrow's stable sort by
    (k1 ascending, k2 descending), nulls where ``null_placement`` says
    (the JAX package routes null primary keys by their storage: C18)."""
    _, got = layout
    rng = np.random.default_rng(0)
    k1 = pa.array(rng.integers(0, 37, 4096),
                  mask=~(rng.random(4096) >= 0.05))
    k2 = pa.array(rng.integers(-100, 100, 4096).astype(np.int32),
                  mask=~(rng.random(4096) >= 0.05))
    v = pa.array(rng.standard_normal(4096))
    t = pa.table({"k1": k1, "k2": k2, "v": v})
    exp = t.sort_by([("k1", "ascending", placement),
                     ("k2", "descending", placement)])
    case = f"sort_{placement}"
    for arrays in got:
        for i, name in enumerate(("k1", "k2", "v")):
            vals, ok = _column(arrays, case, i)
            assert [x if o else None for x, o in zip(
                vals.tolist(), ok.tolist())] == exp[name].to_pylist(), name


def test_two_process_capacity_errors_raise_on_every_rank(layout):
    _, got = layout
    msgs = [str(a["too_small_raises.error"]) for a in got]
    assert msgs[0] == msgs[1]
    assert "raise max_groups_per_shard" in msgs[0]
    assert "distributed join" in msgs[0]


def test_two_process_q3_small_fanout_raises_on_every_rank(layout):
    """A fanout of 2 rows a shard in the Q3 Declaration's streaming join:
    a shard's probe output outgrows it mid-stream, and every process
    reaches the join's finish and raises the same gathered error."""
    _, got = layout
    msgs = [str(a["q3_fanout_raises.error"]) for a in got]
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("distributed join overflow"), msgs[0]


def test_two_process_uint64_and_dictionary_keys_vs_numpy(layout):
    _, got = layout
    rng = np.random.default_rng(0)
    k = (np.uint64(1) << np.uint64(63)) + \
        rng.integers(0, 37, 4096).astype(np.uint64)
    v = rng.integers(0, 1 << 62, 4096).astype(np.uint64) << np.uint64(1)
    for arrays in got:
        keys = _column(arrays, "uint64", 0)[0].view(np.uint64)
        mins = _column(arrays, "uint64", 1)[0].view(np.uint64)
        maxs = _column(arrays, "uint64", 2)[0].view(np.uint64)
        assert sorted(keys.tolist()) == sorted(set(k.tolist()))
        for key, lo, hi in zip(keys, mins, maxs):
            assert lo == v[k == key].min() and hi == v[k == key].max()
        # the dictionary key's groups name every word once
        codes, ok = _column(arrays, "dict_key", 0)
        words = arrays["dict_key.0.dictionary"].tobytes()
        offs = arrays["dict_key.0.dictionary_offsets"]
        names = [words[offs[c]:offs[c + 1]].decode() if o else None
                 for c, o in zip(codes.tolist(), ok.tolist())]
        assert sorted(n for n in names if n is not None) == \
            [f"name{i:04d}" for i in range(37)]
        assert names.count(None) == 1


@pytest.mark.parametrize("backend,devices,error", [
    ("nccl", ["cpu"] * 4, ValueError),
    ("mpi", ["cpu"] * 4, ValueError)], ids=["nccl_on_cpu", "unknown"])
def test_initialize_refuses_a_backend_that_cannot_run(backend, devices,
                                                      error):
    """A named backend that cannot move these shards raises before any
    process group is made; nothing changes the backend quietly."""
    from arrow_tpu_torch.parallel import multihost
    with pytest.raises(error, match="backend"):
        multihost.initialize(coordinator="127.0.0.1:1", num_processes=2,
                             process_id=0, local_devices=devices,
                             backend=backend)
    assert not multihost.is_initialized()


_EXCHANGE_WORKER = r"""
import sys, numpy as np, torch, torch.distributed as dist, datetime
from arrow_tpu_torch.parallel import shuffle
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
P, B, L = 8, 16, 4
rng = np.random.default_rng(5)
# every shard's (P, B, ...) leaves: the widths and types a batch has, a
# wide unsigned and a two-limb one among them; counts under and past B
sends, counts = [], []
for s in range(P):
    c = rng.integers(0, B + 3, P)
    leaves = [torch.from_numpy(rng.integers(0, 1 << 62, (P, B)).astype(
                  np.uint64) << np.uint64(1)),
              torch.from_numpy(rng.integers(0, 1 << 16, (P, B)).astype(
                  np.uint16)),
              torch.from_numpy(rng.random((P, B)) < 0.5),
              None,
              torch.from_numpy(rng.standard_normal((P, B, 2)))]
    for x in leaves:
        if x is not None:   # rows past a bucket's count are zeros
            for p in range(P):
                x[p, min(int(c[p]), B):] = 0
    sends.append(leaves)
    counts.append(torch.from_numpy(c.astype(np.int32)))
want, want_counts = shuffle.exchange(sends, counts, ["cpu"] * P)
mine = slice(rank * L, (rank + 1) * L)
got, got_counts = shuffle.exchange(sends[mine], counts[mine], ["cpu"] * L,
                                   group=dist.group.WORLD)
for p in range(L):
    assert torch.equal(got_counts[p], want_counts[rank * L + p])
    for g, w in zip(got[p], want[rank * L + p]):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
dist.destroy_process_group()
print("EXCHANGE_OK", rank)
"""


def test_collective_exchange_meets_the_exchange_contract(tmp_path):
    """``shuffle.exchange`` across 2 gloo processes x 4 shards gives each
    process's shards what the single-controller exchange over all 8 gives
    them, byte for byte, counts too (counts past B included), for every
    leaf width and type (uint64, uint16, bool, a (B, 2) float64, a None
    leaf), every leaf in one all-to-all."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=str(root), GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", _EXCHANGE_WORKER,
                               str(r), port], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"EXCHANGE_OK {r}" in out, out[-3000:]
