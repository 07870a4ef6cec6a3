"""Port parity: the distributed hash join (``DistContext.join`` and the
streaming ``DistHashJoin``) against the JAX package on the 8-virtual-device
CPU mesh; the port runs 8 logical shards on the CPU.

The same shards must hold rows, and on each shard the rows must be an equal
multiset: integers and nulls exact, floats by their bits (a join moves
values, it computes none). The union is also held against pyarrow's join,
as the JAX package's own test does."""

import re

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu.acero.options import HashJoinNodeOptions as JOptions
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.acero.options import HashJoinNodeOptions
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import entry_dist_join, example_columns_join
from arrow_tpu_torch.ops.hashing import hash32
from arrow_tpu_torch.parallel import DistContext, DistHashJoin, shuffle
from test_torch_acero import _rows

N = 8
JOIN_TYPES = ["inner", "left outer", "left semi", "left anti",
              "right outer", "full outer", "right semi", "right anti"]


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _port(b):
    return batch_from_pyarrow(b, device="cpu")


def _assert_same_shards(got, want):
    """The port's and the JAX package's per-shard batches: equal lengths
    in shard order, and each shard an equal multiset of rows."""
    assert got.schema.to_pyarrow().equals(want.schema.to_pyarrow())
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        g = pa.Table.from_batches([gb.to_pyarrow()])
        w = pa.Table.from_batches([wb.to_pyarrow()])
        assert _rows(g) == _rows(w)


def _assert_like_pyarrow(got: pa.Table, exp: pa.Table, join_type: str):
    """``test_parallel.test_dist_join``'s comparison with pyarrow: the row
    count, the key multiset where pyarrow does not coalesce the keys, and
    the build payload's multiset."""
    assert got.num_rows == exp.num_rows, (join_type, got.num_rows,
                                          exp.num_rows)
    key = (lambda x: (x is None, x))
    if "k" in got.column_names and "k" in exp.column_names and \
            join_type not in ("right outer", "full outer"):
        assert sorted(got["k"].to_pylist(), key=key) == \
            sorted(exp["k"].to_pylist(), key=key)
    if "rv" in got.column_names:
        assert sorted(got["rv"].to_pylist(), key=key) == \
            sorted(exp["rv"].to_pylist(), key=key)


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_dist_join_vs_jax(ctx, jctx, rng, join_type):
    nl, nr = 2048, 512
    lk = rng.integers(0, 800, nl)
    l = pa.table({"k": pa.array(lk, mask=rng.random(nl) < 0.05),
                  "lv": pa.array(rng.standard_normal(nl),
                                 mask=rng.random(nl) < 0.1)})
    r = pa.table({"k": pa.array(rng.permutation(800)[:nr]),
                  "rv": pa.array(rng.standard_normal(nr))})
    lb, rb = l.to_batches()[0], r.to_batches()[0]
    kw = dict(right_output=["rv"], max_build_rows=1024)
    got = ctx.join(_port(lb), _port(rb),
                   HashJoinNodeOptions(join_type, ["k"], ["k"], **kw),
                   fanout_per_shard=2048)
    want = jctx.join(at.Batch.from_pyarrow(lb), at.Batch.from_pyarrow(rb),
                     JOptions(join_type, ["k"], ["k"], **kw),
                     fanout_per_shard=2048)
    _assert_same_shards(got, want)
    _assert_like_pyarrow(got.to_pyarrow(), l.join(r, keys="k",
                                                  join_type=join_type),
                         join_type)


def test_dist_join_duplicate_build_keys_two_columns_vs_jax(ctx, jctx, rng):
    """Duplicate build keys (pairs fan out), a two-column key with an int32
    lane, unsigned payload."""
    nl, nr = 1500, 700
    l = pa.table({"a": pa.array(rng.integers(0, 30, nl)),
                  "b": pa.array(rng.integers(0, 4, nl).astype(np.int32)),
                  "lv": pa.array(rng.integers(0, 1 << 64, nl,
                                              dtype=np.uint64))})
    r = pa.table({"a": pa.array(rng.integers(0, 30, nr)),
                  "b": pa.array(rng.integers(0, 4, nr).astype(np.int32)),
                  "rv": pa.array(rng.standard_normal(nr).astype(np.float32))})
    lb, rb = l.to_batches()[0], r.to_batches()[0]
    kw = dict(right_output=["rv"], max_build_rows=1024)
    got = ctx.join(_port(lb), _port(rb), HashJoinNodeOptions(
        "inner", ["a", "b"], ["a", "b"], **kw), fanout_per_shard=1 << 14)
    want = jctx.join(at.Batch.from_pyarrow(lb), at.Batch.from_pyarrow(rb),
                     JOptions("inner", ["a", "b"], ["a", "b"], **kw),
                     fanout_per_shard=1 << 14)
    _assert_same_shards(got, want)
    exp = l.join(r, keys=["a", "b"], join_type="inner")
    assert got.num_rows == exp.num_rows
    assert _rows(got.to_pyarrow()) == _rows(exp.select(["a", "b", "lv",
                                                        "rv"]))


def test_dist_join_build_capacity_raises_like_jax(ctx, jctx, rng):
    """More distinct build keys on a shard than ``max_build_rows``: both
    packages raise at collect with the per-shard error flags."""
    l = pa.table({"k": pa.array(rng.integers(0, 4000, 512))})
    r = pa.table({"k": pa.array(rng.permutation(4000)[:1024])})
    lb, rb = l.to_batches()[0], r.to_batches()[0]
    with pytest.raises(RuntimeError, match="distributed join overflow") as e:
        ctx.join(_port(lb), _port(rb), HashJoinNodeOptions(
            "inner", ["k"], ["k"], max_build_rows=64))
    with pytest.raises(RuntimeError, match="distributed join overflow") as j:
        jctx.join(at.Batch.from_pyarrow(lb), at.Batch.from_pyarrow(rb),
                  JOptions("inner", ["k"], ["k"], max_build_rows=64))
    assert str(e.value) == str(j.value)


@pytest.mark.parametrize("join_type", ["inner", "left anti", "full outer",
                                       "right semi"])
def test_dist_hash_join_streaming_vs_pyarrow(ctx, rng, join_type):
    """``DistHashJoin`` over a build stream of three batches and a probe
    stream of two gives the rows of pyarrow's join."""
    nl, nr = 3000, 900
    l = pa.table({"k": pa.array(rng.integers(0, 500, nl)),
                  "lv": pa.array(rng.integers(0, 100, nl))})
    r = pa.table({"k": pa.array(rng.integers(0, 500, nr)),
                  "rv": pa.array(rng.standard_normal(nr))})
    opts = HashJoinNodeOptions(join_type, ["k"], ["k"], max_build_rows=1024,
                               output_suffix_for_left="_l",
                               output_suffix_for_right="_r")
    dhj = DistHashJoin(ctx, _port(l.slice(0, 1).to_batches()[0]).schema,
                       _port(r.slice(0, 1).to_batches()[0]).schema, opts,
                       fanout_per_shard=1 << 13)
    acc = dhj.init_build()
    for rb in r.to_batches(max_chunksize=300):
        acc = dhj.consume_build(acc, _port(rb))
    ps = dhj.finish_build(acc)
    out = []
    for lb in l.to_batches(max_chunksize=1500):
        batches, ps = dhj.probe(ps, _port(lb))
        out += batches
    out += dhj.finish(ps)
    got = pa.Table.from_batches([b.to_pyarrow() for b in out])
    exp = l.join(r, keys="k", join_type=join_type, left_suffix="_l",
                 right_suffix="_r", coalesce_keys=False)
    assert _rows(got) == _rows(exp.select(got.column_names))


def test_dist_hash_join_build_capacity_raises_at_finish(ctx, rng):
    """Rows past ``max_build_rows`` on a shard's accumulation drop and set
    its error flag; ``finish`` raises the JAX package's message."""
    r = pa.table({"k": pa.array(np.zeros(600, np.int64))})
    dhj = DistHashJoin(ctx, _port(r.to_batches()[0]).schema,
                       _port(r.to_batches()[0]).schema,
                       HashJoinNodeOptions("inner", ["k"], ["k"],
                                           max_build_rows=256))
    b = _port(r.to_batches()[0])
    acc = dhj.consume_build(dhj.init_build(), b)
    ps = dhj.finish_build(acc)
    hot = int(hash32([b.column("k")], seed=shuffle.EXCHANGE_SEED)[0] % N)
    flags = [int(s == hot) for s in range(N)]
    assert [int(a.length) for a in acc] == [256 * f for f in flags]
    with pytest.raises(RuntimeError, match=re.escape(
            f"distributed join overflow (per-shard errors={flags})")):
        dhj.finish(ps)


def test_entry_dist_join_rows_on_their_shards(jctx):
    """``entry_dist_join``: the multiset of numpy's inner join, every row
    on the shard ``hash32`` of its key names, equal per shard to the JAX
    package's join."""
    step, (bb, pb) = entry_dist_join("cpu", N, 512, 4096, 3)
    got = step(bb, pb)
    bcols, pcols = example_columns_join(512, 4096, 3)
    rv = dict(zip(bcols["k"].tolist(), bcols["rv"].tolist()))
    exp = pa.table({"k": [k for k in pcols["k"].tolist() if k in rv],
                    "lv": pcols["lv"][np.isin(pcols["k"], bcols["k"])],
                    "rv": [rv[k] for k in pcols["k"].tolist() if k in rv]})
    assert _rows(got.to_pyarrow()) == _rows(exp)
    assert len(got.batches) == N
    for s, b in enumerate(got.batches):
        dest = hash32([b.column("k")], seed=shuffle.EXCHANGE_SEED) % N
        assert bool((dest[:len(b)] == s).all())
    want = jctx.join(at.batch(pcols), at.batch(bcols), JOptions(
        "inner", left_keys=["k"], right_keys=["k"], right_output=["rv"],
        max_build_rows=512))
    _assert_same_shards(got, want)
