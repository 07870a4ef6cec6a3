"""Port parity: dictionary columns across the exchange and through every
distributed operator (``shard_batch``, ``shuffle_batch``,
``DistContext.group_by`` / ``group_by_raw_rows`` / ``join`` / ``sort_by``,
``DistGroupBy``, ``DistHashJoin`` and the plan nodes' ``dist=``), against
the JAX package on the 8-virtual-device CPU mesh and against pyarrow; the
port runs 8 logical shards on the CPU.

A dictionary column moves its codes; each shard reads them through its
copy of the dictionary, and keys hash and match by the content the codes
name, so the same rows land on the same shards in both packages. Where the
JAX package is wrong the port is held to pyarrow and the JAX difference is
kept on record: its streaming ``DistHashJoin`` keys dictionary columns by
code (ROADMAP C21). A dictionary primary sort key and raw string columns
raise in both packages (C22; "dictionary-encode first").

Keys with nulls throughout; the words are at most 8 bytes, the names 18:
neither reaches the JAX short-string lanes' misread of a batch's last
capacity row (C19)."""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import arrow_tpu as at
import arrow_tpu.acero as jacero
import arrow_tpu_torch as att
import arrow_tpu_torch.acero as tacero
from arrow_tpu.acero.options import HashJoinNodeOptions as JOptions
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.compute.expressions import literal as jliteral
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu.parallel import DistGroupBy as JDistGroupBy
from arrow_tpu.parallel import shuffle as jshuffle
from arrow_tpu.parallel.context import _local_batch
from arrow_tpu.parallel.dist_join import DistHashJoin as JDistHashJoin
from arrow_tpu_torch.acero.options import HashJoinNodeOptions
from arrow_tpu_torch.compute.expressions import field
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import (
    SEGMENTS, SORT_KEYS_DIST_DICT, entry_dist_dict, entry_dist_sort_dict,
    entry_q3_dist, entry_q3s, example_columns_generic, example_columns_q3,
    example_columns_sort_dist_dict)
from arrow_tpu_torch.ops.hashing import hash32
from arrow_tpu_torch.parallel import (DistContext, DistGroupBy,
                                      DistHashJoin, dist_agg, shuffle)
from test_torch_acero import _drop_jax_executables  # noqa: F401 (autouse)
from test_torch_dist_group_by import _assert_same_per_shard

N = 8
WORDS = np.array(["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta",
                  "theta"])


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _port(rb):
    return batch_from_pyarrow(rb, device="cpu")


def _words(rng, n, n_words=8, null_share=0.1):
    """A dictionary<int32, utf8> column of ``n`` rows over the first
    ``n_words`` words, about ``null_share`` of them null."""
    return pa.array(WORDS[rng.integers(0, n_words, n)],
                    mask=rng.random(n) < null_share).dictionary_encode()


def _decoded(t: pa.Table) -> pa.Table:
    """``t`` with every dictionary column cast to its value type."""
    return pa.table({name: c.cast(c.type.value_type)
                      if pa.types.is_dictionary(c.type) else c
                      for name, c in zip(t.column_names, t.columns)})


def _rows(t: pa.Table):
    """The rows of ``t`` (dictionaries decoded) as a sorted multiset."""
    cols = [c.to_pylist() for c in _decoded(t).columns]
    return sorted(zip(*cols), key=lambda r: [(x is None, x) for x in r])


def _pa_sort(t: pa.Table, keys, null_placement="at_end") -> pa.Table:
    return t.take(pc.sort_indices(
        t, sort_keys=[(name, order, null_placement) for name, order in keys]))


# ---- the exchange -------------------------------------------------------------

@pytest.mark.parametrize("glen", [512, 470], ids=["full", "partly_filled"])
@pytest.mark.parametrize("keys", [["s"], ["s", "k"]],
                         ids=["dict_key", "dict_and_int64_keys"])
def test_shuffle_batch_of_a_dictionary_column_vs_jax(rng, glen, keys):
    """The raw-row shuffle by a dictionary key (with nulls): the received
    codes, validity and int64 column, the lengths and the error flags equal
    the JAX package's shard for shard, every row on the shard the content
    hash of its key names, and every received batch carries the
    dictionary."""
    cap, B = 512, 128
    t = pa.table({"s": _words(rng, cap),
                  "k": pa.array(rng.integers(-50, 50, cap))})
    rb = t.to_batches()[0]
    jb = at.Batch.from_pyarrow(rb)
    jdict = jb.column("s").dictionary
    schema = jb.schema

    def jstep(codes, valid, k):
        i = jax.lax.axis_index("d")
        local_len = jnp.clip(jnp.int32(glen) - i.astype(jnp.int32)
                             * (cap // N), 0, cap // N)
        lb = _local_batch(schema, [jdict, None], [codes, valid, k, None],
                          local_len)
        out, err = jshuffle.shuffle_batch(lb, keys, "d", N,
                                          bucket_capacity=B)
        return (out.column("s").values, out.column("s").validity,
                out.column("k").values,
                jnp.asarray(out.length, jnp.int32).reshape((1,)),
                err.reshape((1,)))

    mesh = Mesh(np.asarray(jax.devices()), ("d",))
    fn = jax.jit(jax.shard_map(
        jstep, mesh=mesh, in_specs=(P("d"), P("d"), P("d")),
        out_specs=tuple(P("d") for _ in range(5)), check_vma=False))
    want = [np.asarray(x).reshape((N, -1)) for x in fn(
        jb.column("s").values, jb.column("s").validity, jb.column("k").values)]

    pb = _port(rb).with_length(glen)
    sharded = ctx_ = DistContext(devices=["cpu"] * N)
    sharded = ctx_.shard_batch(pb)
    out = shuffle.shuffle_batch(sharded.shards, keys, ctx_.devices,
                                bucket_capacity=B)
    total = 0
    for s, (got, err) in enumerate(out):
        col = got.column("s")
        assert col.dictionary is pb.column("s").dictionary
        for g, w in zip((col.values, col.validity, got.column("k").values),
                        want[:3]):
            np.testing.assert_array_equal(g.numpy(), w[s])
        assert int(got.length) == int(want[3][s][0])
        assert int(err) == int(want[4][s][0]) == 0
        n = int(got.length)
        total += n
        place = hash32([got.column(k) for k in keys],
                       seed=shuffle.EXCHANGE_SEED) % N
        assert bool((place[:n] == s).all())
    assert total == glen


def test_shard_batch_replicates_the_dictionary(rng):
    """``shard_batch`` slices the codes and gives every shard the
    dictionary: the one object on the one device of logical shards."""
    t = pa.table({"s": _words(rng, 300), "v": pa.array(np.arange(300))})
    b = _port(t.to_batches()[0])
    sb = DistContext(devices=["cpu"] * N).shard_batch(b)
    d = b.column("s").dictionary
    assert all(x.column("s").dictionary is d for x in sb.shards)
    codes = torch.cat([x.column("s").values for x in sb.shards])
    assert torch.equal(codes[:300], b.column("s").values[:300])
    got = pa.Table.from_batches([x.to_pyarrow() for x in sb.shards])
    assert _decoded(got).equals(_decoded(t))


def test_dictionaries_move_once_per_device():
    """``dictionaries_on``: a dictionary that lies on another device is
    copied once for all the shards of a device; None passes."""
    d = att.array(np.array(["x", "y"]), device="cpu")
    moved = []

    class Spy:
        device = torch.device("meta")

        def to(self, dev):
            moved.append(dev)
            return d

    spy = Spy()
    out = shuffle.dictionaries_on([[spy, None]] * 4, ["cpu"] * 4)
    assert moved == ["cpu"]
    assert all(ds[0] is d and ds[1] is None for ds in out)


# ---- group-by -----------------------------------------------------------------

def _dict_group_table(rng, n=4096, two_keys=False):
    cols = {"k": _words(rng, n, 4)}
    if two_keys:
        cols["j"] = pa.array(rng.integers(0, 6, n),
                             mask=rng.random(n) < 0.05)
    cols["v"] = pa.array(rng.integers(0, 100, n))
    cols["x"] = pa.array(rng.standard_normal(n))
    return pa.table(cols)


@pytest.mark.parametrize("two_keys", [False, True],
                         ids=["dictionary", "dictionary_and_int64"])
def test_dist_group_by_dictionary_keys_vs_jax_and_pyarrow(ctx, jctx, rng,
                                                          two_keys):
    """``test_parallel.test_dist_group_by_dict_keys``'s shape (four words),
    null keys, and with an int64 second key: equal to the JAX package per
    shard and in row order, and as a set to pyarrow's group-by."""
    t = _dict_group_table(rng, two_keys=two_keys)
    keys = ["k", "j"] if two_keys else ["k"]
    aggs = [("sum", "v"), ("sum", "x"), ("count_all",)]
    rb = t.to_batches()[0]
    got = ctx.group_by(_port(rb), keys, aggs, max_groups_per_shard=64)
    want = jctx.group_by(at.Batch.from_pyarrow(rb), keys, aggs,
                         max_groups_per_shard=64)
    _assert_same_per_shard(got, want, _decoded(t), keys,
                           float_cols=("x_sum",))
    assert all(b.column("k").dictionary is not None for b in got.batches)
    exp = _decoded(t).group_by(keys, use_threads=False).aggregate(
        [("v", "sum"), ([], "count_all")])
    g = _decoded(got.to_pyarrow()).select(keys + ["v_sum", "count_all"])
    order = [(k, "ascending") for k in keys]
    assert g.sort_by(order).equals(exp.select(g.column_names).sort_by(order))


def test_group_by_raw_rows_dictionary_key_vs_pyarrow(ctx, rng):
    """The raw-row fallback shuffles the codes by their content hash and
    each shard groups what it received: pyarrow's groups, each on one
    shard, every shard's key column carrying the dictionary."""
    t = _dict_group_table(rng, 3000)
    got = ctx.group_by_raw_rows(_port(t.to_batches()[0]), ["k"],
                                [("count_all",), ("sum", "v")],
                                max_groups_per_shard=16,
                                pre_filter=field("v") > 10)
    sel = _decoded(t).filter(pc.greater(t["v"], 10))
    exp = sel.group_by("k", use_threads=False).aggregate(
        [([], "count_all"), ("v", "sum")])
    g = _decoded(got.to_pyarrow())
    assert g.sort_by("k").equals(exp.select(g.column_names).sort_by("k"))
    for s, b in enumerate(got.batches):
        assert b.column("k").dictionary is not None
    keys = [k for b in got.batches for k in b.to_pydict()["k"]]
    assert len(keys) == len(set(keys))


def test_dist_group_by_streaming_dictionary_key_vs_jax(ctx, jctx, rng):
    """``DistGroupBy`` over three batches that share one dictionary, then
    the state-row exchange: equal to the JAX package per shard."""
    n = 3 * 1024
    t = pa.table({"k": _words(rng, n), "v": pa.array(rng.integers(0, 9, n))})
    morsels = t.to_batches(max_chunksize=1024)
    aggs = [("sum", "v"), ("min", "v"), ("count_all",)]
    dgb = DistGroupBy(ctx, _port(morsels[0]).schema, ["k"], aggs,
                      max_groups_per_shard=16)
    jdgb = JDistGroupBy(jctx, at.Batch.from_pyarrow(morsels[0]).schema,
                        ["k"], aggs, max_groups_per_shard=16)
    state, jstate = dgb.init_state(), jdgb.init_state()
    for rb in morsels:
        state = dgb.consume(state, _port(rb))
        jstate = jdgb.consume(jstate, at.Batch.from_pyarrow(rb))
    got, want = dgb.finalize_table(state), jdgb.finalize_table(jstate)
    _assert_same_per_shard(got, want, _decoded(t), ["k"])
    assert got.num_rows == 9            # eight words and the null


def test_dist_group_by_dictionary_state_both_ways(ctx, jctx, rng):
    """The state of a dictionary key carried from and to the JAX package:
    its unique codes, validity and table leaves equal the JAX state's, and
    either package's exchange and merge of the other's state gives the JAX
    package's table."""
    t = _dict_group_table(rng, 2048, two_keys=True)
    rb = t.to_batches()[0]
    aggs = [("sum", "v"), ("count_all",)]
    keys = ["k", "j"]
    dgb = DistGroupBy(ctx, _port(rb).schema, keys, aggs,
                      max_groups_per_shard=64)
    jdgb = JDistGroupBy(jctx, at.Batch.from_pyarrow(rb).schema, keys, aggs,
                        max_groups_per_shard=64)
    pb = _port(rb)
    state = dgb.consume(dgb.init_state(), pb)
    jstate = jdgb.consume(jdgb.init_state(), at.Batch.from_pyarrow(rb))
    want = jdgb.finalize_table(jstate)
    jleaves = tuple(np.asarray(x) for x in jstate)

    ours = dist_agg.state_to_numpy(dgb, state)
    assert len(ours) == len(jleaves)
    for a, b in zip(ours, jleaves):
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    used = jleaves[1] >= 0                      # table_gid: slots in use
    np.testing.assert_array_equal(ours[0][used], jleaves[0][used])
    for a, b in zip(ours[1:], jleaves[1:]):
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b)
    back = jdgb.finalize_table(tuple(jnp.asarray(x) for x in ours))
    _assert_same_per_shard(dgb.finalize_table(state), back, _decoded(t),
                           keys)

    fresh = DistGroupBy(ctx, pb.schema, keys, aggs, max_groups_per_shard=64)
    carried = dist_agg.state_from_numpy(
        fresh, jleaves, {"k": pb.column("k").dictionary})
    _assert_same_per_shard(fresh.finalize_table(carried), want, _decoded(t),
                           keys)


def test_plan_dist_aggregate_dictionary_key_vs_jax(ctx, jctx, rng):
    """An aggregate node with ``dist=`` keyed by a dictionary column over a
    stream of 256-row batches: the JAX package's dist plan's groups."""
    n = 2048
    t = pa.table({"k": _words(rng, n), "v": pa.array(rng.integers(0, 50, n))})

    def run(A, src, fld, dist):
        return A.Declaration.from_sequence([
            src, A.Declaration("filter", A.FilterNodeOptions(fld("v") > 5)),
            A.Declaration("aggregate", A.AggregateNodeOptions(
                [A.AggregateSpec("sum", "v"), A.AggregateSpec("count_all")],
                keys=["k"], max_groups=16, dist=dist))]).to_table()

    got = run(tacero, tacero.Declaration("table_source",
                                         tacero.TableSourceNodeOptions(
                                             att.Table.from_pyarrow(
                                                 t, max_rows_per_batch=256,
                                                 device="cpu"))),
              field, ctx)
    want = run(jacero, jacero.Declaration("table_source",
                                          jacero.TableSourceNodeOptions(
                                              t, max_batch_rows=256)),
               jfield, jctx)
    g = _decoded(got.to_pyarrow()).sort_by("k")
    assert g.equals(_decoded(want.to_pyarrow()).sort_by("k"))
    assert g.num_rows == 9


# ---- join ---------------------------------------------------------------------

JOIN_TYPES = ["inner", "left outer", "left semi", "left anti",
              "right outer", "full outer", "right semi", "right anti"]


def _cross_dictionary_sides(rng, n=512, key_nulls=0.05):
    """``test_dist_join_dict_keys_cross_dictionary``'s sides: probe keys
    over eight words, build keys over four of them, each side with its own
    dictionary; the probe keys with nulls."""
    lk = _words(rng, n, 8, key_nulls)
    rk = pa.array(WORDS[[0, 2, 4, 6]]).dictionary_encode()
    left = pa.record_batch({"k": lk, "v": pa.array(np.arange(n))})
    right = pa.record_batch({"k": rk, "w": pa.array([10, 20, 30, 40])})
    return left, right


@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_dist_join_cross_dictionary_vs_jax_and_pyarrow(ctx, jctx, rng,
                                                       join_type):
    """``DistContext.join`` on dictionary keys whose two sides have
    different dictionaries: keyed by content, the rows of pyarrow's join,
    equal per shard to the JAX package's, every dictionary column carrying
    a dictionary."""
    lb, rb = _cross_dictionary_sides(rng)
    kw = dict(right_output=["w"], max_build_rows=64)
    got = ctx.join(_port(lb), _port(rb),
                   HashJoinNodeOptions(join_type, ["k"], ["k"], **kw),
                   fanout_per_shard=4 * 512)
    want = jctx.join(at.Batch.from_pyarrow(lb), at.Batch.from_pyarrow(rb),
                     JOptions(join_type, ["k"], ["k"], **kw),
                     fanout_per_shard=4 * 512)
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        assert _rows(pa.Table.from_batches([gb.to_pyarrow()])) == \
            _rows(pa.Table.from_batches([wb.to_pyarrow()]))
        for f, a in zip(gb.schema.fields, gb.arrays):
            assert (a.dictionary is not None) == \
                (f.type.id.startswith("dictionary"))
    lt, rt = _decoded(pa.table(lb)), _decoded(pa.table(rb))
    exp = lt.join(rt, keys="k", join_type=join_type)
    g = _decoded(got.to_pyarrow())
    assert g.num_rows == exp.num_rows
    if join_type not in ("right outer", "full outer"):
        assert _rows(g) == _rows(exp.select(g.column_names))


def _dist_hash_join(dhj, build, probe):
    acc = dhj.init_build()
    for rb in build:
        acc = dhj.consume_build(acc, rb)
    ps = dhj.finish_build(acc)
    out = []
    for pb in probe:
        batches, ps = dhj.probe(ps, pb)
        out += batches
    return out + dhj.finish(ps)


def test_dist_hash_join_cross_dictionary_like_pyarrow(ctx, jctx, rng):
    """ROADMAP C21: the streaming ``DistHashJoin`` on the cross-dictionary
    keys. The port keys them by content and gives pyarrow's rows (and the
    rows of its own ``DistContext.join``); the JAX package's shard-local
    batches carry no dictionary, so it keys them by code and does not."""
    lb, rb = _cross_dictionary_sides(rng, key_nulls=0.0)
    opts = dict(right_output=["w"], max_build_rows=64)
    dhj = DistHashJoin(ctx, _port(lb).schema, _port(rb).schema,
                       HashJoinNodeOptions("inner", ["k"], ["k"], **opts),
                       fanout_per_shard=4 * 512)
    out = _dist_hash_join(dhj, [_port(rb)], [_port(lb.slice(0, 256)),
                                             _port(lb.slice(256))])
    got = pa.Table.from_batches([b.to_pyarrow() for b in out])
    exp = _decoded(pa.table(lb)).join(_decoded(pa.table(rb)), keys="k",
                                      join_type="inner")
    assert _rows(got) == _rows(exp.select(got.column_names))
    one_shot = ctx.join(_port(lb), _port(rb), HashJoinNodeOptions(
        "inner", ["k"], ["k"], **opts), fanout_per_shard=4 * 512)
    assert _rows(one_shot.to_pyarrow()) == _rows(got)

    jb, jl = at.Batch.from_pyarrow(rb), at.Batch.from_pyarrow(lb)
    jdhj = JDistHashJoin(jctx, jl.schema, jb.schema,
                         JOptions("inner", ["k"], ["k"], **opts),
                         fanout_per_shard=4 * 512)
    jout = _dist_hash_join(jdhj, [jb], [jl])
    jgot = pa.Table.from_batches([b.to_pyarrow() for b in jout])
    assert jgot.num_rows != exp.num_rows
    assert _rows(jgot) != _rows(exp.select(jgot.column_names))


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "right anti"])
def test_dist_hash_join_dictionary_payloads_vs_pyarrow(ctx, rng, join_type):
    """``DistHashJoin`` on an int64 key with a dictionary payload on each
    side, the build side in three batches: pyarrow's rows, the build
    payload read through the build side's dictionary and the tails' null
    probe columns carrying the probe side's."""
    nl, nr = 1500, 400
    l = pa.table({"k": pa.array(rng.integers(0, 300, nl)),
                  "ls": _words(rng, nl)})
    r = pa.table({"k": pa.array(rng.integers(0, 300, nr)),
                  "rs": _words(rng, nr, 5)})
    opts = HashJoinNodeOptions(join_type, ["k"], ["k"], max_build_rows=512,
                               output_suffix_for_left="_l",
                               output_suffix_for_right="_r")
    dhj = DistHashJoin(ctx, _port(l.to_batches()[0]).schema,
                       _port(r.to_batches()[0]).schema, opts,
                       fanout_per_shard=1 << 12)
    out = _dist_hash_join(
        dhj, [_port(b) for b in r.to_batches(max_chunksize=150)],
        [_port(b) for b in l.to_batches(max_chunksize=750)])
    for b in out:
        for f, a in zip(b.schema.fields, b.arrays):
            if f.type.id.startswith("dictionary"):
                assert a.dictionary is not None and a.dictionary.capacity > 0
    got = pa.Table.from_batches([b.to_pyarrow() for b in out])
    exp = _decoded(l).join(_decoded(r), keys="k", join_type=join_type,
                           left_suffix="_l", right_suffix="_r",
                           coalesce_keys=False)
    assert _rows(got) == _rows(exp.select(got.column_names))


# ---- sort ---------------------------------------------------------------------

@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_dist_sort_dictionary_secondary_key_vs_jax_and_pyarrow(ctx, jctx, rng,
                                                               order):
    """An int64 primary key with many ties, then a dictionary key (nulls
    last) by its values: row for row pyarrow's sort and the JAX
    package's, on the JAX package's shards."""
    n = 2048
    t = pa.table({"a": pa.array(rng.integers(0, 30, n)),
                  "s": _words(rng, n),
                  "i": pa.array(np.arange(n))})
    keys = [("a", "ascending"), ("s", order)]
    rb = t.to_batches()[0]
    got = ctx.sort_by(_port(rb), keys)
    want = jctx.sort_by(at.Batch.from_pyarrow(rb), keys)
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    g = _decoded(got.to_pyarrow())
    assert g.equals(_decoded(want.to_pyarrow()))
    assert g.equals(_pa_sort(_decoded(t), keys))


def test_dist_sort_dictionary_primary_key_raises_like_jax(ctx, jctx, rng):
    """ROADMAP C22: neither package range-partitions on a dictionary."""
    t = pa.table({"s": _words(rng, 256), "v": pa.array(np.arange(256))})
    rb = t.to_batches()[0]
    with pytest.raises(NotImplementedError) as e:
        ctx.sort_by(_port(rb), [("s", "ascending")])
    with pytest.raises(NotImplementedError) as j:
        jctx.sort_by(at.Batch.from_pyarrow(rb), [("s", "ascending")])
    assert str(e.value) == str(j.value)


# ---- raw strings are refused ----------------------------------------------------

def _raw_string_batch():
    rb = pa.record_batch({"k": pa.array(np.arange(16)),
                          "s": pa.array([f"s{i}" for i in range(16)])})
    return _port(rb), at.Batch.from_pyarrow(rb)


@pytest.mark.parametrize("where", ["shard_batch", "shuffle", "build"])
def test_raw_strings_are_refused_like_jax(ctx, jctx, where):
    """A plain string column raises "dictionary-encode first" at the
    split over the mesh, the shuffle and the streaming join's build, with
    the JAX package's words."""
    tb, jb = _raw_string_batch()
    if where == "shard_batch":
        calls = (lambda: ctx.shard_batch(tb), lambda: jctx.shard_batch(jb))
    elif where == "shuffle":
        calls = (lambda: shuffle.partition_for_exchange(tb, ["k"], N, 16),
                 lambda: jshuffle._column_leaves(jb))
    else:
        opts = dict(max_build_rows=64)
        calls = (lambda: DistHashJoin(
                     ctx, tb.schema, tb.schema,
                     HashJoinNodeOptions("inner", ["k"], ["k"], **opts))
                 .init_build(),
                 lambda: JDistHashJoin(
                     jctx, jb.schema, jb.schema,
                     JOptions("inner", ["k"], ["k"], **opts)).init_build())
    with pytest.raises(NotImplementedError) as e:
        calls[0]()
    with pytest.raises(NotImplementedError) as j:
        calls[1]()
    assert str(e.value) == str(j.value)
    assert "dictionary-encode first" in str(e.value)


def test_dist_group_by_on_plain_strings_raises_at_consume(ctx):
    """``DistGroupBy`` takes a raw string key's schema, as the JAX package
    does; the batch raises at ``consume``'s split over the mesh."""
    tb, _ = _raw_string_batch()
    dgb = DistGroupBy(ctx, tb.schema, ["s"], [("count_all",)],
                      max_groups_per_shard=16)
    state = dgb.init_state()
    with pytest.raises(NotImplementedError, match="dictionary-encode first"):
        dgb.consume(state, tb)


# ---- the entry points -------------------------------------------------------------

def _jax_q3_dist(li, od, cu, ctx, segment, max_groups=256):
    """The JAX package's Q3 Declaration with ``dist=ctx``, customers
    filtered by ``c_mktsegment == segment``, in 64-row batches."""
    A = jacero
    li_t, od_t, cu_t = (at.Table.from_pyarrow(t, max_rows_per_batch=64)
                        for t in (li, od, cu))
    f, lit = jfield, jliteral
    co = A.Declaration("hashjoin", A.HashJoinNodeOptions(
        "inner", left_keys=["o_custkey"], right_keys=["c_custkey"],
        left_output=["o_orderkey", "o_date"], right_output=[],
        max_build_rows=max(cu.num_rows, 16), dist=ctx), inputs=[
            A.Declaration.from_sequence([
                A.Declaration("table_source", A.TableSourceNodeOptions(od_t)),
                A.Declaration("filter", A.FilterNodeOptions(
                    f("o_date") < lit(25)))]),
            A.Declaration.from_sequence([
                A.Declaration("table_source", A.TableSourceNodeOptions(cu_t)),
                A.Declaration("filter", A.FilterNodeOptions(
                    f("c_mktsegment") == segment))])])
    return A.Declaration.from_sequence([
        A.Declaration("hashjoin", A.HashJoinNodeOptions(
            "inner", left_keys=["l_orderkey"], right_keys=["o_orderkey"],
            left_output=["l_orderkey", "l_price", "l_disc"],
            right_output=["o_date"], max_build_rows=max(od.num_rows, 16),
            dist=ctx), inputs=[A.Declaration.from_sequence([
                A.Declaration("table_source", A.TableSourceNodeOptions(li_t)),
                A.Declaration("filter", A.FilterNodeOptions(
                    f("l_ship") > lit(40)))]), co]),
        A.Declaration("project", A.ProjectNodeOptions(
            [f("l_orderkey"), f("l_price") * (lit(1.0) - f("l_disc")),
             f("o_date")], ["l_orderkey", "rev", "o_date"])),
        A.Declaration("aggregate", A.AggregateNodeOptions(
            [A.AggregateSpec("sum", "rev", name="revenue")],
            keys=["l_orderkey", "o_date"], max_groups=max_groups, dist=ctx)),
        A.Declaration("order_by", A.OrderByNodeOptions(
            [("revenue", "descending"), ("l_orderkey", "ascending")])),
        A.Declaration("fetch", A.FetchNodeOptions(0, 10)),
    ]).to_table().to_pyarrow()


def test_entry_q3_dist_with_string_segment_vs_jax_and_one_device(jctx):
    """Path 7s at a small size: ``entry_q3_dist(segment="BUILDING")``
    (768 lineitem rows, 64-row batches, 8 logical shards) gives
    ``entry_q3s``'s top 10 on the same tables and the JAX package's
    ``dist=`` plan's on its pyarrow twins."""
    step, tables = entry_q3_dist("cpu", N, 768, 7, 256, 64, "BUILDING")
    cu = tables[2]
    assert cu.schema.field("c_mktsegment").type.id.startswith("dictionary")
    got = step(*tables).to_pyarrow()
    one, tables1 = entry_q3s("cpu", 768, 7, 256, 64)
    li, od, cu = example_columns_q3(768, 7)
    cus = pa.table({"c_custkey": cu["c_custkey"],
                    "c_mktsegment": pa.DictionaryArray.from_arrays(
                        pa.array(cu["c_seg"]), pa.array(list(SEGMENTS)))})
    jax_dist = _jax_q3_dist(pa.table(li), pa.table(od), cus, jctx,
                            "BUILDING")
    for want in (one(*tables1).to_pyarrow(), jax_dist):
        assert got.num_rows == want.num_rows == 10
        assert got["l_orderkey"].to_pylist() == \
            want["l_orderkey"].to_pylist()
        assert got["o_date"].to_pylist() == want["o_date"].to_pylist()
        # each adds a group's rows in its own order (rev is positive)
        g = np.asarray(got["revenue"], dtype=np.float64)
        w = np.asarray(want["revenue"], dtype=np.float64)
        assert (np.abs(g - w) <= 1e-12 * w + 1e-12).all(), (g, w)


def test_entry_dist_dict_vs_numpy_and_jax(jctx):
    """Path 3s at a small size: ``entry_dist_dict`` (4096 rows, 300 names,
    w > 0) against the numpy oracle by the names' indices, and equal per
    shard to the JAX package's group-by of the same dictionary column."""
    step, (b,) = entry_dist_dict("cpu", N, 4096, 300, 256, 3)
    got = step(b)
    cols = example_columns_generic(4096, 300, 3)
    keep = cols["w"] > 0
    d = got.to_pydict()
    idx = np.array([int(x[len("Customer#"):]) - 1 for x in d["name"]])
    assert len(set(idx.tolist())) == len(idx) == \
        len(np.unique(cols["k"][keep]))
    count = np.bincount(cols["k"][keep], minlength=300)
    assert np.array_equal(np.asarray(d["count_all"]), count[idx])
    wmin = {k: cols["w"][keep & (cols["k"] == k)].min() for k in idx}
    assert d["w_min"] == [int(wmin[k]) for k in idx]
    vsum = np.bincount(cols["k"][keep], cols["v"][keep], minlength=300)
    assert np.allclose(d["v_sum"], vsum[idx], rtol=1e-12, atol=1e-12)
    pb = b.to_pyarrow()
    jb = at.Batch.from_pyarrow(pb)
    want = jctx.group_by(jb, ["name"], [("sum", "v"), ("min", "w"),
                                        ("count_all",)],
                         max_groups_per_shard=256,
                         pre_filter=jfield("w") > 0)
    _assert_same_per_shard(got, want, _decoded(pa.Table.from_batches([pb])),
                           ["name"], float_cols=("v_sum",))


def test_entry_dist_sort_dict_vs_numpy_and_jax(jctx):
    """Path 7e at a small size: ``entry_dist_sort_dict`` (k1 ascending,
    then the dictionary string s descending, nulls last) equals numpy's
    stable sort by (k1, the descending rank of s) index for index, and the
    JAX package's shards row for row."""
    n = 4096
    step, (b,) = entry_dist_sort_dict("cpu", N, n, 5, 100)
    got = step(b)
    cols = example_columns_sort_dist_dict(n, 100, 5)
    # the words cat%04d sort as their indices; numpy's lexsort is stable
    # and its last key the primary: k1, then the null flag, then -index
    perm = np.lexsort((np.where(cols["s_valid"], -cols["s_idx"], 0),
                       ~cols["s_valid"], cols["k1"]))
    g = got.to_pyarrow()
    assert np.array_equal(np.asarray(g["k1"]), cols["k1"][perm])
    assert np.array_equal(np.asarray(g["v"]), cols["v"][perm])
    s = _decoded(g)["s"].to_pylist()
    assert s == [f"cat{i:04d}" if ok else None for i, ok in
                 zip(cols["s_idx"][perm], cols["s_valid"][perm])]
    want = jctx.sort_by(at.Batch.from_pyarrow(b.to_pyarrow()),
                        SORT_KEYS_DIST_DICT)
    assert [len(x) for x in got.batches] == [len(x) for x in want.batches]
    assert _decoded(g).equals(_decoded(want.to_pyarrow()))
