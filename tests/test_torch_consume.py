"""Port parity: ``HashAggregate.consume`` (the sort-grouping routes:
generic, range-packed, and ``first``) against the JAX package on the same
pyarrow data.

Groups and their first-appearance order, keys, nulls, counts, integer sums,
every min / max (NaN included), the grouper's table, the uniques and the
error flags must match exactly. Float sums and means are summed in another
order by the two packages: f64 within |diff| <= 1e-12 * sum(|v|) + 1e-12
per group, f32 within 1e-5 * sum(|v|) + 1e-6.
"""

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops.agg_options import CountOptions as JCountOptions
from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
from arrow_tpu.ops.hash_aggregate import HashAggregate as JHashAggregate
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.ops.agg_options import CountOptions
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, HashAggregate

TOL = {np.dtype(np.float64): (1e-12, 1e-12),
       np.dtype(np.float32): (1e-5, 1e-6)}


def _specs(J, cols=("v", "w")):
    """All six aggregators, the three count modes, over every column."""
    Spec = JSpec if J else AggregateSpec
    Count = JCountOptions if J else CountOptions
    out = [Spec("count_all")]
    for c in cols:
        out += [Spec("sum", c), Spec("min", c), Spec("max", c),
                Spec("mean", c), Spec("count", c),
                Spec("count", c, Count("only_null"), name=f"{c}_nulls"),
                Spec("count", c, Count("all"), name=f"{c}_all")]
    return out


def _record_batch(rng, n, keys=("k",), key_hi=40, vtype=np.float64,
                  null_keys=True, null_values=True, nan=True):
    cols = {}
    for i, k in enumerate(keys):
        kv = rng.integers(-3, key_hi, n) if i == 0 else \
            rng.integers(0, 3, n).astype(np.int32)
        cols[k] = pa.array(kv, mask=(rng.random(n) < 0.05)
                           if null_keys else None)
    v = rng.standard_normal(n).astype(vtype)
    if nan:
        v[rng.random(n) < 0.02] = np.nan
        v[rng.random(n) < 0.01] = np.inf
        v[rng.random(n) < 0.01] = -np.inf
    w = rng.integers(-(1 << 62), 1 << 62, n)
    w[: n // 4] = rng.integers(-100, 100, n // 4)
    w[0], w[1] = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    cols["v"] = pa.array(v, mask=(rng.random(n) < 0.1)
                         if null_values else None)
    cols["w"] = pa.array(w, mask=(rng.random(n) < 0.1)
                         if null_values else None)
    return pa.record_batch(cols)


def _abs_sums(rbs, keys, col):
    out = {}
    for rb in rbs:
        ks = list(zip(*[rb[k].to_pylist() for k in keys]))
        for k, v in zip(ks, rb[col].to_pylist()):
            if v is not None and np.isfinite(v):
                out[k] = out.get(k, 0.0) + abs(v)
    return out


def _assert_same_table(got, want, rbs, keys):
    assert got.schema.names == want.schema.names
    gkeys = list(zip(*[got[k].to_pylist() for k in keys]))
    assert gkeys == list(zip(*[want[k].to_pylist() for k in keys]))
    for name in want.schema.names:
        g, w = got[name], want[name]
        assert g.type == w.type, name
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        base = name.rsplit("_", 1)[0]
        if name.endswith(("_sum", "_mean")) and pa.types.is_floating(g.type):
            src = rbs[0][base].type.to_pandas_dtype()
            # means of integers accumulate in float64
            rtol, atol = TOL.get(np.dtype(src), TOL[np.dtype(np.float64)])
            abs_sums = _abs_sums(rbs, keys, base)
            for k, a, b in zip(gkeys, g.to_pylist(), w.to_pylist()):
                if a is None or not np.isfinite(a) or not np.isfinite(b):
                    assert (a is None and b is None) or (a != a and b != b) \
                        or a == b, (name, k, a, b)
                    continue
                assert abs(a - b) <= rtol * abs_sums.get(k, 0.0) + atol, \
                    (name, k, a, b)
        else:
            np.testing.assert_array_equal(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), err_msg=name)


def _assert_same_state(tst, jst):
    """Grouper table, counters and uniques, slot for slot."""
    tg, jg = tst[0], jst[0]
    n = int(jg.num_groups)
    assert int(tg.num_groups) == n
    assert int(tg.error) == int(jg.error)
    np.testing.assert_array_equal(tg.table_gid.numpy(),
                                  np.asarray(jg.table_gid))
    used = np.asarray(jg.table_gid) >= 0
    np.testing.assert_array_equal(
        tg.table_lanes.numpy()[used],
        np.asarray(jg.table_lanes).astype(np.int64)[used])
    for tu, ju in zip(tst[2], jst[2]):
        np.testing.assert_array_equal(tu.values.numpy()[:n],
                                      np.asarray(ju.values)[:n])
        np.testing.assert_array_equal(tu.validity.numpy()[:n],
                                      np.asarray(ju.validity)[:n])


def _routes(tha, jha, tb, jb):
    """Both packages' routing of one batch from their own probes."""
    tvals = {k: v.numpy() for k, v in tha.probe_scalars(tb).items()}
    jvals = jax.device_get(jha.probe_scalars(jb))
    for k in jvals:
        np.testing.assert_array_equal(tvals[k], np.asarray(jvals[k]), k)
    return tha.probe_route(tb, tvals), jha.probe_route(jb, jvals)


def _consume_both(tha, jha, tst, jst, rb, mode, first):
    """One batch through both packages: ``mode`` "generic", or "packed"
    with the range packing each package's own probe gives."""
    tb, jb = batch_from_pyarrow(rb, device="cpu"), at.Batch.from_pyarrow(rb)
    jconsume = jax.jit(jha.consume, static_argnums=(3, 4))
    if mode == "generic":
        return (tha.consume(tst, tb, None, None, first),
                jconsume(jst, jb, None, None, first))
    (tkind, tp), (jkind, jp) = _routes(tha, jha, tb, jb)
    assert tkind == jkind == "packed"
    for a, b in zip(tp[:3], jp[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tuple(tp[3:]) == tuple(jp[3:])
    return (tha.consume(tst, tb, tuple(tp[:3]), tuple(tp[3:]), first),
            jconsume(jst, jb, tuple(jp[:3]), tuple(jp[3:]), first))


def _pair(rb, keys, cols=("v", "w"), max_groups=256):
    tb, jb = batch_from_pyarrow(rb, device="cpu"), at.Batch.from_pyarrow(rb)
    return (HashAggregate(tb.schema, list(keys), _specs(False, cols),
                          max_groups=max_groups),
            JHashAggregate(jb.schema, list(keys), _specs(True, cols),
                           max_groups=max_groups))


@pytest.mark.parametrize("first", [False, True], ids=["merge", "first"])
@pytest.mark.parametrize("mode", ["generic", "packed"])
@pytest.mark.parametrize("keys", [("k",), ("k", "k2")],
                         ids=["one_key", "two_keys"])
def test_consume_vs_jax(keys, mode, first):
    rng = np.random.default_rng(len(keys) * 10 + first)
    rb = _record_batch(rng, 1500, keys)
    tha, jha = _pair(rb, keys)
    tst, jst = _consume_both(tha, jha, tha.init_state("cpu"),
                             jha.init_state(), rb, mode, first)
    _assert_same_state(tst, jst)
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb], keys)


@pytest.mark.parametrize("vtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("null_keys,null_values", [(False, False),
                                                   (True, False),
                                                   (False, True)],
                         ids=["no_nulls", "null_keys", "null_values"])
def test_consume_nullability_and_value_types_vs_jax(null_keys, null_values,
                                                    vtype):
    rng = np.random.default_rng(77)
    rb = _record_batch(rng, 900, ("k",), vtype=vtype, null_keys=null_keys,
                       null_values=null_values)
    tha, jha = _pair(rb, ("k",))
    tst, jst = _consume_both(tha, jha, tha.init_state("cpu"),
                             jha.init_state(), rb, "generic", False)
    _assert_same_state(tst, jst)
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb], ("k",))


@pytest.mark.parametrize("vtype", [np.int32, np.int16, np.uint8, np.bool_],
                         ids=["i32", "i16", "u8", "bool"])
def test_consume_narrow_value_types_vs_jax(vtype):
    """min / max of types of at most 32 bits take the packed-cummax
    reduction."""
    rng = np.random.default_rng(5)
    n = 700
    x = rng.integers(0, 2, n).astype(vtype) if vtype is np.bool_ else \
        rng.integers(np.iinfo(vtype).min, np.iinfo(vtype).max, n,
                     dtype=np.int64, endpoint=True).astype(vtype)
    rb = pa.record_batch({
        "k": pa.array(rng.integers(0, 30, n)),
        "x": pa.array(x, mask=rng.random(n) < 0.2)})
    tb, jb = batch_from_pyarrow(rb, device="cpu"), at.Batch.from_pyarrow(rb)
    # sums of unsigned types accumulate in uint64 (the port holds the bits
    # as int64 and views them as uint64 at finalize)
    fns = ("min", "max", "sum")
    tha = HashAggregate(tb.schema, ["k"],
                        [AggregateSpec(f, "x") for f in fns], max_groups=64)
    jha = JHashAggregate(jb.schema, ["k"], [JSpec(f, "x") for f in fns],
                         max_groups=64)
    want = jha.finalize(jha.consume(jha.init_state(), jb)).to_pyarrow()
    got = tha.finalize(tha.consume(tha.init_state("cpu"), tb)).to_pyarrow()
    _assert_same_table(got, want, [rb], ("k",))


@pytest.mark.parametrize("mode,first", [("generic", False), ("generic", True),
                                        ("packed", True)],
                         ids=["generic_merge", "generic_first",
                              "packed_first"])
def test_unsigned_sums_vs_jax(mode, first):
    """Grouped sums of uint8 / uint16 / uint32 / uint64 columns accumulate
    in uint64 (held as int64 bits by the port): equal to the JAX package
    bit for bit, with totals past 2^63; then the same through ``merge`` of
    two states and through a state carried from JAX."""
    rng = np.random.default_rng(31)
    n = 1200
    cols = {"k": pa.array(rng.integers(0, 25, n))}
    for name, npd in (("a", np.uint8), ("b", np.uint16), ("c", np.uint32)):
        cols[name] = pa.array(rng.integers(0, np.iinfo(npd).max, n,
                                           dtype=npd, endpoint=True),
                              mask=rng.random(n) < 0.1)
    cols["d"] = pa.array(rng.integers(1 << 60, 1 << 64, n, dtype=np.uint64),
                         mask=rng.random(n) < 0.1)
    rb = pa.record_batch(cols)
    tb, jb = batch_from_pyarrow(rb, device="cpu"), at.Batch.from_pyarrow(rb)
    tha = HashAggregate(tb.schema, ["k"],
                        [AggregateSpec("sum", c) for c in "abcd"],
                        max_groups=64)
    jha = JHashAggregate(jb.schema, ["k"], [JSpec("sum", c) for c in "abcd"],
                         max_groups=64)
    tst, jst = _consume_both(tha, jha, tha.init_state("cpu"),
                             jha.init_state(), rb, mode, first)
    got, want = tha.finalize(tst).to_pyarrow(), jha.finalize(jst).to_pyarrow()
    assert got.equals(want)
    assert got["d_sum"].type == pa.uint64()
    assert max(got["d_sum"].to_pylist()) > (1 << 63)
    # merge of two states == the JAX merge; and a state carried from JAX
    tm = tha.finalize(tha.merge(tst, tst)).to_pyarrow()
    jm = jha.finalize(jha.merge(jst, jst)).to_pyarrow()
    assert tm.equals(jm)
    carried = tha.state_from_numpy(jax.tree_util.tree_map(np.asarray, jst),
                                   device="cpu")
    assert tha.finalize(carried).to_pyarrow().equals(want)


def test_merge_of_states_vs_jax():
    """``HashAggregate.merge``: another state's groups fold in through the
    group-id mapping; an empty other state changes nothing."""
    rng = np.random.default_rng(41)
    rb1 = _record_batch(rng, 900, ("k",), key_hi=30)
    rb2 = _record_batch(rng, 700, ("k",), key_hi=60, nan=False)
    tha, jha = _pair(rb1, ("k",), max_groups=128)
    t1, j1 = _consume_both(tha, jha, tha.init_state("cpu"), jha.init_state(),
                           rb1, "generic", False)
    t2, j2 = _consume_both(tha, jha, tha.init_state("cpu"), jha.init_state(),
                           rb2, "generic", False)
    tm, jm = tha.merge(t1, t2), jha.merge(j1, j2)
    _assert_same_state(tm, jm)
    _assert_same_table(tha.finalize(tm).to_pyarrow(),
                       jha.finalize(jm).to_pyarrow(), [rb1, rb2], ("k",))
    assert tha.merge(t1, tha.init_state("cpu")) is t1
    assert tha.supports_state_exchange and jha.supports_state_exchange


@pytest.mark.parametrize("mode", ["generic", "packed"])
def test_consume_two_batch_stream_with_carried_state(mode):
    """JAX consumes batch 1; its state, fetched as numpy, becomes the
    port's (``state_from_numpy``); both consume batch 2. Also the port alone
    over both batches (first, then merge)."""
    rng = np.random.default_rng(12)
    rb1 = _record_batch(rng, 1200, ("k",), key_hi=50)
    rb2 = _record_batch(rng, 1000, ("k",), key_hi=90, nan=False)
    tha, jha = _pair(rb1, ("k",), max_groups=128)
    _, jst1 = _consume_both(tha, jha, tha.init_state("cpu"),
                            jha.init_state(), rb1, mode, True)
    carried = tha.state_from_numpy(jax.tree_util.tree_map(np.asarray, jst1),
                                   device="cpu")
    _assert_same_state(carried, jst1)
    tst2, jst2 = _consume_both(tha, jha, carried, jst1, rb2, mode, False)
    _assert_same_state(tst2, jst2)
    want = jha.finalize(jst2).to_pyarrow()
    _assert_same_table(tha.finalize(tst2).to_pyarrow(), want, [rb1, rb2],
                       ("k",))
    # the port on its own over the stream
    own, _ = _consume_both(tha, jha, tha.init_state("cpu"), jha.init_state(),
                           rb1, mode, True)
    own, _ = _consume_both(tha, jha, own, jst1, rb2, mode, False)
    _assert_same_table(tha.finalize(own).to_pyarrow(), want, [rb1, rb2],
                       ("k",))


@pytest.mark.parametrize("first", [False, True], ids=["merge", "first"])
def test_consume_too_many_groups_sets_the_same_error_flag(first):
    rng = np.random.default_rng(3)
    rb = _record_batch(rng, 600, ("k",), key_hi=200, null_keys=False)
    tha, jha = _pair(rb, ("k",), cols=("w",), max_groups=32)
    tst, jst = _consume_both(tha, jha, tha.init_state("cpu"),
                             jha.init_state(), rb, "generic", first)
    assert int(jst[0].error) != 0
    assert int(tst[0].error) == int(jst[0].error)
    assert int(tst[0].num_groups) == int(jst[0].num_groups)


def test_row_consume_matches_grouped_consume():
    """``GroupedAggregator.consume`` (rows folded by group id) and
    ``consume_grouped`` (run reductions) give the same states."""
    rng = np.random.default_rng(8)
    rb = _record_batch(rng, 800, ("k",), nan=False)
    tb = batch_from_pyarrow(rb, device="cpu")
    tha = HashAggregate(tb.schema, ["k"], _specs(False), max_groups=64)
    grouped = tha.consume(tha.init_state("cpu"), tb)
    gstate, gids = tha.grouper.consume(tha.grouper.init_state("cpu"),
                                       [tb.column("k")])
    assert int(gstate.num_groups) == int(grouped[0].num_groups)
    for spec, agg, want in zip(tha.aggs, tha._aggregators, grouped[1]):
        values = tb.column(spec.targets[0]) if spec.targets else None
        got = agg.consume(agg.init("cpu"), values, gids)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if a.dtype.is_floating_point and spec.function != "min" \
                    and spec.function != "max":
                torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
            else:
                assert torch.equal(a, b), spec
