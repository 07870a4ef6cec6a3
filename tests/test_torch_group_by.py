"""Port parity: the sort-merge grouping primitives and HashAggregate's
dense route against the JAX package, on the same numpy data.

Integers, nulls, NaNs and group order must match exactly; f32 sums within
|diff| <= 1e-5 * sum(|x|) + 1e-6 per group (the two sum in another order).
A float min / max skips NaN in the port, as in pyarrow, and is held against
the NaN-skipping reduction of the data; the JAX package's (whose NaN wins)
against the same where it is not NaN (ROADMAP C32 (b),
``test_torch_consume._extremes``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops import distinct as jdist
from arrow_tpu.ops import segment as jseg
from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
from arrow_tpu.ops.hash_aggregate import HashAggregate as JHashAggregate
from arrow_tpu.ops.agg_options import CountOptions as JCountOptions
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import consume_routed
from arrow_tpu_torch.ops import distinct as tdist
from arrow_tpu_torch.ops import segment as tseg
from arrow_tpu_torch.ops.agg_options import CountOptions
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, HashAggregate
from test_torch_consume import _extremes


def _lanes(rng, cap, L):
    """u32 lanes with many repeats, values near 0 and near 2^32."""
    base = rng.integers(0, 6, (cap, L)).astype(np.uint32)
    return np.where(rng.random((cap, L)) < 0.3,
                    np.uint32(0xFFFFFFF0) + base, base).astype(np.uint32)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x.copy())


@pytest.mark.parametrize("L", [1, 2, 3])
def test_sort_group_vs_jax(L):
    rng = np.random.default_rng(L)
    cap = 500
    lanes = _lanes(rng, cap, L)
    active = rng.random(cap) < 0.8
    jg, _ = jdist.sort_group(jnp.asarray(lanes), jnp.asarray(active),
                             rep_capacity=64)
    tg, (s0,) = tdist.sort_group(_t(lanes), torch.from_numpy(active),
                                 rep_capacity=64, payloads=(_t(lanes[:, 0]),))
    for name in ("codes", "num_unique", "n_active", "unique_rows",
                 "gid_of_seg", "seg_of_gid", "head", "head_pos",
                 "head_pos_seg", "s_active"):
        np.testing.assert_array_equal(
            getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
            err_msg=name)
    act = np.asarray(jg.s_active)
    np.testing.assert_array_equal(tg.seg.numpy()[act],
                                  np.asarray(jg.seg)[act])
    # payloads ride the sort: lane 0 in sorted order
    np.testing.assert_array_equal(s0.numpy()[act],
                                  lanes[np.asarray(jg.perm), 0][act])


def test_merge_insert_and_merge_find_vs_jax():
    rng = np.random.default_rng(9)
    S, R, L = 64, 40, 2
    j_tab = (jnp.zeros((S, L), jnp.uint32), jnp.full((S,), -1, jnp.int32),
             jnp.int32(0))
    t_tab = (torch.zeros((S, L), dtype=torch.int64),
             torch.full((S,), -1, dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    for step in range(3):
        reps = np.unique(_lanes(rng, R, L), axis=0)
        reps = reps[rng.permutation(len(reps))]
        pad = np.zeros((R - len(reps), L), np.uint32)
        rep_lanes = np.concatenate([reps, pad])
        rep_active = np.arange(R) < len(reps)
        rep_active &= rng.random(R) < 0.9
        jl, jgid, jrep, jnew = jdist.merge_insert(
            *j_tab, jnp.asarray(rep_lanes), jnp.asarray(rep_active))
        tl, tgid, trep, tnew = tdist.merge_insert(
            *t_tab, _t(rep_lanes), torch.from_numpy(rep_active))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(tgid.numpy(), np.asarray(jgid))
        np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
        assert int(tnew) == int(jnew)
        j_tab = (jl, jgid, j_tab[2] + jnew)
        t_tab = (tl, tgid, t_tab[2] + tnew)
    probes = _lanes(rng, 300, L)
    pact = rng.random(300) < 0.9
    want = jdist.merge_find(j_tab[0], j_tab[1], jnp.asarray(probes),
                            jnp.asarray(pact))
    got = tdist.merge_find(t_tab[0], t_tab[1], _t(probes),
                           torch.from_numpy(pact))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() >= 0).any() and (got.numpy() < 0).any()


def test_segmented_scans_vs_jax():
    rng = np.random.default_rng(4)
    n = 333
    head = rng.random(n) < 0.1
    head[0] = True
    v = rng.integers(-5, 50, n).astype(np.int32)
    for combine_j, combine_t in ((jnp.minimum, torch.minimum),
                                 (jnp.add, torch.add)):
        want = jseg.segmented_scan(jnp.asarray(v), jnp.asarray(head),
                                   combine_j)
        got = tseg.segmented_scan(torch.from_numpy(v),
                                  torch.from_numpy(head), combine_t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    head[0] = False
    want = jseg.segmented_carry_last(jnp.asarray(v), jnp.asarray(head))
    got = tseg.segmented_carry_last(torch.from_numpy(v),
                                    torch.from_numpy(head))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- HashAggregate, dense route -------------------------------------------

def _specs(J):
    Spec = JSpec if J else AggregateSpec
    Count = JCountOptions if J else CountOptions
    return [Spec("sum", "v"), Spec("min", "v"), Spec("max", "v"),
            Spec("mean", "v"), Spec("count", "v"),
            Spec("count", "v", Count("only_null"), name="v_nulls"),
            Spec("count", "v", Count("all"), name="v_all"),
            Spec("sum", "w"), Spec("min", "w"), Spec("max", "w"),
            Spec("count_all")]


def _record_batch(rng, n, lo, hi, nan=True):
    keys = rng.integers(lo, hi, n)
    v = rng.standard_normal(n).astype(np.float32)
    if nan:
        v[keys == lo + 3] = np.where(rng.random((keys == lo + 3).sum()) < 0.2,
                                     np.nan, v[keys == lo + 3])
    w = rng.integers(-(1 << 62), 1 << 62, n)
    w[: n // 10] = rng.integers(-100, 100, n // 10)
    return pa.record_batch({
        "k": pa.array(keys, mask=rng.random(n) < 0.05),
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "w": pa.array(w, mask=rng.random(n) < 0.1)})


def _jax_consume(ha, state, b):
    """The JAX AggregateNode's dense route, jitted as the node jits it."""
    vals = jax.device_get(jax.jit(ha.probe_scalars)(b))
    kind, cfg = ha.probe_route(b, vals)
    assert kind == "dense" and cfg["impl"] == "pallas" and cfg["G"] == 128
    consume = jax.jit(ha.consume_dense, static_argnums=(3, 4))
    return consume(state, b, np.int64(cfg["lo"]), cfg["G"], "pallas")


def _abs_sums(rbs):
    """per key (None for null): sum of |v| over valid v."""
    out = {}
    for rb in rbs:
        for k, v in zip(rb["k"].to_pylist(), rb["v"].to_pylist()):
            if v is not None and v == v:
                out[k] = out.get(k, 0.0) + abs(v)
    return out


def _assert_same_table(got, want, rbs, extreme_rbs=None):
    """``extreme_rbs``: what v's min / max reduce over, where it is not
    ``rbs`` (a state carried from the JAX package)."""
    assert got.schema.names == want.schema.names
    abs_sums = _abs_sums(rbs)
    keys = want["k"].to_pylist()
    assert got["k"].to_pylist() == keys       # same groups, same order
    for name in want.schema.names:
        g, w = got[name], want[name]
        assert g.type == w.type, name
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if name in ("v_min", "v_max"):
            ref = _extremes((extreme_rbs or {}).get(name[2:], rbs), ["k"],
                            "v", name[2:])
            for k, a, b in zip(keys, g.to_pylist(), w.to_pylist()):
                if a is None:
                    assert b is None, name
                    continue
                r = float(np.float32(ref[(k,)]))
                assert a == r or (a != a and r != r), (name, k, a, r)
                assert b == r or b != b, (name, k, b, r)
        elif name in ("v_sum", "v_mean"):
            for k, a, b in zip(keys, g.to_pylist(), w.to_pylist()):
                if a is None or a != a:
                    assert (a is None and b is None) or (b != b), name
                    continue
                assert abs(a - b) <= 1e-5 * abs_sums.get(k, 0.0) + 1e-6, \
                    (name, k, a, b)
        else:
            np.testing.assert_array_equal(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), err_msg=name)


def test_hash_aggregate_dense_route_vs_jax():
    rng = np.random.default_rng(21)
    rb = _record_batch(rng, 2500, -40, 60)
    jb = at.Batch.from_pyarrow(rb)
    tb = batch_from_pyarrow(rb, device="cpu")
    jha = JHashAggregate(jb.schema, ["k"], _specs(True), max_groups=256)
    tha = HashAggregate(tb.schema, ["k"], _specs(False), max_groups=256)
    assert tha.dense_static_ok() and jha.dense_static_ok()
    tvals = {k: v.numpy() for k, v in tha.probe_scalars(tb).items()}
    jvals = jax.device_get(jha.probe_scalars(jb))
    for k in jvals:
        np.testing.assert_array_equal(tvals[k], np.asarray(jvals[k]), k)
    assert tha.probe_route(tb, tvals) == jha.probe_route(jb, jvals)
    want = jha.finalize(_jax_consume(jha, jha.init_state(), jb))
    got = tha.finalize(consume_routed(tha, tha.init_state("cpu"), tb))
    assert int(got.length) == int(want.length)
    _assert_same_table(got.to_pyarrow(), want.to_pyarrow(), [rb])
    # a second batch folds into the same state (merge_rows with a table)
    rb2 = _record_batch(rng, 1000, -20, 80)
    jst = _jax_consume(jha, _jax_consume(jha, jha.init_state(), jb),
                       at.Batch.from_pyarrow(rb2))
    tst = consume_routed(tha, consume_routed(tha, tha.init_state("cpu"), tb),
                         batch_from_pyarrow(rb2, device="cpu"))
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb, rb2])


def test_hash_aggregate_carried_state_jax_to_port():
    """JAX consumes the first half; its state, fetched as numpy, becomes
    the port's; the port consumes the second half. The result equals JAX
    consuming both halves."""
    rng = np.random.default_rng(33)
    first = _record_batch(rng, 1500, 0, 90)
    second = _record_batch(rng, 1500, 30, 110, nan=False)
    jb1, jb2 = at.Batch.from_pyarrow(first), at.Batch.from_pyarrow(second)
    jha = JHashAggregate(jb1.schema, ["k"], _specs(True), max_groups=512)
    tha = HashAggregate(batch_from_pyarrow(first, device="cpu").schema, ["k"],
                        _specs(False), max_groups=512)
    jst1 = _jax_consume(jha, jha.init_state(), jb1)
    want = jha.finalize(_jax_consume(jha, jst1, jb2)).to_pyarrow()
    leaves = jax.tree_util.tree_map(np.asarray, jst1)
    tst = tha.state_from_numpy(leaves, device="cpu")
    assert int(tst[0].num_groups) == int(jst1[0].num_groups)
    tst = consume_routed(tha, tst, batch_from_pyarrow(second, device="cpu"))
    # the carried min / max are the JAX package's (NaN where the first
    # half held one): they reduce with the second half's values
    half = jha.finalize(jst1).to_pyarrow()
    _assert_same_table(tha.finalize(tst).to_pyarrow(), want,
                       [first, second],
                       {w: [pa.record_batch({"k": half["k"],
                                             "v": half[f"v_{w}"]}), second]
                        for w in ("min", "max")})


@pytest.mark.parametrize("precision", [10, 38])
def test_consume_routed_decimal_keys_vs_jax(precision):
    """Decimal keys (one int64 lane, or two limbs past precision 18) group
    as in the JAX package: the same groups in the same order, the same
    decimal sums and counts, exactly."""
    import decimal
    rng = np.random.default_rng(precision)
    n = 300
    dec = pa.decimal128(precision, 2)
    keys = [decimal.Decimal(int(x)).scaleb(-2) * (10 ** 15 if precision > 18
                                                  else 1)
            for x in rng.integers(-20, 20, n)]
    rb = pa.record_batch({
        "k": pa.array(keys, dec, mask=rng.random(n) < 0.05),
        "d": pa.array(keys[::-1], dec, mask=rng.random(n) < 0.1),
        "v": pa.array(rng.integers(-100, 100, n))})
    specs = [("sum", "d"), ("sum", "v"), ("count", "v"), ("count_all", None)]
    jha = JHashAggregate(at.Batch.from_pyarrow(rb).schema, ["k"],
                         [JSpec(f, t) if t else JSpec(f)
                          for f, t in specs], max_groups=64)
    jst = jha.consume(jha.init_state(), at.Batch.from_pyarrow(rb))
    want = jha.finalize(jst).to_pyarrow()
    tb = batch_from_pyarrow(rb, device="cpu")
    tha = HashAggregate(tb.schema, ["k"],
                        [AggregateSpec(f, t) if t else AggregateSpec(f)
                         for f, t in specs], max_groups=64)
    got = tha.finalize(consume_routed(tha, tha.init_state("cpu"), tb)
                       ).to_pyarrow()
    assert got.equals(want)
    assert got["k"].to_pylist() == list(dict.fromkeys(
        rb["k"].to_pylist()))       # first-appearance order, null a group


def test_consume_routed_sorted_dense_route_runs():
    """A key domain past the dense kernel's slots takes the sorted dense
    reduction; the sort-grouping routes run as well."""
    rb = pa.record_batch({"k": pa.array(np.arange(0, 50000, 7)),
                          "v": pa.array(np.ones(7143, np.float32))})
    tb = batch_from_pyarrow(rb, device="cpu")
    tha = HashAggregate(tb.schema, ["k"], [AggregateSpec("sum", "v")],
                        max_groups=1 << 16)
    kind, cfg = tha.probe_route(
        tb, {k: v.numpy() for k, v in tha.probe_scalars(tb).items()})
    assert kind == "dense" and cfg["impl"] == "sorted"
    out = tha.finalize(consume_routed(tha, tha.init_state("cpu"), tb))
    assert int(out.length) == 7143
    np.testing.assert_array_equal(out["k"].values[:7143].numpy(),
                                  np.arange(0, 50000, 7))
    assert (out["v_sum"].values[:7143] == 1.0).all()
    # the sort-grouping routes run: 7143 distinct keys into 1024 slots
    # leave the deferred error flag set
    tha = HashAggregate(tb.schema, ["k"], [AggregateSpec("sum", "v")],
                        max_groups=1024)
    st = consume_routed(tha, tha.init_state("cpu"), tb)
    assert int(st[0].error) != 0


@pytest.mark.parametrize("null_keys,null_values",
                         [(False, False), (True, False), (False, True),
                          (True, True)],
                         ids=["no_nulls", "null_keys", "null_values",
                              "null_keys_and_values"])
def test_consume_dense_native_kinds_vs_jax(monkeypatch, null_keys,
                                           null_values):
    """``consume_dense`` on the kernel's native kinds against the JAX
    ``consume_dense`` (limb, pair and masked streams through its Pallas
    kernel): every aggregate, ``count`` in its three modes and ``mean``,
    with and without null keys and null values, over two batches. The port
    hands the kernel the key and the columns themselves and builds no gid
    and no 32-bit stream but the counts of a column with nulls."""
    import arrow_tpu_torch.ops.hash_aggregate as tha_mod
    calls = []
    inner = tha_mod.dense_group_reduce

    def rec(gid, inputs, kinds, G, valid=None):
        calls.append((gid, inputs, kinds, valid))
        return inner(gid, inputs, kinds, G, valid=valid)
    monkeypatch.setattr(tha_mod, "dense_group_reduce", rec)
    rng = np.random.default_rng(61 + 2 * null_keys + null_values)

    def batch(n, lo, hi):
        rb = _record_batch(rng, n, lo, hi)
        cols = {"k": rb["k"] if null_keys else pa.array(rb["k"].fill_null(lo)),
                "v": rb["v"] if null_values else
                pa.array(rb["v"].fill_null(1.5)),
                "w": rb["w"] if null_values else
                pa.array(rb["w"].fill_null(-7))}
        return pa.record_batch(cols)
    rb, rb2 = batch(2500, -40, 60), batch(1200, -10, 80)
    jb, tb = at.Batch.from_pyarrow(rb), batch_from_pyarrow(rb, device="cpu")
    assert (tb.column("k").validity is not None) == null_keys
    assert (tb.column("w").validity is not None) == null_values
    jha = JHashAggregate(jb.schema, ["k"], _specs(True), max_groups=256)
    tha = HashAggregate(tb.schema, ["k"], _specs(False), max_groups=256)
    tst = consume_routed(tha, tha.init_state("cpu"), tb)
    jst = _jax_consume(jha, jha.init_state(), jb)
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb])
    (slots, inputs, kinds, valid), = calls
    # the slots come from the key column itself: no gid is built
    k = tb.column("k")
    assert isinstance(slots, tha_mod.DenseKey)
    assert slots.values.data_ptr() == k.values.data_ptr()
    assert slots.validity is k.validity and slots.length == 2500
    # a count stream only for a column with nulls: v's valid and null
    # counts, w's valid count
    count = ["count"] if null_values else []
    assert list(kinds) == ["first_row"] + count + ["sum", "min", "max"] \
        + count + count + ["sum64", "min64", "max64"]
    v, w = tb.column("v"), tb.column("w")
    streams = dict(zip(kinds[1:], zip(inputs, valid[1:])))
    for kind in ("sum", "min", "max"):
        assert streams[kind][0].data_ptr() == v.values.data_ptr()
        assert streams[kind][1] is v.validity
    for kind in ("sum64", "min64", "max64"):
        assert streams[kind][0].data_ptr() == w.values.data_ptr()
        assert streams[kind][1] is w.validity
    tst = consume_routed(tha, tst, batch_from_pyarrow(rb2, device="cpu"))
    jst = _jax_consume(jha, jst, at.Batch.from_pyarrow(rb2))
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb, rb2])


@pytest.mark.parametrize("ktype,base", [(np.uint16, 40000),
                                        (np.uint32, 3_000_000_000),
                                        (np.uint64, (1 << 63) - 100)],
                         ids=["uint16", "uint32", "uint64"])
def test_dense_route_unsigned_keys(ktype, base):
    """The dense route over a wide unsigned key (values past the signed
    range of its width): probe and result equal to the JAX package for
    uint16 and uint32; a uint64 key, which the JAX dense route refuses
    (its key offset overflows), against numpy."""
    rng = np.random.default_rng(3)
    n = 3000
    k = (np.uint64(base) + rng.integers(0, 90, n).astype(np.uint64)) \
        .astype(ktype)
    rb = pa.record_batch({
        "k": pa.array(k, mask=rng.random(n) < 0.05),
        "v": pa.array(rng.standard_normal(n).astype(np.float32)),
        "w": pa.array(rng.integers(-1000, 1000, n))})
    tb = batch_from_pyarrow(rb, device="cpu")
    aggs = [("sum", "w"), ("min", "v"), ("count_all",)]
    tha = HashAggregate(tb.schema, ["k"], [AggregateSpec(*a) for a in aggs],
                        max_groups=256)
    tvals = {name: v.numpy() for name, v in tha.probe_scalars(tb).items()}
    kind, cfg = tha.probe_route(tb, tvals)
    valid = np.array(rb["k"].is_valid().to_pylist())
    assert kind == "dense" and cfg["lo"] == int(k[valid].min())
    import arrow_tpu_torch.entry as entry_mod
    assert tha.probe_route(tb, entry_mod._host_probe(
        tha.probe_scalars(tb))) == (kind, cfg)
    got = tha.finalize(consume_routed(tha, tha.init_state("cpu"), tb)) \
        .to_pyarrow()
    assert got["k"].type == rb["k"].type
    if ktype is np.uint64:
        keys = rb["k"].to_pylist()
        order = list(dict.fromkeys(keys))
        assert got["k"].to_pylist() == order
        assert got["count_all"].to_pylist() == [keys.count(x) for x in order]
        w = rb["w"].to_pylist()
        assert got["w_sum"].to_pylist() == [
            sum(x for x, kk in zip(w, keys) if kk == o) for o in order]
        return
    jb = at.Batch.from_pyarrow(rb)
    jha = JHashAggregate(jb.schema, ["k"], [JSpec(*a) for a in aggs],
                         max_groups=256)
    jvals = jax.device_get(jha.probe_scalars(jb))
    for name in jvals:
        np.testing.assert_array_equal(tvals[name], np.asarray(jvals[name]),
                                      name)
    assert jha.probe_route(jb, jvals) == (kind, cfg)
    want = jha.finalize(jha.consume_dense(
        jha.init_state(), jb, np.int64(cfg["lo"]), cfg["G"], "pallas"))
    assert got.equals(want.to_pyarrow())
