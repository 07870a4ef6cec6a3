"""Port parity: the other grouped and scalar aggregators (product, any,
all, variance, stddev, first, last, one, count_distinct, skew, kurtosis,
tdigest, approximate_median, the decimal sum) against the JAX package on
the same numpy data: the sort route and ``merge``, the dense route's
``any`` / ``all`` (the B3 plain version and the sorted route), the scalar
aggregates, and the registry's names.

Tolerances: integers, bools, first / last / one and medians exact; float64
results within 1e-9 relative. Where the JAX package is at fault (ROADMAP
C25-C27) the port is held against numpy or pyarrow, and the JAX result is
kept on record as differing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.compute import call_function as jcall
from arrow_tpu.compute.registry import registry as jregistry
from arrow_tpu.core import datatype as jdt
from arrow_tpu.core.array import Array as JArray
from arrow_tpu.ops import aggregates as jaggs
from arrow_tpu.ops.agg_options import CountOptions as JCount
from arrow_tpu.ops.agg_options import ScalarAggregateOptions as JScalarOpts
from arrow_tpu.ops.agg_options import VarianceOptions as JVariance
from arrow_tpu.ops.aggregates_order import TDigestOptions as JTDigest
from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
from arrow_tpu.ops.hash_aggregate import HashAggregate as JHashAggregate
from arrow_tpu.ops.pallas_kernels import dense_group_reduce as jax_dgr
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.compute.registry import registry as tregistry
from arrow_tpu_torch.core import datatype as tdt
from arrow_tpu_torch.core.array import Array as TArray
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.entry import consume_routed
from arrow_tpu_torch.ops import aggregates as taggs
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops.agg_options import CountOptions as TCount
from arrow_tpu_torch.ops.agg_options import \
    ScalarAggregateOptions as TScalarOpts
from arrow_tpu_torch.ops.agg_options import VarianceOptions as TVariance
from arrow_tpu_torch.ops.aggregates_order import TDigestOptions as TTDigest
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec as TSpec
from arrow_tpu_torch.ops.hash_aggregate import HashAggregate as THashAggregate

F64_RTOL = 1e-9


def _record_batch(rng, n, nkeys=40, offset=0.0):
    """Float64 key ``k`` (the sort route in both packages) with nulls; f64
    ``v`` and f32 ``x`` with nulls and a NaN group; small int64 ``i``;
    uint32 ``u``; bool ``b`` with nulls."""
    k = rng.integers(0, nkeys, n).astype(np.float64)
    v = rng.standard_normal(n) + offset
    v[k == 7] = np.where(rng.random(int((k == 7).sum())) < 0.3, np.nan,
                         v[k == 7])
    return pa.record_batch({
        "k": pa.array(k, mask=rng.random(n) < 0.03),
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "x": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-3, 4, n)),
        "u": pa.array(rng.integers(0, 1 << 32, n, dtype=np.uint64)
                      .astype(np.uint32), mask=rng.random(n) < 0.05),
        "b": pa.array(rng.random(n) < 0.6, mask=rng.random(n) < 0.1)})


# name -> (target column, JAX options, port options)
_CASES = {
    "product": ("i", None, None),
    "product_f64": ("v", None, None),
    "any": ("b", None, None),
    "all": ("b", None, None),
    "variance": ("v", None, None),
    "stddev": ("x", JVariance(ddof=1), TVariance(ddof=1)),
    "first": ("u", None, None),
    "last": ("v", None, None),
    "one": ("b", None, None),
    "count_distinct": ("u", None, None),
    "count_distinct_all": ("u", JCount("all"), TCount("all")),
    "skew": ("v", None, None),
    "kurtosis": ("x", None, None),
    "tdigest": ("v", None, None),
    "approximate_median": ("i", None, None),
}


def _spec(Spec, case, options_j_or_t):
    fn = case.split("_f64")[0].replace("count_distinct_all",
                                       "count_distinct")
    tgt = _CASES[case][0]
    return Spec(fn, tgt, options_j_or_t, name=f"{tgt}_{case}")


def _columns(b):
    """{name: (values[:n] numpy, validity[:n] numpy or None)}."""
    n = int(np.asarray(b.length))
    out = {}
    for f, a in zip(b.schema.fields, b.arrays):
        vals = np.asarray(a.values.cpu() if isinstance(a.values, torch.Tensor)
                          else a.values)[:n]
        va = None if a.validity is None else np.asarray(
            a.validity.cpu() if isinstance(a.validity, torch.Tensor)
            else a.validity)[:n]
        out[f.name] = (vals, va)
    return out


def _assert_same(got, want, float_cols=()):
    """Port finalize Batch against the JAX one: same groups in the same
    order, same nulls; floats of ``float_cols`` within F64_RTOL relative
    (NaN equal to NaN), the rest exact."""
    g, w = _columns(got), _columns(want)
    assert list(g) == list(w)
    for name in w:
        (gv, gm), (wv, wm) = g[name], w[name]
        gm = np.ones(gv.shape[0], bool) if gm is None else gm
        wm = np.ones(wv.shape[0], bool) if wm is None else wm
        np.testing.assert_array_equal(gm, wm, err_msg=f"{name} nulls")
        gv, wv = gv[wm], wv[wm]
        if name in float_cols:
            np.testing.assert_allclose(gv, wv, rtol=F64_RTOL, atol=1e-300,
                                       equal_nan=True, err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


_FLOAT_CASES = {"product_f64", "variance", "stddev", "skew", "kurtosis",
                "tdigest"}


@pytest.mark.parametrize("case", list(_CASES))
def test_grouped_sort_route_and_merge_vs_jax(case):
    """Two batches consumed into one state, a third into another, the
    second state merged into the first (the reference's Merge with a
    group-id mapping); the finalized groups as the JAX package gives
    them."""
    rng = np.random.default_rng(sum(map(ord, case)))
    rbs = [_record_batch(rng, n) for n in (700, 500, 600)]
    _, jo, to = _CASES[case]
    jbs = [at.Batch.from_pyarrow(rb) for rb in rbs]
    tbs = [batch_from_pyarrow(rb, device="cpu") for rb in rbs]
    if case in ("tdigest", "approximate_median"):
        # the JAX merge appends the other buffer whole: room for both
        jo, to = JTDigest(), TTDigest()
        jo.buffer_rows = to.buffer_rows = 1 << 14
    jha = JHashAggregate(jbs[0].schema, ["k"], [_spec(JSpec, case, jo)],
                         max_groups=64)
    tha = THashAggregate(tbs[0].schema, ["k"], [_spec(TSpec, case, to)],
                         max_groups=64)
    js = jha.consume(jha.consume(jha.init_state(), jbs[0]), jbs[1])
    ts = tha.consume(tha.consume(tha.init_state("cpu"), tbs[0]), tbs[1])
    _assert_same(tha.finalize(ts), jha.finalize(js),
                 {f"{_CASES[case][0]}_{case}"} if case in _FLOAT_CASES
                 else ())
    js = jha.merge(js, jha.consume(jha.init_state(), jbs[2]))
    ts = tha.merge(ts, tha.consume(tha.init_state("cpu"), tbs[2]))
    assert tha.aggregator_errors(ts) == []
    if case not in ("tdigest", "approximate_median"):
        _assert_same(tha.finalize(ts), jha.finalize(js),
                     {f"{_CASES[case][0]}_{case}"} if case in _FLOAT_CASES
                     else ())
        return
    # the JAX merge appends the other buffer whole, past any buffer that
    # holds a row already (ROADMAP C25): its error flag is set. The port
    # appends the rows in use; its medians are the exact ones.
    assert int(np.asarray(js[1][0][3])) != 0
    got = _columns(tha.finalize(ts))
    tbl = pa.Table.from_batches(rbs)
    tgt = _CASES[case][0]
    keys, key_valid = got["k"]
    for key, valid, med in zip(keys, key_valid, got[f"{tgt}_{case}"][0]):
        sel = pa.compute.equal(tbl["k"], key) if valid else \
            tbl["k"].is_null()
        x = np.sort(tbl[tgt].filter(sel).drop_null().to_numpy()
                    .astype(np.float64))
        rank = 0.5 * (len(x) - 1)
        lo, hi = int(np.floor(rank)), int(np.ceil(rank))
        want = x[lo] + (rank - lo) * (x[hi] - x[lo])
        assert med == want or (med != med and want != want), key


@pytest.mark.parametrize("case", ["product", "any", "all", "variance",
                                  "skew", "first", "last", "one"])
def test_grouped_row_consume_vs_jax(case):
    """The row-scatter ``consume`` (the scalar aggregate node's), group ids
    given, against the JAX package's."""
    rng = np.random.default_rng(7)
    rb = _record_batch(rng, 1024)
    tgt, jo, to = _CASES[case]
    gids = rng.integers(-1, 12, 1024).astype(np.int32)
    ja = jaggs.make_grouped_aggregator(case, at.Batch.from_pyarrow(rb)
                                       .column(tgt).type, 16, jo)
    ta = taggs.make_grouped_aggregator(case, batch_from_pyarrow(
        rb, device="cpu").column(tgt).type, 16, to)
    jcol = at.Batch.from_pyarrow(rb).column(tgt)
    tcol = batch_from_pyarrow(rb, device="cpu").column(tgt)
    js = ja.consume(ja.consume(ja.init(), jcol, jnp.asarray(gids)), jcol,
                    jnp.asarray(gids[::-1].copy()))
    ts = ta.consume(ta.consume(ta.init("cpu"), tcol, torch.from_numpy(gids)),
                    tcol, torch.from_numpy(gids[::-1].copy()))
    w, g = ja.finalize(js, 16), ta.finalize(ts, 16)
    wm, gm = np.asarray(w.validity), g.validity.numpy()
    np.testing.assert_array_equal(gm, wm)
    wv, gv = np.asarray(w.values)[wm], g.values.numpy()[wm]
    if case in ("variance", "skew"):
        np.testing.assert_allclose(gv, wv, rtol=F64_RTOL, equal_nan=True)
    else:
        np.testing.assert_array_equal(gv, wv)


def test_first_last_vs_pyarrow_over_batches():
    """first / last over a stream of three batches against pyarrow's
    (``use_threads=False``: pyarrow orders them only then, ROADMAP C1)."""
    rng = np.random.default_rng(11)
    rbs = [_record_batch(rng, n) for n in (400, 300, 500)]
    tbl = pa.Table.from_batches(rbs)
    want = tbl.group_by("k", use_threads=False).aggregate(
        [("v", "first"), ("v", "last"), ("u", "first"), ("b", "last")])
    got = Table.from_pyarrow(tbl, max_rows_per_batch=400,
                             device="cpu").group_by("k").aggregate(
        [("v", "first"), ("v", "last"), ("u", "first"), ("b", "last")])
    got, want = got.to_pyarrow(), want
    order_g = np.argsort(np.nan_to_num(np.array(
        got["k"].to_pylist(), dtype=float), nan=-1.0), kind="stable")
    order_w = np.argsort(np.nan_to_num(np.array(
        want["k"].to_pylist(), dtype=float), nan=-1.0), kind="stable")
    for name in ("v_first", "v_last", "u_first", "b_last"):
        g = [got[name].to_pylist()[i] for i in order_g]
        w = [want[name].to_pylist()[i] for i in order_w]
        assert [x if x == x else "nan" for x in g] == \
            [x if x == x else "nan" for x in w], name


# ---- the dense route: any / all on B3 and on the sorted route ---------------

def _dense_batch(rng, n, lo, hi, null_keys):
    k = rng.integers(lo, hi, n)
    f = np.where(k % 4 == 0, True, np.where(k % 4 == 1, False,
                                            rng.random(n) < 0.5))
    return pa.record_batch({
        "k": pa.array(k, mask=(rng.random(n) < 0.05) if null_keys else None),
        "f": pa.array(f, mask=rng.random(n) < 0.05),
        "g": pa.array(rng.random(n) < 0.5),
        "w": pa.array(rng.integers(-100, 100, n))})


_DENSE_SPECS = [("count_all", None), ("any", "f"), ("all", "f"),
                ("any", "g"), ("all", "g"), ("min", "w"), ("count", "f")]


@pytest.mark.parametrize("impl", ["pallas", "sorted"])
@pytest.mark.parametrize("null_keys", [False, True],
                         ids=["keys_valid", "null_keys"])
def test_dense_route_any_all_vs_jax(impl, null_keys):
    """any / all ride the dense route in both packages: the port's B3
    kinds any8 / all8 (plain version here) or the sorted route, the JAX
    package's imax / imin streams through its Pallas kernel (interpret
    mode) or its sorted reduction. Two batches fold into one state."""
    rng = np.random.default_rng(5 + null_keys)
    hi = 90 if impl == "pallas" else 5000
    rbs = [_dense_batch(rng, 3000, -10, hi, null_keys),
           _dense_batch(rng, 1200, 0, hi + 20, null_keys)]
    jbs = [at.Batch.from_pyarrow(rb) for rb in rbs]
    tbs = [batch_from_pyarrow(rb, device="cpu") for rb in rbs]
    jha = JHashAggregate(jbs[0].schema, ["k"],
                         [JSpec(f, t) for f, t in _DENSE_SPECS],
                         max_groups=1 << 13)
    tha = THashAggregate(tbs[0].schema, ["k"],
                         [TSpec(f, t) for f, t in _DENSE_SPECS],
                         max_groups=1 << 13)
    assert jha.dense_static_ok() and tha.dense_static_ok()
    js, ts = jha.init_state(), tha.init_state("cpu")
    for jb, tb in zip(jbs, tbs):
        vals = jax.device_get(jax.jit(jha.probe_scalars)(jb))
        kind, cfg = jha.probe_route(jb, vals)
        assert kind == "dense" and cfg["impl"] == impl
        js = jax.jit(jha.consume_dense, static_argnums=(3, 4))(
            js, jb, np.int64(cfg["lo"]), cfg["G"], impl)
        ts = consume_routed(tha, ts, tb)
    _assert_same(tha.finalize(ts), jha.finalize(js))


def test_bool_kinds_plain_vs_tpu_imax_imin():
    """B3's any8 / all8 plain version against the JAX kernel's imax / imin
    over the int32 streams its caller builds ((f & ok), (f | ~ok)), with
    inactive rows and rows past G."""
    rng = np.random.default_rng(2)
    n, G = 5000, 128
    gid = rng.integers(-1, G + 8, n).astype(np.int32)
    f = rng.random(n) < 0.5
    f[gid == 0], f[gid == 1] = True, False
    ok = rng.random(n) >= 0.1
    rows, (t_any, t_all) = ck.dense_group_reduce(
        torch.from_numpy(gid), (torch.from_numpy(f),) * 2, ("any8", "all8"),
        G, (torch.from_numpy(ok),) * 2)
    jrows, (j_any, j_all) = jax_dgr(
        jnp.asarray(gid), (jnp.asarray((f & ok).astype(np.int32)),
                           jnp.asarray((f | ~ok).astype(np.int32))),
        ("imax", "imin"), G)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    seen = np.asarray(jrows) > 0
    np.testing.assert_array_equal(t_any.numpy()[seen],
                                  np.asarray(j_any)[seen])
    np.testing.assert_array_equal(t_all.numpy()[seen],
                                  np.asarray(j_all)[seen])
    assert (t_any.numpy()[~seen] == 0).all() and \
        (t_all.numpy()[~seen] == 1).all()


@pytest.mark.parametrize("G", [128, 4096])
def test_bool_kinds_fit_the_launch_split(G):
    """The bool kinds take 4 bytes a slot of shared memory, as counts do:
    sixteen kinds a launch, and the split keeps each launch in budget."""
    kinds = ("first_row",) + ("any8", "all8", "count") * 8
    groups = ck._dg_launch_groups(kinds, G)
    assert sum(len(g) for g in groups) == len(kinds)
    for g in groups:
        assert len(g) <= ck._DG_MAX_KINDS
        assert 4 * G + sum(ck._dg_acc_bytes(kinds[i], G) for i in g) <= \
            ck._DG_SMEM_BUDGET
    with pytest.raises(ValueError, match="bool or torch.int32"):
        ck.dense_group_reduce(torch.zeros(8, dtype=torch.int32),
                              (torch.zeros(8, dtype=torch.float32),),
                              ("any8",), 128)
    # an int32 stream: its nonzero entries are True
    gid = torch.arange(8, dtype=torch.int32) % 2
    x = torch.tensor([0, 0, 5, 0, -1, 0, 0, 0], dtype=torch.int32)
    _, (a, al) = ck.dense_group_reduce(gid, (x, x), ("any8", "all8"), 128)
    assert a[:2].tolist() == [1, 0] and al[:2].tolist() == [0, 0]


# ---- decimal sums -----------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True], ids=["decimal64", "decimal128"])
def test_decimal_sum_vs_jax(wide):
    """hash_sum of a decimal column: exact 128-bit sums recombined into
    two limbs, on the sort route and through merge, as in the JAX
    package; wide decimals refuse mean."""
    rng = np.random.default_rng(13 + wide)
    n, G = 800, 32
    prec = 30 if wide else 12
    gids = rng.integers(-1, 20, n).astype(np.int32)
    if wide:
        lo = rng.integers(-(1 << 63), (1 << 63) - 1, n)
        hi = rng.integers(-(1 << 40), 1 << 40, n)
        vals = np.stack([lo, hi], axis=1)
    else:
        vals = rng.integers(-10**12, 10**12, n)
    valid = rng.random(n) >= 0.1
    jt, tt = jdt.decimal128(prec, 2), tdt.decimal128(prec, 2)
    ja = jaggs.make_grouped_aggregator("hash_sum", jt, G)
    ta = taggs.make_grouped_aggregator("hash_sum", tt, G)
    assert isinstance(ta, taggs.GroupedDecimalSum)
    jcol = JArray(jt, jnp.asarray(vals), jnp.asarray(valid))
    tcol = TArray(tt, torch.from_numpy(vals), torch.from_numpy(valid))
    js = ja.consume(ja.init(), jcol, jnp.asarray(gids))
    ts = ta.consume(ta.init("cpu"), tcol, torch.from_numpy(gids))
    mapping = rng.permutation(G).astype(np.int32)
    js = ja.merge(js, ja.consume(ja.init(), jcol, jnp.asarray(gids)),
                  jnp.asarray(mapping))
    ts = ta.merge(ts, ta.consume(ta.init("cpu"), tcol,
                                 torch.from_numpy(gids)),
                  torch.from_numpy(mapping))
    w, g = ja.finalize(js, G), ta.finalize(ts, G)
    assert g.type == ta.out_type and g.values.shape == (G, 2)
    np.testing.assert_array_equal(g.validity.numpy(), np.asarray(w.validity))
    np.testing.assert_array_equal(g.values.numpy(), np.asarray(w.values))
    if wide:
        with pytest.raises(NotImplementedError, match="wide"):
            taggs.make_grouped_aggregator("mean", tt, G)


# ---- scalar aggregates --------------------------------------------------------

_SCALAR_OPTS = {
    "default": (None, None),
    "keep_nulls": (JScalarOpts(skip_nulls=False), TScalarOpts(
        skip_nulls=False)),
    "min_count": (JScalarOpts(min_count=2000), TScalarOpts(min_count=2000)),
}


@pytest.mark.parametrize("opts", list(_SCALAR_OPTS))
@pytest.mark.parametrize("fn,col", [
    ("sum", "i"), ("product", "i"), ("product", "x"), ("mean", "v"),
    ("min", "u"), ("max", "b"), ("any", "b"), ("all", "b"),
    ("variance", "v"), ("stddev", "x"), ("count", "v")])
def test_scalar_aggregates_vs_jax(fn, col, opts):
    rng = np.random.default_rng(17)
    rb = _record_batch(rng, 1500)
    jo, to = _SCALAR_OPTS[opts]
    if fn in ("variance", "stddev") and opts != "default":
        jo = JVariance(ddof=1, skip_nulls=opts != "keep_nulls",
                       min_count=2000 if opts == "min_count" else 0)
        to = TVariance(ddof=1, skip_nulls=opts != "keep_nulls",
                       min_count=2000 if opts == "min_count" else 0)
    if fn == "count":
        jo, to = JCount("all"), TCount("all")
    if fn == "product":     # a product that stays in range
        rb = rb.slice(0, 40)
    w = jcall(fn, [at.Batch.from_pyarrow(rb).column(col)], options=jo)
    g = tcall(fn, [batch_from_pyarrow(rb, device="cpu").column(col)],
              options=to)
    assert repr(g.type) == repr(w.type) and g.is_valid == w.is_valid
    a, b = g.as_py(), w.as_py()
    if isinstance(b, float):
        assert a == pytest.approx(b, rel=F64_RTOL, nan_ok=True)
    else:
        assert a == b


# ---- the registry ---------------------------------------------------------------

def test_port_registers_every_jax_aggregate_name():
    """Every function name the JAX package registers in aggregates.py,
    aggregates_order.py and vector_hash.py is registered in the port,
    with the same kind; the grouped aggregators have the same 21 names."""
    mods = {"arrow_tpu.ops.aggregates", "arrow_tpu.ops.aggregates_order",
            "arrow_tpu.ops.vector_hash"}
    jregistry.list_functions()
    names = {n: f for n, f in jregistry._functions.items()
             if f.exec.__module__ in mods}
    assert len(names) > 40
    for name, f in names.items():
        assert name in tregistry, name
        assert tregistry.get(name).kind.name == f.kind.name, name
    # list and pivot_wider join the table from the nested and pivot
    # modules, which the registry loads, in both packages
    assert set(taggs.GROUPED_AGGREGATORS) == set(jaggs.GROUPED_AGGREGATORS)
    assert len(taggs.GROUPED_AGGREGATORS) == 21
    with pytest.raises(ValueError, match="Direct calls"):
        tcall("hash_stddev", [TArray(tdt.float64, torch.zeros(4))])


# ---- faults of the reference side (ROADMAP C25-C27) ---------------------------

@pytest.mark.parametrize("batches", [1, 2])
@pytest.mark.parametrize("offset", [0.0, 1e6, 1e9])
def test_moments_with_a_large_mean_match_numpy(offset, batches):
    """C27: 20,000 standard-normal values plus an offset over 4 keys, ddof
    1, in one batch or two (the second combines the states' moments). The
    port's mean-centred moments give numpy's variance and sd within 1e-9
    at every offset in one batch. A state keeps its mean as a float64,
    known to its spacing s (1.2e-7 at 1e9), so combining two batches' means
    adds up to 4 s relative (their distance is below 1 sd here); skew and
    kurtosis, odd and high moments about that mean, are held within 1e-9
    plus 16 s absolute. The JAX package's raw power sums lose the variance
    as the offset grows: at 1e6 in the 7th digit, at 1e9 all of it."""
    rng = np.random.default_rng(23)
    n = 20000
    k = rng.integers(0, 4, n)
    v = rng.standard_normal(n) + offset
    rb = pa.record_batch({"k": pa.array(k.astype(np.float64)),
                          "v": pa.array(v)})
    specs = [("variance", TVariance(ddof=1), JVariance(ddof=1)),
             ("stddev", TVariance(ddof=1), JVariance(ddof=1)),
             ("skew", None, None), ("kurtosis", None, None)]
    tb = batch_from_pyarrow(rb, device="cpu")
    tha = THashAggregate(tb.schema, ["k"], [TSpec(f, "v", o)
                                            for f, o, _ in specs])
    parts = [rb] if batches == 1 else [rb.slice(0, n // 2),
                                       rb.slice(n // 2)]
    st = tha.init_state("cpu")
    for part in parts:
        st = tha.consume(st, batch_from_pyarrow(part, device="cpu"))
    got = tha.finalize(st)
    got_k = got.column("k").values[:4].numpy()
    s = np.spacing(offset) if offset else 0.0
    for name, fn in (("v_variance", lambda x: np.var(x, ddof=1)),
                     ("v_stddev", lambda x: np.std(x, ddof=1)),
                     ("v_skew", _skew), ("v_kurtosis", _kurtosis)):
        want = np.array([fn(v[k == key]) for key in got_k])
        if name in ("v_skew", "v_kurtosis"):
            tol = dict(rtol=F64_RTOL, atol=16 * s)
        else:
            tol = dict(rtol=F64_RTOL + (4 * s if batches > 1 else 0.0),
                       atol=0)
        np.testing.assert_allclose(got.column(name).values[:4].numpy(), want,
                                   err_msg=name, **tol)
    jb = at.Batch.from_pyarrow(rb)
    jha = JHashAggregate(jb.schema, ["k"], [JSpec(f, "v", o)
                                            for f, _, o in specs])
    jvar = np.asarray(jha.finalize(jha.consume(jha.init_state(), jb))
                      .column("v_variance").values)[:4]
    want_var = np.array([np.var(v[k == key], ddof=1) for key in got_k])
    rel = np.abs(jvar - want_var) / want_var
    if offset == 0.0:
        assert (rel < 1e-9).all()
    elif offset == 1e6:
        assert (rel > 1e-8).any()
    else:
        assert (jvar == 0).all() or (rel > 0.5).all()


def _skew(x):
    d = x - x.mean()
    return (d ** 3).mean() / (d ** 2).mean() ** 1.5


def _kurtosis(x):
    d = x - x.mean()
    return (d ** 4).mean() / (d ** 2).mean() ** 2 - 3.0


def test_median_buffer_full_raises_not_wrong():
    """C25: 120,000 rows in 4 batches over 4 keys against the default
    65,536-row buffer. The port raises through ``Table.group_by``, naming
    ``buffer_rows``; with the buffer raised its medians are pandas'. The
    JAX package returns medians off by a wide margin and no error."""
    rng = np.random.default_rng(29)
    n = 120000
    k = rng.integers(0, 4, n)
    v = rng.standard_normal(n)
    tbl = pa.table({"k": k, "v": v})
    t = Table.from_pyarrow(tbl, max_rows_per_batch=n // 4, device="cpu")
    with pytest.raises(RuntimeError, match="buffer_rows"):
        t.group_by("k").aggregate([("v", "approximate_median")])
    got = t.group_by("k").aggregate([("v", "approximate_median",
                                      TTDigest(buffer_rows=1 << 17))])
    d = got.to_pydict()
    want = {key: np.median(v[k == key]) for key in range(4)}
    assert {key: m for key, m in zip(d["k"], d["v_approximate_median"])} \
        == want
    jb = [at.Batch.from_pyarrow(rb) for rb in tbl.to_batches(n // 4)]
    jha = JHashAggregate(jb[0].schema, ["k"],
                         [JSpec("approximate_median", "v")])
    js = jha.init_state()
    for b in jb:
        js = jha.consume(js, b)
    assert jha.aggregator_errors(js) == []
    jout = jha.finalize(js)
    jmed = dict(zip(np.asarray(jout.column("k").values)[:4].tolist(),
                    np.asarray(jout.column("v_approximate_median")
                               .values)[:4].tolist()))
    assert max(abs(jmed[key] - want[key]) for key in range(4)) > 1e-3


def test_count_distinct_pair_table_full_raises_not_wrong():
    """C26: 20,000 rows over 4 keys, values in [0, 10^6), max_groups 16
    (4,096 pairs). The port raises through ``Table.group_by`` naming
    ``max_pairs``; with it raised the counts are numpy's. The JAX package
    returns counts of 0 and 4,096 and no error."""
    rng = np.random.default_rng(31)
    n = 20000
    k = rng.integers(0, 4, n)
    w = rng.integers(0, 10**6, n)
    tbl = pa.table({"k": k, "w": w})
    t = Table.from_pyarrow(tbl, device="cpu")
    with pytest.raises(RuntimeError, match="max_pairs"):
        t.group_by("k", max_groups=16).aggregate([("w", "count_distinct")])
    opts = TCount()
    opts.max_pairs = 1 << 15
    d = t.group_by("k", max_groups=16).aggregate(
        [("w", "count_distinct", opts)]).to_pydict()
    want = {key: len(np.unique(w[k == key])) for key in range(4)}
    assert dict(zip(d["k"], d["w_count_distinct"])) == want
    jb = at.Batch.from_pyarrow(tbl.to_batches()[0])
    jha = JHashAggregate(jb.schema, ["k"], [JSpec("count_distinct", "w")],
                         max_groups=16)
    js = jha.consume(jha.init_state(), jb)
    assert jha.aggregator_errors(js) == []
    jcounts = np.asarray(jha.finalize(js).column("w_count_distinct")
                         .values)[:4]
    assert sorted(jcounts.tolist()) != sorted(want.values())


# ---- the entry point of path 1c ----------------------------------------------

def test_entry_any_all_vs_numpy_and_jax():
    """``entry_any_all`` at 4,096 rows over 100 keys (CPU: B1's and B3's
    plain versions): its groups against numpy's, and against the JAX
    package's dense route over the same filtered rows."""
    from arrow_tpu_torch.entry import AGGREGATES_ANY_ALL, entry_any_all, \
        example_columns_any_all
    n, nkeys = 4096, 100
    step, (b,) = entry_any_all("cpu", n, nkeys, 4)
    out = step(b).to_pyarrow()
    cols = example_columns_any_all(n, nkeys, 4)
    sel = cols["w"] > 0
    k, f, fv = cols["k"][sel], cols["f"][sel], cols["f_valid"][sel]
    keys = list(dict.fromkeys(k.tolist()))      # first appearance
    assert out["k"].to_pylist() == keys
    for key, cnt, a, al in zip(keys, out["count_all"].to_pylist(),
                               out["f_any"].to_pylist(),
                               out["f_all"].to_pylist()):
        rows = k == key
        assert cnt == int(rows.sum())
        vals = f[rows & fv]
        assert a == (bool(vals.any()) if vals.size else None)
        assert al == (bool(vals.all()) if vals.size else None)
    rb = pa.record_batch({"k": cols["k"][sel], "v": cols["v"][sel],
                          "w": cols["w"][sel],
                          "f": pa.array(cols["f"][sel],
                                        mask=~cols["f_valid"][sel])})
    jb = at.Batch.from_pyarrow(rb)
    jha = JHashAggregate(jb.schema, ["k"], [JSpec(s.function, s.target)
                                            for s in AGGREGATES_ANY_ALL],
                         max_groups=2048)
    kind, cfg = jha.probe_route(jb, jax.device_get(jha.probe_scalars(jb)))
    assert kind == "dense"
    want = jha.finalize(jha.consume_dense(
        jha.init_state(), jb, np.int64(cfg["lo"]), cfg["G"],
        cfg["impl"])).to_pyarrow()
    for name in ("k", "count_all", "w_min", "f_any", "f_all"):
        assert out[name].to_pylist() == want[name].to_pylist(), name
    v = cols["v"][sel].astype(np.float64)
    for key, a, w in zip(keys, out["v_sum"].to_pylist(),
                         want["v_sum"].to_pylist()):
        assert abs(a - w) <= 1e-5 * np.abs(v[k == key]).sum() + 1e-6
