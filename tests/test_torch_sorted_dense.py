"""Port parity: the sorted dense reduction (``sorted_group_reduce`` and the
``impl="sorted"`` branch of ``consume_dense``), which ``consume_routed``
takes for a single integer key whose domain lies past the dense kernel's
slot count, against the JAX package's "sorted" impl on the same data.

Groups, their first-appearance order, counts, int64 sums / mins / maxes
and f32 mins / maxes exact; f32 sums and means within
|diff| <= 1e-5 * sum(|x|) + 1e-6 per group (the two sum in another order).
The dense route takes float32 and int64 values only: a float64 column goes
the sort-grouping route (``tests/test_torch_consume.py``, 1e-12).
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
from arrow_tpu_torch.entry import consume_routed
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops.agg_options import CountOptions
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, \
    HashAggregate, sorted_group_reduce

MAX_GROUPS = 1 << 13


def _specs(J):
    Spec = JSpec if J else AggregateSpec
    Count = JCountOptions if J else CountOptions
    return [Spec("sum", "v"), Spec("min", "v"), Spec("max", "v"),
            Spec("mean", "v"), Spec("count", "v"),
            Spec("count", "v", Count("only_null"), name="v_nulls"),
            Spec("count", "v", Count("all"), name="v_all"),
            Spec("sum", "w"), Spec("min", "w"), Spec("max", "w"),
            Spec("count_all")]


def _record_batch(rng, n, lo, hi, null_keys, null_values):
    keys = rng.integers(lo, hi, n)
    keys[:2] = [lo, hi - 1]             # the whole domain, every batch
    v = rng.standard_normal(n).astype(np.float32)
    w = rng.integers(-(1 << 62), 1 << 62, n)
    w[: n // 10] = rng.integers(-100, 100, n // 10)
    kmask = rng.random(n) < 0.05 if null_keys else None
    if null_keys:
        kmask[:2] = False
    vmask = (rng.random(n) < 0.1) if null_values else None
    wmask = (rng.random(n) < 0.1) if null_values else None
    return pa.record_batch({"k": pa.array(keys, mask=kmask),
                            "v": pa.array(v, mask=vmask),
                            "w": pa.array(w, mask=wmask)})


def _jax_consume(ha, state, b):
    vals = jax.device_get(jax.jit(ha.probe_scalars)(b))
    kind, cfg = ha.probe_route(b, vals)
    assert kind == "dense" and cfg["impl"] == "sorted", (kind, cfg)
    consume = jax.jit(ha.consume_dense, static_argnums=(3, 4))
    return consume(state, b, np.int64(cfg["lo"]), cfg["G"], "sorted")


def _assert_same_table(got, want, rbs):
    assert got.schema.names == want.schema.names
    abs_sums = {}
    for rb in rbs:
        for k, v in zip(rb["k"].to_pylist(), rb["v"].to_pylist()):
            if v is not None:
                abs_sums[k] = abs_sums.get(k, 0.0) + abs(v)
    keys = want["k"].to_pylist()
    assert got["k"].to_pylist() == keys       # same groups, same order
    for name in want.schema.names:
        g, w = got[name], want[name]
        assert g.type == w.type, name
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if name in ("v_sum", "v_mean"):
            for k, a, b in zip(keys, g.to_pylist(), w.to_pylist()):
                if a is not None:
                    assert abs(a - b) <= 1e-5 * abs_sums.get(k, 0.0) + 1e-6, \
                        (name, k, a, b)
        else:
            np.testing.assert_array_equal(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), err_msg=name)


@pytest.mark.parametrize("null_keys,null_values",
                         [(False, False), (True, False), (False, True),
                          (True, True)],
                         ids=["no_nulls", "null_keys", "null_values",
                              "null_keys_and_values"])
def test_consume_routed_sorted_dense_vs_jax(null_keys, null_values):
    """A key domain of 6000 values (past ``DENSE_CAP`` 4096): both packages
    route to ("dense", impl "sorted"), over two batches."""
    rng = np.random.default_rng(5 + 2 * null_keys + null_values)
    rb = _record_batch(rng, 3000, -1000, 5000, null_keys, null_values)
    rb2 = _record_batch(rng, 1500, -1000, 5000, null_keys, null_values)
    jb, tb = at.Batch.from_pyarrow(rb), batch_from_pyarrow(rb, device="cpu")
    jha = JHashAggregate(jb.schema, ["k"], _specs(True),
                         max_groups=MAX_GROUPS)
    tha = HashAggregate(tb.schema, ["k"], _specs(False),
                        max_groups=MAX_GROUPS)
    tvals = {k: v.numpy() for k, v in tha.probe_scalars(tb).items()}
    kind, cfg = tha.probe_route(tb, tvals)
    assert kind == "dense" and cfg["impl"] == "sorted" and cfg["G"] == 8192
    assert (kind, cfg) == jha.probe_route(
        jb, jax.device_get(jha.probe_scalars(jb)))
    tst = consume_routed(tha, tha.init_state("cpu"), tb)
    jst = _jax_consume(jha, jha.init_state(), jb)
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb])
    tst = consume_routed(tha, tst, batch_from_pyarrow(rb2, device="cpu"))
    jst = _jax_consume(jha, jst, at.Batch.from_pyarrow(rb2))
    _assert_same_table(tha.finalize(tst).to_pyarrow(),
                       jha.finalize(jst).to_pyarrow(), [rb, rb2])


KIND_SETS = [("first_row",), ("first_row", "count", "sum", "sum64"),
             ("first_row", "min", "max", "min64", "max64"),
             ("first_row", "sum", "min", "count", "sum64", "max64", "max")]


@pytest.mark.parametrize("kinds", KIND_SETS, ids=["+".join(k)
                                                  for k in KIND_SETS])
@pytest.mark.parametrize("G", [128, 8192])
@pytest.mark.parametrize("dense_key", [False, True], ids=["gid", "key"])
def test_sorted_group_reduce_vs_dense_plain(kinds, G, dense_key):
    """The same interface as ``dense_group_reduce``: against its plain
    version, with a validity stream on every second kind, a gid with
    inactive and out-of-range rows or a ``DenseKey`` with null keys."""
    rng = np.random.default_rng(G + len(kinds))
    n = 4000
    inputs, valid = [], []
    for i, kind in enumerate(kinds):
        if kind in ("sum", "min", "max"):
            inputs.append(torch.from_numpy(
                rng.standard_normal(n).astype(np.float32)))
        elif kind == "count":
            inputs.append(torch.from_numpy(
                rng.integers(0, 2, n).astype(np.int32)))
        elif kind != "first_row":
            inputs.append(torch.from_numpy(
                rng.integers(-(1 << 62), 1 << 62, n)))
        valid.append(torch.from_numpy(rng.random(n) < 0.8)
                     if i % 2 and kind != "first_row" else None)
    if dense_key:
        gid = ck.DenseKey(torch.from_numpy(rng.integers(-7, G - 9, n)), -7,
                          n - 100, torch.from_numpy(rng.random(n) < 0.9))
    else:
        gid = torch.from_numpy(rng.integers(-3, G + 3, n).astype(np.int32))
    wrows, wouts = ck.dense_group_reduce_plain(gid, tuple(inputs), kinds, G,
                                               tuple(valid))
    rows, outs = sorted_group_reduce(gid, tuple(inputs), kinds, G,
                                     tuple(valid))
    np.testing.assert_array_equal(rows.numpy(), wrows.numpy())
    assert rows.dtype == torch.int32 and len(outs) == len(wouts)
    for kind, o, w in zip(kinds, outs, wouts):
        assert o.dtype == w.dtype and o.shape == (G,), kind
        if kind == "sum":
            np.testing.assert_allclose(o.numpy(), w.numpy(), rtol=0,
                                       atol=1e-4)
        else:
            np.testing.assert_array_equal(o.numpy(), w.numpy(), err_msg=kind)


def test_sorted_group_reduce_refuses_the_limb_kinds():
    gid = torch.zeros(8, dtype=torch.int32)
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sumc"):
        sorted_group_reduce(gid, (x,), ("sumc",), 128)
