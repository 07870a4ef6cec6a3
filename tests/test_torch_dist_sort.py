"""Port parity: the distributed sort (``DistContext.sort_by``) against the
JAX package on the 8-virtual-device CPU mesh and against pyarrow; the port
runs 8 logical shards on the CPU.

Wherever the primary key has no nulls the port's result equals the JAX
package's and pyarrow's row for row, and its shards hold as many rows as
the JAX package's (the range bounds are the same samples). With null
primary keys the port routes the null rows to the last shard (nulls at the
end) or the first (at the start) and equals pyarrow; the JAX package
routes them by their storage values into the middle of the order
(ROADMAP C18), which one test keeps on record."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.core.interop import batch_from_pyarrow
from arrow_tpu_torch.entry import SORT_KEYS, entry_dist_sort, \
    example_columns_sort
from arrow_tpu_torch.parallel import DistContext

N = 8


@pytest.fixture(scope="module")
def jctx():
    return JDistContext()


@pytest.fixture(scope="module")
def ctx():
    return DistContext(devices=["cpu"] * N)


def _pa_sort(t: pa.Table, keys, null_placement="at_end") -> pa.Table:
    return t.take(pa.compute.sort_indices(
        t, sort_keys=[(name, order, null_placement) for name, order in keys]))


def _both(ctx, jctx, t: pa.Table, keys, **kw):
    rb = t.to_batches()[0]
    got = ctx.sort_by(batch_from_pyarrow(rb, device="cpu"), keys, **kw)
    want = jctx.sort_by(at.Batch.from_pyarrow(rb), keys, **kw)
    return got, want


def _assert_sorted_like(got, want, exp: pa.Table):
    """Row for row equal to pyarrow's sort and to the JAX package's, with
    the JAX package's per-shard lengths."""
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    g = got.to_pyarrow()
    assert g.equals(want.to_pyarrow())
    assert g.equals(exp)


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_dist_sort_two_keys_vs_jax(ctx, jctx, rng, order):
    n = 4096
    t = pa.table({"a": pa.array(rng.integers(-1000, 1000, n)),
                  "b": pa.array(rng.standard_normal(n),
                                mask=rng.random(n) < 0.1)})
    keys = [("a", order), ("b", "descending")]
    got, want = _both(ctx, jctx, t, keys)
    _assert_sorted_like(got, want, _pa_sort(t, keys))


def test_dist_sort_many_ties_is_stable(ctx, jctx, rng):
    """Five distinct keys over 4096 rows: ties keep their input order (the
    received buckets arrive in source-shard order, the local sort is
    stable)."""
    n = 4096
    t = pa.table({"a": pa.array(rng.integers(0, 5, n).astype(np.int32)),
                  "i": pa.array(np.arange(n))})
    got, want = _both(ctx, jctx, t, [("a", "ascending")])
    _assert_sorted_like(got, want, _pa_sort(t, [("a", "ascending")]))
    g = got.to_pyarrow()
    for k in range(5):
        i = np.asarray(g["i"])[np.asarray(g["a"]) == k]
        assert (np.diff(i) > 0).all()


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_dist_sort_float_primary_vs_jax(ctx, jctx, rng, order):
    n = 2048
    v = rng.standard_normal(n)
    v[::7] = np.inf
    v[3::11] = -np.inf
    t = pa.table({"a": pa.array(v.astype(np.float32)),
                  "b": pa.array(rng.integers(0, 1 << 62, n))})
    keys = [("a", order), ("b", "ascending")]
    got, want = _both(ctx, jctx, t, keys, samples_per_shard=64)
    _assert_sorted_like(got, want, _pa_sort(t, keys))


@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_dist_sort_uint64_keys_vs_jax(ctx, jctx, rng, order):
    """uint64 keys on both sides of 2^63: the range word's signed order
    must be the unsigned order."""
    n = 3000
    t = pa.table({"a": pa.array(rng.integers(0, 1 << 64, n,
                                             dtype=np.uint64)),
                  "v": pa.array(rng.standard_normal(n))})
    keys = [("a", order)]
    got, want = _both(ctx, jctx, t, keys, bucket_factor=2)
    _assert_sorted_like(got, want, _pa_sort(t, keys))


@pytest.mark.parametrize("null_placement", ["at_end", "at_start"])
def test_dist_sort_null_primary_like_pyarrow(ctx, jctx, rng, null_placement):
    """ROADMAP C18: 512 rows, about 20 % null primary keys. The port equals
    pyarrow for either placement; the JAX package (nulls at the end only)
    does not."""
    n = 512
    t = pa.table({"a": pa.array(rng.integers(-50, 50, n),
                                mask=rng.random(n) < 0.2),
                  "b": pa.array(rng.standard_normal(n))})
    keys = [("a", "ascending"), ("b", "descending")]
    rb = t.to_batches()[0]
    got = ctx.sort_by(batch_from_pyarrow(rb, device="cpu"), keys,
                      null_placement=null_placement)
    exp = _pa_sort(t, keys, null_placement)
    assert got.to_pyarrow().equals(exp)
    nulls = [int(b.column("a").validity[:len(b)].logical_not().sum())
             for b in got.batches]
    held = nulls[-1] if null_placement == "at_end" else nulls[0]
    assert held == t["a"].null_count
    if null_placement == "at_end":
        want = jctx.sort_by(at.Batch.from_pyarrow(rb), keys).to_pyarrow()
        assert want.num_rows == n and not want.equals(exp)


def test_entry_dist_sort_vs_numpy_and_jax(jctx):
    """``entry_dist_sort`` (``entry_sort``'s columns: k1 ascending, k2 with
    5 % nulls descending, nulls last): the numpy lexsort permutation row
    for row, and the JAX package's per-shard lengths (k1 has no nulls)."""
    n = 4096
    step, (b,) = entry_dist_sort("cpu", N, n, 5, 100)
    got = step(b)
    cols = example_columns_sort(n, 100, 5)
    k2 = cols["k2"].astype(np.int64)
    # numpy's lexsort is stable; its last key is the primary: k1, then k2's
    # null flag (nulls last), then k2 descending
    perm = np.lexsort((np.where(cols["k2_valid"], -k2, 0),
                       ~cols["k2_valid"], cols["k1"]))
    g = got.to_pyarrow()
    assert np.array_equal(np.asarray(g["k1"]), cols["k1"][perm])
    assert np.array_equal(np.asarray(g["v"]), cols["v"][perm])
    jb = at.batch({"k1": cols["k1"],
                   "k2": pa.array(cols["k2"], mask=~cols["k2_valid"]),
                   "v": cols["v"]})
    want = jctx.sort_by(jb, SORT_KEYS)
    assert [len(x) for x in got.batches] == [len(x) for x in want.batches]
    assert g.equals(want.to_pyarrow())
