"""Port parity of the one-launch column compaction (B1's card form).

``filter_compact_columns_plain`` against the JAX ``filter_compact_chunks``
(Pallas in interpret mode) on the same columns packed as the JAX caller
packs them (u8 planes side by side), and ``filter_batch`` against the JAX
``filter_batch`` (its Pallas "dma" route) over every fixed-width type, with
and without validity, under DROP and EMIT_NULL, at capacities that end mid
tile, at selectivities 0 to 100 %, on sliced and strided column views.
Inputs come from numpy with a seed; integers and bits must be exact.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops import selection as jsel
from arrow_tpu.ops.pallas_kernels import \
    filter_compact_chunks as jax_filter_compact_chunks
from arrow_tpu_torch.core.array import Array
from arrow_tpu_torch.core.batch import Batch
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    batch_from_pyarrow
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import selection as tsel

# (name, numpy storage, pyarrow type): every fixed-width type the filter
# takes, temporal ones as their storage
_TYPES = [
    ("i8", np.int8, pa.int8()), ("i16", np.int16, pa.int16()),
    ("i32", np.int32, pa.int32()), ("i64", np.int64, pa.int64()),
    ("u8", np.uint8, pa.uint8()), ("u16", np.uint16, pa.uint16()),
    ("u32", np.uint32, pa.uint32()), ("u64", np.uint64, pa.uint64()),
    ("f16", np.float16, pa.float16()), ("f32", np.float32, pa.float32()),
    ("f64", np.float64, pa.float64()), ("b", np.bool_, pa.bool_()),
    ("d32", np.int32, pa.date32()), ("ts", np.int64, pa.timestamp("us")),
]
_CAPS = [1, 255, 257, 1001, 2048, 100_003]
_SELECTIVITIES = [0.0, 0.03, 0.5, 1.0]


def _values(rng, n, np_type):
    """n random values of a storage type: the full bit range, so that every
    byte of a row is checked."""
    if np_type == np.bool_:
        return rng.random(n) < 0.5
    raw = rng.integers(0, 256, (n, np.dtype(np_type).itemsize),
                       dtype=np.uint8)
    vals = raw.view(np_type).reshape(n)
    if np.dtype(np_type).kind == "f":       # NaN payloads would not compare
        vals = np.where(np.isfinite(vals), vals, 0).astype(np_type)
    return vals


def _record_batch(rng, n):
    """Every type twice: once without nulls, once with 20 % nulls."""
    cols = {}
    for name, np_type, pa_type in _TYPES:
        for nulls in (False, True):
            vals = _values(rng, n, np_type)
            mask = rng.random(n) < 0.2 if nulls else None
            cols[f"{name}_{'n' if nulls else 'v'}"] = pa.array(
                vals, type=pa_type, mask=mask)
    return pa.record_batch(cols)


def _mask(rng, n, p):
    """A filter mask selecting about ``p`` of the rows, 10 % of it null."""
    return pa.array(rng.random(n) < p, mask=rng.random(n) < 0.1)


def _planes(columns):
    """The JAX caller's form: every column as u8 planes side by side."""
    cap = columns[0].shape[0]
    return np.concatenate(
        [c.reshape(cap, -1).view(np.uint8).reshape(cap, -1)
         for c in columns], axis=1)


@pytest.mark.parametrize("p", _SELECTIVITIES)
@pytest.mark.parametrize("cap", [256, 1001, 2048, 100_003])
def test_filter_compact_columns_plain_vs_jax_planes(cap, p):
    rng = np.random.default_rng(cap + int(100 * p))
    sel = rng.random(cap) < p
    columns = [_values(rng, cap, t) for _, t, _ in _TYPES]
    columns.append(rng.integers(0, 256, (cap, 7), dtype=np.uint8))
    outs, count = ck.filter_compact_columns_plain(
        torch.from_numpy(sel), [torch.from_numpy(c) for c in columns])
    n = int(sel.sum())
    assert count.dtype == torch.int32 and count.shape == () and \
        int(count) == n
    # the JAX kernel takes whole 256-row tiles: pad with unselected rows
    pad = (-cap) % 256
    planes = _planes(columns)
    want = np.asarray(jax_filter_compact_chunks(
        jnp.asarray(np.concatenate([sel, np.zeros(pad, np.bool_)])),
        jnp.asarray(np.concatenate(
            [planes, np.zeros((pad, planes.shape[1]), np.uint8)]))))
    got = _planes([o.numpy() for o in outs])
    for o, c in zip(outs, columns):
        assert o.dtype == torch.from_numpy(c).dtype and o.shape == c.shape
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:n], planes[sel])


def test_filter_compact_chunks_is_the_one_column_form():
    rng = np.random.default_rng(11)
    sel = torch.from_numpy(rng.random(5000) < 0.4)
    chunks = torch.from_numpy(rng.integers(0, 256, (5000, 20),
                                           dtype=np.uint8))
    (col,), count = ck.filter_compact_columns(sel, [chunks])
    n = int(count)
    assert torch.equal(ck.filter_compact_chunks(sel, chunks)[:n], col[:n])
    assert torch.equal(col[:n], chunks[sel])


def test_filter_compact_columns_no_columns_gives_the_count():
    sel = torch.from_numpy(np.random.default_rng(2).random(777) < 0.3)
    outs, count = ck.filter_compact_columns(sel, [])
    assert outs == [] and int(count) == int(sel.sum())


@pytest.mark.parametrize("bad", ["3d", "wide_2d", "complex", "rows",
                                 "sel_dtype", "row_stride"])
def test_filter_compact_columns_refuses_what_the_kernel_does_not_take(bad):
    sel = torch.ones(8, dtype=torch.bool)
    col = torch.zeros(8, dtype=torch.int32)
    if bad == "3d":
        col = torch.zeros((8, 2, 2), dtype=torch.uint8)
    elif bad == "wide_2d":
        col = torch.zeros((8, 2), dtype=torch.int64)
    elif bad == "complex":
        col = torch.zeros(8, dtype=torch.complex128)
    elif bad == "rows":
        col = torch.zeros(9, dtype=torch.int32)
    elif bad == "row_stride":       # rows 2^16 + 4 bytes apart
        col = torch.zeros(8 * ((1 << 14) + 1), dtype=torch.int32)[
            ::(1 << 14) + 1]
    else:
        sel = torch.ones(8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        ck.filter_compact_columns(sel, [col])


def _assert_same(got, want):
    assert got.capacity == want.capacity
    assert int(got.length) == int(want.length)
    assert got.to_pyarrow().equals(want.to_pyarrow())


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("p", _SELECTIVITIES)
@pytest.mark.parametrize("cap", _CAPS)
def test_filter_batch_every_type_vs_jax(monkeypatch, cap, p, behavior):
    monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", "dma")
    rng = np.random.default_rng(7 * cap + int(100 * p))
    n = max(cap - cap // 7, 1)          # padding rows past the length
    rb = _record_batch(rng, n)
    m = _mask(rng, n, p)
    want = jsel.filter_batch(at.Batch.from_pyarrow(rb, capacity=cap),
                             at.array(m, capacity=cap),
                             jsel.FilterOptions(behavior))
    tb = batch_from_pyarrow(rb, capacity=cap, device="cpu")
    tm = array_from_pyarrow(m, capacity=cap, device="cpu")
    got = tsel.filter_batch(tb, tm, tsel.FilterOptions(behavior))
    _assert_same(got, want)
    emits = behavior == "emit_null" and tm.validity is not None
    for a, b in zip(got.arrays, tb.arrays):
        assert a.values.dtype == b.values.dtype
        assert (a.validity is not None) == (b.validity is not None or emits)


def _view_of(t: torch.Tensor, kind: str, off: int) -> torch.Tensor:
    """The same values as a view: at an offset into a longer tensor, or
    every other element of one."""
    n = t.shape[0]
    if kind == "sliced":
        base = torch.zeros((n + off + 3,), dtype=t.dtype)
        base[off:off + n] = t
        return base[off:off + n]
    base = torch.zeros((2 * n + off,), dtype=t.dtype)
    base[off::2][:n] = t
    return base[off::2][:n]


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("off", [1, 3])
@pytest.mark.parametrize("kind", ["sliced", "strided"])
@pytest.mark.parametrize("cap", [1001, 4099])
def test_filter_batch_column_views_vs_jax(monkeypatch, cap, kind, off,
                                          behavior):
    """Columns, validity and the mask as views (an offset into a longer
    buffer, or a stride of 2), as ``Batch.slice`` and the plan engine's
    compaction hand them over."""
    monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", "dma")
    rng = np.random.default_rng(cap + off)
    n = cap - 5
    rb = _record_batch(rng, n)
    m = _mask(rng, n, 0.5)
    want = jsel.filter_batch(at.Batch.from_pyarrow(rb, capacity=cap),
                             at.array(m, capacity=cap),
                             jsel.FilterOptions(behavior))
    tb = batch_from_pyarrow(rb, capacity=cap, device="cpu")
    tm = array_from_pyarrow(m, capacity=cap, device="cpu")

    def viewed(a):
        return Array(a.type, _view_of(a.values, kind, off),
                     None if a.validity is None
                     else _view_of(a.validity, kind, off), length=a.length)
    vb = Batch(tb.schema, [viewed(a) for a in tb.arrays], tb.length)
    assert not vb.arrays[3].values.is_contiguous() or kind == "sliced"
    got = tsel.filter_batch(vb, viewed(tm), tsel.FilterOptions(behavior))
    _assert_same(got, want)
    for a in got.arrays:
        assert a.values.is_contiguous()


@pytest.mark.parametrize("p", _SELECTIVITIES)
def test_filter_batch_count_is_the_selection_sum(p):
    rng = np.random.default_rng(int(100 * p))
    rb = _record_batch(rng, 3000)
    m = pa.array(rng.random(3000) < p)
    tb = batch_from_pyarrow(rb, capacity=4096, device="cpu")
    tm = array_from_pyarrow(m, capacity=4096, device="cpu")
    got = tsel.filter_batch(tb, tm)
    assert isinstance(got.length, torch.Tensor)
    assert got.length.dtype == torch.int32 and got.length.shape == ()
    assert int(got.length) == int(np.asarray(m).sum())
