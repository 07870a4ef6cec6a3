"""Port parity for the take-index filter route: ``tile_compact_local``
(plain version) against the JAX Pallas kernel in interpret mode,
``rows_of_positions``, ``get_take_indices`` against the JAX package with
its "pallas" route (``ARROW_TPU_FILTER_IMPL=pallas``) and with its scatter
form, and ``filter_batch(impl="pallas")`` against ``impl="dma"``.

Everything is integers, flags and row order: equal, no tolerance. Indices
and their validity are compared up to ``length`` (rows past it are padding)
and, against the scatter forms, over the whole capacity, where both hold 0
and valid.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
from arrow_tpu.ops import selection as jsel
from arrow_tpu.ops.pallas_kernels import \
    tile_compact_local as jax_tile_compact_local
from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.interop import array_from_pyarrow, \
    batch_from_pyarrow
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import selection as tsel

_DENSITIES = {"none": 0.0, "all": 1.0, "half": 0.5, "few": 0.02}


@pytest.mark.parametrize("density", list(_DENSITIES))
@pytest.mark.parametrize("cap", [1024, 4096])
def test_tile_compact_local_plain_vs_jax(cap, density):
    rng = np.random.default_rng(cap)
    sel = rng.random(cap) < _DENSITIES[density]
    jloc, jcnt = jax_tile_compact_local(jnp.asarray(sel))
    loc, cnt = ck.tile_compact_local(torch.from_numpy(sel))
    assert loc.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
    for t in range(cap // 1024):
        want = np.flatnonzero(sel[t * 1024:(t + 1) * 1024])
        np.testing.assert_array_equal(
            loc.numpy()[t * 1024:t * 1024 + len(want)], want)


def test_tile_compact_local_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 1024"):
        ck.tile_compact_local(torch.zeros(1000, dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        ck.tile_compact_local(torch.zeros(1024, dtype=torch.uint8))
    loc, cnt = ck.tile_compact_local(torch.zeros(0, dtype=torch.bool))
    assert loc.shape == (0,) and cnt.shape == (0,)


@pytest.mark.parametrize("out_cap", [40, 64])
def test_rows_of_positions_vs_jax(out_cap):
    rng = np.random.default_rng(out_cap)
    lens = rng.integers(0, 4, 30)
    lens[[0, 5, 6, 29]] = 0                      # empty rows, both ends
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    assert off[-1] <= out_cap
    want = np.asarray(jsel.rows_of_positions(jnp.asarray(off), out_cap))
    got = tsel.rows_of_positions(torch.from_numpy(off), out_cap)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:off[-1]],
                                  np.repeat(np.arange(30), lens))


def _mask(rng, cap, n, density, nulls):
    vals = rng.random(n) < _DENSITIES[density]
    m = pa.array(vals, mask=(rng.random(n) < 0.2) if nulls else None)
    return m, at.array(m, capacity=cap), \
        array_from_pyarrow(m, capacity=cap, device="cpu")


def _assert_same_indices(got, want, whole: bool):
    n = int(want.length)
    assert int(got.length) == n
    assert got.type == dt.int32 and got.values.dtype == torch.int32
    stop = got.capacity if whole else n
    np.testing.assert_array_equal(got.values.numpy()[:stop],
                                  np.asarray(want.values)[:stop])
    assert (got.validity is None) == (want.validity is None)
    if want.validity is not None:
        np.testing.assert_array_equal(got.validity.numpy()[:stop],
                                      np.asarray(want.validity)[:stop])


@pytest.mark.parametrize("nulls", [False, True], ids=["valid", "nulls"])
@pytest.mark.parametrize("density", ["none", "all", "half"])
@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("cap,n", [(1000, 1000), (1024, 1024), (1024, 700),
                                   (5000, 4321)])
def test_get_take_indices_vs_jax(monkeypatch, cap, n, behavior, density,
                                 nulls):
    rng = np.random.default_rng(cap + n)
    _, jm, tm = _mask(rng, cap, n, density, nulls)
    got = tsel.get_take_indices(tm, behavior)
    # the JAX kernel route (capacities off the 1024 grid fall to its other
    # forms there; the port pads instead)
    monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", "pallas")
    _assert_same_indices(got, jsel.get_take_indices(jm, behavior),
                         whole=cap % 1024 == 0)
    # the scatter forms of both packages: equal over the whole capacity
    monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", "scatter")
    _assert_same_indices(got, jsel.get_take_indices(jm, behavior),
                         whole=True)
    sel, emit_valid, _ = tsel._selection_mask(tm, behavior)
    idx, validity = tsel._scatter_take_indices(sel, emit_valid)
    assert torch.equal(got.values, idx)
    assert (validity is None and got.validity is None) or \
        torch.equal(got.validity, validity)


def _table(rng, n):
    return pa.record_batch({
        "k": pa.array(rng.integers(-5, 5, n), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.standard_normal(n)),
        "f": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=rng.random(n) < 0.3),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.2),
        "i": pa.array(rng.integers(0, 100, n).astype(np.int32))})


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("cap,n", [(1024, 1000), (3000, 3000)])
def test_filter_batch_pallas_vs_dma_and_jax(monkeypatch, cap, n, behavior):
    rng = np.random.default_rng(n)
    rb = _table(rng, n)
    m, jm, tm = _mask(rng, cap, n, "half", True)
    tb = batch_from_pyarrow(rb, capacity=cap, device="cpu")
    opts = tsel.FilterOptions(behavior)
    got = tsel.filter_batch(tb, tm, opts, impl="pallas")
    dma = tsel.filter_batch(tb, tm, opts, impl="dma")
    assert got.to_pyarrow().equals(dma.to_pyarrow())
    assert got.to_pyarrow().equals(
        tsel.filter_batch(tb, tm, opts).to_pyarrow())     # "dma" by default
    monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", "pallas")
    want = jsel.filter_batch(at.Batch.from_pyarrow(rb, capacity=cap), jm,
                             jsel.FilterOptions(behavior))
    assert got.to_pyarrow().equals(want.to_pyarrow())
    assert got.to_pyarrow().equals(
        rb.filter(m, null_selection_behavior=behavior))
    with pytest.raises(ValueError, match="impl"):
        tsel.filter_batch(tb, tm, opts, impl="sort")


def test_filter_array_and_take_batch_run_the_tile_route(monkeypatch):
    """``filter_array`` and ``take_batch`` reach ``tile_compact_local``
    through ``get_take_indices``, and match the JAX package."""
    calls = []
    inner = tsel.tile_compact_local
    monkeypatch.setattr(tsel, "tile_compact_local",
                        lambda sel: calls.append(sel.shape[0]) or inner(sel))
    rng = np.random.default_rng(2)
    rb = _table(rng, 1500)
    m, jm, tm = _mask(rng, 1500, 1500, "half", True)
    tb = batch_from_pyarrow(rb, capacity=1500, device="cpu")
    jb = at.Batch.from_pyarrow(rb, capacity=1500)
    for name in rb.schema.names:
        got = tsel.filter_array(tb.column(name), tm)
        want = jsel.filter_array(jb.column(name), jm)
        assert got.to_pyarrow().equals(want.to_pyarrow()), name
    assert calls == [2048] * rb.num_columns     # padded to the 1024 grid
    idx = tsel.get_take_indices(tm, "emit_null")
    jidx = jsel.get_take_indices(jm, "emit_null")
    assert tsel.take_batch(tb, idx).to_pyarrow().equals(
        jsel.take_batch(jb, jidx).to_pyarrow())


def _stitch_selection(rng, cap, shape):
    """A padded (multiple of 1024) selection of ``cap`` rows by shape."""
    sel = np.zeros((-(-cap // 1024)) * 1024, np.bool_)
    if shape == "all":
        sel[:cap] = True
    elif shape == "half":
        sel[:cap] = rng.random(cap) < 0.5
    elif shape == "stretches":                  # whole tiles left empty
        sel[:cap] = rng.random(cap) < 0.3
        for t in range(0, len(sel) // 1024, 2):
            sel[t * 1024:(t + 1) * 1024] = False
    elif shape == "one":
        sel[cap - 1] = True
    return sel


@pytest.mark.parametrize("shape", ["none", "all", "half", "stretches", "one"])
@pytest.mark.parametrize("cap", [1, 1000, 1024, 4097, 8192])
def test_tile_stitch_plain_vs_jax_and_numpy(cap, shape):
    """``tile_stitch_plain`` after ``tile_compact_local_plain`` equals the
    JAX package's ``_pallas_take_indices`` over the whole capacity and
    ``np.nonzero`` up to the count, zeros past it."""
    rng = np.random.default_rng(cap)
    sel = _stitch_selection(rng, cap, shape)
    loc, counts = ck.tile_compact_local(torch.from_numpy(sel))
    starts = torch.cat([torch.zeros(1, dtype=torch.int32),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    got = ck.tile_stitch(loc, counts, starts, cap)
    assert got.dtype == torch.int32 and got.shape == (cap,)
    want = np.flatnonzero(sel)
    np.testing.assert_array_equal(got.numpy()[:len(want)], want)
    assert not got.numpy()[len(want):].any()
    jidx, _ = jsel._pallas_take_indices(jnp.asarray(sel), None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jidx)[:cap])
    # the index formula, slot by slot
    for t in np.flatnonzero(counts.numpy())[:3]:
        r = int(counts[t]) - 1
        assert int(got[int(starts[t]) + r]) == \
            t * 1024 + int(loc[t * 1024 + r])


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("cap", [1, 1000, 1024, 4097])
def test_get_take_indices_vs_numpy_nonzero(cap, behavior):
    """DROP: the indices are ``np.nonzero(valid & true)``; EMIT_NULL: null
    mask slots are selected too and come out as null indices."""
    rng = np.random.default_rng(cap + 7)
    vals, valid = rng.random(cap) < 0.5, rng.random(cap) >= 0.2
    m = pa.array(vals, mask=~valid)
    got = tsel.get_take_indices(array_from_pyarrow(m, device="cpu"),
                                behavior)
    sel = (vals & valid) if behavior == "drop" else (vals | ~valid)
    want = np.flatnonzero(sel)
    assert int(got.length) == len(want)
    np.testing.assert_array_equal(got.values.numpy()[:len(want)], want)
    assert not got.values.numpy()[len(want):].any()
    if behavior == "drop" or valid.all():
        assert got.validity is None
    else:
        np.testing.assert_array_equal(got.validity.numpy()[:len(want)],
                                      valid[want])
        assert got.validity.numpy()[len(want):].all()


def test_tile_stitch_refuses_what_the_kernel_does_not_take():
    loc = torch.zeros(2048, dtype=torch.int32)
    counts = torch.zeros(2, dtype=torch.int32)
    starts = torch.zeros(3, dtype=torch.int32)
    assert ck.tile_stitch(loc, counts, starts, 5).tolist() == [0] * 5
    with pytest.raises(ValueError, match="starts"):
        ck.tile_stitch(loc, counts, starts[:2], 5)
    with pytest.raises(ValueError, match="int32"):
        ck.tile_stitch(loc.long(), counts, starts, 5)
    with pytest.raises(ValueError, match="2\\^31"):
        ck.tile_stitch(loc, counts, starts, 1 << 31)
    with pytest.raises(ValueError, match="T >= 1"):
        ck.tile_stitch(loc[:0], counts[:0], starts[:1], 5)
