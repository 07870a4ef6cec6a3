"""Port parity: filter_compact_chunks (plain version) against the JAX
Pallas kernel (interpret mode), and the port's filter / take functions
against the JAX package's on the same numpy data (exact)."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow_tpu as at
import arrow_tpu_torch as att
from arrow_tpu.ops import selection as jsel
from arrow_tpu.ops.pallas_kernels import \
    filter_compact_chunks as jax_filter_compact_chunks
from arrow_tpu_torch.compute import call_function
from arrow_tpu_torch.core.interop import batch_from_pyarrow, array_from_pyarrow
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import selection as tsel


@pytest.mark.parametrize("cap,C,p", [(256, 1, 0.0), (256, 1, 0.5),
                                     (256, 1, 1.0), (256, 20, 0.0),
                                     (256, 20, 0.5), (256, 20, 1.0),
                                     (2048, 1, 0.5), (2048, 20, 0.5),
                                     (2048, 20, 0.03)])
def test_filter_compact_chunks_plain_vs_jax(cap, C, p):
    rng = np.random.default_rng(cap + C)
    sel = rng.random(cap) < p
    chunks = rng.integers(0, 256, (cap, C)).astype(np.uint8)
    want = np.asarray(jax_filter_compact_chunks(jnp.asarray(sel),
                                                jnp.asarray(chunks)))
    got = ck.filter_compact_chunks(torch.from_numpy(sel),
                                   torch.from_numpy(chunks)).numpy()
    n = int(sel.sum())
    assert got.shape == want.shape == (cap, C)
    np.testing.assert_array_equal(got[:n], want[:n])
    np.testing.assert_array_equal(got[:n], chunks[sel])


def test_filter_compact_chunks_any_capacity():
    """The port's kernel contract needs no 256-row alignment."""
    rng = np.random.default_rng(5)
    sel = rng.random(1001) < 0.4
    chunks = rng.integers(0, 256, (1001, 7)).astype(np.uint8)
    got = ck.filter_compact_chunks(torch.from_numpy(sel),
                                   torch.from_numpy(chunks)).numpy()
    np.testing.assert_array_equal(got[:sel.sum()], chunks[sel])


def test_filter_batch_zero_capacity():
    b = att.batch_from_numpy({"k": np.zeros(0, np.int64),
                              "b": np.zeros(0, np.bool_)}, device="cpu")
    out = tsel.filter_batch(b, call_function("greater", [b["k"], 0]))
    assert len(out) == 0 and out.to_pydict() == {"k": [], "b": []}


def _table(n, rng):
    """int64 / float32 / bool / int32 columns with nulls, and a mask with
    nulls."""
    def mask():
        return rng.random(n) < 0.15
    rb = pa.record_batch({
        "k": pa.array(rng.integers(-50, 50, n), mask=mask()),
        "v": pa.array(rng.standard_normal(n).astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "i": pa.array(rng.integers(-9, 9, n).astype(np.int32), mask=mask()),
    })
    m = pa.array(rng.random(n) < 0.45, mask=mask())
    return rb, m


@pytest.mark.parametrize("impl", [None, "dma"])
@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
@pytest.mark.parametrize("n,cap", [(700, 1000), (3000, 4096), (200, 200),
                                   (0, 16)])
def test_filter_batch_vs_jax(monkeypatch, impl, behavior, n, cap):
    if impl is None:
        monkeypatch.delenv("ARROW_TPU_FILTER_IMPL", raising=False)
    else:
        monkeypatch.setenv("ARROW_TPU_FILTER_IMPL", impl)
    rng = np.random.default_rng(n)
    rb, m = _table(n, rng)
    jb = at.Batch.from_pyarrow(rb, capacity=cap)
    jm = at.array(m, capacity=cap)
    want = jsel.filter_batch(jb, jm, jsel.FilterOptions(behavior))
    tb = batch_from_pyarrow(rb, capacity=cap, device="cpu")
    tm = array_from_pyarrow(m, capacity=cap, device="cpu")
    got = tsel.filter_batch(tb, tm, tsel.FilterOptions(behavior))
    assert got.capacity == cap
    assert int(got.length) == int(want.length)
    assert got.to_pyarrow().equals(want.to_pyarrow())


@pytest.mark.parametrize("behavior", ["drop", "emit_null"])
def test_take_indices_filter_array_and_take_vs_jax(behavior):
    rng = np.random.default_rng(3)
    rb, m = _table(900, rng)
    jm = at.array(m, capacity=1024)
    tm = array_from_pyarrow(m, capacity=1024, device="cpu")
    jidx = jsel.get_take_indices(jm, behavior)
    tidx = tsel.get_take_indices(tm, behavior)
    n = int(jidx.length)
    assert int(tidx.length) == n
    np.testing.assert_array_equal(tidx.values[:n].numpy(),
                                  np.asarray(jidx.values)[:n])
    assert tidx.to_pyarrow().equals(jidx.to_pyarrow())
    for name in rb.schema.names:
        ja = at.array(rb.column(name), capacity=1024)
        ta = array_from_pyarrow(rb.column(name), capacity=1024,
                                device="cpu")
        opts = jsel.FilterOptions(behavior)
        want = jsel.filter_array(ja, jm, opts)
        got = call_function("filter", [ta, tm],
                            tsel.FilterOptions(behavior))
        assert got.to_pyarrow().equals(want.to_pyarrow()), name
        assert tsel.take_array(ta, tidx).to_pyarrow().equals(
            jsel.take_array(ja, jidx).to_pyarrow()), name
