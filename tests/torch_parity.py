"""Helpers of the port's parity tests of the cast, temporal, checked,
vector_misc and set-lookup modules: the same pyarrow data staged in both
packages, a function run in both, and the port's Array held against the
JAX package's.

Exact comparison, as ``test_torch_strings_family.py`` has it: the length,
the row capacity, validity, a varlen column's offsets and used bytes, a
fixed-width column's valid values bit for bit, and a struct-layout
column's children. Floats may be given a tolerance in ulps of the larger
magnitude (``ulps``) or relative to a scale (``rtol`` times ``scale``)."""

import numpy as np

from arrow_tpu.compute import call_function as jcall
from arrow_tpu.core import interop as jinterop
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.core import interop as tinterop


def valid_of(validity, n):
    return np.ones(n, bool) if validity is None else \
        np.asarray(validity)[:n].astype(bool)


def within_ulps(got, want, ulps):
    """|got - want| <= ulps * spacing(max(|got|, |want|)), NaN == NaN,
    equal infinities."""
    nan = np.isnan(got) & np.isnan(want)
    same = (got == want) | nan
    mag = np.maximum(np.abs(got), np.abs(want))
    with np.errstate(invalid="ignore"):
        close = np.abs(got - want) <= ulps * np.spacing(
            mag.astype(got.dtype))
    return bool(np.all(same | close))


def assert_same(t, j, ulps=0, rtol=None, scale=None):
    """A port Array against a JAX Array."""
    n = len(j)
    assert len(t) == n and t.capacity == j.capacity, (len(t), n, t.capacity,
                                                      j.capacity)
    ok = valid_of(t.validity, n)
    np.testing.assert_array_equal(ok, valid_of(j.validity, n))
    if getattr(j, "children", None):
        assert len(t.children) == len(j.children)
        for tc, jc in zip(t.children, j.children):
            assert_same(tc.with_validity(t.validity),
                        _with_validity(jc, j.validity), ulps, rtol, scale)
        return
    if j.offsets is not None:
        off = t.offsets[:n + 1].numpy()
        np.testing.assert_array_equal(off, np.asarray(j.offsets)[:n + 1])
        np.testing.assert_array_equal(t.values[:off[-1]].numpy(),
                                      np.asarray(j.values)[:off[-1]])
        return
    got = t.values[:n].numpy()[ok]
    want = np.asarray(j.values)[:n][ok]
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind == "f" and (ulps or rtol):
        if rtol is not None:
            tol = rtol * (np.abs(want) if scale is None
                          else np.asarray(scale)[:n][ok])
            bad = ~((got == want) | (np.isnan(got) & np.isnan(want)) |
                    (np.abs(got - want) <= tol))
            assert not bad.any(), (got[bad][:5], want[bad][:5])
        else:
            assert within_ulps(got, want, ulps), (got, want)
        return
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _with_validity(j, validity):
    from arrow_tpu.core.array import Array
    return Array(j.type, j.values, validity, length=j.length)


def stage(arr, capacity=None):
    """A pyarrow array in both packages: (port on the CPU, JAX)."""
    return (tinterop.array_from_pyarrow(arr, capacity=capacity,
                                        device="cpu"),
            jinterop.array_from_pyarrow(arr, capacity=capacity))


def both(fn, arrs, capacity=None, ulps=0, rtol=None, options=None,
         jax_options=None, **kw):
    """Run ``fn`` in both packages on the pyarrow arrays ``arrs`` (staged
    at ``capacity``; other arguments pass as they are) and compare;
    returns the port's result."""
    t_args, j_args = [], []
    for a in arrs:
        if hasattr(a, "type") and hasattr(a, "to_pylist"):
            t, j = stage(a, capacity)
        else:
            t = j = a
        t_args.append(t)
        j_args.append(j)
    got = tcall(fn, t_args, options=options, **kw)
    want = jcall(fn, j_args, options=jax_options, **kw)
    assert_same(got, want, ulps=ulps, rtol=rtol)
    return got


def assert_layout_same(t, j):
    """A port Array against a JAX Array of any layout: the length and
    validity, then a list's offsets and its child (over the used child
    rows), a struct's children, a union's codes (and a dense union's value
    offsets) and children, else ``assert_same`` on the values."""
    from arrow_tpu_torch.core import datatype as tdt
    n = len(j)
    assert len(t) == n, (len(t), n)
    np.testing.assert_array_equal(valid_of(t.validity, n),
                                  valid_of(j.validity, n))
    typ = t.type
    if isinstance(typ, tdt.ListType):
        off = t.offsets[:n + 1].numpy()
        np.testing.assert_array_equal(off, np.asarray(j.offsets)[:n + 1])
        used = int(off[-1])
        assert_layout_same(t.dictionary.with_length(used),
                           j.dictionary.with_length(used))
        return
    if isinstance(typ, tdt.UnionType):
        np.testing.assert_array_equal(t.values[:n].numpy(),
                                      np.asarray(j.values)[:n])
        if typ.mode == "dense":
            np.testing.assert_array_equal(t.offsets[:n].numpy(),
                                          np.asarray(j.offsets)[:n])
        for tc_, jc_ in zip(t.children, j.children):
            assert_layout_same(tc_, jc_)
        return
    if isinstance(typ, tdt.StructType):
        assert len(t.children) == len(j.children)
        for tc_, jc_ in zip(t.children, j.children):
            assert_layout_same(tc_.with_length(n), jc_.with_length(n))
        return
    if t.capacity != j.capacity:
        # capacities may differ where the packages size a result apart:
        # compare the live rows only
        t = t.with_length(n)
    ok = valid_of(t.validity, n)
    if j.offsets is not None:
        off = t.offsets[:n + 1].numpy()
        np.testing.assert_array_equal(off, np.asarray(j.offsets)[:n + 1])
        np.testing.assert_array_equal(t.values[:off[-1]].numpy(),
                                      np.asarray(j.values)[:off[-1]])
        return
    got = t.values[:n].numpy()[ok]
    want = np.asarray(j.values)[:n][ok]
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
