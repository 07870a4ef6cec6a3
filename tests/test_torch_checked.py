"""Port parity of the checked kernels (``ops/scalar_checked.py``, with
``utils/errors.py``) with the JAX package's, on the same pyarrow data made
from a seed, on the CPU: every case has the same outcome in both
packages and in pyarrow, equal values or ``ArrowInvalid`` with the same
message. Integers exact; transcendental results within 2 ulp (torch's
libm against XLA's); cumulative float sums within 1e-12 relative.

The uint32 product that passes 2^63 (where an int64 widening wraps) and
the uint64 compares and divisions are cases of their own."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from arrow_tpu.compute import call_function as jcall
from arrow_tpu.compute.scalar import Scalar as JScalar
from arrow_tpu.core.datatype import from_pyarrow_type as jtype
from arrow_tpu.utils import errors as jerrors
from arrow_tpu_torch.compute import call_function as tcall
from arrow_tpu_torch.compute import registry as tregistry
from arrow_tpu_torch.compute.scalar import Scalar as TScalar
from arrow_tpu_torch.core.datatype import from_pyarrow_type as ttype
from arrow_tpu_torch.utils import errors

from torch_parity import assert_same, stage


def _args(pa_args, capacity=None):
    t_args, j_args = [], []
    for a in pa_args:
        if isinstance(a, pa.Array):
            t, j = stage(a, capacity)
        elif isinstance(a, pa.Scalar):
            v = a.as_py() if a.is_valid else None
            t = TScalar(v, ttype(a.type), is_valid=a.is_valid)
            j = JScalar(v, jtype(a.type), is_valid=a.is_valid)
        else:
            t = j = a
        t_args.append(t)
        j_args.append(j)
    return t_args, j_args


def outcome(fn, pa_args, ulps=0, rtol=None, capacity=None, **kw):
    """Run ``fn`` in pyarrow and both packages: the same error message in
    all three, or equal values (the port's against the JAX package's)."""
    pa_err = None
    try:
        pa_res = getattr(pc, fn)(*pa_args, **kw)
    except pa.lib.ArrowInvalid as e:
        pa_err = str(e)
    t_args, j_args = _args(pa_args, capacity)
    try:
        want = jcall(fn, j_args, **kw)
        j_err = None
    except jerrors.ArrowInvalid as e:
        j_err = str(e)
    try:
        got = tcall(fn, t_args, **kw)
    except errors.ArrowInvalid as e:
        assert str(e) == pa_err == j_err, (str(e), pa_err, j_err)
        return None
    assert pa_err is None and j_err is None, (fn, pa_err, j_err)
    assert_same(got, want, ulps=ulps, rtol=rtol)
    return got, pa_res


def rand_ints(seed, n, t, null_every=10):
    rng = np.random.default_rng(seed)
    npt = t.to_pandas_dtype()
    if pa.types.is_floating(t):
        v = rng.standard_normal(n) * 1e3
    else:
        info = np.iinfo(npt)
        v = rng.integers(info.min, info.max, n, dtype=npt, endpoint=True)
    return pa.array([None if i % null_every == 3 else x.item()
                     for i, x in enumerate(v.astype(npt))], type=t)


BINARY = ["add_checked", "subtract_checked", "multiply_checked",
          "divide_checked"]
TYPES = [pa.int8(), pa.int16(), pa.int32(), pa.int64(), pa.uint8(),
         pa.uint16(), pa.uint32(), pa.uint64(), pa.float64()]


@pytest.mark.parametrize("t", TYPES, ids=str)
@pytest.mark.parametrize("fn", BINARY)
def test_binary_checked_fuzz(fn, t):
    """Full-range values: a mix of raising and passing calls."""
    for trial in range(6):
        outcome(fn, [rand_ints(10 * trial, 48, t),
                     rand_ints(10 * trial + 1, 48, t)], capacity=64)


@pytest.mark.parametrize("t", TYPES, ids=str)
@pytest.mark.parametrize("fn", BINARY)
def test_binary_checked_success(fn, t):
    """Small values that do not wrap: equal values in all three."""
    rng = np.random.default_rng(5)
    a = pa.array(rng.integers(6, 11, 40), t)
    b = pa.array(rng.integers(1, 6, 40), t)
    got, pa_res = outcome(fn, [a, b])
    if not pa.types.is_floating(t) or fn != "divide_checked":
        assert got.to_pylist() == pa_res.to_pylist()


def test_uint32_product_past_2_63():
    """uint32 x uint32 can pass 2^63: the test is b > max // a, not an
    int64 product (which wraps negative)."""
    a = pa.array([4_000_000_000, 65536, 65535, 3], pa.uint32())
    b = pa.array([4_000_000_000, 65536, 65537, 5], pa.uint32())
    assert outcome("multiply_checked", [a, b]) is None
    ok = outcome("multiply_checked", [pa.array([65535, 3], pa.uint32()),
                                      pa.array([65537, 5], pa.uint32())])
    assert ok[0].to_pylist() == [4294967295, 15]


def test_uint64_checked_edges():
    big = 2**64 - 1
    for fn, a, b in (("add_checked", [big, 1], [0, 2]),
                     ("add_checked", [big, 1], [1, 2]),
                     ("subtract_checked", [5, 2**63], [5, 1]),
                     ("subtract_checked", [5, 2**63], [6, 1]),
                     ("multiply_checked", [2**32, 3], [2**31, 5]),
                     ("multiply_checked", [2**32, 3], [2**32, 5]),
                     ("divide_checked", [big, 7], [3, 0])):
        outcome(fn, [pa.array(a, pa.uint64()), pa.array(b, pa.uint64())])


def test_divide_checked_errors():
    outcome("divide_checked", [pa.array([1, 2], pa.int32()),
                               pa.array([1, 0], pa.int32())])
    imin = np.iinfo(np.int64).min
    outcome("divide_checked", [pa.array([imin], pa.int64()),
                               pa.array([-1], pa.int64())])
    # an error under a null slot is not an error
    outcome("divide_checked", [pa.array([1, None], pa.int32()),
                               pa.array([None, 0], pa.int32())])
    outcome("divide_checked", [pa.array([1.0, 2.0]), pa.array([0.0, 1.0])])


@pytest.mark.parametrize("t", [pa.int8(), pa.int32(), pa.int64()], ids=str)
def test_negate_abs_checked(t):
    imin = np.iinfo(t.to_pandas_dtype()).min
    outcome("negate_checked", [pa.array([imin, 5, None], t)])
    outcome("abs_checked", [pa.array([imin, -5, None], t)])
    outcome("negate_checked", [pa.array([1, -2, None], t)])
    outcome("abs_checked", [pa.array([1, -2, None], t)])


def test_negate_float_and_unsigned():
    outcome("negate_checked", [pa.array([1.5, -2.5])])
    outcome("abs_checked", [pa.array([1, 200, None], pa.uint8())])
    with pytest.raises(TypeError):
        tcall("negate_checked", [stage(pa.array([1], pa.uint32()))[0]])


def test_power_checked():
    for a, b, t in (([2, 3, None], [10, 4, 2], pa.int64()),
                    ([2], [-1], pa.int64()), ([2], [63], pa.int64()),
                    ([2], [62], pa.int64()), ([2], [31], pa.int32()),
                    ([-1, 0, 1], [100, 0, 200], pa.int64()),
                    ([3, 2], [40, 64], pa.uint64()),
                    ([-2, 2], [63, 7], pa.int64())):
        outcome("power_checked", [pa.array(a, t), pa.array(b, t)])
    outcome("power_checked", [pa.array([2.0]), pa.array([-2.0])])


@pytest.mark.parametrize("t", [pa.int8(), pa.uint16(), pa.int64(),
                               pa.uint32()], ids=str)
def test_power_checked_fuzz(t):
    rng = np.random.default_rng(6)
    npt = t.to_pandas_dtype()
    for trial in range(4):
        lo = 0 if np.issubdtype(npt, np.unsignedinteger) else -5
        base = pa.array(rng.integers(lo, 6, 40).astype(npt), t)
        exp = pa.array(rng.integers(0, 70, 40).astype(npt), t)
        outcome("power_checked", [base, exp])


def test_shift_checked():
    a = pa.array([1, 2, 4, None], pa.int32())
    u = pa.array([1, 2, 4, None], pa.uint32())
    for x, amounts in ((a, [1, 30, 2, 3]), (a, [1, 31, 2, 3]),
                       (u, [1, 31, 2, 3]), (u, [1, 32, 2, 3])):
        outcome("shift_left_checked", [x, pa.array(amounts, x.type)])
    outcome("shift_right_checked", [a, pa.array([-1, 1, 2, 3], pa.int32())])
    outcome("shift_right_checked", [pa.array([-64, 64, -1, None],
                                             pa.int8()),
                                    pa.array([1, 6, 3, 1], pa.int8())])
    outcome("shift_left_checked", [pa.array([64, 100, 1], pa.int8()),
                                   pa.array([1, 1, 6], pa.int8())])


FLOAT_DOMAIN = [
    ("sqrt_checked", [4.0, 2.25, 7.5]), ("sqrt_checked", [-1.0]),
    ("ln_checked", [1.0, 2.7, 1e-300]), ("ln_checked", [0.0]),
    ("ln_checked", [-3.0]),
    ("log2_checked", [8.0, 3.3]), ("log2_checked", [0.0]),
    ("log10_checked", [100.0, 7.0]), ("log10_checked", [-1.0]),
    ("log1p_checked", [0.5, 1e-10]), ("log1p_checked", [-1.0]),
    ("log1p_checked", [-2.0]),
    ("sin_checked", [0.5, 100.0]), ("sin_checked", [float("inf")]),
    ("cos_checked", [0.5, -3.0]), ("cos_checked", [float("-inf")]),
    ("tan_checked", [0.5, 1.5]), ("tan_checked", [float("inf")]),
    ("asin_checked", [0.5, -1.0]), ("asin_checked", [2.0]),
    ("acos_checked", [0.5, 1.0]), ("acos_checked", [-2.0]),
    ("atanh_checked", [0.5, -0.99]), ("atanh_checked", [1.0]),
    ("acosh_checked", [2.0, 1.0]), ("acosh_checked", [0.5]),
]


@pytest.mark.parametrize("fn,vals", FLOAT_DOMAIN,
                         ids=[f"{f}-{i}" for i, (f, _) in
                              enumerate(FLOAT_DOMAIN)])
@pytest.mark.parametrize("t", [pa.float64(), pa.float32()], ids=str)
def test_float_domain_checked(fn, vals, t):
    outcome(fn, [pa.array(vals + [None], t)], ulps=2)


def test_float_checked_int_input_and_logb():
    outcome("sqrt_checked", [pa.array([4, 9, None], pa.int32())], ulps=2)
    outcome("ln_checked", [pa.array([1, 10], pa.int64())], ulps=2)
    outcome("logb_checked", [pa.array([8.0, 16.0]), pa.array([2.0, 4.0])],
            ulps=2)
    outcome("logb_checked", [pa.array([8.0]), pa.array([0.0])])
    outcome("logb_checked", [pa.array([-8.0]), pa.array([2.0])])
    outcome("logb_checked", [pa.array([8, 9], pa.int32()),
                             pa.array([2, 3], pa.int32())], ulps=2)


@pytest.mark.parametrize("skip_nulls", [False, True])
@pytest.mark.parametrize("t", [pa.int32(), pa.int64(), pa.uint8(),
                               pa.float64()], ids=str)
@pytest.mark.parametrize("fn", ["cumulative_sum_checked",
                                "cumulative_prod_checked"])
def test_cumulative_checked_success(fn, t, skip_nulls):
    vals = [1, 2, None, 3] if fn.startswith("cumulative_sum") else \
        [1, 2, None, 2]
    outcome(fn, [pa.array(vals, t)], skip_nulls=skip_nulls, rtol=1e-12)


@pytest.mark.parametrize("case", range(6))
def test_cumulative_checked_raises(case):
    big = np.iinfo(np.int64).max
    fn, vals, t, kw = [
        ("cumulative_sum_checked", [100, 100, 100], pa.int8(), {}),
        ("cumulative_prod_checked", [16, 16], pa.int8(), {}),
        ("cumulative_sum_checked", [100, 100], pa.int8(), {"start": 100}),
        ("cumulative_sum_checked", [big, 1], pa.int64(), {}),
        ("cumulative_sum_checked", [big, None, 1], pa.int64(),
         {"skip_nulls": False}),
        ("cumulative_prod_checked", [70000, 70000], pa.uint32(), {}),
    ][case]
    outcome(fn, [pa.array(vals, t)], **kw)


def test_pairwise_diff_checked():
    outcome("pairwise_diff_checked", [pa.array([5, 3, None, 100], pa.int8())])
    outcome("pairwise_diff_checked", [pa.array([-100, 100], pa.int8())])
    outcome("pairwise_diff_checked", [pa.array([-100, 100], pa.int8())],
            period=-1)
    outcome("pairwise_diff_checked", [rand_ints(7, 100, pa.int64())],
            period=3)


def test_checked_with_scalar():
    a = pa.array([120, 1], pa.int8())
    outcome("add_checked", [a, pa.scalar(10, pa.int8())])
    outcome("add_checked", [a, pa.scalar(1, pa.int8())])
    outcome("add_checked", [a, pa.scalar(None, pa.int8())])


def test_errors_scope_reads_once():
    """``errors.collect``: flags recorded, one code, the first tripped
    message raised by ``raise_code``; outside a scope ``check`` raises at
    once."""
    with errors.collect() as scope:
        errors.check(torch.tensor(False), "first")
        errors.check(torch.tensor(True), "second")
        errors.check(torch.tensor(True), "third")
    assert scope.messages() == ["first", "second", "third"]
    assert int(scope.encode()) == 2
    with pytest.raises(errors.ArrowInvalid, match="second"):
        errors.raise_code(scope.encode(), scope.messages())
    with pytest.raises(errors.ArrowInvalid, match="now"):
        errors.check(torch.tensor(True), "now")


def test_registers_the_checked_functions():
    names = set(tregistry.list_functions())
    assert {f for f in names if f.endswith("_checked")} == {
        "add_checked", "subtract_checked", "multiply_checked",
        "divide_checked", "shift_left_checked", "shift_right_checked",
        "power_checked", "negate_checked", "abs_checked", "sqrt_checked",
        "ln_checked", "log2_checked", "log10_checked", "log1p_checked",
        "sin_checked", "cos_checked", "tan_checked", "asin_checked",
        "acos_checked", "atanh_checked", "acosh_checked", "logb_checked",
        "cumulative_sum_checked", "cumulative_prod_checked",
        "pairwise_diff_checked"}
