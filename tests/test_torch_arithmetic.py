"""Port parity: ``arrow_tpu_torch.ops.scalar_arithmetic`` against the JAX
package's ``ops/scalar_arithmetic``: the same pyarrow columns (numpy made
from a seed, with nulls) through ``call_function`` in both packages give
the same type, the same nulls and the same values: integers exactly (they
wrap like C; division truncates; division by zero, negative powers and
shifts out of range give what the JAX package gives), float arithmetic
bit for bit (a subnormal result equal to zero: XLA on the CPU flushes
them), transcendental functions within a few ulps (1e-6 relative for
float32, 1e-13 for float64). Also the expression operators ``+ - * /``
(ROADMAP C15) and the Q3 project's float64 result type."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jc
import arrow_tpu_torch as att
import arrow_tpu_torch.compute as tc
from arrow_tpu.ops.scalar_arithmetic import RoundOptions as JRound, \
    RoundToMultipleOptions as JRoundM
from arrow_tpu_torch.ops.scalar_arithmetic import RoundOptions as TRound, \
    RoundToMultipleOptions as TRoundM

N = 257

INT_TYPES = ["int8", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64"]
FLOAT_TYPES = ["float32", "float64"]


def _col(rng, np_type, kind="any"):
    """N values of ``np_type`` with ~10 % nulls: the type's extremes,
    zeros and ones among them; ``kind="shift"`` small shift amounts (some
    out of range), ``"exponent"`` small exponents (some negative)."""
    dt = np.dtype(np_type)
    if kind == "shift":
        v = rng.integers(-2, 8 * dt.itemsize + 3, N)
    elif kind == "exponent":
        v = rng.integers(-3 if dt.kind == "i" else 0, 12, N)
    elif dt.kind == "f":
        v = rng.standard_normal(N) * 10
        v[:6] = [0.0, -0.0, 1.0, np.inf, -2.5, 0.5]
    else:
        info = np.iinfo(dt)
        v = rng.integers(info.min, info.max, N, dtype=dt, endpoint=True)
        v[:8] = [info.min, info.max, 0, 1, 0, info.min, 1, info.max]
        if dt.kind == "i":
            v[8:12] = [-1, -7, 7, -1]
    mask = rng.random(N) < 0.1
    mask[:12] = False
    return pa.array(np.asarray(v).astype(dt), mask=mask)


def _pair(name, t_a, t_b, options=None, scalar_b=None, kind="any", seed=0):
    """(port result, JAX result) of ``name`` over two columns (or a column
    and a scalar), as pyarrow arrays."""
    rng = np.random.default_rng(seed)
    a = _col(rng, t_a)
    b = _col(rng, t_b, kind)
    rb = pa.record_batch([a, b], names=["a", "b"])
    jb = at.Batch.from_pyarrow(rb)
    tb = att.Batch.from_pyarrow(rb, device="cpu")
    jargs = [jb["a"], jb["b"] if scalar_b is None else scalar_b]
    targs = [tb["a"], tb["b"] if scalar_b is None else scalar_b]
    jo, to = options if options is not None else (None, None)
    return (tc.call_function(name, targs, options=to).to_pyarrow(),
            jc.call_function(name, jargs, options=jo).to_pyarrow())


def _assert_same(got, want, rtol=0.0):
    assert got.type == want.type, (got.type, want.type)
    assert got.is_valid().equals(want.is_valid())
    g = got.fill_null(0).to_numpy(zero_copy_only=False)
    w = want.fill_null(0).to_numpy(zero_copy_only=False)
    if g.dtype.kind == "f":
        # XLA on the CPU flushes subnormal results to zero; torch keeps them
        tiny = np.finfo(g.dtype).tiny
        g = np.where(np.abs(g) < tiny, np.copysign(0, g), g)
        w = np.where(np.abs(w) < tiny, np.copysign(0, w), w)
    if g.dtype.kind == "f" and rtol:
        ok = (np.isnan(g) & np.isnan(w)) | (g == w) | \
            (np.abs(g - w) <= rtol * np.abs(w))
        assert ok.all(), (g[~ok], w[~ok])
    elif g.dtype.kind == "f":
        bits = np.uint32 if g.dtype == np.float32 else np.uint64
        nan = np.isnan(g) & np.isnan(w)
        assert ((g.view(bits) == w.view(bits)) | nan).all(), (g, w)
    else:
        assert (g == w).all(), (g[g != w], w[g != w])


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "mod", "bit_wise_and", "bit_wise_or",
                                  "bit_wise_xor", "max_element_wise",
                                  "min_element_wise"])
@pytest.mark.parametrize("t_a,t_b", [(t, t) for t in INT_TYPES] +
                         [("int32", "uint16"), ("uint8", "int64"),
                          ("int16", "uint32")])
def test_integer_binary_vs_jax(name, t_a, t_b):
    _assert_same(*_pair(name, t_a, t_b))


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "mod", "power", "max_element_wise",
                                  "min_element_wise", "atan2", "hypot",
                                  "logb"])
@pytest.mark.parametrize("t_a,t_b", [("float32", "float32"),
                                     ("float64", "float64"),
                                     ("float32", "float64"),
                                     ("int32", "float32")])
def test_float_binary_vs_jax(name, t_a, t_b):
    rtol = 0.0 if name in ("add", "subtract", "multiply", "divide",
                           "max_element_wise", "min_element_wise") else \
        (1e-13 if "float64" in (t_a, t_b) else 1e-6)
    _assert_same(*_pair(name, t_a, t_b), rtol=rtol)


@pytest.mark.parametrize("name,kind", [("shift_left", "shift"),
                                       ("shift_right", "shift"),
                                       ("power", "exponent")])
@pytest.mark.parametrize("t", INT_TYPES)
def test_shifts_and_integer_power_vs_jax(name, kind, t):
    _assert_same(*_pair(name, t, t, kind=kind))


# (a negative literal meets only signed and float columns)
@pytest.mark.parametrize("name,scalar,t", [
    (name, scalar, t)
    for name, scalar in (("multiply", 3), ("divide", 0), ("subtract", 1.0),
                         ("add", -5), ("power", 3), ("mod", -4),
                         ("max_element_wise", 0))
    for t in ("int32", "uint32", "float32", "uint64")
    if not (isinstance(scalar, int) and scalar < 0 and t.startswith("u"))])
def test_column_and_scalar_vs_jax(name, scalar, t):
    _assert_same(*_pair(name, t, t, scalar_b=scalar),
                 rtol=1e-6 if name == "power" and t == "float32" else 0.0)


def test_element_wise_min_max_null_options_vs_jax():
    from arrow_tpu.ops.scalar_arithmetic import \
        ElementWiseAggregateOptions as JO
    from arrow_tpu_torch.ops.scalar_arithmetic import \
        ElementWiseAggregateOptions as TO
    for skip in (True, False):
        for name in ("max_element_wise", "min_element_wise"):
            _assert_same(*_pair(name, "int64", "int32",
                                options=(JO(skip), TO(skip))))


UNARY_INT = ["negate", "abs", "sign", "floor", "ceil", "trunc",
             "bit_wise_not", "round"]
UNARY_FLOAT = ["negate", "abs", "sign", "floor", "ceil", "trunc", "sqrt",
               "exp", "expm1", "ln", "log2", "log10", "log1p", "sin", "cos",
               "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh",
               "asinh", "acosh", "atanh", "round"]


def _unary(name, t, options=(None, None), seed=1):
    rng = np.random.default_rng(seed)
    rb = pa.record_batch([_col(rng, t)], names=["a"])
    jb = at.Batch.from_pyarrow(rb)
    tb = att.Batch.from_pyarrow(rb, device="cpu")
    return (tc.call_function(name, [tb["a"]], options=options[1])
            .to_pyarrow(),
            jc.call_function(name, [jb["a"]], options=options[0])
            .to_pyarrow())


@pytest.mark.parametrize("t", INT_TYPES)
@pytest.mark.parametrize("name", UNARY_INT + ["sqrt", "ln", "cos"])
def test_unary_integer_vs_jax(name, t):
    _assert_same(*_unary(name, t), rtol=1e-13)


@pytest.mark.parametrize("t", FLOAT_TYPES)
@pytest.mark.parametrize("name", UNARY_FLOAT)
def test_unary_float_vs_jax(name, t):
    exact = name in ("negate", "abs", "sign", "floor", "ceil", "trunc",
                     "round")
    _assert_same(*_unary(name, t),
                 rtol=0.0 if exact else (1e-6 if t == "float32" else 1e-13))


@pytest.mark.parametrize("mode", ["half_to_even", "down", "up",
                                  "towards_zero", "towards_infinity",
                                  "half_down", "half_up",
                                  "half_towards_zero",
                                  "half_towards_infinity"])
@pytest.mark.parametrize("t", FLOAT_TYPES)
def test_round_modes_vs_jax(mode, t):
    for nd in (0, 2, -1):
        _assert_same(*_unary("round", t, (JRound(nd, mode),
                                          TRound(nd, mode))))
    for m in (0.25, 3.0):
        _assert_same(*_unary("round_to_multiple", t,
                             (JRoundM(m, mode), TRoundM(m, mode))))
    _assert_same(*_unary("round_to_multiple", "int32",
                         (JRoundM(5, mode), TRoundM(5, mode))))


@pytest.mark.parametrize("mode", ["half_to_even", "down", "up"])
def test_round_binary_vs_jax(mode):
    rng = np.random.default_rng(3)
    a = _col(rng, "float64")
    nd = pa.array(rng.integers(-2, 4, N).astype(np.int32))
    rb = pa.record_batch([a, nd], names=["a", "n"])
    jb = at.Batch.from_pyarrow(rb)
    tb = att.Batch.from_pyarrow(rb, device="cpu")
    _assert_same(
        tc.call_function("round_binary", [tb["a"], tb["n"]],
                         options=TRound(0, mode)).to_pyarrow(),
        jc.call_function("round_binary", [jb["a"], jb["n"]],
                         options=JRound(0, mode)).to_pyarrow())


@pytest.mark.parametrize("op", ["+", "-", "*", "/"])
def test_expression_operators_vs_jax(op):
    """``field + - * /`` evaluate in the port (ROADMAP C15): the Q3
    project's ``l_price * (1.0 - l_disc)`` is float64 in both packages."""
    from arrow_tpu.compute.expressions import execute_scalar_expression \
        as jexec, field as jf, literal as jl
    from arrow_tpu_torch.compute.expressions import \
        execute_scalar_expression as texec, field as tf, literal as tl
    rng = np.random.default_rng(4)
    rb = pa.record_batch([pa.array(rng.random(N).astype(np.float32) * 100),
                          pa.array(rng.random(N).astype(np.float32) * .1,
                                   mask=rng.random(N) < .1),
                          _col(rng, "int64")], names=["p", "d", "i"])

    def expr(f, lit):
        a, b = f("p"), (lit(1.0) - f("d"))
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[op], \
            {"+": f("i") + lit(3), "-": lit(3) - f("i"),
             "*": f("i") * f("i"), "/": f("i") / lit(7)}[op]

    jb, tb = at.Batch.from_pyarrow(rb), att.Batch.from_pyarrow(rb,
                                                                device="cpu")
    for te, je in zip(expr(tf, tl), expr(jf, jl)):
        got, want = texec(te, tb).to_pyarrow(), jexec(je, jb).to_pyarrow()
        _assert_same(got, want)
    assert texec(expr(tf, tl)[0], tb).type == att.float64
