"""Port parity: the boolean, validity and selection functions of
``arrow_tpu_torch.ops.scalar_compare`` against the JAX package's: Kleene
``and_kleene`` / ``or_kleene`` / ``and_not_kleene`` over every pair of
true / false / null (``false & null`` is false, ``true | null`` is true),
the plain boolean functions, the float predicates, ``if_else``,
``coalesce``, ``fill_null``, ``case_when`` and ``choose``; every result
exact in type, nulls and values. Also ``&`` and ``|`` on expressions
(ROADMAP C14)."""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu.compute as jc
import arrow_tpu_torch as att
import arrow_tpu_torch.compute as tc

TRUTH = [True, False, None]
# every (a, b) pair of the three values, and again with the padding
A = pa.array([a for a in TRUTH for _ in TRUTH], pa.bool_())
B = pa.array([b for _ in TRUTH for b in TRUTH], pa.bool_())


def _batches(rb):
    return at.Batch.from_pyarrow(rb), att.Batch.from_pyarrow(rb,
                                                             device="cpu")


def _call(name, cols, extra=(), options=(None, None)):
    """(port result, JAX result) of ``name`` over the columns ``cols`` (a
    dict of pyarrow arrays) and the scalars ``extra``, as pyarrow."""
    rb = pa.record_batch(list(cols.values()), names=list(cols))
    jb, tb = _batches(rb)
    return (tc.call_function(name, [tb[n] for n in cols] + list(extra),
                             options=options[1]).to_pyarrow(),
            jc.call_function(name, [jb[n] for n in cols] + list(extra),
                             options=options[0]).to_pyarrow())


def _same(got, want):
    assert got.type == want.type and got.equals(want), (got, want)


KLEENE_WANT = {
    "and_kleene": [True, False, None, False, False, False, None, False,
                   None],
    "or_kleene": [True, True, True, True, False, None, True, None, None],
    "and_not_kleene": [False, True, None, False, False, False, False, None,
                       None],
}


@pytest.mark.parametrize("name", sorted(KLEENE_WANT))
def test_kleene_truth_tables_vs_jax(name):
    got, want = _call(name, {"a": A, "b": B})
    _same(got, want)
    assert got.to_pylist() == KLEENE_WANT[name]


@pytest.mark.parametrize("name", ["and", "or", "xor", "and_not"])
def test_plain_boolean_vs_jax(name):
    """Null in either input -> null (the registry's intersection)."""
    got, want = _call(name, {"a": A, "b": B})
    _same(got, want)


@pytest.mark.parametrize("name", ["and_kleene", "or_kleene", "xor",
                                  "and_not_kleene"])
@pytest.mark.parametrize("scalar", [True, False])
def test_boolean_with_a_scalar_vs_jax(name, scalar):
    _same(*_call(name, {"a": A}, extra=[scalar]))


@pytest.mark.parametrize("name", ["is_nan", "is_finite", "is_inf",
                                  "true_unless_null", "invert"])
@pytest.mark.parametrize("kind", ["float32", "float64", "int32", "bool"])
def test_predicates_vs_jax(name, kind):
    if kind == "bool":
        col = A
    else:
        v = np.array([0.0, np.nan, np.inf, -np.inf, 1.5, -2.0, 3.0, 4.0,
                      5.0])
        col = pa.array(v.astype(kind) if kind != "int32" else
                       np.arange(9, dtype=np.int32),
                       mask=np.arange(9) % 4 == 3)
    if name == "invert" and kind != "bool":
        return
    if name in ("is_nan", "is_finite", "is_inf") and kind == "bool":
        return
    _same(*_call(name, {"a": col}))


def _num_cols(seed, n=64):
    rng = np.random.default_rng(seed)
    return {
        "c": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.15),
        "x": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.2),
        "y": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                      mask=rng.random(n) < 0.3),
        "f": pa.array(rng.standard_normal(n), mask=rng.random(n) < 0.25),
        "u": pa.array(rng.integers(0, 1 << 40, n).astype(np.uint64),
                      mask=rng.random(n) < 0.2),
    }


@pytest.mark.parametrize("left,right", [("x", "y"), ("x", "f"), ("u", "u"),
                                        ("y", 7), (2.5, "f")])
def test_if_else_vs_jax(left, right):
    cols = _num_cols(1)
    names = ["c"] + [c for c in (left, right) if isinstance(c, str)]
    rb = pa.record_batch([cols[n] for n in names], names=names)
    jb, tb = _batches(rb)

    def args(b):
        return [b["c"]] + [b[c] if isinstance(c, str) else c
                           for c in (left, right)]
    _same(tc.call_function("if_else", args(tb)).to_pyarrow(),
          jc.call_function("if_else", args(jb)).to_pyarrow())


@pytest.mark.parametrize("names", [["x", "y"], ["y", "x", "f"], ["u", "u"]])
def test_coalesce_vs_jax(names):
    cols = _num_cols(2)
    rb = pa.record_batch([cols[n] for n in dict.fromkeys(names)],
                         names=list(dict.fromkeys(names)))
    jb, tb = _batches(rb)
    _same(tc.call_function("coalesce", [tb[n] for n in names] + [0])
          .to_pyarrow(),
          jc.call_function("coalesce", [jb[n] for n in names] + [0])
          .to_pyarrow())


@pytest.mark.parametrize("col,fill", [("x", -1), ("f", 0.5), ("y", "x"),
                                      ("u", "u")])
def test_fill_null_vs_jax(col, fill):
    cols = _num_cols(3)
    names = [col] + ([fill] if isinstance(fill, str) and fill != col
                     else [])
    rb = pa.record_batch([cols[n] for n in names], names=names)
    jb, tb = _batches(rb)

    def args(b):
        return [b[col], b[fill] if isinstance(fill, str) else fill]
    _same(tc.call_function("fill_null", args(tb)).to_pyarrow(),
          jc.call_function("fill_null", args(jb)).to_pyarrow())


@pytest.mark.parametrize("with_else", [True, False])
def test_case_when_vs_jax(with_else):
    """First true condition wins; a null condition does not match; no
    match and no else -> null."""
    rng = np.random.default_rng(4)
    n = 64
    conds = pa.record_batch(
        [pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.2),
         pa.array(rng.random(n) < 0.5)], names=["c0", "c1"])
    cols = _num_cols(5, n)
    vals = pa.record_batch([cols["x"], cols["y"]], names=["x", "y"])
    jc_, tc_ = _batches(conds)
    jv, tv = _batches(vals)
    tail = [99] if with_else else []
    _same(tc.call_function("case_when", [tc_, tv["x"], tv["y"]] + tail)
          .to_pyarrow(),
          jc.call_function("case_when", [jc_, jv["x"], jv["y"]] + tail)
          .to_pyarrow())


def test_choose_vs_jax():
    rng = np.random.default_rng(6)
    n = 64
    cols = _num_cols(7, n)
    idx = pa.array(rng.integers(0, 3, n).astype(np.int8),
                   mask=rng.random(n) < 0.1)
    rb = pa.record_batch([idx, cols["x"], cols["y"]], names=["i", "x", "y"])
    jb, tb = _batches(rb)
    _same(tc.call_function("choose", [tb["i"], tb["x"], tb["y"], -3])
          .to_pyarrow(),
          jc.call_function("choose", [jb["i"], jb["x"], jb["y"], -3])
          .to_pyarrow())


@pytest.mark.parametrize("op", ["&", "|"])
def test_expression_and_or_are_kleene_vs_jax(op):
    """``a & b`` and ``a | b`` on expressions build Kleene calls and run in
    the port (ROADMAP C14), with nulls on both sides."""
    from arrow_tpu.compute.expressions import execute_scalar_expression \
        as jexec, field as jf, literal as jl
    from arrow_tpu_torch.compute.expressions import \
        execute_scalar_expression as texec, field as tf, literal as tl
    cols = _num_cols(8)
    rb = pa.record_batch([cols["x"], cols["f"]], names=["x", "f"])
    jb, tb = _batches(rb)

    def expr(f, lit):
        a, b = f("x") > lit(0), f("f") < lit(0.5)
        return a & b if op == "&" else a | b
    _same(texec(expr(tf, tl), tb).to_pyarrow(),
          jexec(expr(jf, jl), jb).to_pyarrow())
