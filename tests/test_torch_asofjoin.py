"""Port parity: the ``asofjoin`` node (``acero/nodes.py`` ``AsofJoinNode``)
against the JAX package's, a numpy oracle and pyarrow.

Left and right are ordered by ``on`` and staged in small batches of
uneven counts, so that the right side's carry streams, shrinks and is
pulled at several rounds. The port's output equals the JAX package's row
for row and a row-by-row numpy oracle exactly (the right payload and its
nulls). Past matches: the latest right row at or before the left row's
``on`` within |tolerance|; the later right row of a tie wins, as in
pyarrow. Future matches (tolerance >= 0): the earliest at or after it;
among the right rows of that time the later one wins, as the JAX
package's mirrored sort gives it (pyarrow takes the earlier: kept on
record below). pyarrow is wrong where a ``by`` key is null (a probe in
ROADMAP's record of faults outside the JAX package), so null keys are held
against the JAX package and numpy only."""

import numpy as np
import pyarrow as pa
import pyarrow.acero as pac
import pytest

from test_torch_acero import JAX, PORT, _assert_equal, \
    _drop_jax_executables  # noqa: F401 (an autouse fixture)


def _sides(seed, n_left, n_right, n_by=4, null_by=False, span=200,
           unique_right=False):
    """(left, right) pyarrow tables ordered by ``t``: by key ``s`` (nulls
    when ``null_by``), right payload ``rv`` (unique values) and ``rs`` (a
    string with nulls), left payload ``lv``. ``unique_right``: no two
    right rows share (s, t)."""
    rng = np.random.default_rng(seed)
    if unique_right:
        pairs = rng.choice(n_by * span, n_right, replace=False)
        rs_, rt = pairs % n_by, np.sort(pairs // n_by)
        rs_ = rs_[np.argsort(pairs // n_by, kind="stable")]
    else:
        rt = np.sort(rng.integers(0, span, n_right))
        rs_ = rng.integers(0, n_by, n_right)
    lt = np.sort(rng.integers(0, span + 5, n_left))
    ls_ = rng.integers(0, n_by, n_left)
    lmask = rng.random(n_left) < 0.2 if null_by else None
    rmask = rng.random(n_right) < 0.2 if null_by else None
    left = pa.table({"t": lt, "s": pa.array(ls_, mask=lmask),
                     "lv": rng.standard_normal(n_left)})
    right = pa.table({"t": rt, "s": pa.array(rs_, mask=rmask),
                      "rv": np.arange(n_right) * 10,
                      "rs": pa.array([f"q{i}" for i in range(n_right)],
                                     mask=rng.random(n_right) < 0.1)})
    return left, right


def _asof(P, left, right, tol, rows_l=8, rows_r=16, by=("s",)):
    return P.acero.Declaration("asofjoin", P.acero.AsofJoinNodeOptions(
        "t", list(by), "t", list(by), tol), [
        P.acero.Declaration("table_source", P.acero.TableSourceNodeOptions(
            P.table(left, rows_l))),
        P.acero.Declaration("table_source", P.acero.TableSourceNodeOptions(
            P.table(right, rows_r)))]).to_table().to_pyarrow()


def _numpy_matches(left, right, tol, by=("s",)):
    """Each left row's matched right row (-1 for none), row by row: a null
    key equals a null key (as the JAX package groups them)."""
    lk = list(zip(*[left[c].to_pylist() for c in by]))
    rk = list(zip(*[right[c].to_pylist() for c in by]))
    lt, rt = left["t"].to_numpy(), right["t"].to_numpy()
    out = np.full(len(lt), -1)
    for i in range(len(lt)):
        best = -1
        for j in range(len(rt)):
            if rk[j] != lk[i]:
                continue
            d = lt[i] - rt[j] if tol < 0 else rt[j] - lt[i]
            if d < 0 or d > abs(tol):
                continue
            # the nearest; of a tie the later right row
            if best < 0 or abs(rt[j] - lt[i]) <= abs(rt[best] - lt[i]):
                best = j
        out[i] = best
    return out


def _assert_matches(got, left, right, match):
    hit = match >= 0
    assert got["rv"].is_valid().to_pylist() == hit.tolist()
    assert got["rv"].to_numpy(zero_copy_only=False)[hit].tolist() == \
        right["rv"].to_numpy()[match[hit]].tolist()
    want_rs = [right["rs"][int(m)].as_py() if m >= 0 else None
               for m in match]
    assert got["rs"].to_pylist() == want_rs
    _assert_equal(got.select(left.column_names), left)


@pytest.mark.parametrize("tol", [-3, -1000000, 0, 2])
def test_asofjoin_vs_jax_and_numpy(tol):
    left, right = _sides(abs(tol) % 97, 70, 130)
    got = _asof(PORT, left, right, tol)
    _assert_equal(got, _asof(JAX, left, right, tol))
    _assert_matches(got, left, right, _numpy_matches(left, right, tol))


@pytest.mark.parametrize("tol", [-3, -1000000, 0, 2])
def test_asofjoin_vs_pyarrow(tol):
    """Non-null keys without two right rows at one (key, time): pyarrow's
    answer, row for row."""
    left, right = _sides(5 + abs(tol) % 89, 60, 90, unique_right=True)
    got = _asof(PORT, left, right, tol, rows_l=16, rows_r=8)
    want = pac.Declaration("asofjoin", pac.AsofJoinNodeOptions(
        "t", ["s"], "t", ["s"], tol), [
        pac.Declaration("table_source", pac.TableSourceNodeOptions(left)),
        pac.Declaration("table_source", pac.TableSourceNodeOptions(right))
    ]).to_table()
    _assert_equal(got, want)


def test_asofjoin_ties_and_pyarrow_on_record():
    """Two right rows at one time: a past match takes the later in both
    engines; a future match takes the later in the port and the JAX
    package, the earlier in pyarrow."""
    left = pa.table({"t": [5, 5], "s": [1, 2], "lv": [0.5, 1.5]})
    right = pa.table({"t": [5, 5, 7, 7], "s": [1, 1, 2, 2],
                      "rv": [10, 20, 30, 40],
                      "rs": ["a", "b", "c", "d"]})

    def pyarrow_asof(tol):
        return pac.Declaration("asofjoin", pac.AsofJoinNodeOptions(
            "t", ["s"], "t", ["s"], tol), [
            pac.Declaration("table_source", pac.TableSourceNodeOptions(left)),
            pac.Declaration("table_source",
                            pac.TableSourceNodeOptions(right))]).to_table()
    past = _asof(PORT, left, right, -1)
    assert past["rv"].to_pylist() == [20, None] == \
        pyarrow_asof(-1)["rv"].to_pylist()
    future = _asof(PORT, left, right, 5)
    assert future["rv"].to_pylist() == [20, 40] == \
        _asof(JAX, left, right, 5)["rv"].to_pylist()
    assert pyarrow_asof(5)["rv"].to_pylist() == [10, 30]


@pytest.mark.parametrize("tol", [-3, -1000000, 0, 2])
def test_asofjoin_null_by_keys(tol):
    """A null ``by`` key matches a null key, as the JAX package groups it;
    held against the JAX package and numpy (pyarrow is wrong there: the
    probe below keeps its answer on record)."""
    left, right = _sides(11 + abs(tol) % 83, 50, 110, null_by=True)
    got = _asof(PORT, left, right, tol)
    _assert_equal(got, _asof(JAX, left, right, tol))
    _assert_matches(got, left, right, _numpy_matches(left, right, tol))


def test_asofjoin_null_by_probe():
    """The probe: left on [1, 2, 3], by [null, 1, null]; right on
    [0, 1, 2], the same by, rv [10, 20, 30]; tolerance -5. The port and
    the JAX package give [10, 20, 30]; pyarrow gives [10, None, 30]."""
    by = pa.array([None, 1, None], pa.int64())
    left = pa.table({"t": [1, 2, 3], "s": by})
    right = pa.table({"t": [0, 1, 2], "s": by, "rv": [10, 20, 30]})
    got = _asof(PORT, left, right, -5)
    assert got["rv"].to_pylist() == [10, 20, 30]
    assert _asof(JAX, left, right, -5)["rv"].to_pylist() == [10, 20, 30]
    want = pac.Declaration("asofjoin", pac.AsofJoinNodeOptions(
        "t", ["s"], "t", ["s"], -5), [
        pac.Declaration("table_source", pac.TableSourceNodeOptions(left)),
        pac.Declaration("table_source", pac.TableSourceNodeOptions(right))
    ]).to_table()
    assert want["rv"].to_pylist() == [10, None, 30]


def test_asofjoin_two_and_string_by_keys():
    """Two ``by`` keys, one a string: grouped by their content."""
    left, right = _sides(23, 40, 90, n_by=3)
    rng = np.random.default_rng(1)
    left = left.append_column("c", pa.array(rng.choice(["x", "yy"], 40)))
    right = right.append_column("c", pa.array(rng.choice(["x", "yy"], 90)))
    got = _asof(PORT, left, right, -20, by=("s", "c"))
    _assert_equal(got, _asof(JAX, left, right, -20, by=("s", "c")))
    _assert_matches(got, left, right,
                    _numpy_matches(left, right, -20, by=("s", "c")))
