"""The comparison that decides ``correct``.

A query's answer (the port's result Table, copied to the host as numpy
columns by ``host_columns``) is held against its reference's
(``reference/<query>.py``: ``answer(tables, params, dtype)`` and the
``KEYS``, ``ORDER`` and ``LIMIT`` of the query). Two numbers come of it:

- ``mismatches``: rows the answer lacks or has too many of, rows whose
  integer, date or string values differ, and rows out of the query's order;
  exact, so its limit is 0;
- ``rel_err``: the largest |answer - reference| / |reference| over the float
  values of the rows matched by their keys.

A result under a ``LIMIT`` (a top-k) is held to the reference's whole
answer: each of its rows must rank within the reference's first k, and each
row that ranks above the k-th by more than the cell's ``rel_err`` limit must
be there; a near tie at the k-th row may go either way.
"""

from __future__ import annotations

import numpy as np
import torch

from qbench.data import strings


def host_columns(table) -> dict:
    """The columns of a port Table (host lengths, as ``to_table`` returns)
    as numpy arrays: fixed-width values as they are, dictionary and string
    columns as ``bytes_``. Reads the Arrays' tensors, not pyarrow."""
    out = {}
    for i, name in enumerate(table.schema.names):
        parts = []
        for b in table.batches:
            a, n = b.arrays[i], int(b.length)
            if a.dictionary is not None:
                d = a.dictionary
                parts.append(strings(d.offsets, d.values,
                                     a.values[:n].to(torch.int64)))
            elif a.offsets is not None:
                parts.append(strings(a.offsets[:n + 1], a.values))
            else:
                parts.append(a.values[:n].cpu().numpy())
        if parts and parts[0].dtype.kind == "S":
            width = max(p.dtype.itemsize for p in parts)
            parts = [p.astype(f"S{width}") for p in parts]
        out[name] = np.concatenate(parts) if parts else np.zeros(0)
    return out


def _keys(a: dict, b: dict, keys: list) -> tuple:
    """Structured arrays of the key columns of ``a`` and ``b`` in common
    dtypes (row indices where there are no keys: a scalar answer has one
    row)."""
    if not keys:
        return (np.arange(len(next(iter(a.values())))),
                np.arange(len(next(iter(b.values())))))
    cols_a, cols_b = [], []
    for k in keys:
        x, y = a[k], b[k]
        common = np.result_type(x.dtype, y.dtype) if x.dtype.kind != "S" \
            else np.dtype(f"S{max(x.dtype.itemsize, y.dtype.itemsize)}")
        cols_a.append(x.astype(common))
        cols_b.append(y.astype(common))
    return (np.rec.fromarrays(cols_a, names=keys),
            np.rec.fromarrays(cols_b, names=keys))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    got, want = got.astype(np.float64), want.astype(np.float64)
    if got.size == 0:
        return 0.0
    diff = np.abs(got - want)
    scale = np.abs(want)
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(diff == 0, 0.0, diff / scale)
    rel = np.where(np.isnan(rel), np.inf, rel)
    return float(rel.max())


def _order_key(cols: dict, order: list) -> np.ndarray:
    """The rows' ranks by ``order`` (descending float / integer columns
    negated; strings ascending only)."""
    arrays = []
    for name, direction in reversed(order):
        v = cols[name]
        if direction == "descending":
            v = -v.astype(np.float64)
        arrays.append(v)
    return np.lexsort(arrays)


def head(cols: dict, order: list, limit: int) -> dict:
    """The first ``limit`` rows of ``cols`` in ``order`` (the shape of a
    top-k answer, for a reference put in the program's place)."""
    rank = _order_key(cols, order)[:limit]
    return {k: v[rank] for k, v in cols.items()}


def compare(got: dict, want: dict, keys: list, order, limit,
            tie: float) -> tuple:
    """(mismatches, rel_err) of the answer ``got`` against ``want``; ``tie``
    is the relative gap within which two values of the order's first
    column count as tied."""
    if set(got) != set(want):
        return max(len(next(iter(want.values()), [])), 1), 0.0
    n_got = len(next(iter(got.values()))) if got else 0
    n_want = len(next(iter(want.values()))) if want else 0
    bad = 0
    if limit is not None:
        rank = _order_key(want, order)
        want = {k: v[rank] for k, v in want.items()}
    gk, wk = _keys(got, want, keys)
    if keys:
        # a key the answer repeats is a wrong row each time it repeats;
        # the rows are matched by their first occurrence
        _, first_got = np.unique(gk, return_index=True)
        bad += n_got - len(first_got)
        _, ig, iw = np.intersect1d(gk[first_got], wk, assume_unique=True,
                                   return_indices=True)
        ig = first_got[ig]
        n_distinct = len(first_got)
    else:
        m = min(n_got, n_want)
        ig = iw = np.arange(m)
        n_distinct = n_got
    # rows of the answer that the reference lacks
    bad += n_distinct - len(ig)
    if limit is None:
        # rows of the reference that the answer lacks
        bad += n_want - len(iw)
    else:
        bad += abs(n_got - min(limit, n_want))
        first, direction = order[0]
        if n_want and n_got:
            kth = float(want[first][min(limit, n_want) - 1])
            slack = tie * abs(kth)
            sign = 1.0 if direction == "descending" else -1.0
            # every matched row ranks within the first k, up to a tie
            ranked = sign * (want[first][iw].astype(np.float64) - kth)
            bad += int(np.sum(ranked < -slack))
            # every row clearly above the k-th is in the answer
            above = np.flatnonzero(
                sign * (want[first].astype(np.float64) - kth) > slack)
            bad += int(np.sum(~np.isin(above, iw)))
    if order is not None and n_got > 1:
        bad += _out_of_order(got, order, tie)
    rel = 0.0
    wrong_rows = np.zeros(len(ig), dtype=bool)
    for name in got:
        if name in keys:
            continue
        g, w = got[name][ig], want[name][iw]
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            rel = max(rel, _rel(g, w))
        else:
            wrong_rows |= g != w
    return bad + int(wrong_rows.sum()), rel


def _out_of_order(got: dict, order: list, tie: float) -> int:
    """Adjacent pairs of the answer's rows out of ``order``: the first
    column decides unless its values tie (exact for integers and strings,
    within ``tie`` for floats); a tie passes to the next column."""
    n = len(got[order[0][0]])
    undecided = np.ones(n - 1, dtype=bool)
    bad = np.zeros(n - 1, dtype=bool)
    for name, direction in order:
        v = got[name]
        a, b = v[:-1], v[1:]
        if v.dtype.kind == "f":
            a, b = a.astype(np.float64), b.astype(np.float64)
            tied = np.abs(a - b) <= tie * np.maximum(np.abs(a), np.abs(b))
        else:
            tied = a == b
        wrong = (a < b) if direction == "descending" else (a > b)
        bad |= undecided & ~tied & wrong
        undecided &= tied
    return int(bad.sum())
