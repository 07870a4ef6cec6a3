"""Port parity of ``ops/pivot`` (``hash_pivot_wider`` through the aggregate
node, ``Table.group_by`` and ``DistContext.group_by`` over 4 logical
shards; the scalar ``pivot_wider``) and of the ``pivot_longer`` node;
against pyarrow's ``group_by(..., use_threads=False)`` and the JAX
package's plans on the same tables. Mirrors the JAX package's
``tests/test_pivot.py`` and the ``pivot_longer`` cases of
``tests/test_acero_nodes2.py``.
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow_tpu as at
from arrow_tpu import acero as jacero
from arrow_tpu.ops.agg_options import PivotWiderOptions as JOpts
from arrow_tpu.ops.hash_aggregate import AggregateSpec as JSpec
from arrow_tpu_torch import acero as tacero
from arrow_tpu_torch import compute as tc
from arrow_tpu_torch.core import interop as tinterop
from arrow_tpu_torch.core.batch import Table
from arrow_tpu_torch.ops.agg_options import PivotWiderOptions
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec


def _port(pt, key_names, max_batch_rows=None, behavior="ignore"):
    t = Table.from_pyarrow(pt, device="cpu")
    src = tacero.TableSourceNodeOptions(t, max_batch_rows or (1 << 15))
    return tacero.Declaration(
        "aggregate", tacero.AggregateNodeOptions(
            [AggregateSpec("hash_pivot_wider", ("k", "v"), PivotWiderOptions(
                key_names, behavior))], keys=["g"]),
        inputs=[tacero.Declaration("table_source", src)]
    ).to_table().to_pyarrow()


def _jax(pt, key_names, max_batch_rows=None, behavior="ignore"):
    src = jacero.TableSourceNodeOptions(at.table(pt), max_batch_rows) \
        if max_batch_rows else jacero.TableSourceNodeOptions(at.table(pt))
    return jacero.Declaration(
        "aggregate", jacero.AggregateNodeOptions(
            [JSpec("hash_pivot_wider", ("k", "v"),
                   JOpts(key_names, behavior))], keys=["g"]),
        inputs=[jacero.Declaration("table_source", src)]
    ).to_table().to_pyarrow()


def _oracle(pt, key_names, behavior="ignore"):
    return pt.group_by(["g"], use_threads=False).aggregate(
        [(("k", "v"), "pivot_wider", pc.PivotWiderOptions(
            key_names=key_names, unexpected_key_behavior=behavior))])


def _unique_pairs(rng, n, ngroups, keys, values):
    g = rng.integers(0, ngroups, n)
    k = np.array(keys)[rng.integers(0, len(keys), n)]
    seen, keep = set(), []
    for i in range(n):
        keep.append((int(g[i]), str(k[i])) not in seen)
        seen.add((int(g[i]), str(k[i])))
    keep = np.asarray(keep)
    return pa.table({"g": g[keep], "k": k[keep],
                     "v": values(int(keep.sum()))})


CASES = {
    "basic": (pa.table({"g": [1, 1, 2, 3], "k": ["h", "w", "w", "h"],
                        "v": [11, 12, 13, 14]}), ["h", "w"], None),
    "null_values": (pa.table({"g": [1, 1, 1, 2, 2],
                              "k": ["h", "w", "w", "h", "w"],
                              "v": [11, None, 5, None, 13]}),
                    ["h", "w"], None),
    "unexpected_ignored": (pa.table({"g": [1, 1], "k": ["h", "zz"],
                                     "v": [1, 2]}), ["h", "w"], None),
    "bool_values": (pa.table({"g": [1, 2], "k": ["x", "y"],
                              "v": [True, False]}), ["x", "y"], None),
    "multi_batch": (_unique_pairs(np.random.default_rng(7), 300, 60,
                                  ["a", "b", "c", "d"],
                                  lambda m: np.random.default_rng(8)
                                  .normal(size=m)),
                    ["a", "b", "c", "d"], 32),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_pivot_matches_pyarrow_and_jax(case):
    pt, names, rows = CASES[case]
    got = _port(pt, names, rows).sort_by("g")
    assert got.equals(_oracle(pt, names).sort_by("g"))
    assert got.equals(_jax(pt, names, rows).sort_by("g"))


@pytest.mark.parametrize("what,pt,behavior", [
    ("duplicate", pa.table({"g": [1, 1], "k": ["h", "h"], "v": [1, 2]}),
     "ignore"),
    ("cannot be null", pa.table({"g": [1, 2], "k": ["h", None],
                                 "v": [1, 2]}), "ignore"),
    ("unexpected", pa.table({"g": [1, 1], "k": ["h", "zz"], "v": [1, 2]}),
     "raise")])
def test_hash_pivot_errors(what, pt, behavior):
    """The port raises through the aggregate node, as pyarrow does. C30
    (g): the JAX plan returns a table and raises nothing (its own
    ``tests/test_pivot.py`` error cases fail in its slow lane)."""
    with pytest.raises(RuntimeError, match=what):
        _port(pt, ["h", "w"], behavior=behavior)
    with pytest.raises(pa.ArrowException):
        _oracle(pt, ["h", "w"], behavior)
    assert _jax(pt, ["h", "w"], behavior=behavior).num_rows >= 1


def test_hash_pivot_through_table_group_by_and_four_shards():
    """``Table.group_by`` with a (key, value) target, and
    ``DistContext.group_by`` over 4 logical shards (the raw-row shuffle:
    the grid is not one row per group), equal one device's; the linenumber
    pivot of the order-baskets path at a small size."""
    from arrow_tpu_torch.parallel import DistContext
    rng = np.random.default_rng(2)
    n_orders = 300
    lines = rng.integers(1, 8, n_orders)
    pt = pa.table({
        "g": np.repeat(np.arange(n_orders), lines),
        "k": pa.array(np.concatenate([np.arange(1, m + 1) for m in lines])
                      .astype(str)),
        "v": rng.integers(1, 51, int(lines.sum())).astype(np.float64)})
    names = [str(i) for i in range(1, 8)]
    opts = PivotWiderOptions(names)
    rows = {}
    for g, k, v in zip(*(pt[c].to_pylist() for c in ("g", "k", "v"))):
        rows.setdefault(g, dict.fromkeys(names))[k] = v
    want = [rows[g] for g in sorted(rows)]
    tt = Table.from_pyarrow(pt, max_rows_per_batch=256, device="cpu")
    got = tt.group_by("g", max_groups=512).aggregate(
        [(("k", "v"), "pivot_wider", opts)]).to_pyarrow().sort_by("g")
    assert got["k_v_pivot_wider"].to_pylist() == want
    assert got.equals(_jax(pt, names, 256).sort_by("g"))
    ctx = DistContext(devices=["cpu"] * 4)
    # the exchange moves strings dictionary-encoded
    enc = pt.set_column(1, "k", pc.dictionary_encode(pt["k"]))
    dist = ctx.group_by(tinterop.batch_from_pyarrow(enc, device="cpu"),
                        ["g"], [AggregateSpec("hash_pivot_wider",
                                              ("k", "v"), opts)],
                        max_groups_per_shard=512).to_pyarrow().sort_by("g")
    assert dist.equals(got)
    # on record: pyarrow 25 puts key "6" under field "7" and key "7"
    # under "6" with these key names (its scalar pivot_wider too)
    oracle = _oracle(pt, names).sort_by("g")["k_v_pivot_wider"].to_pylist()
    swapped = [dict(r, **{"6": r["7"], "7": r["6"]}) for r in want]
    assert oracle == swapped != want


def test_scalar_pivot():
    from arrow_tpu import compute as jc
    k = pa.array(["h", "w"])
    v = pa.array([1, 2])
    opts = PivotWiderOptions(["h", "w", "d"])
    s = tc.call_function("pivot_wider", [tinterop.array_from_pyarrow(
        k, device="cpu"), tinterop.array_from_pyarrow(v, device="cpu")],
        options=opts)
    assert s.as_py() == {"h": 1, "w": 2, "d": None} == pc.pivot_wider(
        k, v, key_names=["h", "w", "d"]).as_py()
    assert s.as_py() == jc.call_function(
        "pivot_wider", [at.array(k), at.array(v)],
        options=JOpts(["h", "w", "d"])).as_py()
    with pytest.raises(RuntimeError, match="duplicate"):
        tc.call_function("pivot_wider", [tinterop.array_from_pyarrow(
            pa.array(["h", "h"]), device="cpu"),
            tinterop.array_from_pyarrow(v, device="cpu")],
            options=PivotWiderOptions(["h"]))


@pytest.mark.parametrize("templates,features,measures", [
    ([(["jan"], ["jan"]), (["feb"], ["feb"])], ["month"], ["value"]),
    ([(["ab"], ["jan", "feb"]), (["a-only"], ["jan", None])], ["which"],
     ["x", "y"])])
def test_pivot_longer(templates, features, measures):
    t = pa.table({"name": pa.array([10, 20], pa.int64()),
                  "jan": pa.array([1.0, 2.0]), "feb": pa.array([3.0, 4.0])})
    got = tacero.Declaration.from_sequence([
        tacero.Declaration("table_source", tacero.TableSourceNodeOptions(
            Table.from_pyarrow(t, device="cpu"))),
        tacero.Declaration("pivot_longer", tacero.PivotLongerNodeOptions(
            features, measures, templates))]).to_table().to_pyarrow()
    want = jacero.Declaration.from_sequence([
        jacero.Declaration("table_source",
                           jacero.TableSourceNodeOptions(at.table(t))),
        jacero.Declaration("pivot_longer", jacero.PivotLongerNodeOptions(
            features, measures, templates))]).to_table().to_pyarrow()
    assert got.equals(want)
    if features == ["month"]:
        assert got["month"].to_pylist() == ["jan", "jan", "feb", "feb"]
        assert got["value"].to_pylist() == [1.0, 2.0, 3.0, 4.0]
    else:
        assert got["y"].to_pylist() == [3.0, 4.0, None, None]
