"""The slice's card paths at SF 0.01 on the CPU: the word count over TPC-H
``o_comment`` (``entry_wordcount``) against pyarrow and the JAX package;
the order baskets of lineitem (``entry_baskets``) against the numpy
oracle, the numpy oracle against pyarrow's ``group_by(...,
use_threads=False)`` with ``list`` and ``pivot_wider``, and the port's
plan against the JAX package's aggregate and functions; the run-end
encoding of the sorted
l_orderkey (``entry_ree_keys``) against numpy and the JAX package.
"""

from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow_tpu as at
from arrow_tpu import compute as jc
from arrow_tpu_torch import entry as E

SF = 0.01


@pytest.fixture(scope="module")
def wordcount():
    step, args = E.entry_wordcount("cpu", SF)
    return step, step(*args)


@pytest.fixture(scope="module")
def baskets():
    step, args = E.entry_baskets("cpu", SF)
    return step, step(*args)


def test_wordcount_matches_pyarrow(wordcount):
    step, out = wordcount
    got = out.to_pyarrow()
    assert got.equals(E.wordcount_pyarrow(step.source))
    assert got.num_rows > 1000 and got["count"][0].as_py() > 1000


def test_wordcount_matches_jax(wordcount):
    """The JAX package's split, flatten and count (its split is a Python
    loop over the rows) on the same comments."""
    step, out = wordcount
    comments = step.source["orders"]["o_comment"].combine_chunks()
    words = jc.call_function("list_flatten", [jc.call_function(
        "utf8_split_whitespace", [at.array(comments)])])
    counts = at.Table.from_pyarrow(pa.table({
        "word": words.to_pyarrow()})).group_by("word").aggregate(
        [([], "count_all")]).to_pyarrow()
    want = dict(zip(counts["word"].to_pylist(),
                    counts["count_all"].to_pylist()))
    got = out.to_pyarrow()
    assert dict(zip(got["word"].to_pylist(), got["count"].to_pylist())) == \
        want


def test_baskets_match_numpy(baskets):
    step, out = baskets
    want = E.baskets_numpy(step.source)
    assert E.baskets_differ(E.baskets_arrays(out), want) == []
    assert len(want["l_orderkey"]) > 1000


def test_baskets_numpy_oracle_against_pyarrow(baskets):
    """The numpy oracle's lists equal pyarrow's ``list``; its quantities
    equal pyarrow's ``pivot_wider`` but for the fields "6" and "7", which
    pyarrow 25 swaps with these key names (on record in
    ``test_torch_pivot``)."""
    step, _ = baskets
    li = step.source["lineitem"]
    want = E.baskets_numpy(step.source)
    t = pa.table({"k": li["l_orderkey"], "p": li["l_partkey"],
                  "ln": pc.cast(li["l_linenumber"], pa.string()),
                  "q": li["l_quantity"]})
    g = t.group_by("k", use_threads=False).aggregate([
        ("p", "list"), (("ln", "q"), "pivot_wider", pc.PivotWiderOptions(
            key_names=list(E.BASKET_LINES)))]).sort_by("k")
    lists = g["p_list"].to_pylist()
    n = np.array([len(x) for x in lists])
    keep = n >= E.BASKET_MIN_PARTS
    np.testing.assert_array_equal(g["k"].to_numpy()[keep],
                                  want["l_orderkey"])
    flat = [v for x, k in zip(lists, keep) if k for v in x]
    np.testing.assert_array_equal(flat, want["parts"])
    piv = [r for r, k in zip(g["ln_q_pivot_wider"].to_pylist(), keep) if k]
    for name in E.BASKET_LINES:
        other = {"6": "7", "7": "6"}.get(name, name)
        got = np.array([r[other] or 0.0 for r in piv])
        ok = np.array([r[other] is not None for r in piv])
        np.testing.assert_array_equal(ok, want[f"qty_{name}_valid"])
        np.testing.assert_array_equal(got, want[f"qty_{name}"])


def test_baskets_match_jax(baskets):
    """The JAX package's aggregate (``list`` and ``pivot_wider`` by
    l_orderkey) and its four functions on the same lineitem, filtered on
    the host. C30 (h): the JAX plan cannot run this Declaration whole: its
    project node sizes its output on ``empty_batch``, which has no list
    layout."""
    from arrow_tpu.ops.agg_options import PivotWiderOptions
    from arrow_tpu.ops.hash_aggregate import AggregateSpec, HashAggregate
    from arrow_tpu.ops.nested import ListSliceOptions, StructFieldOptions
    step, out = baskets
    src = step.source["lineitem"]
    li = pa.table({"l_orderkey": src["l_orderkey"],
                   "l_partkey": src["l_partkey"],
                   "l_quantity": src["l_quantity"],
                   "ln": pc.cast(src["l_linenumber"], pa.string())})
    jt = at.Table.from_pyarrow(li, max_rows_per_batch=1 << 17)
    ha = HashAggregate(jt.schema, ["l_orderkey"], [
        AggregateSpec("hash_list", "l_partkey",
                      SimpleNamespace(buffer_rows=1 << 17), "parts"),
        AggregateSpec("hash_pivot_wider", ("ln", "l_quantity"),
                      PivotWiderOptions(list(E.BASKET_LINES)), "qty")],
        max_groups=1 << 14)
    st = ha.init_state()
    for b in jt.batches:
        st = ha.consume(st, b)
    agg = ha.finalize(st)
    parts, qty = agg.column("parts"), agg.column("qty")
    cols = {"l_orderkey": agg.column("l_orderkey").to_pyarrow(),
            "parts": parts.to_pyarrow(), "qty": qty.to_pyarrow(),
            "n": jc.call_function("list_value_length",
                                  [parts]).to_pyarrow(),
            "first": jc.call_function("list_element",
                                      [parts, 0]).to_pyarrow(),
            "top3": jc.call_function("list_slice", [parts],
                                     ListSliceOptions(0, 3)).to_pyarrow(),
            "q1": jc.call_function("struct_field", [qty],
                                   StructFieldOptions(name="1")).to_pyarrow()}
    want = pa.table(cols)
    want = want.filter(pc.greater_equal(want["n"], E.BASKET_MIN_PARTS))
    got = out.to_pyarrow()
    assert got.sort_by("l_orderkey").equals(want.sort_by("l_orderkey"))


def test_ree_keys_match_numpy_and_jax():
    step, args = E.entry_ree_keys("cpu", SF, max_batch_rows=1 << 14)
    res = step(*args)
    assert len(res) == len(args[0].batches) > 1
    for (enc, dec), b in zip(res, args[0].batches):
        col = b.column("l_orderkey")
        k = col.values[:len(col)].numpy()
        np.testing.assert_array_equal(enc.offsets[1:len(enc) + 1].numpy(),
                                      E.ree_runs_numpy(k))
        np.testing.assert_array_equal(dec.values[:len(dec)].numpy(), k)
    col = args[0].batches[0].column("l_orderkey")
    j = jc.call_function("run_end_encode", [at.array(col.to_pyarrow())])
    enc = res[0][0]
    np.testing.assert_array_equal(enc.offsets[:len(enc) + 1].numpy(),
                                  np.asarray(j.offsets)[:len(enc) + 1])
