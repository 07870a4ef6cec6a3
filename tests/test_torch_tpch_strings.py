"""The string workloads of the port on the CPU: TPC-H Q13 (its regex
filter at the host hop) and Q22 (its substring on the device) at SF 0.01
against pyarrow's run of the same queries over the same generated tables,
and bench.py's host_boundary regex filter at 2^17 rows in both stagings
(a dictionary: the regex's dictionary branch; a plain varlen column: the
device pushdown) against Python ``re`` over the 4,096 words."""

import numpy as np
import pytest

from arrow_tpu_torch import entry as E
from arrow_tpu_torch.ops import strings_regex


def test_q13_against_pyarrow():
    step, args = E.entry_q13("cpu", 0.01)
    strings_regex.reset_host_hops()
    got = step(*args)
    assert dict(strings_regex.HOST_HOPS) == {"direct": 1}
    want = E.q13_pyarrow(step.source)
    assert got.column_names == ("c_count", "custdist")
    assert got.to_pydict() == want.to_pydict()
    # customer keys = 0 (mod 3) place no orders: a third count 0
    d = got.to_pydict()
    assert d["custdist"][d["c_count"].index(0)] == 500


def test_q13_orders_in_small_batches():
    """Orders in 4,096-row batches: one host hop a batch."""
    step, args = E.entry_q13("cpu", 0.01, max_groups=256,
                             max_batch_rows=4096)
    strings_regex.reset_host_hops()
    got = step(*args)
    assert dict(strings_regex.HOST_HOPS) == {"direct": 4}
    assert got.to_pydict() == E.q13_pyarrow(step.source).to_pydict()


def test_q22_against_pyarrow():
    step, args = E.entry_q22("cpu", 0.01)
    got = step(*args).to_pydict()
    want = E.q22_pyarrow(step.source).to_pydict()
    assert got["cntrycode"] == want["cntrycode"] and \
        set(got["cntrycode"]) <= set(E.Q22_CODES)
    assert got["numcust"] == want["numcust"]
    g, w = np.array(got["totacctbal"]), np.array(want["totacctbal"])
    assert np.all(np.abs(g - w) <= 1e-12 * np.abs(w) + 1e-12), (g, w)


@pytest.mark.parametrize("staging,branch", [("dictionary", "dictionary"),
                                            ("plain", "pushdown")])
def test_host_boundary(staging, branch):
    n = 1 << 17
    step, (b,) = E.entry_host_boundary("cpu", n, staging=staging)
    keep, v_kept = E.host_boundary_numpy(n, 7)
    strings_regex.reset_host_hops()
    out = step(b)
    assert dict(strings_regex.HOST_HOPS) == {branch: 1}
    assert len(out) == int(keep.sum()) > 0
    np.testing.assert_array_equal(out.column("v").values[:len(out)].numpy(),
                                  v_kept)
    codes, _ = E.example_columns_host_boundary(n, 7)
    assert out.column("s").to_pylist() == E.HB_WORDS[codes[keep]].tolist()
