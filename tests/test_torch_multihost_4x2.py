"""The port's distributed operators across 4 processes x 2 logical CPU
shards over gloo: every case of ``entry.DIST_CASES`` started once in the
layout, every process's results equal, bit for bit and in row order, to
the single-controller port's over the same 8-shard mesh, and the Q3
Declaration with ``dist=`` against the JAX package's plan over its 8
devices (the 2 x 4 layout and the other comparisons with the JAX package
and pyarrow are in ``test_torch_multihost.py``)."""

import pytest

from arrow_tpu.parallel import DistContext as JDistContext
from arrow_tpu_torch.entry import DIST_CASES, example_columns_q3
from test_torch_dryrun import _assert_top10_equal, _jax_q3
from test_torch_multihost import _host_table, assert_case_equal, run_layout


@pytest.fixture(scope="module")
def layout():
    return run_layout(4)


@pytest.mark.parametrize("case", DIST_CASES)
def test_four_processes_equal_single_controller(layout, case):
    want, got = layout
    assert len(got) == 4
    assert_case_equal(want, got, case)


def test_four_process_workers_import_no_jax(layout):
    _, got = layout
    assert [bool(a["imported_jax"]) for a in got] == [False] * 4


def test_four_process_q3_vs_jax_dist_plan(layout):
    """The Q3 Declaration with ``dist=`` (the streaming ``DistHashJoin``
    and ``DistGroupBy`` across the processes) on the case's 768 lineitem
    rows in 64-row batches: every process's top 10 equal the JAX package's
    plan with ``dist=`` over its 8 devices, keys, dates and order exactly,
    revenue within 1e-12 * revenue + 1e-12 (revenue is a sum of positive
    terms)."""
    _, got = layout
    want = _jax_q3(*example_columns_q3(768, 0), JDistContext())
    for arrays in got:
        _assert_top10_equal(
            _host_table(arrays, "q3", want.column_names), want)
