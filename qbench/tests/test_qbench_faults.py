"""The comparison fails what it must: a whole run on the CPU at a tiny size
(the harness's look for a card skipped) with the timed path broken
underneath sees ``correct`` come out false, once for each fault a
single-card query engine can have; and the control, the reference in
float32 put in the program's place, fails the cells' limits."""

import pytest
import torch

from arrow_tpu_torch.acero import nodes, plan
from arrow_tpu_torch.core.array import Array
from qbench import control, run

CPU = torch.device("cpu")


def _run(bench, workload):
    result, lines = run.run_cell(bench, workload, 77, 0.3, False, CPU)
    return result


def _altered(to_table):
    """A plan whose answer has the first value of its last column altered."""
    def wrapped(self, *a, **kw):
        t = to_table(self, *a, **kw)
        b = t.batches[0]
        x = b.arrays[-1]
        v = x.values.clone()
        v[0] += 1
        first = b.__class__(b.schema, list(b.arrays[:-1]) + [
            Array(x.type, v, x.validity, x.length, x.offsets, x.dictionary,
                  x.children)], b.length)
        return t.__class__(t.schema, [first] + list(t.batches[1:]))
    return wrapped


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_sound_run_is_correct(tiny_bench, workload):
    assert _run(tiny_bench, workload)["correct"] is True


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_answer_altered_where_produced(tiny_bench, workload, monkeypatch):
    monkeypatch.setattr(plan.Declaration, "to_table",
                        _altered(plan.Declaration.to_table))
    assert _run(tiny_bench, workload)["correct"] is False


def _repeated(to_table):
    """A plan whose answer holds its first row twice (a group emitted
    twice)."""
    def wrapped(self, *a, **kw):
        t = to_table(self, *a, **kw)
        b = t.batches[0]
        row = [Array(x.type, x.values if x.offsets is not None
                     else x.values[:1],
                     None if x.validity is None else x.validity[:1], 1,
                     None if x.offsets is None else x.offsets[:2],
                     x.dictionary, x.children) for x in b.arrays]
        return t.__class__(t.schema, list(t.batches) + [
            b.__class__(b.schema, row, 1)])
    return wrapped


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6",
                                      "tiny_h2o.only_q1"])
def test_row_repeated(tiny_bench, workload, monkeypatch):
    monkeypatch.setattr(plan.Declaration, "to_table",
                        _repeated(plan.Declaration.to_table))
    assert _run(tiny_bench, workload)["correct"] is False


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_input_written_in_place(tiny_bench, workload, monkeypatch):
    """A plan that writes into the batches it reads: the references would
    read the same written tensors, so only the inputs' checksum sees it."""
    inner = nodes.TableSourceNode.batches

    def writes(self):
        for b in inner(self):
            x = next(a for a in b.arrays
                     if a.offsets is None and a.dictionary is None)
            x.values[0] += 1
            yield b
    monkeypatch.setattr(nodes.TableSourceNode, "batches", writes)
    result, lines = run.run_cell(tiny_bench, workload, 77, 0.3, False, CPU)
    assert result["checks"]["inputs_changed"]["value"] > 0
    assert result["correct"] is False


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_half_of_the_batches_left_out(tiny_bench, workload, monkeypatch):
    inner = nodes.TableSourceNode.batches

    def half(self):
        for i, b in enumerate(inner(self)):
            if i % 2 == 0:
                yield b
    monkeypatch.setattr(nodes.TableSourceNode, "batches", half)
    assert _run(tiny_bench, workload)["correct"] is False


@pytest.mark.parametrize("workload", ["tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_stale_answer(tiny_bench, workload, monkeypatch):
    """A plan that returns its kind's first answer, whatever the new
    parameters."""
    inner, first = plan.Declaration.to_table, {}

    def stale(self, *a, **kw):
        key = self.to_string()
        key = key.split("(")[0]
        if key not in first:
            first[key] = inner(self, *a, **kw)
        return first[key]
    monkeypatch.setattr(plan.Declaration, "to_table", stale)
    assert _run(tiny_bench, workload)["correct"] is False


@pytest.mark.parametrize("workload", ["tiny_h2o.large_groups",
                                      "tiny_h2o.small_groups",
                                      "tiny_tpch.q3", "tiny_tpch.q1_q6"])
def test_control_fails_the_limits(tiny_bench, workload):
    from qbench import catalog
    limits = catalog.data("limits", workload)
    r = control.readings(tiny_bench, workload, 3, CPU)
    program, low = r["program"]["all"], r["control"]["all"]
    assert program["mismatches"] <= limits["mismatches"]
    assert program["rel_err"] <= limits["rel_err"]
    assert low["mismatches"] > limits["mismatches"] or \
        low["rel_err"] > limits["rel_err"]


@pytest.mark.parametrize("keys", [["k"], []])
def test_repeated_row_never_cancels(keys):
    """A key the answer repeats counts as a wrong row, and no count of rows
    goes below nought to hide another."""
    import numpy as np

    from qbench import check
    want = {"k": np.array([1, 2, 3]), "v": np.array([10, 20, 30])}
    got = {"k": np.array([1, 2, 3, 1]), "v": np.array([10, 20, 30, 10])}
    assert check.compare(got, want, keys, None, None, 0.0)[0] >= 1
    got = {"k": np.array([1, 1, 1]), "v": np.array([10, 10, 99])}
    assert check.compare(got, want, keys, None, None, 0.0)[0] >= 2
    same = {"k": np.array([3, 1, 2]), "v": np.array([30, 10, 20])}
    assert check.compare(same, want, ["k"], None, None, 0.0) == (0, 0.0)
