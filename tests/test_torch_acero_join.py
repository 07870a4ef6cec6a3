"""Port parity of the plan engine's hash join node: each join type, on the
packed route and (two wide keys) on the "sort" route, with the Bloom
pushdown on and off, against the JAX package's node over the same tables;
rows compare as multisets (integers and nulls exactly, floats by their
bits). The JAX side runs once per join type and route: the pushdown does
not change a join's rows."""

import pytest

from test_torch_acero import JAX, PORT, _drop_jax_executables, _join_plan, \
    _join_tables, _rows, _run  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("join_type,wide", [
    (jt, False) for jt in ("inner", "left outer", "left semi", "left anti",
                           "full outer")] +
    [(jt, True) for jt in ("inner", "left semi", "left anti")])
def test_hashjoin_node_vs_jax(join_type, wide):
    lt, rt = _join_tables(300, 120, 9, wide)
    keys = ["k", "k2"] if wide else ["k"]
    kw = {}
    if join_type in ("inner", "left outer", "full outer"):
        kw = dict(output_suffix_for_left="_l", output_suffix_for_right="_r")
    want = _run(JAX, _join_plan, lt, rt, join_type=join_type, keys=keys,
                **kw)
    for bloom in (True, False):
        got = _run(PORT, _join_plan, lt, rt, join_type=join_type, keys=keys,
                   bloom=bloom, **kw)
        assert got.column_names == want.column_names
        assert got.schema.types == want.schema.types
        assert _rows(got) == _rows(want), bloom
