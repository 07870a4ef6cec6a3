"""``Table.join`` coalesces its keys as ``pyarrow.Table.join`` does (ROADMAP
C34): each key column appears once, placed as pyarrow places it (the
right's for a right outer join), and a full outer join's key is the left
key where the left row exists, else the right key. ``coalesce_keys=False``
gives every column of both sides, the JAX package's result.

Keys of int64, a string, a dictionary, and two keys, with null keys on both
sides; all eight join types; rows compared as multisets (join output order
is free), dictionaries decoded.
"""

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
from arrow_tpu_torch.core.batch import Table

JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti"]
KEY_KINDS = ["int64", "string", "dictionary", "two_keys"]


def sides(kind: str, n_left: int = 40, n_right: int = 24, seed: int = 3):
    """(left, right, keys): tables whose keys overlap in part, one in
    seven of them null."""
    rng = np.random.default_rng(seed)

    def key(n):
        ints = rng.integers(0, 16, n)
        mask = rng.random(n) < 1 / 7
        if kind == "int64":
            return pa.array(ints, mask=mask)
        words = pa.array([f"key{int(i):02d}" + "x" * int(i % 5)
                          for i in ints], mask=mask)
        return words.dictionary_encode() if kind == "dictionary" else words

    def table(n, payload):
        cols = {"k": key(n)}
        if kind == "two_keys":
            cols["j"] = pa.array(rng.integers(0, 3, n),
                                 mask=rng.random(n) < 0.1)
        cols[payload] = pa.array(rng.integers(0, 1000, n))
        return pa.table(cols)
    keys = ["k", "j"] if kind == "two_keys" else ["k"]
    return table(n_left, "a"), table(n_right, "b"), keys


def rows(t: pa.Table) -> list:
    t = t.combine_chunks() if not any(
        pa.types.is_dictionary(f.type) for f in t.schema) else t
    cols = [c.cast(c.type.value_type) if pa.types.is_dictionary(c.type)
            else c for c in t.columns]
    return sorted(zip(*[c.to_pylist() for c in cols]), key=repr)


def port_join(left, right, keys, join_type, device, **kw):
    """The port's join in 16-row batches (a string key's fanout overflows
    and retries: ROADMAP C36), its build table sized to the inputs."""
    return Table.from_pyarrow(left, max_rows_per_batch=16, device=device) \
        .join(Table.from_pyarrow(right, max_rows_per_batch=16,
                                 device=device), keys, join_type=join_type,
              max_build_rows=64, **kw)


@pytest.mark.parametrize("kind", KEY_KINDS)
@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_join_coalesces_keys_as_pyarrow(kind, join_type):
    left, right, keys = sides(kind)
    got = port_join(left, right, keys, join_type, "cpu").to_pyarrow()
    want = left.join(right, keys, join_type=join_type)
    assert got.schema.names == want.schema.names
    assert [f.type for f in got.schema] == [f.type for f in want.schema]
    assert rows(got) == rows(want)


@pytest.mark.parametrize("join_type", ["left outer", "right outer",
                                       "full outer"])
def test_join_without_coalescing_as_pyarrow(join_type):
    left, right, keys = sides("int64")
    got = port_join(left, right, keys, join_type, "cpu",
                    coalesce_keys=False).to_pyarrow()
    want = left.join(right, keys, join_type=join_type, coalesce_keys=False)
    assert got.schema.names == want.schema.names == ["k", "a", "k", "b"]
    assert rows(got) == rows(want)


def test_join_with_suffixes_coalesces_as_pyarrow():
    """Colliding payload names take the suffixes; the coalesced key keeps
    its name."""
    left, right, keys = sides("int64")
    right = right.rename_columns(["k", "a"])
    for join_type in ("inner", "full outer", "right outer"):
        got = port_join(left, right, keys, join_type, "cpu",
                        left_suffix="_l", right_suffix="_r").to_pyarrow()
        want = left.join(right, keys, join_type=join_type, left_suffix="_l",
                         right_suffix="_r")
        assert got.schema.names == want.schema.names, join_type
        assert rows(got) == rows(want), join_type


def test_join_keys_jax_difference_on_record():
    """On record: the JAX package's ``Table.join`` keeps both key columns
    (the right one null where no right row matched); the port's
    ``coalesce_keys=False`` gives the same rows."""
    left = pa.table({"k": [1, 2, 3], "a": [10, 20, 30]})
    right = pa.table({"k": [2, 3, 4], "b": [200, 300, 400]})
    jax_out = at.Table.from_pyarrow(left).join(
        at.Table.from_pyarrow(right), "k", join_type="full outer") \
        .to_pyarrow()
    assert jax_out.schema.names == ["k", "a", "k", "b"]
    port = port_join(left, right, ["k"], "full outer", "cpu",
                     coalesce_keys=False).to_pyarrow()
    assert rows(port) == rows(jax_out)
    coalesced = port_join(left, right, ["k"], "full outer",
                          "cpu").to_pyarrow()
    assert sorted(coalesced["k"].to_pylist()) == [1, 2, 3, 4]
