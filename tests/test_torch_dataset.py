"""The port's dataset layer (``arrow_tpu_torch/dataset``): partitioned
write, discovery, pruning, the scan on the device and the ``scan`` plan
node, against the JAX package where it is right and against
``pyarrow.dataset`` where it is not (ROADMAP C40 (a)-(c), each JAX
difference kept on record here):

  (a) ATB keeps an int or bool column with nulls as its type (the JAX
      package stores the int as float64 and fails on the bool), and a type
      it cannot carry raises naming it;
  (b) a null partition value goes to ``__HIVE_DEFAULT_PARTITION__`` and
      reads back as null (the JAX package drops its rows);
  (c) hive values are percent-escaped and unescaped (the JAX package
      writes them raw).
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.dataset as pds
import pyarrow.fs as pafs
import pytest

import arrow_tpu.dataset as jds
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as tacero
from arrow_tpu_torch import dataset as tds
from arrow_tpu_torch.compute.expressions import field, literal
from arrow_tpu.compute.expressions import field as jfield, \
    literal as jliteral


def _sorted(t: pa.Table, by="i") -> pa.Table:
    return t.select(sorted(t.column_names)).sort_by(by)


@pytest.fixture(scope="module")
def lake():
    """Rows with nulls in every kind of column, a null partition value and
    one that needs escaping."""
    rng = np.random.default_rng(5)
    n = 400
    return pa.table({
        "i": np.arange(n),
        "x": pa.array(rng.integers(-50, 50, n), mask=rng.random(n) < 0.1),
        "f": rng.normal(size=n),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "s": pa.array([f"s{j % 17}" for j in range(n)],
                      mask=rng.random(n) < 0.1),
        "p": pa.array(rng.integers(0, 3, n), mask=rng.random(n) < 0.1),
        "m": pa.array(rng.choice(["MAIL", "REG AIR", "SHIP"], n))})


@pytest.mark.parametrize("fmt", ["parquet", "atb", "ipc", "feather"])
def test_write_discover_scan_round_trip(lake, tmp_path, fmt):
    root = str(tmp_path / fmt)
    tds.write_dataset(lake, root, partitioning=["p", "m"], format=fmt)
    d = tds.dataset(root, partitioning=["p", "m"])
    assert len(d.fragments) == len(lake.select(["p", "m"]).group_by(
        ["p", "m"]).aggregate([]))
    got = d.to_table(device="cpu").to_pyarrow()
    assert _sorted(got).equals(_sorted(lake))


@pytest.mark.parametrize("fmt", ["parquet", "ipc"])
def test_pyarrow_reads_the_ports_hive_dataset(lake, tmp_path, fmt):
    """C40 (b), (c): escaped values and the null partition as pyarrow
    writes and reads them."""
    root = str(tmp_path / fmt)
    tds.write_dataset(lake, root, partitioning=["p", "m"], format=fmt)
    names = {os.path.relpath(dp, root) for dp, _, fs in os.walk(root)
             if fs}
    assert "p=__HIVE_DEFAULT_PARTITION__/m=REG%20AIR" in names
    got = pds.dataset(root, format=fmt, partitioning="hive").to_table()
    # pyarrow infers an int32 partition field, the port an int64 one
    assert got.schema.field("p").type == pa.int32()
    got = got.set_column(got.schema.get_field_index("p"), "p",
                         got["p"].cast(pa.int64()))
    assert _sorted(got).equals(_sorted(lake))


def test_the_port_reads_pyarrows_hive_dataset(lake, tmp_path):
    root = str(tmp_path / "pa")
    pds.write_dataset(lake, root, format="parquet", partitioning=["p", "m"],
                      partitioning_flavor="hive")
    got = tds.dataset(root, partitioning=["p", "m"]).to_table(
        device="cpu").to_pyarrow()
    assert _sorted(got).equals(_sorted(lake))


def test_atb_keeps_nullable_ints_and_bools_and_refuses_dates(tmp_path):
    """C40 (a)."""
    t = pa.table({"i": pa.array([1, None, 3, 4]),
                  "b": pa.array([True, None, False, True]),
                  "p": pa.array([1, 1, 2, 2])})
    root = str(tmp_path / "atb")
    tds.write_dataset(t, root, partitioning=["p"], format="atb")
    got = tds.dataset(root, partitioning=["p"]).to_table(device="cpu")
    assert got.to_pyarrow().schema == t.schema
    assert _sorted(got.to_pyarrow(), "p").equals(_sorted(t, "p"))
    # the JAX package: the int column with a null goes in as float64, so
    # its fragments disagree; the bool column with a null raises
    jroot = str(tmp_path / "jax")
    jds.write_dataset(t.select(["i", "p"]), jroot, partitioning=["p"],
                      format="atb")
    with pytest.raises(pa.ArrowInvalid, match="Schema at index 1"):
        jds.dataset(jroot, partitioning=["p"]).to_table().to_pyarrow()
    with pytest.raises(KeyError):
        jds.write_dataset(t.select(["b", "p"]), str(tmp_path / "jb"),
                          partitioning=["p"], format="atb")
    dates = pa.table({"d": pa.array([0, 1], pa.date32())})
    with pytest.raises(NotImplementedError,
                       match=r"format='atb'.*'d'.*date32"):
        tds.write_dataset(dates, str(tmp_path / "d"), format="atb")
    with pytest.raises(KeyError):
        jds.write_dataset(dates, str(tmp_path / "jd"), format="atb")


def test_null_partition_rows_are_kept(tmp_path):
    """C40 (b): the JAX package drops the row with the null partition and
    leaves a file a later filter cannot read."""
    t = pa.table({"i": [1, 2, 3, 4], "p": pa.array([1, 1, 2, None])})
    root, jroot = str(tmp_path / "t"), str(tmp_path / "j")
    tds.write_dataset(t, root, partitioning=["p"])
    got = tds.dataset(root, partitioning=["p"]).to_table(device="cpu")
    assert _sorted(got.to_pyarrow()).equals(_sorted(t))
    sc = tds.dataset(root, partitioning=["p"]).scanner(
        filter=field("p") == literal(1), device="cpu")
    assert sc.to_table().to_pyarrow().column("i").to_pylist() == [1, 2]
    jds.write_dataset(t, jroot, partitioning=["p"])
    assert jds.dataset(jroot, partitioning=["p"]).to_table().num_rows == 3
    with pytest.raises(TypeError):
        jds.dataset(jroot, partitioning=["p"]).scanner(
            filter=jfield("p") == jliteral(1)).to_table()


def test_hive_values_are_escaped(tmp_path):
    """C40 (c): the JAX package writes ``m=REG AIR``."""
    t = pa.table({"i": [1, 2], "m": ["REG AIR", "a/b%c"]})
    tds.write_dataset(t, str(tmp_path / "t"), partitioning=["m"])
    jds.write_dataset(t, str(tmp_path / "j"), partitioning=["m"])
    assert sorted(os.listdir(tmp_path / "t")) == ["m=REG%20AIR",
                                                  "m=a%2Fb%25c"]
    assert "m=REG AIR" in os.listdir(tmp_path / "j")
    hp = tds.HivePartitioning(["m"])
    assert hp.parse("m=REG%20AIR/part-0.parquet") == {"m": "REG AIR"}


def test_pruning_and_the_residual_filter(lake, tmp_path):
    """Partition conjuncts prune fragments on the host; the rest runs on
    the scanned batches; the same split as the JAX package's."""
    root = str(tmp_path / "pq")
    tds.write_dataset(lake, root, partitioning=["p", "m"])
    d = tds.dataset(root, partitioning=["p", "m"])
    expr = field("m").isin(["MAIL", "SHIP"]) & (field("p") == literal(2)) \
        & (field("x") > literal(0))
    part, rest = tds.split_filter(expr, ["p", "m"])
    jexpr = jfield("m").isin(["MAIL", "SHIP"]) & \
        (jfield("p") == jliteral(2)) & (jfield("x") > jliteral(0))
    jpart, jrest = jds.split_filter(jexpr, ["p", "m"])
    assert [repr(c) for c in part] == [repr(c) for c in jpart]
    assert repr(rest) == repr(jrest)
    tds.reset_stats()
    got = d.scanner(filter=expr, columns=["i", "x"], device="cpu") \
        .to_table().to_pyarrow()
    assert tds.STATS["pruned"] == len(d.fragments) - 2 and \
        tds.STATS["read"] == 2 and tds.STATS["bytes_read"] > 0
    want = lake.filter(pa.compute.and_(pa.compute.and_(
        pa.compute.is_in(lake["m"], pa.array(["MAIL", "SHIP"])),
        pa.compute.equal(lake["p"], 2)), pa.compute.greater(lake["x"], 0)))
    assert _sorted(got).equals(_sorted(want.select(["i", "x"])))


def test_scan_node_in_a_plan_against_the_jax_package(lake, tmp_path):
    """A scan -> filter -> aggregate plan where the JAX package is right
    (no null partition, no value to escape, no plan node reading a
    partition column: the JAX scan's schema leaves them out, C40 (f))."""
    import arrow_tpu.acero as jacero
    t = lake.filter(pa.compute.is_valid(lake["p"])).drop_columns(["m"])
    root = str(tmp_path / "pq")
    tds.write_dataset(t, root, partitioning=["p"])
    jds.write_dataset(t, str(tmp_path / "j"), partitioning=["p"])

    def plan(mod, ds, f, opts, keys):
        return mod.Declaration.from_sequence([
            mod.Declaration("scan", mod.ScanNodeOptions(
                ds, filter=f("p") != 1, **opts)),
            mod.Declaration("filter", mod.FilterNodeOptions(f("f") > 0.0)),
            mod.Declaration("aggregate", mod.AggregateNodeOptions(
                [mod.AggregateSpec("sum", "x"),
                 mod.AggregateSpec("count_all")], keys=keys))])
    got = plan(tacero, tds.dataset(root, partitioning=["p"]), field,
               {"device": "cpu"}, ["b"]).to_table().to_pyarrow()
    jd = jds.dataset(str(tmp_path / "j"), partitioning=["p"])
    want = plan(jacero, jd, jfield, {}, ["b"]).to_table().to_pyarrow()
    assert _sorted(got, "b").equals(_sorted(want, "b"))
    by_p = plan(tacero, tds.dataset(root, partitioning=["p"]), field,
                {"device": "cpu"}, ["p"]).to_table().to_pyarrow()
    assert sorted(by_p.column("p").to_pylist()) == [0, 2]
    with pytest.raises(KeyError, match="'p'"):
        plan(jacero, jd, jfield, {}, ["p"]).to_table()


def test_scan_node_schema_reads_only_metadata(lake, tmp_path, monkeypatch):
    root = str(tmp_path / "pq")
    tds.write_dataset(lake, root, partitioning=["p", "m"])
    node_cls = tacero.plan._nodes.FACTORIES["scan"]
    node = node_cls(tacero.ScanNodeOptions(
        tds.dataset(root, partitioning=["p", "m"]), device="cpu"), [])

    def no_read(self):
        raise AssertionError("output_schema read a whole fragment")
    monkeypatch.setattr(tds.Fragment, "read_pyarrow", no_read)
    assert node.output_schema().names == ("i", "x", "f", "b", "s", "p", "m")
    assert node.output_schema().to_pyarrow() == lake.schema


def test_directory_partitioning_filesystem_and_uri(lake, tmp_path):
    t = lake.filter(pa.compute.is_valid(lake["p"]))
    root = str(tmp_path / "dir")
    part = tds.DirectoryPartitioning(["p", "m"])
    tds.write_dataset(t, root, partitioning=part, format="ipc")
    assert os.path.isdir(os.path.join(root, "2", "REG%20AIR"))
    for kw in ({"filesystem": pafs.LocalFileSystem()}, {}):
        r = ("file://" + root) if not kw else root
        got = tds.dataset(r, partitioning=part, **kw).to_table(
            device="cpu").to_pyarrow()
        assert _sorted(got).equals(_sorted(t))
    with pytest.raises(ValueError, match="local-mmap only"):
        tds.write_dataset(t, "file://" + str(tmp_path / "x"), format="atb")


def test_avro_and_unknown_formats(tmp_path):
    (tmp_path / "a.avro").write_bytes(b"Obj\x01")
    d = tds.dataset(str(tmp_path))
    # a truncated container fails in the reader, as the JAX package's does
    with pytest.raises(EOFError, match="truncated"):
        d.to_table(device="cpu")
    with pytest.raises(EOFError, match="truncated"):
        jds.dataset(str(tmp_path)).to_table()
    with pytest.raises(ValueError, match="cannot write format"):
        tds.write_dataset(pa.table({"a": [1]}), str(tmp_path / "o"),
                          format="orc")


def test_module_has_the_jax_packages_names():
    assert set(jds.__all__) <= set(tds.__all__)
    for name in jds.__all__:
        assert getattr(tds, name) is not None
