"""The port's Avro adapter (``arrow_tpu_torch.dataset.avro``) held against
the JAX package's on the CPU: files cross between the packages in both
directions and are equal but for the 16-byte sync marker ``write_avro``
draws at random; both codecs and the types of ``tests/test_dataset.py``;
the reader fuzz cases of ``tests/test_fuzz_readers.py`` (truncation, bit
flips, bad magic, a zigzag bomb), where the two readers must raise the same
error or read the same table; and a ``.avro`` fragment through the port's
``scan`` node against the JAX package's plan."""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu.acero as ja
import arrow_tpu.dataset as jds
import arrow_tpu_torch.acero as ta
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.dataset import avro as javro
from arrow_tpu_torch import dataset as tds
from arrow_tpu_torch.compute.expressions import field as tfield
from arrow_tpu_torch.dataset import avro as tavro


def _typed_table():
    return pa.table({
        "i": pa.array([1, None, 3, -(1 << 40)], type=pa.int64()),
        "f": pa.array([0.5, 1.5, None, 3.25], type=pa.float64()),
        "s": pa.array(["a", "β", None, ""], type=pa.string()),
        "b": pa.array([True, False, None, True]),
        "raw": pa.array([b"\x00\x01", b"", None, b"zz"], type=pa.binary()),
        "d": pa.array([datetime.date(2020, 1, 1), None,
                       datetime.date(1969, 12, 31),
                       datetime.date(2024, 2, 29)], type=pa.date32()),
        "ts": pa.array([1, 2, None, 4], type=pa.timestamp("us")),
        "lst": pa.array([[1, 2], [], None, [5]],
                        type=pa.list_(pa.int64())),
    })


def _sync_of(raw: bytes) -> bytes:
    """The container's sync marker: the last 16 bytes of a file that
    ends with a block."""
    return raw[-16:]


def _masked(raw: bytes) -> bytes:
    return raw.replace(_sync_of(raw), b"\0" * 16)


@pytest.mark.parametrize("codec", ["deflate", "null"])
def test_files_cross_between_packages(tmp_path, codec):
    t = _typed_table()
    pt, pj = str(tmp_path / "port.avro"), str(tmp_path / "jax.avro")
    tavro.write_avro(t, pt, codec=codec, block_rows=3)
    javro.write_avro(t, pj, codec=codec, block_rows=3)
    raw_t, raw_j = open(pt, "rb").read(), open(pj, "rb").read()
    assert _sync_of(raw_t) != _sync_of(raw_j)        # drawn at random
    assert _masked(raw_t) == _masked(raw_j)
    assert javro.read_avro(pt).equals(t)             # a port file by JAX
    assert tavro.read_avro(pj).equals(t)             # a JAX file by the port
    assert tavro.AvroFile(pj).read().equals(javro.AvroFile(pt).read())


def test_non_nullable_column_and_not_avro(tmp_path):
    t = pa.table({"k": pa.array([1, 2, 3], type=pa.int32())}).cast(
        pa.schema([pa.field("k", pa.int32(), nullable=False)]))
    path = str(tmp_path / "k.avro")
    tavro.write_avro(t, path)
    assert tavro.read_avro(path).equals(javro.read_avro(path))
    assert tavro.read_avro(path).equals(
        t.cast(pa.schema([pa.field("k", pa.int32())])))
    got, want = _read_both(__file__)        # not an avro file
    assert got == want and want[0] is ValueError


def _valid_avro(tmp_path):
    p = str(tmp_path / "v.avro")
    tavro.write_avro(pa.table({
        "i": pa.array([1, 2, None, 4], pa.int64()),
        "s": pa.array(["ab", None, "c", "defg"]),
        "f": pa.array([0.5, 1.5, 2.5, None], pa.float64()),
    }), p)
    return p


def _read_both(path):
    """(port outcome, JAX outcome): a table, or (error type, message)."""
    out = []
    for mod in (tavro, javro):
        try:
            out.append(mod.read_avro(path))
        except Exception as e:      # the outcome compared, not hidden
            out.append((type(e), str(e)))
    return out


def _same_outcome(path):
    got, want = _read_both(path)
    if isinstance(want, pa.Table):
        assert isinstance(got, pa.Table) and got.equals(want)
        assert got.num_rows <= 4 + 64       # never fabricate massive data
    else:
        assert got == want


def _mutants(raw: bytes, rng):
    """The fuzz inputs: truncations, bit flips, bad magic and schema, and
    a huge record count spliced over the data blocks."""
    for cut in [0, 1, 3, 4, 16, len(raw) // 3, len(raw) // 2,
                len(raw) - 2]:
        yield raw[:cut]
    for _ in range(60):
        mut = bytearray(raw)
        for _ in range(int(rng.integers(1, 5))):
            i = int(rng.integers(0, len(mut)))
            mut[i] ^= 1 << int(rng.integers(0, 8))
        yield bytes(mut)
    yield b"NotAvroAtAll" * 4
    yield b"Obj\x01" + b"\x02" + b"\xff" * 40
    for pos in range(len(raw) - 10, max(len(raw) - 200, 0), -7):
        mut = bytearray(raw)
        mut[pos:pos + 9] = bytes([0xFE] * 8 + [0x1F])
        yield bytes(mut)


def test_reader_fuzz_matches_jax(tmp_path, rng):
    raw = open(_valid_avro(tmp_path), "rb").read()
    bad = str(tmp_path / "bad.avro")
    n = 0
    for mut in _mutants(raw, rng):
        with open(bad, "wb") as f:
            f.write(mut)
        _same_outcome(bad)
        n += 1
    assert n > 80


def test_avro_fragments_through_dataset(tmp_path):
    t = _typed_table()
    for codec in ("deflate", "null"):
        tavro.write_avro(t, str(tmp_path / f"t_{codec}.avro"), codec=codec,
                         block_rows=3)
    d = tds.dataset(str(tmp_path))
    assert {f.format for f in d.fragments} == {"avro"}
    got = d.to_table(device="cpu").to_pyarrow()
    want = jds.dataset(str(tmp_path)).to_table().to_pyarrow()
    assert got.num_rows == 2 * t.num_rows
    assert got.equals(want)
    # the schema from the header alone is the decoded file's
    for frag in d.fragments:
        assert frag.physical_schema() == tavro.read_avro(frag.path).schema


def _orders(rng, n):
    days = rng.integers(8035, 10591, n)        # 1992-01-01 .. 1998-12-31
    return pa.table({
        "o_orderkey": pa.array(np.arange(1, n + 1, dtype=np.int64)),
        "o_orderstatus": pa.array(rng.choice(["F", "O", "P"], n)),
        "o_totalprice": pa.array(rng.uniform(900, 5e5, n)),
        "o_orderdate": pa.array(days.astype(np.int32), pa.date32()),
    })


def _scan_plan(pkg, field, dataset, **scan_kw):
    lo, hi = datetime.date(1995, 1, 1), datetime.date(1996, 1, 1)
    return pkg.Declaration.from_sequence([
        pkg.Declaration("scan", pkg.ScanNodeOptions(dataset, **scan_kw)),
        pkg.Declaration("filter", pkg.FilterNodeOptions(
            (field("o_orderdate") >= lo) & (field("o_orderdate") < hi))),
        pkg.Declaration("aggregate", pkg.AggregateNodeOptions(
            [pkg.AggregateSpec("count_all", [], name="n"),
             pkg.AggregateSpec("sum", "o_totalprice", name="price")],
            keys=["o_orderstatus"])),
    ])


def test_avro_scan_plan_matches_jax(tmp_path, rng):
    """The Avro scan of the card's path, small: orders in two deflate
    files -> scan -> a 1995 filter -> count and sum by status."""
    t = _orders(rng, 3000)
    for i in range(2):
        tavro.write_avro(t.slice(1500 * i, 1500), str(tmp_path /
                                                      f"o{i}.avro"))
    got = _scan_plan(ta, tfield, tds.dataset(str(tmp_path)),
                     device="cpu").to_table().to_pyarrow()
    want = _scan_plan(ja, jfield,
                      jds.dataset(str(tmp_path))).to_table().to_pyarrow()
    got = got.sort_by("o_orderstatus")
    want = want.sort_by("o_orderstatus")
    assert got["o_orderstatus"].equals(want["o_orderstatus"])
    assert got["n"].to_pylist() == want["n"].to_pylist()
    g = np.array(got["price"].to_pylist())
    w = np.array(want["price"].to_pylist())
    # C5: f64 sums differ in order
    assert np.all(np.abs(g - w) <= 1e-12 * np.abs(w) * 64 + 1e-12)
