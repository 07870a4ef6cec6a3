"""The port's native host runtime (``arrow_tpu_torch/native.py``, its own
copy of the C++ source) against the JAX package's: ATB files of every
dtype code, with validity, a byte pool and no rows, written by either
package and read by the other, byte for byte the same file; the memory
pool's stats; the morsel loader's slices; a failed build that raises with
the compiler's message."""

import numpy as np
import pytest

import arrow_tpu.native as jnative
import arrow_tpu_torch.native as tnative

CODES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
         "uint32", "uint64", "float16", "float32", "float64"]


def _columns(n: int, seed: int = 0) -> dict:
    """One column of every dtype code (every other one with validity) and
    two byte pools, ``n`` rows."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i, name in enumerate(CODES):
        d = np.dtype(name)
        if d.kind == "b":
            data = rng.random(n) < 0.5
        elif d.kind == "f":
            data = rng.normal(size=n).astype(d)
        else:
            info = np.iinfo(d)
            data = rng.integers(info.min, info.max, n, dtype=d,
                                endpoint=True)
        col = {"data": data}
        if i % 2:
            col["validity"] = rng.random(n) < 0.7
        cols[f"c_{name}"] = col
    words = [("w" * (i % 7)).encode() for i in range(n)]
    off = np.zeros((n + 1,), np.int32)
    off[1:] = np.cumsum([len(w) for w in words])
    pool = np.frombuffer(b"".join(words), np.uint8).copy()
    cols["s"] = {"data": pool, "offsets": off}
    cols["s_nulls"] = {"data": pool, "offsets": off,
                       "validity": rng.random(n) < 0.5}
    return cols


def _same(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert set(g) == set(w), name
        for k in w:
            assert g[k].dtype == (np.bool_ if k == "validity"
                                  else w[k].dtype), (name, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=name)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_atb_round_trip_of_every_dtype_code(tmp_path, n):
    cols = _columns(n)
    path = str(tmp_path / "t.atb")
    size = tnative.write_atb(path, cols, n)
    assert size == (tmp_path / "t.atb").stat().st_size
    got, nrows = tnative.read_atb(path)
    assert nrows == n
    _same(got, cols)


@pytest.mark.parametrize("n", [0, 333])
def test_atb_files_are_the_jax_packages_byte_for_byte(tmp_path, n):
    cols = _columns(n, seed=3)
    tp, jp = str(tmp_path / "port.atb"), str(tmp_path / "jax.atb")
    tnative.write_atb(tp, cols, n)
    jnative.write_atb(jp, cols, n)
    assert (tmp_path / "port.atb").read_bytes() == \
        (tmp_path / "jax.atb").read_bytes()
    for reader, path in ((jnative.read_atb, tp), (tnative.read_atb, jp)):
        got, nrows = reader(path)
        assert nrows == n
        _same(got, cols)


def test_atb_rejects_what_it_cannot_carry(tmp_path):
    path = str(tmp_path / "t.atb")
    with pytest.raises(TypeError, match="ATB carries no"):
        tnative.write_atb(path, {"d": {"data": np.zeros(3, "M8[D]")}}, 3)
    with pytest.raises(ValueError, match="validity bytes"):
        tnative.write_atb(path, {"a": {"data": np.zeros(3),
                                       "validity": np.ones(2, bool)}}, 3)
    (tmp_path / "bad.atb").write_bytes(b"ATB1" + b"\xff" * 40)
    with pytest.raises(OSError, match="cannot open"):
        tnative.read_atb(str(tmp_path / "bad.atb"))


def test_atb_write_reports_a_full_disk():
    with pytest.raises(OSError, match="atb_write"):
        tnative.write_atb("/dev/full", {"a": {"data": np.zeros(100_000)}},
                          100_000)


def test_open_atb_gives_views_until_closed(tmp_path):
    cols = _columns(50)
    path = str(tmp_path / "t.atb")
    tnative.write_atb(path, cols, 50)
    with tnative.open_atb(path) as f:
        assert f.nrows == 50
        np.testing.assert_array_equal(f.columns["c_int64"]["data"],
                                      cols["c_int64"]["data"])
        assert not f.columns["c_int64"]["data"].flags.owndata
    assert f.columns == {}


def test_memory_pool_stats_and_poison():
    pool = tnative.MemoryPool(poison=True)
    a = pool.alloc(1000)
    b = pool.alloc(24)
    assert a.ctypes.data % 64 == 0 and b.ctypes.data % 64 == 0
    assert (a == 0xDE).all()
    assert pool.bytes_allocated == 1024 and pool.num_allocations == 2
    pool.free(a)
    assert pool.bytes_allocated == 24 and pool.max_memory == 1024
    pool.free(b)
    assert pool.bytes_allocated == 0


@pytest.mark.parametrize("morsel", [7, 64])
def test_morsel_loader_slices(tmp_path, morsel):
    files = []
    for i, n in enumerate((50, 0, 23)):
        cols = _columns(n, seed=i)
        path = str(tmp_path / f"f{i}.atb")
        tnative.write_atb(path, cols, n)
        files.append((path, cols, n))
    seen = {i: [] for i in range(3)}
    loader = tnative.MorselLoader([f[0] for f in files], morsel_rows=morsel,
                                  nthreads=2, queue_depth=2)
    for fi, cols, n in loader:
        assert 0 < n <= morsel
        seen[fi].append((cols, n))
    loader.close()
    for fi, (_, want, n) in enumerate(files):
        assert sum(m for _, m in seen[fi]) == n
        if not n:
            continue
        # morsels of one file come in order (one thread reads a file)
        lo = 0
        for cols, m in seen[fi]:
            for k in ("c_int32", "c_float64"):
                np.testing.assert_array_equal(cols[k]["data"],
                                              want[k]["data"][lo:lo + m])
            off = want["s"]["offsets"]
            np.testing.assert_array_equal(cols["s"]["offsets"],
                                          off[lo:lo + m + 1] - off[lo])
            np.testing.assert_array_equal(
                cols["s"]["data"], want["s"]["data"][off[lo]:off[lo + m]])
            lo += m


def test_morsel_loader_raises_for_a_file_it_cannot_open(tmp_path):
    good = str(tmp_path / "g.atb")
    tnative.write_atb(good, _columns(5), 5)
    loader = tnative.MorselLoader([good, str(tmp_path / "missing.atb")])
    with pytest.raises(OSError, match="1 of 2 ATB files"):
        list(loader)
    loader.close()


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++ at all;\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert not tnative.available()
    assert "error" in tnative.build_error()
    for call in (lambda: tnative.write_atb(str(tmp_path / "x.atb"), {}, 0),
                 lambda: tnative.read_atb(str(tmp_path / "x.atb")),
                 tnative.MemoryPool):
        with pytest.raises(RuntimeError, match="did not build"):
            call()


def test_the_library_builds_from_the_ports_own_source():
    assert tnative.available(), tnative.build_error()
    path = tnative.library_path()
    assert path.is_file() and path.parent.name == ".kernels_build"
    assert tnative._SRC.parent.parts[-3:] == ("arrow_tpu_torch", "csrc",
                                              "host")
