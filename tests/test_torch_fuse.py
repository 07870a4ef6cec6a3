"""The port's plan drivers (``acero/fuse.py``, the lazy mode of
``acero/nodes.py`` and ``Declaration.to_table(lazy=)``) held against the
JAX package's on the CPU, in the shapes of the JAX package's fused tests
(``tests/test_acero.py``): top-k fetch, fused against eager, multi-morsel
streaming, a fanout fallback, a nested build error that falls back,
project aliases kept apart, adaptive capacities and their string slices,
the plan store's round trip. Each plan runs fused, eager and lazy in the
port and through the JAX package's ``to_table`` on the same seeded data;
integers and strings must be equal, float sums within ROADMAP C5's
tolerance. And the repairs of the JAX package's plan store (ROADMAP C2): a
learned route whose check fires is unlearned, two processes save at once,
no identity key is saved, no file lands outside the store's directory."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest

import arrow_tpu as at
import arrow_tpu.acero as ja
import arrow_tpu_torch as tat
import arrow_tpu_torch.acero as ta
from arrow_tpu.acero import fuse as jfuse
from arrow_tpu.compute.expressions import field as jfield
from arrow_tpu.compute.expressions import literal as jliteral
from arrow_tpu_torch.acero import fuse
from arrow_tpu_torch.compute.expressions import field as tfield
from arrow_tpu_torch.compute.expressions import literal as tliteral
from arrow_tpu_torch.entry import plan_driver

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = ("fused", "eager", "lazy")


class _Pkg:
    def __init__(self, acero, field, literal, stage):
        self.acero, self.field, self.literal = acero, field, literal
        self.stage = stage

    def source(self, t, rows=1 << 20):
        return self.acero.Declaration("table_source",
                                      self.acero.TableSourceNodeOptions(
                                          self.stage(t, rows)))


JAX = _Pkg(ja, jfield, jliteral,
           lambda t, rows: at.Table.from_pyarrow(t, max_rows_per_batch=rows))
PORT = _Pkg(ta, tfield, tliteral,
            lambda t, rows: tat.Table.from_pyarrow(
                t, max_rows_per_batch=rows, device="cpu"))


@pytest.fixture(autouse=True)
def _fresh_plan_state(tmp_path, monkeypatch):
    """Each test starts from no learned state, with both packages' stores
    in its own directory; the JAX executables are dropped after it."""
    monkeypatch.setenv("ARROW_TPU_PLAN_CACHE", str(tmp_path / "store" /
                                                   "plans.json"))
    monkeypatch.setattr(jfuse, "_PLAN_STORE_PATH",
                        str(tmp_path / "jax_plans.json"))
    for mod in (fuse, jfuse):
        monkeypatch.setattr(mod, "_PLAN_OBS", {})
        monkeypatch.setattr(mod, "_PLAN_IMPL", {})
        monkeypatch.setattr(mod, "_PLAN_LOADED", True)
    fuse.reset_stats()
    yield
    from arrow_tpu.acero.nodes import clear_stage_cache
    clear_stage_cache()


def _rows(t: pa.Table, order_free: bool):
    rows = list(zip(*[t.column(i).to_pylist()
                      for i in range(t.num_columns)]))
    return sorted(rows, key=repr) if order_free else rows


def _close(got: pa.Table, want: pa.Table, order_free=True, f32=False):
    """Equal Tables: integers and strings exactly, floats within C5's
    tolerance of the value (f32 sums 1e-5, f64 1e-12, scaled)."""
    assert got.column_names == want.column_names
    g, w = _rows(got, order_free), _rows(want, order_free)
    assert len(g) == len(w)
    tol = 1e-5 if f32 else 1e-12
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(b, float) and a is not None:
                assert abs(a - b) <= tol * max(abs(b), 1.0) * 64, (rg, rw)
            else:
                assert a == b, (rg, rw)


def _port_runs(make):
    """The port's Table of ``make(PORT)`` through each driver."""
    return {d: plan_driver(make(PORT), d).to_pyarrow() for d in DRIVERS}


def _check_all(make, order_free=True, f32=False, want=None):
    """Every port driver against the JAX package's to_table (``want``
    when the caller has it) and against each other; returns the port's
    fused Table."""
    if want is None:
        want = make(JAX).to_table().to_pyarrow()
    runs = _port_runs(make)
    for d, got in runs.items():
        _close(got, want, order_free, f32)
    _close(runs["fused"], runs["eager"], order_free, f32)
    _close(runs["lazy"], runs["eager"], order_free, f32)
    return runs["fused"]


def _li_od(rng, n, n_keys=400, n_build=300, key_span=500):
    li = pa.table({"k": pa.array(rng.integers(0, n_keys, n)),
                   "x": pa.array(rng.standard_normal(n).astype(np.float32)),
                   "d": pa.array(rng.integers(0, 100, n).astype(np.int32))})
    od = pa.table({"k2": pa.array(rng.permutation(key_span)[:n_build]
                                  .astype(np.int64)),
                   "y": pa.array(rng.integers(0, 7, n_build)
                                 .astype(np.int32))})
    return li, od


def _join_filter(p, li, od, rows=1 << 20, d_min=20, **join_kw):
    kw = dict(left_output=["k", "x"], right_output=["y"],
              max_build_rows=1 << 10)
    kw.update(join_kw)
    return p.acero.Declaration("hashjoin", p.acero.HashJoinNodeOptions(
        "inner", left_keys=["k"], right_keys=["k2"], **kw), inputs=[
        p.acero.Declaration.from_sequence([
            p.source(li, rows),
            p.acero.Declaration("filter", p.acero.FilterNodeOptions(
                p.field("d") > p.literal(d_min)))]),
        p.source(od)])


def test_topk_fetch_fused(rng):
    n = 3000
    t = pa.table({"k": pa.array(rng.integers(0, 1_000_000, n)),
                  "s": pa.array([f"s{i % 97}" for i in range(n)])})
    for offset, count in [(5, 25)]:
        def make(p):
            return p.acero.Declaration("fetch", p.acero.FetchNodeOptions(
                offset, count), [p.acero.Declaration(
                    "order_by", p.acero.OrderByNodeOptions(
                        [("k", "descending")]), [p.source(t, 1024)])])
        got = _check_all(make, order_free=False)
        exp = t.sort_by([("k", "descending")]).slice(offset, count)
        assert got["k"].to_pylist() == exp["k"].to_pylist()
        assert got["s"].to_pylist() == exp["s"].to_pylist()
    assert fuse.STATS["fused"] == 1 and fuse.STATS["graphs"] == 0


def test_fused_matches_eager_and_falls_back(rng):
    li, od = _li_od(rng, 1500)

    def make(p):
        return p.acero.Declaration.from_sequence([
            _join_filter(p, li, od),
            p.acero.Declaration("project", p.acero.ProjectNodeOptions(
                [p.field("k"), p.field("x") * 2.0, p.field("y")],
                ["k", "x2", "y"])),
            p.acero.Declaration("aggregate", p.acero.AggregateNodeOptions(
                [p.acero.AggregateSpec("sum", "x2"),
                 p.acero.AggregateSpec("count_all")],
                keys=["y"], max_groups=64)),
            p.acero.Declaration("order_by", p.acero.OrderByNodeOptions(
                [("count_all", "descending"), ("y", "ascending")])),
            p.acero.Declaration("fetch", p.acero.FetchNodeOptions(1, 4))])
    _check_all(make, order_free=False, f32=True)
    assert fuse.STATS["fused"] == 1 and fuse.STATS["fallbacks"] == 0

    # a fanout past its capacity (build keys that repeat: no unique-key
    # route): the fused run's flag fires, the eager driver's retries give
    # the answer
    dup = od.set_column(0, "k2", pa.array(np.repeat(
        od.column("k2").to_numpy()[:150], 2)))

    def fanout(p):
        return _join_filter(p, li, dup, d_min=-1, fanout_capacity=512)
    before = fuse.STATS["fallbacks"]
    _check_all(fanout, f32=True)
    assert fuse.STATS["fallbacks"] == before + 1


def test_streaming_multi_morsel(rng):
    li, od = _li_od(rng, 6144, n_keys=500, n_build=400, key_span=600)
    shapes = {
        "pure": lambda p: [],
        "agg": lambda p: [p.acero.Declaration(
            "aggregate", p.acero.AggregateNodeOptions(
                [p.acero.AggregateSpec("sum", "x"),
                 p.acero.AggregateSpec("count_all")],
                keys=["y"], max_groups=64))],
        "topk_stream": lambda p: [
            p.acero.Declaration("order_by", p.acero.OrderByNodeOptions(
                [("x", "descending")])),
            p.acero.Declaration("fetch", p.acero.FetchNodeOptions(0, 7))],
    }
    for i, (name, tail) in enumerate(shapes.items()):
        fuse.reset_stats()
        _check_all(lambda p: p.acero.Declaration.from_sequence(
            [_join_filter(p, li, od, rows=2048)] + tail(p)), f32=True)
        # one fused run: the first reads its build's route (the bootstrap),
        # the others build on the learned route; then ONE read at the end;
        # no graph on the CPU
        assert fuse.STATS["fused"] == 1, name
        assert fuse.STATS["host_reads"] == (2 if i == 0 else 1), \
            (name, fuse.STATS)
        assert fuse.STATS["graphs"] == 0, name


def test_nested_build_error_falls_back(rng):
    n = 300
    a = pa.table({"k": pa.array(rng.integers(0, 40, n)),
                  "v": pa.array(np.arange(n, dtype=np.int64))})
    b = pa.table({"k2": pa.array(np.arange(40, dtype=np.int64)),
                  "w": pa.array(rng.integers(0, 9, 40).astype(np.int32))})
    c = pa.table({"k3": pa.array(rng.integers(0, 40, 500)),
                  "u": pa.array(rng.integers(0, 5, 500).astype(np.int32))})

    def make(p):
        build = p.acero.Declaration("hashjoin", p.acero.HashJoinNodeOptions(
            "inner", left_keys=["k"], right_keys=["k2"],
            left_output=["k", "v"], right_output=["w"],
            max_build_rows=1 << 8, fanout_capacity=256),
            inputs=[p.source(a), p.source(b)])
        return p.acero.Declaration("hashjoin", p.acero.HashJoinNodeOptions(
            "inner", left_keys=["k3"], right_keys=["k"],
            left_output=["k3", "u"], right_output=["v", "w"],
            max_build_rows=1 << 13), inputs=[p.source(c), build])
    _check_all(make)
    assert fuse.STATS["fallbacks"] == 1 and fuse.STATS["fused"] == 0


def test_project_aliases_kept_apart(rng):
    t = pa.table({"a": pa.array(rng.integers(0, 100, 2000)),
                  "b": pa.array(rng.standard_normal(2000)
                                .astype(np.float32))})

    def make(names):
        return lambda p: p.acero.Declaration.from_sequence([
            p.source(t), p.acero.Declaration(
                "project", p.acero.ProjectNodeOptions(
                    [p.field("a"), p.field("b") * 2.0], names))])
    t1 = _check_all(make(["a", "b2"]), order_free=False)
    t2 = _check_all(make(["x", "y"]), order_free=False)
    assert t1.column_names == ["a", "b2"] and t2.column_names == ["x", "y"]
    assert t1["b2"].to_pylist() == t2["y"].to_pylist()


def _agg_plan(li_t, od_t, d_min):
    def make(p):
        return p.acero.Declaration.from_sequence([
            _join_filter(p, li_t, od_t, d_min=d_min),
            p.acero.Declaration("aggregate", p.acero.AggregateNodeOptions(
                [p.acero.AggregateSpec("sum", "x"),
                 p.acero.AggregateSpec("count_all")],
                keys=["y"], max_groups=64))])
    return make


def test_adaptive_capacity(rng):
    """Slices learned at >= 2^16 rows: the second run slices the filter
    and the join output to the first run's lengths; data past them fires
    the flag, falls back and relearns."""
    n = 40_000
    li, od = _li_od(rng, n, n_keys=500, n_build=400, key_span=800)
    li_big = li.set_column(2, "d", pa.array(np.full(n, 99, np.int32)))
    make = _agg_plan(li, od, 60)
    want = make(JAX).to_table().to_pyarrow()
    for _ in range(2):
        _check_all(make, f32=True, want=want)
    assert len(fuse._PLAN_OBS) >= 2
    assert fuse.STATS["fallbacks"] == 0
    # the same plan's data past the slices, against its eager run (held
    # against the JAX package's above): it falls back, then relearns
    big = _agg_plan(li_big, od, 60)
    want = plan_driver(big(PORT), "eager").to_pyarrow()
    _close(plan_driver(big(PORT)).to_pyarrow(), want, f32=True)
    assert fuse.STATS["fallbacks"] == 1
    _close(plan_driver(big(PORT)).to_pyarrow(), want, f32=True)
    assert fuse.STATS["fallbacks"] == 1


def test_adaptive_slice_of_strings(rng):
    n = 40_000
    strs = np.array([f"val{i:06d}x{i % 7}" for i in range(n)])
    li = pa.table({"k": pa.array(rng.integers(0, 5000, n)),
                   "s": pa.array(strs),
                   "d": pa.array(rng.integers(0, 100, n).astype(np.int32))})
    od = pa.table({"k2": pa.array(rng.permutation(8000)[:4000]
                                  .astype(np.int64)),
                   "y": pa.array(rng.integers(0, 9, 4000).astype(np.int32))})

    def make(p):
        return _join_filter(p, li, od, d_min=75, left_output=["k", "s"],
                            max_build_rows=1 << 13)
    want = make(JAX).to_table().to_pyarrow()
    for _ in range(3):
        _check_all(make, want=want)
    assert fuse.STATS["fused"] == 3 and fuse.STATS["fallbacks"] == 0


def test_plan_store_round_trip(rng):
    li, od = _li_od(rng, 40_000, n_keys=500, n_build=400, key_span=800)
    make = _agg_plan(li, od, 50)
    want = make(JAX).to_table().to_pyarrow()
    for _ in range(2):
        _close(plan_driver(make(PORT)).to_pyarrow(), want, f32=True)
    store = os.environ["ARROW_TPU_PLAN_CACHE"]
    saved = json.load(open(store))
    assert saved["obs"] == fuse._PLAN_OBS and saved["impl"] == fuse._PLAN_IMPL
    assert saved["impl"]
    # a fresh process: the state comes back from the store
    fuse._PLAN_OBS.clear()
    fuse._PLAN_IMPL.clear()
    fuse._PLAN_LOADED = False
    fuse.reset_stats()
    _close(plan_driver(make(PORT)).to_pyarrow(), want, f32=True)
    assert fuse._PLAN_IMPL == saved["impl"]
    assert fuse.STATS["host_reads"] == 1       # the inline form at once


def test_learned_route_is_unlearned(rng):
    """C2: the route learned on unique build keys ("packed_u") is checked
    in the run; build keys that repeat fire the check, the run falls back,
    the route is removed and saved, and the next run learns again."""
    li, od = _li_od(rng, 3000)
    dup = od.set_column(0, "k2", pa.array(np.repeat(
        od.column("k2").to_numpy()[:150], 2)))
    for _ in range(2):
        _check_all(lambda p: _join_filter(p, li, od))
    (learned,) = fuse._PLAN_IMPL.values()
    assert learned == "packed_u"
    fuse.reset_stats()
    _check_all(lambda p: _join_filter(p, li, dup))
    assert fuse.STATS["unlearned"] == 1 and fuse.STATS["fallbacks"] == 1
    assert fuse._PLAN_IMPL == {}
    store = os.environ["ARROW_TPU_PLAN_CACHE"]
    assert json.load(open(store))["impl"] == {}
    plan_driver(_join_filter(PORT, li, dup))      # bootstraps again
    assert list(fuse._PLAN_IMPL.values()) == ["packed"]
    assert list(json.load(open(store))["impl"].values()) == ["packed"]


def test_no_identity_keys_in_the_store(tmp_path):
    store = os.environ["ARROW_TPU_PLAN_CACHE"]
    fuse._PLAN_OBS.update({"('obs', ('data', 123))": 5, "('obs', 1)": 7})
    fuse._PLAN_IMPL.update({"('impl', ('id', 9))": "sort"})
    fuse._PLAN_DIRTY = True
    fuse._save_plan_store()
    assert json.load(open(store)) == {"obs": {"('obs', 1)": 7}, "impl": {}}
    with open(store, "w") as f:
        json.dump({"obs": {"('obs', ('id', 4))": 3, "('obs', 2)": 1},
                   "impl": {"('impl', ('data', 8))": "packed"}}, f)
    fuse._PLAN_OBS.clear()
    fuse._PLAN_IMPL.clear()
    fuse._PLAN_LOADED = False
    fuse._load_plan_store()
    assert fuse._PLAN_OBS == {"('obs', 2)": 1} and fuse._PLAN_IMPL == {}


_SAVER = """
import os, sys
from arrow_tpu_torch.acero import fuse
fuse._PLAN_LOADED = True
for i in range(50):
    fuse._PLAN_OBS["('obs', %r, %d)" % (sys.argv[1], i)] = i
    fuse._PLAN_DIRTY = True
    fuse._save_plan_store()
"""


def test_two_processes_save_at_once(tmp_path):
    env = dict(os.environ, ARROW_TPU_PLAN_CACHE=str(tmp_path / "s.json"))
    procs = [subprocess.Popen([sys.executable, "-c", _SAVER, tag], cwd=ROOT,
                              env=env, stderr=subprocess.PIPE)
             for tag in ("a", "b")]
    for p in procs:
        _, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    d = json.load(open(tmp_path / "s.json"))
    assert len(d["obs"]) == 50         # one process's whole store
    assert sorted(os.listdir(tmp_path)) == ["s.json"]


def test_files_only_in_the_store_directory(rng, monkeypatch):
    """With ``ARROW_TPU_PLAN_CACHE`` set, the one file in its directory;
    unset, no file anywhere in the checkout (the state stays in the
    process)."""
    folder = Path(os.environ["ARROW_TPU_PLAN_CACHE"]).parent

    def listing():
        return sorted(str(p.relative_to(ROOT)) for p in ROOT.rglob("*")
                      if "plan" in p.name and ".git" not in p.parts)
    before = listing()
    li, od = _li_od(rng, 3000)
    for _ in range(2):
        plan_driver(_join_filter(PORT, li, od))
    assert sorted(os.listdir(folder)) == ["plans.json"]
    monkeypatch.delenv("ARROW_TPU_PLAN_CACHE")
    fuse._PLAN_OBS.clear()
    fuse._PLAN_IMPL.clear()
    for _ in range(2):
        plan_driver(_join_filter(PORT, li, od))
    assert fuse._PLAN_IMPL
    assert sorted(os.listdir(folder)) == ["plans.json"]
    assert listing() == before


def test_lazy_run_is_its_threads_own(rng, monkeypatch):
    """A plan pulled by ``to_batches_prefetched``'s producer thread while
    the main thread is inside ``to_table(lazy=True)`` keeps its own
    checks: its aggregate's full group table is read and replayed at twice
    ``max_groups`` (not deferred into the lazy run's list), so both plans
    give their whole answers and the lazy run does not re-run."""
    from arrow_tpu_torch.acero import nodes as tnodes
    keys = rng.integers(0, 50, 4000)
    t = pa.table({"k": pa.array(keys),
                  "v": pa.array(np.arange(4000, dtype=np.int64))})
    agg = ta.Declaration.from_sequence([
        PORT.source(t, 1024), ta.Declaration(
            "aggregate", ta.AggregateNodeOptions(
                [ta.AggregateSpec("count_all")], keys=["k"], max_groups=8))])
    pulled = []
    inner = tnodes.FilterNode._run

    def run(self, b):
        assert tnodes.LAZY.active
        pulled.append(list(agg.to_batches_prefetched()))
        assert tnodes.LAZY.active and tnodes.LAZY.deferred == []
        return inner(self, b)
    monkeypatch.setattr(tnodes.FilterNode, "_run", run)
    got = ta.Declaration.from_sequence([
        PORT.source(t), ta.Declaration("filter", ta.FilterNodeOptions(
            tfield("k") < tliteral(10)))]).to_table(lazy=True)
    assert not tnodes.LAZY.active
    assert len(pulled) == 1                 # no eager re-run
    assert got.num_rows == int((keys < 10).sum())
    (b,) = pulled[0]
    counts = tat.Table(b.schema, [b]).to_pyarrow().to_pydict()
    want = dict(zip(*np.unique(keys, return_counts=True)))
    assert dict(zip(counts["k"], counts["count_all"])) == want


def test_capture_rules_need_work_and_replays():
    """What the card would capture, decided from the plan's shape: a bare
    source has no work to capture, a filter over it has; a morsel whose
    shapes recur in fewer than ``MIN_REPLAYS`` further morsels (a tail
    batch) runs as plain calls."""
    t = pa.table({"a": pa.array(np.arange(3 * 1024 + 100))})
    src = PORT.source(t, 1024)
    node = src._build()
    assert not fuse._capturable(node, {})
    assert fuse._capturable(ta.Declaration.from_sequence([
        src, ta.Declaration("filter", ta.FilterNodeOptions(
            tfield("a") > tliteral(3)))])._build(), {})
    batches = node.table.batches
    assert [b.capacity for b in batches] == [1024] * 3 + [128]
    seg = fuse._Segment(lambda b: (b, ()), [], True, batches)
    assert dict(seg.ahead) == {fuse._leaf_key(batches[1]): 2,
                               fuse._leaf_key(batches[3]): 1}
    for b in (batches[0], batches[3]):
        assert seg(b)[0] is b               # plain calls, no capture
    assert seg.graphs == {}


def test_long_string_sort_key_c41(monkeypatch):
    """ROADMAP C41: the JAX fused driver sorts a string key by its default
    prefix words, so keys equal in their first 60 bytes keep their input
    order; the port's fused driver reads the longest key (one host read)
    and sorts as pyarrow does. The JAX difference stays on record here."""
    t = pa.table({"s": pa.array(["x" * 60 + c for c in "dbca"]),
                  "v": pa.array([1, 2, 3, 4])})
    want = t.sort_by("s")["v"].to_pylist()

    def make(p):
        return p.acero.Declaration.from_sequence([
            p.source(t), p.acero.Declaration(
                "order_by", p.acero.OrderByNodeOptions([("s", "ascending")]))])
    for d, got in _port_runs(make).items():
        assert got["v"].to_pylist() == want, d
    assert fuse.STATS["fused"] == 1
    assert make(JAX).to_table().to_pyarrow()["v"].to_pylist() == [1, 2, 3, 4]
    monkeypatch.setenv("ARROW_TPU_FUSE_PLAN", "0")
    assert make(JAX).to_table().to_pyarrow()["v"].to_pylist() == want
