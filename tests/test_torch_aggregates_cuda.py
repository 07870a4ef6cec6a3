"""The other aggregators on the card against the same calls on the CPU
(where the kernel wrappers take their plain versions): the dense kernel
B3's bool kinds ``any8`` / ``all8`` against their plain version at a few
G, with nulls, views and bytes other than 0 / 1; every grouped aggregator
through HashAggregate's sort route, its dense route and ``merge``; the
scalar aggregates; the three entry points of paths 1c, 9 and 3q at a
small size.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_aggregates_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.compute import call_function
from arrow_tpu_torch.core.array import array_from_numpy
from arrow_tpu_torch.core.batch import batch
from arrow_tpu_torch.entry import consume_routed, entry_any_all, \
    entry_dist_groupby_q6, entry_groupby_q6
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops.agg_options import CountOptions, VarianceOptions
from arrow_tpu_torch.ops.aggregates_order import TDigestOptions
from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, HashAggregate

pytestmark = pytest.mark.cuda

F64_RTOL = 1e-9


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("G", [128, 1024, 4096])
def test_bool_kinds_against_plain(cuda_device, G):
    gen = torch.Generator(device=cuda_device).manual_seed(G)
    n = (1 << 18) + 3
    gid = torch.randint(-1, G + 8, (n,), generator=gen, device=cuda_device,
                        dtype=torch.int32)
    f = torch.rand(n, generator=gen, device=cuda_device) < 0.5
    f = torch.where(gid == 0, True, torch.where(gid == 1, False, f))
    ok = torch.rand(n, generator=gen, device=cuda_device) < 0.9
    kinds = ("first_row", "any8", "all8", "count", "any8", "all8")
    inputs = (f, f, ok.to(torch.int32), f, f)
    valid = (None, ok, ok, None, None, None)
    for sl in (slice(0, n), slice(1, n)):       # aligned, and a view
        args = (gid[sl], tuple(x[sl] for x in inputs), kinds, G,
                tuple(None if v is None else v[sl] for v in valid))
        before = ck.LAUNCHES["dense_group_reduce"]
        rows, outs = ck.dense_group_reduce(*args)
        assert ck.LAUNCHES["dense_group_reduce"] == before + 1
        prows, pouts = ck.dense_group_reduce_plain(*args)
        assert torch.equal(rows, prows)
        for a, b in zip(outs, pouts):
            assert a.dtype == b.dtype and torch.equal(a, b)
    raw = torch.randint(0, 4, (n,), generator=gen, device=cuda_device,
                        dtype=torch.uint8) * 85
    _, got = ck.dense_group_reduce(gid, (raw.view(torch.bool),) * 2,
                                   ("any8", "all8"), G)
    _, want = ck.dense_group_reduce_plain(gid, (raw != 0,) * 2,
                                          ("any8", "all8"), G)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _batch(rng, n, device, dense):
    k = rng.integers(0, 60 if dense else 500, n)
    f = rng.random(n) < 0.5
    return batch({
        "k": array_from_numpy(k if dense else k.astype(np.float64),
                              validity=rng.random(n) >= 0.02,
                              device=device),
        "v": array_from_numpy(rng.standard_normal(n) + 1e3,
                              validity=rng.random(n) >= 0.1, device=device),
        "i": array_from_numpy(rng.integers(-3, 4, n), device=device),
        "f": array_from_numpy(f, validity=rng.random(n) >= 0.05,
                              device=device)})


_ALL = [AggregateSpec("product", "i"), AggregateSpec("any", "f"),
        AggregateSpec("all", "f"), AggregateSpec("variance", "v"),
        AggregateSpec("stddev", "v", VarianceOptions(ddof=1)),
        AggregateSpec("first", "v"), AggregateSpec("last", "i"),
        AggregateSpec("one", "f"), AggregateSpec("count_distinct", "i"),
        AggregateSpec("count_distinct", "i", CountOptions("all"),
                      name="i_cd_all"),
        AggregateSpec("skew", "v"), AggregateSpec("kurtosis", "v"),
        AggregateSpec("tdigest", "v", TDigestOptions(q=[0.1, 0.5],
                                                     buffer_rows=1 << 16)),
        AggregateSpec("approximate_median", "v",
                      TDigestOptions(buffer_rows=1 << 16))]
_DENSE = [AggregateSpec("count_all"), AggregateSpec("any", "f"),
          AggregateSpec("all", "f"), AggregateSpec("sum", "i")]


def _same(got, want):
    assert got.schema.names == want.schema.names
    for name in want.schema.names:
        a, b = got[name].to_pylist(), want[name].to_pylist()
        assert len(a) == len(b), name
        for x, y in zip(a, b):
            if isinstance(y, float):
                assert (x != x and y != y) or abs(x - y) <= F64_RTOL * max(
                    abs(y), 1e-300), (name, x, y)
            elif isinstance(y, list):
                assert np.allclose(x, y, rtol=F64_RTOL, atol=0), name
            else:
                assert x == y, name


@pytest.mark.parametrize("dense", [False, True], ids=["sort", "dense"])
def test_grouped_aggregators_card_vs_cpu(cuda_device, dense):
    rng = np.random.default_rng(3)
    specs = _DENSE if dense else _ALL
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        r = np.random.default_rng(3)
        b1, b2 = _batch(r, 20000, dev, dense), _batch(r, 7000, dev, dense)
        ha = HashAggregate(b1.schema, ["k"], specs, max_groups=1024)
        if dense:
            assert ha.dense_static_ok()
        st = consume_routed(ha, ha.init_state(dev), b1, True)
        st = consume_routed(ha, st, b2)
        # merge: another state of the second batch folded in
        other = consume_routed(ha, ha.init_state(dev), b2, True)
        st = ha.merge(st, other)
        assert ha.aggregator_errors(st) == []
        results.append(ha.finalize(st).to_pyarrow())
    _same(results[0], results[1])
    del rng


@pytest.mark.parametrize("fn", ["sum", "product", "mean", "min", "max",
                                "any", "all", "variance", "stddev",
                                "approximate_median", "skew", "kurtosis",
                                "count_distinct", "first", "last"])
def test_scalar_aggregates_card_vs_cpu(cuda_device, fn):
    rng = np.random.default_rng(5)
    vals = rng.integers(-3, 4, 5000) if fn == "product" else \
        (rng.random(5000) < 0.5 if fn in ("any", "all")
         else rng.standard_normal(5000) + 1e3)
    mask = rng.random(5000) >= 0.1
    got = call_function(fn, [array_from_numpy(vals, validity=mask,
                                              device=cuda_device)])
    want = call_function(fn, [array_from_numpy(vals, validity=mask,
                                               device="cpu")])
    a, b = got.as_py(), want.as_py()
    if isinstance(b, float):
        assert abs(a - b) <= F64_RTOL * abs(b)
    else:
        assert a == b


def test_entry_any_all_card_vs_cpu(cuda_device):
    outs = []
    for dev in (cuda_device, "cpu"):
        step, args = entry_any_all(dev, 1 << 16, 1000, 1)
        ck.reset_launch_counts()
        outs.append(step(*args).to_pyarrow())
        if dev != "cpu":
            assert ck.LAUNCHES["dense_group_reduce"] == 1
            assert ck.LAUNCHES["filter_compact_chunks"] == 1
    for name in ("k", "count_all", "w_min", "f_any", "f_all"):
        assert outs[0][name].to_pylist() == outs[1][name].to_pylist(), name


def test_entry_q6_card_vs_cpu(cuda_device):
    outs = []
    for entry, kw in ((entry_groupby_q6, {}),
                      (entry_dist_groupby_q6, {"n_shards": 4})):
        for dev in (cuda_device, "cpu"):
            step, args = entry(dev, n_rows=50000, seed=2, **kw)
            t = step(*args).to_pyarrow().sort_by([("id4", "ascending"),
                                                   ("id5", "ascending")])
            outs.append(t)
    for t in outs[1:]:
        _same(t, outs[0])
