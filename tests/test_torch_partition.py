"""Port parity: the exchange's two kernels, ``partition_histogram_segments``
(rows per destination of every shard of a device, and each tile's offsets)
and ``partition_positions`` (each row's slot in its destination's bucket),
through their plain versions, which the wrappers take for CPU tensors:
against a numpy oracle (a stable argsort by destination) and against the
JAX package's ``partition_histogram`` (its Pallas kernel in interpret
mode). Then the exchange's calls of them: one of each a shuffle and device.

Everything here is integers: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow_tpu.ops.pallas_kernels import partition_histogram as \
    jpartition_histogram
from arrow_tpu_torch.core.batch import batch_from_numpy
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.parallel import DistContext, shuffle

TILE = ck.PH_TILE_ROWS
# segments of unequal lengths: empty, one row, short of a tile, a tile,
# just past one, several tiles
SIZES = [[5000], [0, 1, TILE - 1, 0, TILE, TILE + 1, 3 * TILE + 17, 0],
         [0, 0]]


def _segments(seed, sizes, P, kind):
    """int32 dest segments: uniform over [-1, P + 2) with 2^30 mixed in
    (every value outside [0, P) drops its row), Zipf(1.5) over [0, P), or
    all one value."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        if kind == "uniform":
            d = rng.integers(-1, P + 2, n).astype(np.int32)
            d[rng.random(n) < 0.05] = 1 << 30
        elif kind == "zipf":
            d = np.minimum(rng.zipf(1.5, n) - 1, P - 1).astype(np.int32)
        else:
            d = np.full(n, P - 1, np.int32)
        out.append(d)
    return out


def _oracle(segs, P, B):
    """(counts (S, P), tile offsets (P, T), slots per segment) in numpy:
    a stable argsort by destination ranks each row in its bucket."""
    counts, offsets, slots = [], [], []
    for d in segs:
        valid = (d >= 0) & (d < P)
        key = np.where(valid, d, P)
        counts.append([(key == p).sum() for p in range(P)])
        for t0 in range(0, len(d), TILE):
            offsets.append([(key[:t0] == p).sum() for p in range(P)])
        order = np.argsort(key, kind="stable")
        rank = np.empty(len(d), np.int64)
        starts = np.concatenate([[0], np.cumsum(np.bincount(
            key, minlength=P + 1))[:-1]])
        rank[order] = np.arange(len(d)) - starts[key[order]]
        slots.append(np.where(valid & (rank < B), key.astype(np.int64) * B +
                              rank, P * B))
    return (np.array(counts, np.int32).reshape(len(segs), P),
            np.array(offsets, np.int32).reshape(-1, P).T, slots)


@pytest.mark.parametrize("kind", ["uniform", "zipf", "one_value"])
@pytest.mark.parametrize("sizes", SIZES, ids=["one", "unequal", "empty"])
@pytest.mark.parametrize("P", [1, 3, 8, 128])
def test_segments_kernels_vs_numpy_oracle(P, sizes, kind):
    """Counts, tile offsets and slots with buckets that hold every row,
    some of them (rows past B go to the dump slot P * B) and none."""
    segs = _segments(P * 7 + len(sizes), sizes, P, kind)
    tsegs = [torch.from_numpy(d) for d in segs]
    counts, tiles = ck.partition_histogram_segments(tsegs, P)
    assert counts.dtype == tiles.dtype == torch.int32
    for B in (max(sizes) or 1, 7, 0):
        want_counts, want_tiles, want_slots = _oracle(segs, P, B)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
        np.testing.assert_array_equal(tiles.numpy(), want_tiles)
        got = ck.partition_positions(tsegs, P, B, tiles)
        assert [x.shape[0] for x in got] == sizes
        for g, w in zip(got, want_slots):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("P", [1, 3, 8, 128])
def test_segments_histogram_vs_jax(P):
    """Each segment's counts equal the JAX kernel's on that segment."""
    segs = _segments(P, [0, 700, 1024, 5000], P, "uniform")
    counts, _ = ck.partition_histogram_segments(
        [torch.from_numpy(d) for d in segs], P)
    for d, c in zip(segs, counts):
        want = np.zeros(P, np.int32) if len(d) == 0 else \
            np.asarray(jpartition_histogram(jnp.asarray(d), P))
        np.testing.assert_array_equal(c.numpy(), want)


def test_one_segment_is_partition_histogram():
    d = _segments(3, [3000], 8, "uniform")[0]
    counts, _ = ck.partition_histogram_segments([torch.from_numpy(d)], 8)
    assert torch.equal(counts[0], ck.partition_histogram(
        torch.from_numpy(d), 8))


def test_segments_refuse_what_the_kernels_do_not_take():
    d = torch.zeros((16,), dtype=torch.int32)
    _, tiles = ck.partition_histogram_segments([d], 4)
    with pytest.raises(ValueError):
        ck.partition_histogram_segments([], 4)
    with pytest.raises(ValueError):
        ck.partition_histogram_segments([d] * (ck.MAX_SEGMENTS + 1), 4)
    with pytest.raises(ValueError):
        ck.partition_histogram_segments([d, d.long()], 4)
    with pytest.raises(ValueError):
        ck.partition_histogram_segments([d], ck.MAX_PARTITIONS + 1)
    with pytest.raises(ValueError):
        ck.partition_positions([d], 4, -1, tiles)
    with pytest.raises(ValueError):
        ck.partition_positions([d], 4, 1 << 31, tiles)


# ---- the exchange: one call of each kernel a shuffle and device --------------

@pytest.fixture
def calls(monkeypatch):
    """Every call of the two kernels' wrappers from the exchange: the
    number of segments of each."""
    seen = {"hist": [], "pos": []}
    hist, pos = shuffle.partition_histogram_segments, \
        shuffle.partition_positions

    def rec_hist(dests, P):
        seen["hist"].append(len(dests))
        return hist(dests, P)

    def rec_pos(dests, P, B, tiles):
        seen["pos"].append(len(dests))
        return pos(dests, P, B, tiles)
    monkeypatch.setattr(shuffle, "partition_histogram_segments", rec_hist)
    monkeypatch.setattr(shuffle, "partition_positions", rec_pos)
    return seen


def _batch(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return batch_from_numpy({"k": rng.integers(0, 500, n),
                             "v": rng.standard_normal(n)}, device="cpu")


def test_shuffle_batch_calls_each_kernel_once(calls):
    ctx = DistContext(devices=["cpu"] * 8)
    sharded = ctx.shard_batch(_batch())
    out = shuffle.shuffle_batch(sharded.shards, ["k"], ctx.devices)
    assert calls == {"hist": [8], "pos": [8]}
    assert sum(int(rb.length) for rb, _ in out) == 3000


def test_shuffle_rows_calls_each_kernel_once(calls):
    rng = np.random.default_rng(1)
    leaves = [[torch.from_numpy(rng.integers(0, 9, 100 + s))]
              for s in range(8)]
    dest = [torch.from_numpy(rng.integers(-1, 10, 100 + s)) for s in range(8)]
    out = shuffle.shuffle_rows(leaves, dest, 256, [torch.device("cpu")] * 8)
    assert calls == {"hist": [8], "pos": [8]}
    sent = sum(int(((d >= 0) & (d < 8)).sum()) for d in dest)
    assert sum(int(total) for _, total, _ in out) == sent


def test_group_by_calls_each_kernel_once_a_shuffle(calls):
    ctx = DistContext(devices=["cpu"] * 8)
    b = _batch()
    table = ctx.group_by(ctx.shard_batch(b), ["k"],
                         [("sum", "v", None, "v_sum")],
                         max_groups_per_shard=1024)
    assert sum(len(x) for x in table.batches) == \
        len(np.unique(b.column("k").values.numpy()))
    assert calls["hist"] == calls["pos"] and set(calls["hist"]) == {8}
    assert len(calls["hist"]) == 1     # the one state-row exchange


def test_a_shard_alone_calls_each_kernel_once(calls):
    b = DistContext(devices=["cpu"] * 8).shard_batch(_batch()).shards[0]
    shuffle.partition_for_exchange(b, ["k"], 8, 512)
    assert calls == {"hist": [1], "pos": [1]}
