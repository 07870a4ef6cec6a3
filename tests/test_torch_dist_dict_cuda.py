"""Dictionary columns across the exchange on the card: the three entry
points of that slice (``entry_dist_dict``, ``entry_dist_sort_dict`` and
``entry_q3_dist`` with ``segment=``) over 8 logical shards of the card at a
few thousand rows, each against its CPU twin (where the kernel wrappers
take their plain versions), and a raw-row shuffle of a dictionary column.
Every dictionary column comes back from the card with its codes and a
dictionary equal to its CPU twin's.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_dist_dict_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.core.array import dictionary_from_numpy
from arrow_tpu_torch.core.batch import batch
from arrow_tpu_torch.entry import entry_dist_dict, entry_dist_sort_dict, \
    entry_q3_dist
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.parallel import DistContext, shuffle

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _assert_same_dictionary(got, want):
    """A varlen dictionary from the card equal to its CPU twin's."""
    assert got.device.type == "cuda"
    n = len(want)
    assert len(got) == n
    off = want.offsets[:n + 1]
    assert torch.equal(got.offsets[:n + 1].cpu(), off)
    assert torch.equal(got.values[:int(off[-1])].cpu(),
                       want.values[:int(off[-1])])


def _assert_same_shards(got, want, close=()):
    """Per shard and in row order: equal values (codes for a dictionary
    column, whose dictionary matches its twin's) and validity; the
    ``close`` columns (float sums the two devices add in other orders)
    within 1e-10."""
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        n = len(wb)
        for name in wb.column_names:
            g, w = gb.column(name), wb.column(name)
            assert g.device.type == "cuda"
            if w.dictionary is not None:
                _assert_same_dictionary(g.dictionary, w.dictionary)
            gv, wv = g.validity_or_true()[:n].cpu(), w.validity_or_true()[:n]
            assert torch.equal(gv, wv), name
            a, b = g.values[:n].cpu()[wv], w.values[:n][wv]
            if name in close:
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=1e-10)
            else:
                assert torch.equal(a, b), name


def test_entry_dist_dict_on_card_matches_cpu(cuda_device):
    """The distributed group-by on a dictionary of 3000 ``C_NAME`` strings,
    with no device named: one launch of each exchange kernel and one B1
    launch a shard; the CPU twin's groups per shard, in row order."""
    ck.reset_launch_counts()
    step, args = entry_dist_dict(None, 8, 40_000, 3000, 1 << 12, 3)
    assert args[0].column("name").dictionary.device.type == "cuda"
    got = step(*args)
    assert ck.LAUNCHES["partition_histogram"] == 1
    assert ck.LAUNCHES["partition_positions"] == 1
    assert ck.LAUNCHES["filter_compact_chunks"] == 8
    cstep, cargs = entry_dist_dict("cpu", 8, 40_000, 3000, 1 << 12, 3)
    _assert_same_shards(got, cstep(*cargs), close=("v_sum",))


def test_entry_dist_sort_dict_on_card_matches_cpu(cuda_device):
    """``k1`` ascending, then the dictionary string ``s`` (5 % nulls)
    descending: the CPU twin's shards row for row."""
    ck.reset_launch_counts()
    step, args = entry_dist_sort_dict(None, 8, 30_000, 1, 500)
    got = step(*args)
    assert ck.LAUNCHES["partition_histogram"] == 1
    assert ck.LAUNCHES["partition_positions"] == 1
    cstep, cargs = entry_dist_sort_dict("cpu", 8, 30_000, 1, 500)
    _assert_same_shards(got, cstep(*cargs))


def test_entry_q3_dist_with_segment_on_card_matches_cpu(cuda_device):
    """The Q3 Declaration with ``dist=`` and the dictionary segment over
    8 logical shards: the CPU twin's top 10."""
    step, tables = entry_q3_dist(None, 8, 8000, 3, 1 << 12, 1024, "BUILDING")
    assert tables[2].batches[0].column("c_mktsegment").dictionary \
        .device.type == "cuda"
    ck.reset_launch_counts()
    got = step(*tables)
    assert ck.LAUNCHES["filter_compact_chunks"] > 0
    assert ck.LAUNCHES["pack_key_lanes"] > 0
    cstep, ctables = entry_q3_dist("cpu", 8, 8000, 3, 1 << 12, 1024,
                                   "BUILDING")
    _assert_same_shards(got, cstep(*ctables), close=("revenue",))


def test_shuffle_of_a_dictionary_column_on_card_matches_cpu(cuda_device):
    """The raw-row exchange by a dictionary key with nulls: the CPU twin's
    buffers whole, each received shard reading its codes through the one
    dictionary on the card."""
    rng = np.random.default_rng(4)
    n = 50_000
    idx = rng.integers(0, 300, n)
    valid = rng.random(n) > 0.1
    words = np.array([f"w{i:03d}" for i in range(300)])
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch({"s": dictionary_from_numpy(idx, words, validity=valid,
                                              device=dev)})
        ctx = DistContext(devices=[dev] * 4)
        sb = ctx.shard_batch(b)
        outs.append((b, shuffle.shuffle_batch(
            sb.shards, ["s"], ctx.devices,
            bucket_capacity=sb.local_capacity)))
    (gsrc, got), (_, want) = outs
    for (gb, gerr), (wb, werr) in zip(got, want):
        assert int(gerr) == int(werr) == 0
        assert int(gb.length) == int(wb.length)
        g, w = gb.column("s"), wb.column("s")
        assert g.dictionary is gsrc.column("s").dictionary
        assert torch.equal(g.values.cpu(), w.values)
        assert torch.equal(g.validity.cpu(), w.validity)
