"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


@pytest.mark.parametrize("cap,C,p", [(1, 20, 1.0), (255, 3, 0.5),
                                     (2049, 20, 0.5), (100_003, 7, 0.01),
                                     (1 << 20, 20, 0.99), (1 << 20, 8, 0.0)])
def test_filter_compact_chunks_kernel_vs_plain(cuda_device, cap, C, p):
    g = torch.Generator(device=cuda_device).manual_seed(cap)
    sel = torch.rand(cap, generator=g, device=cuda_device) < p
    chunks = torch.randint(0, 256, (cap, C), generator=g, dtype=torch.uint8,
                           device=cuda_device)
    before = ck.LAUNCHES["filter_compact_chunks"]
    got = ck.filter_compact_chunks(sel, chunks)
    assert ck.LAUNCHES["filter_compact_chunks"] == before + 1
    want = ck.filter_compact_chunks_plain(sel, chunks)
    n = int(sel.sum())
    assert torch.equal(got[:n], want[:n])


@pytest.mark.parametrize("cap,p", [(1024, 0.5), (1024, 0.0), (1024, 1.0),
                                   (1 << 20, 0.5), (1 << 20, 0.001),
                                   (1 << 20, 0.999), (3 * 1024, 0.3)])
def test_tile_compact_local_kernel_vs_plain(cuda_device, cap, p):
    g = torch.Generator(device=cuda_device).manual_seed(cap)
    sel = torch.rand(cap, generator=g, device=cuda_device) < p
    before = ck.LAUNCHES["tile_compact_local"]
    loc, counts = ck.tile_compact_local(sel)
    assert ck.LAUNCHES["tile_compact_local"] == before + 1
    ploc, pcounts = ck.tile_compact_local_plain(sel)
    assert torch.equal(counts, pcounts)
    assert torch.equal(loc, ploc)          # zeros past each tile's count too


def test_get_take_indices_on_card_matches_nonzero(cuda_device):
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.ops.selection import get_take_indices
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for cap in (1000, 1024, 1_000_003):
        sel = torch.rand(cap, generator=g, device=cuda_device) < 0.4
        idx = get_take_indices(Array(dt.bool_, sel))
        want = torch.nonzero(sel).flatten()
        assert int(idx.length) == want.shape[0]
        assert torch.equal(idx.values[:want.shape[0]].long(), want)
        assert not idx.values[want.shape[0]:].any()


@pytest.mark.parametrize("G", [128, 1024, 4096])
def test_dense_group_reduce_kernel_vs_plain(cuda_device, G):
    g = torch.Generator(device=cuda_device).manual_seed(G)
    n = 300_001
    gid = torch.randint(-1, G + 9, (n,), generator=g, dtype=torch.int32,
                        device=cuda_device)
    kinds, inputs = [], []
    for kind in sorted(ck._DG_ARITY):
        kinds.append(kind)
        for _ in range(ck._DG_ARITY[kind][0]):
            if kind in ("sum", "min", "max"):
                x = torch.randn(n, generator=g, device=cuda_device)
                if kind != "sum":
                    x[gid == 5] = float("nan")
            elif kind == "sumc":
                x = torch.randint(0, 1 << 16, (n,), generator=g,
                                  dtype=torch.int32, device=cuda_device)
            else:
                x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,),
                                  generator=g, dtype=torch.int32,
                                  device=cuda_device)
            inputs.append(x)
    rows, outs = ck.dense_group_reduce(gid, inputs, kinds, G)
    prows, pouts = ck.dense_group_reduce_plain(gid, inputs, kinds, G)
    assert torch.equal(rows, prows)
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()
    oi = 0
    ij = 0
    for kind in kinds:
        ni, no = ck._DG_ARITY[kind]
        for a, b in zip(outs[oi:oi + no], pouts[oi:oi + no]):
            if kind == "sum":
                absum = torch.zeros(G + 1, dtype=torch.float64,
                                    device=cuda_device).index_add_(
                    0, slot, inputs[ij].double().abs())[:G]
                assert ((a.double() - b.double()).abs() <=
                        1e-5 * absum + 1e-6).all()
            else:
                same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                    if a.is_floating_point() else a == b
                assert bool(same.all()), kind
        if kind in ("min", "max"):
            assert torch.isnan(outs[oi][5])
        oi += no
        ij += ni


def test_dense_group_reduce_many_kinds_split_over_launches(cuda_device):
    """24 wide kinds at G = 4096 do not fit one block's shared memory."""
    G, n = 4096, 50_000
    gid = torch.randint(0, G, (n,), dtype=torch.int32, device=cuda_device)
    kinds = ("sumc",) * 24
    assert len(ck._dg_launch_groups(kinds, G)) > 1
    inputs = [torch.randint(0, 1 << 16, (n,), dtype=torch.int32,
                            device=cuda_device) for _ in kinds]
    rows, outs = ck.dense_group_reduce(gid, inputs, kinds, G)
    prows, pouts = ck.dense_group_reduce_plain(gid, inputs, kinds, G)
    assert torch.equal(rows, prows)
    for a, b in zip(outs, pouts):
        assert torch.equal(a, b)


def test_wrappers_refuse_mixed_devices(cuda_device):
    sel = torch.ones(8, dtype=torch.bool)
    chunks = torch.zeros((8, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        ck.filter_compact_chunks(sel, chunks)


def test_entry_slice_on_card_matches_cpu(cuda_device):
    from arrow_tpu_torch.entry import entry
    ck.reset_launch_counts()
    step, args = entry(cuda_device, 200_000, 1000, 3)
    got = step(*args)
    assert ck.LAUNCHES["filter_compact_chunks"] == 1
    assert ck.LAUNCHES["dense_group_reduce"] == 1
    cstep, cargs = entry("cpu", 200_000, 1000, 3)
    want = cstep(*cargs)
    n = len(want)
    assert len(got) == n
    for c in want.column_names:
        a = got.column(c).values[:n].cpu().numpy()
        b = want.column(c).values[:n].numpy()
        if c == "v_sum":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)


def test_entry_generic_slice_on_card_matches_cpu(cuda_device):
    """The take-index filter and the sort-grouping consume on the card,
    with no device named (the default is the card)."""
    from arrow_tpu_torch.entry import entry_generic
    ck.reset_launch_counts()
    step, args = entry_generic(None, 300_000, 50_000, 3, 1 << 16)
    assert args[0].device.type == "cuda"
    got = step(*args)
    assert ck.LAUNCHES["tile_compact_local"] == 1
    cstep, cargs = entry_generic("cpu", 300_000, 50_000, 3, 1 << 16)
    want = cstep(*cargs)
    n = len(want)
    assert len(got) == n
    for c in want.column_names:
        a = got.column(c).values[:n].cpu().numpy()
        b = want.column(c).values[:n].numpy()
        if c == "v_sum":        # the two devices may add in another order
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
        else:
            np.testing.assert_array_equal(a, b, err_msg=c)
