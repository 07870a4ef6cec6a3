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


_FC_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16,
              torch.float16, torch.int32, torch.uint32, torch.float32,
              torch.int64, torch.uint64, torch.float64, torch.bool]


def _fc_column(g, dev, cap, dtype):
    """(cap,) random bits of a dtype (bool as 0 / 1)."""
    raw = torch.randint(-(1 << 62), 1 << 62, (cap,), generator=g,
                        device=dev, dtype=torch.int64)
    if dtype == torch.bool:
        return raw > 0
    size = torch.empty((), dtype=dtype).element_size()
    return raw.view(torch.uint8).view(cap, 8)[:, :size].contiguous() \
        .view(dtype).reshape(cap)


def _fc_check(sel, columns, launches=1):
    """filter_compact_columns against its plain version: the count, and
    every column's first count rows byte for byte; ``launches`` kernel
    launches."""
    before = ck.LAUNCHES["filter_compact_chunks"]
    outs, count = ck.filter_compact_columns(sel, columns)
    assert ck.LAUNCHES["filter_compact_chunks"] == before + launches
    want, want_count = ck.filter_compact_columns_plain(sel, columns)
    n = int(want_count)
    assert count.dtype == torch.int32 and count.shape == () and \
        count.device == sel.device
    assert int(count) == n == int(sel.sum())
    for got, w, c in zip(outs, want, columns):
        assert got.dtype == c.dtype and got.shape == c.shape and \
            got.is_contiguous()
        assert torch.equal(got[:n].view(torch.uint8), w[:n].view(torch.uint8))
    return outs, count


@pytest.mark.parametrize("p", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("cap", [1, 15, 17, 4095, 4097, 100_003, 1 << 20])
def test_filter_compact_columns_every_width_in_one_launch(cuda_device, cap,
                                                          p):
    g = torch.Generator(device=cuda_device).manual_seed(cap)
    sel = torch.rand(cap, generator=g, device=cuda_device) < p
    columns = [_fc_column(g, cuda_device, cap, t) for t in _FC_DTYPES]
    for C in (20, 7, 3, 16):        # the one-matrix form, any row width
        columns.append(torch.randint(0, 256, (cap, C), generator=g,
                                     dtype=torch.uint8, device=cuda_device))
    _fc_check(sel, columns)


def test_filter_compact_columns_wide_rows(cuda_device):
    """Rows of up to 1025 copy units (more than a block has threads)."""
    cap = 20_003
    g = torch.Generator(device=cuda_device).manual_seed(7)
    sel = torch.rand(cap, generator=g, device=cuda_device) < 0.5
    columns = [torch.randint(0, 256, (cap, C), generator=g,
                             dtype=torch.uint8, device=cuda_device)
               for C in (600, 1025, 4100, 513)]
    _fc_check(sel, columns)


@pytest.mark.parametrize("n_cols", [33, 70])
def test_filter_compact_columns_more_than_k_columns(cuda_device, n_cols):
    cap = 100_003
    g = torch.Generator(device=cuda_device).manual_seed(n_cols)
    sel = torch.rand(cap, generator=g, device=cuda_device) < 0.4
    columns = [_fc_column(g, cuda_device, cap,
                          _FC_DTYPES[i % len(_FC_DTYPES)])
               for i in range(n_cols)]
    _fc_check(sel, columns, launches=-(-n_cols // ck.FC_MAX_COLUMNS))


@pytest.mark.parametrize("off", [1, 4, 9])
def test_filter_compact_columns_takes_misaligned_and_strided_views(
        cuda_device, off):
    cap = 100_003
    g = torch.Generator(device=cuda_device).manual_seed(off)
    sel = (torch.rand(cap + 16, generator=g, device=cuda_device) < 0.5)[
        off:off + cap]
    assert sel.data_ptr() % 16 != 0
    i64 = _fc_column(g, cuda_device, cap + 16, torch.int64)
    i32 = _fc_column(g, cuda_device, 3 * cap, torch.int32)
    mat = torch.randint(0, 256, (cap, 24), generator=g, dtype=torch.uint8,
                        device=cuda_device)
    f64 = _fc_column(g, cuda_device, 2 * cap, torch.float64).view(cap, 2)
    b = _fc_column(g, cuda_device, cap + 16, torch.bool)
    columns = [i64[off:off + cap], i32[::3], mat[:, off:off + 8],
               mat[:, off], f64[:, 1], b[off:off + cap],
               mat[:, 3:3 + 5 + off]]
    _fc_check(sel, columns)


@pytest.mark.parametrize("pattern", ["all", "none", "alternating",
                                     "last_tile"])
def test_filter_compact_columns_past_30000_tiles(cuda_device, pattern):
    cap = 1 << 28
    rows = torch.arange(cap, device=cuda_device)
    sel = {"all": rows >= 0, "none": rows < 0,
           "alternating": rows % 2 == 1,
           "last_tile": rows >= cap - 3000}[pattern]
    assert cap // ck.FC_TILE_ROWS > 30_000
    val = rows.to(torch.int32)
    _fc_check(sel, [val, (rows % 3 == 0)])


def test_filter_compact_columns_back_to_back_calls_reuse_the_scratch(
        cuda_device):
    """100 calls on one stream with no synchronisation between them, of
    sizes that grow and shrink the scratch, then every result checked."""
    g = torch.Generator(device=cuda_device).manual_seed(100)
    ck._fc_scratch.clear()
    calls = []
    before = ck.LAUNCHES["filter_compact_chunks"]
    for i in range(100):
        cap = (1000, 1 << 20, 4097, 1 << 22, 77)[i % 5] + i
        sel = torch.rand(cap, generator=g, device=cuda_device) < \
            (i % 7) / 6
        cols = [_fc_column(g, cuda_device, cap, torch.int64),
                _fc_column(g, cuda_device, cap, torch.bool)]
        calls.append((sel, cols, ck.filter_compact_columns(sel, cols)))
    assert ck.LAUNCHES["filter_compact_chunks"] == before + 100
    for sel, cols, (outs, count) in calls:
        want, want_count = ck.filter_compact_columns_plain(sel, cols)
        n = int(want_count)
        assert int(count) == n
        for got, w in zip(outs, want):
            assert torch.equal(got[:n], w[:n])


def test_filter_compact_columns_epoch_wrap(cuda_device):
    """The scratch at the epoch's wrap: cleared, epoch 1 again, and the
    calls after it still right."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    cap = 1 << 20

    def call():
        sel = torch.rand(cap, generator=g, device=cuda_device) < 0.3
        _fc_check(sel, [_fc_column(g, cuda_device, cap, torch.float32)])
    call()
    key = (cuda_device.index or 0,
           torch.cuda.current_stream(cuda_device).cuda_stream)
    ck._fc_scratch[key][1] = ck._FC_EPOCHS - 3
    for _ in range(5):
        call()
    assert ck._fc_scratch[key][1] == 3


def test_filter_batch_on_card_matches_cpu(cuda_device):
    """filter_batch over every fixed-width storage type, with and without
    validity, under DROP and EMIT_NULL, on the card and on the CPU."""
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.core.batch import Batch
    from arrow_tpu_torch.core.schema import Field, Schema
    from arrow_tpu_torch.ops import selection
    types = [dt.int8, dt.uint8, dt.int16, dt.uint16, dt.float16, dt.int32,
             dt.uint32, dt.float32, dt.int64, dt.uint64, dt.float64,
             dt.bool_, dt.date32, dt.timestamp("us")]
    cap, n = 100_003, 99_000
    rng = np.random.default_rng(0)
    fields, cols = [], []
    for i, t in enumerate(types):
        raw = rng.integers(0, 256, (cap, t.storage_np.itemsize),
                           dtype=np.uint8)
        vals = raw.view(t.storage_np).reshape(cap) if t != dt.bool_ \
            else rng.random(cap) < 0.5
        ok = rng.random(cap) < 0.8 if i % 2 else None
        fields.append(Field(f"c{i}", t))
        cols.append((t, vals, ok))
    mvals, mok = rng.random(cap) < 0.5, rng.random(cap) < 0.9
    res = []
    for dev in ("cpu", cuda_device):
        arrays = [Array(t, torch.from_numpy(v).to(dev),
                        None if ok is None else torch.from_numpy(ok).to(dev),
                        length=n) for t, v, ok in cols]
        b = Batch(Schema(tuple(fields)), arrays, n)
        mask = Array(dt.bool_, torch.from_numpy(mvals).to(dev),
                     torch.from_numpy(mok).to(dev), length=n)
        for behavior in ("drop", "emit_null"):
            res.append(_host_columns(selection.filter_batch(
                b, mask, selection.FilterOptions(behavior))))
    for got, want in zip(res[2:], res[:2]):
        for name, (a, a_ok) in got.items():
            b, b_ok = want[name]
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert (a_ok is None) == (b_ok is None), name
            if b_ok is not None:
                np.testing.assert_array_equal(a_ok, b_ok, err_msg=name)
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                          err_msg=name)


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


@pytest.mark.parametrize("off", [1, 4, 15])
def test_tile_compact_local_kernel_takes_views_off_the_16_byte_grid(
        cuda_device, off):
    g = torch.Generator(device=cuda_device).manual_seed(off)
    base = torch.rand((1 << 18) + 16, generator=g, device=cuda_device) < 0.5
    view = base[off:off + (1 << 18)]
    assert view.data_ptr() % 16 != 0
    loc, counts = ck.tile_compact_local(view)
    ploc, pcounts = ck.tile_compact_local_plain(view.clone())
    assert torch.equal(counts, pcounts) and torch.equal(loc, ploc)


def test_tile_compact_local_kernel_edge_tiles_and_nonzero_bytes(cuda_device):
    """Tiles with 0, 1, 1023 and 1024 selected rows; any nonzero byte of
    the selection counts as selected."""
    sel = torch.zeros(4096, dtype=torch.bool, device=cuda_device)
    sel[1024 + 5] = True
    sel[2048:3071] = True
    sel[3072:] = True
    loc, counts = ck.tile_compact_local(sel)
    assert counts.tolist() == [0, 1, 1023, 1024]
    assert torch.equal(loc, ck.tile_compact_local_plain(sel)[0])
    g = torch.Generator(device=cuda_device).manual_seed(2)
    raw = torch.randint(0, 256, (1 << 16,), generator=g, dtype=torch.uint8,
                        device=cuda_device)
    raw[torch.rand(1 << 16, generator=g, device=cuda_device) < 0.5] = 0
    loc, counts = ck.tile_compact_local(raw.view(torch.bool))
    ploc, pcounts = ck.tile_compact_local_plain(raw != 0)
    assert torch.equal(counts, pcounts) and torch.equal(loc, ploc)


@pytest.mark.parametrize("shape", ["none", "all", "half", "stretches"])
@pytest.mark.parametrize("cap", [1024, 5 * 1024, 1 << 20])
def test_tile_stitch_kernel_vs_plain(cuda_device, cap, shape):
    g = torch.Generator(device=cuda_device).manual_seed(cap)
    sel = {"none": torch.zeros(cap, dtype=torch.bool, device=cuda_device),
           "all": torch.ones(cap, dtype=torch.bool, device=cuda_device),
           }.get(shape)
    if sel is None:
        sel = torch.rand(cap, generator=g, device=cuda_device) < 0.5
    if shape == "stretches":
        tile = torch.arange(cap, device=cuda_device) // 1024
        sel &= (tile // 2) % 2 == 1
    loc, counts = ck.tile_compact_local(sel)
    starts = torch.cat([counts.new_zeros(1),
                        torch.cumsum(counts, 0, dtype=torch.int32)])
    for out_cap in (cap, max(cap - 1000, int(starts[-1]))):
        before = ck.LAUNCHES["tile_stitch"]
        got = ck.tile_stitch(loc, counts, starts, out_cap)
        assert ck.LAUNCHES["tile_stitch"] == before + (1 if out_cap else 0)
        assert torch.equal(got, ck.tile_stitch_plain(loc, counts, starts,
                                                     out_cap))
        n = int(starts[-1])
        assert torch.equal(got[:n].long(), torch.nonzero(sel).flatten())
        assert not got[n:].any()


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
            elif kind in ck._DG_I64:
                x = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                                  dtype=torch.int64, device=cuda_device)
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


@pytest.mark.parametrize("gids", ["spread", "one_slot", "mostly_one_slot"])
@pytest.mark.parametrize("G", [128, 1024, 4096])
def test_dense_group_reduce_native_kinds_kernel_vs_plain(cuda_device, G,
                                                          gids):
    """first_row, and sum / min / max of an f32 and of an int64 column with
    their validity streams, each column's kinds sharing its stream; gids
    out of range; all or most rows in one slot (the warp-combined path); a
    view off the 16-byte grid."""
    g = torch.Generator(device=cuda_device).manual_seed(G)
    n = 300_003
    gid = torch.randint(-1, G + 9, (n,), generator=g, dtype=torch.int32,
                        device=cuda_device)
    if gids == "one_slot":
        gid = torch.full_like(gid, G - 1)
    elif gids == "mostly_one_slot":
        gid[torch.rand(n, generator=g, device=cuda_device) < 0.7] = 2
    v = torch.randn(n, generator=g, device=cuda_device)
    v[gid == 5] = float("nan")
    w = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                      dtype=torch.int64, device=cuda_device)
    w[gid == 6] = (1 << 63) - 1
    w[7] = -(1 << 63)
    v_ok = torch.rand(n, generator=g, device=cuda_device) < 0.8
    w_ok = torch.rand(n, generator=g, device=cuda_device) < 0.8
    kinds = ("first_row", "sum", "min", "max", "sum64", "min64", "max64",
             "count")
    inputs = (v, v, v, w, w, w, w_ok.to(torch.int32))
    valid = (None, v_ok, v_ok, v_ok, w_ok, w_ok, w_ok, None)
    for cut in (0, 1):
        cg = gid[cut:]
        cin = tuple(x[cut:] for x in inputs)
        cvalid = tuple(x if x is None else x[cut:] for x in valid)
        for vd in (cvalid, None):
            rows, outs = ck.dense_group_reduce(cg, cin, kinds, G, vd)
            prows, pouts = ck.dense_group_reduce_plain(cg, cin, kinds, G, vd)
            assert torch.equal(rows, prows)
            for kind, a, b in zip(kinds, outs, pouts):
                assert a.dtype == b.dtype
                if kind == "sum":
                    assert torch.equal(a.isnan(), b.isnan())
                    d = (a.double() - b.double()).nan_to_num().abs()
                    # 1e-5 of at most n rows of |v| around 0.8
                    assert float(d.max()) <= 1e-5 * 0.8 * n + 1e-6
                else:
                    same = (a == b) | (a.isnan() & b.isnan())
                    assert bool(same.all()), (kind, cut)


@pytest.mark.parametrize("length", ["all", "static", "on_device"])
@pytest.mark.parametrize("G", [128, 4096])
def test_dense_group_reduce_slots_from_key_column_vs_plain(cuda_device, G,
                                                           length):
    """A ``DenseKey``: the kernel forms the slot from the int64 key, its
    validity (null keys in slot G - 1) and the length, also on a view off
    the 16-byte grid."""
    g = torch.Generator(device=cuda_device).manual_seed(G + 1)
    n = 200_003
    lo = (1 << 50) + 3
    keys = lo + torch.randint(-2, G + 5, (n,), generator=g, device=cuda_device)
    k_ok = torch.rand(n, generator=g, device=cuda_device) < 0.9
    w = torch.randint(-(1 << 62), 1 << 62, (n,), generator=g,
                      dtype=torch.int64, device=cuda_device)
    v = torch.randn(n, generator=g, device=cuda_device)
    kinds = ("first_row", "sum64", "min64", "max")
    for cut in (0, 1):
        m = n - cut
        rows_in_use = {"all": m, "static": m // 2,
                       "on_device": torch.tensor(m // 3, dtype=torch.int32,
                                                 device=cuda_device)}[length]
        for ok in (k_ok[cut:], None):
            key = ck.DenseKey(keys[cut:], lo, rows_in_use, ok)
            xs = (w[cut:], w[cut:], v[cut:])
            before = ck.LAUNCHES["dense_group_reduce"]
            rows, outs = ck.dense_group_reduce(key, xs, kinds, G)
            assert ck.LAUNCHES["dense_group_reduce"] == before + 1
            prows, pouts = ck.dense_group_reduce_plain(key, xs, kinds, G)
            assert torch.equal(rows, prows)
            assert int(rows.sum()) <= int(rows_in_use)
            for a, b in zip(outs, pouts):
                assert torch.equal(a, b)


def test_dense_group_reduce_no_kinds_gives_the_row_counts(cuda_device):
    gid = torch.randint(-1, 200, (10_000,), dtype=torch.int32,
                        device=cuda_device)
    rows, outs = ck.dense_group_reduce(gid, (), (), 128)
    assert outs == []
    assert torch.equal(rows, ck.dense_group_reduce_plain(gid, (), (), 128)[0])


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


@pytest.mark.parametrize("P", [1, 2, 8, 33, 64, 128])
@pytest.mark.parametrize("n", [1, 5, 1000, 1 << 20, (1 << 20) + 7])
def test_partition_histogram_kernel_vs_plain(cuda_device, n, P):
    """Equal counts for uniform, one-value, out-of-range and skewed dest,
    and for a dest that does not start on a 16-byte boundary."""
    g = torch.Generator(device=cuda_device).manual_seed(n + P)
    base = torch.randint(-1, P + 2, (n + 3,), generator=g,
                         dtype=torch.int32, device=cuda_device)
    skew = (torch.rand(n, generator=g, device=cuda_device) ** 4 * P) \
        .to(torch.int32)
    cases = [base[:n], base[1:n + 1], base[3:], skew,
             torch.full((n,), P - 1, dtype=torch.int32, device=cuda_device),
             torch.full((n,), P, dtype=torch.int32, device=cuda_device),
             torch.full((n,), -1, dtype=torch.int32, device=cuda_device)]
    for dest in cases:
        before = ck.LAUNCHES["partition_histogram"]
        got = ck.partition_histogram(dest.contiguous(), P)
        assert ck.LAUNCHES["partition_histogram"] == before + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, ck.partition_histogram_plain(dest, P))


def test_partition_histogram_on_card_edges(cuda_device):
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    before = ck.LAUNCHES["partition_histogram"]
    assert ck.partition_histogram(empty, 8).tolist() == [0] * 8
    assert ck.LAUNCHES["partition_histogram"] == before     # no launch
    d = torch.zeros((64,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ck.partition_histogram(d, ck.MAX_PARTITIONS + 1)
    with pytest.raises(ValueError):
        ck.partition_histogram(d[::2], 4)                   # not contiguous


def test_entry_distributed_on_card_matches_cpu(cuda_device):
    """The distributed group-by over 8 logical shards of the card, with no
    device named, against the same on the CPU: per shard, in row order."""
    from arrow_tpu_torch.entry import entry_distributed
    ck.reset_launch_counts()
    step, args = entry_distributed(None, 8, 400_000, 30_000, 1 << 16, 3)
    assert args[0].device.type == "cuda"
    got = step(*args)
    assert ck.LAUNCHES["partition_histogram"] == 8
    assert ck.LAUNCHES["filter_compact_chunks"] == 8
    cstep, cargs = entry_distributed("cpu", 8, 400_000, 30_000, 1 << 16, 3)
    want = cstep(*cargs)
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        n = len(wb)
        for c in wb.column_names:
            a = gb.column(c).values[:n].cpu().numpy()
            b = wb.column(c).values[:n].numpy()
            if c == "v_sum":    # the two devices may add in another order
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
            else:
                np.testing.assert_array_equal(a, b, err_msg=c)


def test_shuffle_batch_on_card_matches_cpu(cuda_device):
    """The raw-row exchange on the card against the CPU, whole buffers."""
    from arrow_tpu_torch.entry import example_columns_generic
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.parallel import DistContext, shuffle
    cols = example_columns_generic(100_000, 5000, 1)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = DistContext(devices=[dev] * 4)
        sb = ctx.shard_batch(batch_from_numpy(cols, device=dev))
        outs.append(shuffle.shuffle_batch(sb.shards, ["k"], ctx.devices,
                                          bucket_capacity=sb.local_capacity))
    for (gb, gerr), (wb, werr) in zip(*outs):
        assert int(gerr) == int(werr) == 0
        assert int(gb.length) == int(wb.length)
        for c in wb.column_names:
            assert torch.equal(gb.column(c).values.cpu(),
                               wb.column(c).values)


def test_wrappers_refuse_mixed_devices(cuda_device):
    sel = torch.ones(8, dtype=torch.bool)
    chunks = torch.zeros((8, 4), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        ck.filter_compact_chunks(sel, chunks)
    with pytest.raises(ValueError):
        ck.filter_compact_columns(sel.to(cuda_device), [chunks, chunks[:, 0]
                                                        .cpu()])
    loc = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ck.tile_stitch(loc, torch.zeros(1, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int32), 8)
    gid = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ck.dense_group_reduce(gid, (), ("first_row",), 128,
                              (torch.ones(8, dtype=torch.bool),))


def _host_columns(out):
    """name -> (values, validity or None) of a result batch's rows, as
    numpy (no pyarrow on the card's machine)."""
    n = len(out)
    cols = {}
    for name in out.column_names:
        a = out.column(name)
        cols[name] = (a.values[:n].cpu().numpy(),
                      None if a.validity is None
                      else a.validity[:n].cpu().numpy())
    return cols


def _assert_same_columns(got, want, float_cols=()):
    assert list(got) == list(want)
    for name, (b, b_ok) in want.items():
        a, a_ok = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert (a_ok is None) == (b_ok is None), name
        keep = np.ones(a.shape, np.bool_)
        if b_ok is not None:
            np.testing.assert_array_equal(a_ok, b_ok, err_msg=name)
            keep = b_ok                     # null rows hold anything
        if name in float_cols:              # atomics add in another order
            np.testing.assert_allclose(a[keep], b[keep], rtol=1e-4,
                                       atol=1e-3, err_msg=name)
        else:
            np.testing.assert_array_equal(a[keep], b[keep], err_msg=name)


def test_consume_dense_with_nulls_on_card_matches_cpu(cuda_device):
    """``consume_dense`` with null keys and null values, every aggregate
    and count mode: the card against the CPU (plain kernel version)."""
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.core.batch import Batch, batch_from_numpy
    from arrow_tpu_torch.entry import consume_routed
    from arrow_tpu_torch.ops.agg_options import CountOptions
    from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, \
        HashAggregate
    rng = np.random.default_rng(4)
    n = 200_000
    cols = {"k": rng.integers(-50, 900, n),
            "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(-(1 << 62), 1 << 62, n)}
    nulls = {c: rng.random(n) < 0.1 for c in cols}
    specs = [AggregateSpec("count_all")]
    for c in ("v", "w"):
        specs += [AggregateSpec(f, c) for f in ("sum", "min", "max",
                                                "count")]
        specs += [AggregateSpec("count", c, CountOptions("only_null"),
                                name=f"{c}_nulls"),
                  AggregateSpec("count", c, CountOptions("all"),
                                name=f"{c}_all")]
    specs.append(AggregateSpec("mean", "v"))
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_from_numpy(cols, device=dev)
        b = Batch(b.schema, [
            Array(a.type, a.values, torch.from_numpy(~nulls[c]).to(dev),
                  a.length) for c, a in zip(b.column_names, b.arrays)],
            b.length)
        ha = HashAggregate(b.schema, ["k"], specs, max_groups=2048)
        before = ck.LAUNCHES["dense_group_reduce"]
        out = ha.finalize(consume_routed(ha, ha.init_state(dev), b))
        assert ck.LAUNCHES["dense_group_reduce"] - before == \
            (1 if dev.type == "cuda" else 0)
        results.append(_host_columns(out))
    got, want = results
    assert len(want["k"][0]) == 951         # 950 keys and the null key
    _assert_same_columns(got, want, float_cols=("v_sum", "v_mean"))


def _unsigned_columns(rng, n, key):
    return {"k": key,
            "a": rng.integers(0, 1 << 16, n, dtype=np.uint16),
            "b": rng.integers(0, 1 << 32, n, dtype=np.uint32),
            "c": rng.integers(0, 1 << 64, n, dtype=np.uint64)}


def test_unsigned_columns_and_uint64_key_on_card_matches_cpu(cuda_device):
    """sum / min / max of uint16 / uint32 / uint64 columns grouped by a
    uint64 key past 2^63 through the sort-grouping consume and ``merge``:
    the card against the CPU, bit for bit (torch gathers, scatters and
    reduces no wide unsigned type on the card: the port moves them as
    their signed bits)."""
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, \
        HashAggregate
    rng = np.random.default_rng(9)
    n = 50_000
    cols = _unsigned_columns(
        rng, n, np.uint64(1 << 63) + rng.integers(0, 300, n).astype(
            np.uint64))
    specs = [AggregateSpec(f, c) for c in "abc"
             for f in ("sum", "min", "max")]
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_from_numpy(cols, device=dev)
        ha = HashAggregate(b.schema, ["k"], specs, max_groups=512)
        st = ha.consume(ha.init_state(dev), b)
        st = ha.merge(st, ha.consume(ha.init_state(dev), b))
        results.append(_host_columns(ha.finalize(st)))
    got, want = results
    assert len(want["k"][0]) == 300 and want["k"][0].dtype == np.uint64
    _assert_same_columns(got, want)


@pytest.mark.parametrize("ktype,base", [(np.uint16, 40000),
                                        (np.uint32, 3_000_000_000),
                                        (np.uint64, (1 << 63) - 100)])
def test_dense_route_unsigned_key_on_card_matches_cpu(cuda_device, ktype,
                                                      base):
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.entry import consume_routed
    from arrow_tpu_torch.ops.hash_aggregate import AggregateSpec, \
        HashAggregate
    rng = np.random.default_rng(10)
    n = 100_000
    cols = {"k": (np.uint64(base) + rng.integers(0, 500, n).astype(
                np.uint64)).astype(ktype),
            "v": rng.standard_normal(n).astype(np.float32),
            "w": rng.integers(-1000, 1000, n)}
    specs = [AggregateSpec("sum", "w"), AggregateSpec("min", "v"),
             AggregateSpec("count_all")]
    results = []
    for dev in (cuda_device, torch.device("cpu")):
        b = batch_from_numpy(cols, device=dev)
        ha = HashAggregate(b.schema, ["k"], specs, max_groups=1024)
        before = ck.LAUNCHES["dense_group_reduce"]
        out = ha.finalize(consume_routed(ha, ha.init_state(dev), b))
        assert ck.LAUNCHES["dense_group_reduce"] - before == \
            (1 if dev.type == "cuda" else 0)
        results.append(_host_columns(out))
    got, want = results
    assert want["k"][0].dtype == ktype and len(want["k"][0]) == 500
    _assert_same_columns(got, want)


def test_dist_group_by_unsigned_on_card_matches_cpu(cuda_device):
    """The distributed group-by (4 logical shards) over a uint64 key with
    unsigned value columns: hash, exchange and merge on the card against
    the CPU, per shard."""
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.parallel import DistContext
    rng = np.random.default_rng(11)
    n = 40_000
    cols = _unsigned_columns(
        rng, n, np.uint64(1 << 63) + rng.integers(0, 200, n).astype(
            np.uint64))
    aggs = [(f, c) for c in "abc" for f in ("sum", "min", "max")]
    tables = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = DistContext(devices=[dev] * 4)
        tables.append(ctx.group_by(batch_from_numpy(cols, device=dev), ["k"],
                                   aggs, max_groups_per_shard=256))
    got, want = tables
    assert [len(b) for b in got.batches] == [len(b) for b in want.batches]
    assert sum(len(b) for b in want.batches) == 200
    for gb, wb in zip(got.batches, want.batches):
        _assert_same_columns(_host_columns(gb), _host_columns(wb))


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
    assert ck.LAUNCHES["tile_stitch"] == 1
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


# ---- sort, planes, join and wide unsigned comparisons on the card ----------

def _same_array(a, b):
    """Two Arrays (one per device): length, value bits and validity
    equal."""
    from arrow_tpu_torch.ops.bits import as_signed_bits
    n = int(a.length)
    assert int(b.length) == n

    def bits(x):            # NaNs compare by their bits
        x = as_signed_bits(x)[:n].cpu()
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        return x.view(ints[x.element_size()]) if x.dtype.is_floating_point \
            else x
    assert torch.equal(bits(a.values), bits(b.values))
    assert (a.validity is None) == (b.validity is None)
    if a.validity is not None:
        assert torch.equal(a.validity[:n].cpu(), b.validity[:n].cpu())


@pytest.mark.parametrize("fn", ["equal", "not_equal", "less", "less_equal",
                                "greater", "greater_equal"])
@pytest.mark.parametrize("t", [np.uint16, np.uint32, np.uint64],
                         ids=["uint16", "uint32", "uint64"])
def test_wide_unsigned_comparisons_on_card(cuda_device, fn, t):
    """The six comparisons of uint16 / uint32 / uint64 columns (torch has
    none for them on the card): against numpy, values past the signed
    range included, column against column and against a scalar."""
    from arrow_tpu_torch import array_from_numpy
    from arrow_tpu_torch.compute import call_function
    from arrow_tpu_torch.compute.scalar import scalar
    rng = np.random.default_rng(7)
    info = np.iinfo(t)
    a = rng.integers(0, info.max, 5000, dtype=t, endpoint=True)
    b = rng.integers(0, info.max, 5000, dtype=t, endpoint=True)
    a[:4] = [0, info.max, info.max // 2, info.max // 2 + 1]
    b[:4] = [info.max, info.max, info.max // 2 + 1, info.max // 2]
    b[100:200] = a[100:200]
    valid = rng.random(5000) < 0.9
    op = getattr(np, fn)
    got = call_function(fn, [
        array_from_numpy(a, validity=valid, device=cuda_device),
        array_from_numpy(b, device=cuda_device)])
    assert torch.equal(got.values.cpu(), torch.from_numpy(op(a, b)))
    assert torch.equal(got.validity.cpu(), torch.from_numpy(valid))
    if t is not np.uint64:      # (an int scalar is int64: no uint64 pivot)
        pivot = int(a[7])
        got = call_function(fn, [array_from_numpy(a, device=cuda_device),
                                 scalar(pivot)])
        assert torch.equal(got.values.cpu(),
                           torch.from_numpy(op(a.astype(np.int64), pivot)))


@pytest.mark.parametrize("placement", ["at_start", "at_end"])
def test_sort_and_rank_on_card_match_cpu(cuda_device, placement):
    """Multi-key sort over every key width (wide unsigned too), rank with
    its four tiebreakers and select_k: the card's results equal the
    CPU's."""
    from arrow_tpu_torch import array_from_numpy
    from arrow_tpu_torch.compute import call_function
    from arrow_tpu_torch.core.batch import batch
    from arrow_tpu_torch.ops import sorting as ts
    rng = np.random.default_rng(11)
    n = 50_000
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    cols = {"a": (rng.integers(0, 50, n).astype(np.int64), None),
            "b": (f, rng.random(n) < 0.9),
            "c": (rng.integers(0, 1 << 16, n).astype(np.uint16), None),
            "d": (rng.integers(0, 1 << 63, n).astype(np.uint64) * 2,
                  rng.random(n) < 0.95),
            "e": (rng.integers(-5, 5, n).astype(np.int32), None),
            "g": (f.astype(np.float32), None)}

    def make(dev):
        return batch({k: array_from_numpy(v, validity=m, capacity=n + 1000,
                                          device=dev)
                      for k, (v, m) in cols.items()})
    bc, bg = make("cpu"), make(cuda_device)
    for keys in ([("a", "ascending"), ("b", "descending")],
                 [("c", "descending"), ("d", "ascending"),
                  ("e", "descending")],
                 [("g", "ascending"), ("a", "descending")]):
        opts = ts.SortOptions(keys, placement)
        _same_array(ts.sort_indices_batch(bg, opts),
                    ts.sort_indices_batch(bc, opts))
    for tb in ("min", "max", "first", "dense"):
        o = ts.RankOptions([("b", "descending")], placement, tb)
        _same_array(call_function("rank", [bg], options=o),
                    call_function("rank", [bc], options=o))
    o = ts.SelectKOptions(100, [("b", "ascending"), ("e", "descending")])
    _same_array(call_function("select_k_unstable", [bg], options=o),
                call_function("select_k_unstable", [bc], options=o))
    q = call_function("rank_normal", [bg["g"]], options=ts.RankOptions())
    qc = call_function("rank_normal", [bc["g"]], options=ts.RankOptions())
    torch.testing.assert_close(q.values[:n].cpu(), qc.values[:n], rtol=0,
                               atol=1e-12)


def test_planes_round_trip_on_card(cuda_device):
    """Pack, row gather and unpack on the card: the matrix equals the CPU's
    word for word, every storage bit comes back."""
    from arrow_tpu_torch.core import datatype as dt
    from arrow_tpu_torch.core.array import Array
    from arrow_tpu_torch.ops import planes
    rng = np.random.default_rng(13)
    n = 10_000
    types = [(dt.bool_, np.bool_), (dt.int8, np.int8), (dt.uint8, np.uint8),
             (dt.int16, np.int16), (dt.uint16, np.uint16),
             (dt.int32, np.int32), (dt.uint32, np.uint32),
             (dt.int64, np.int64), (dt.uint64, np.uint64),
             (dt.float16, np.float16), (dt.float32, np.float32),
             (dt.float64, np.float64), (dt.date32, np.int32)] * 3
    cpu_cols = []
    for i, (t, np_t) in enumerate(types):
        if np_t == np.bool_:
            v = rng.random(n) < 0.5
        else:
            v = rng.integers(0, 256, (n, np.dtype(np_t).itemsize),
                             dtype=np.uint8).view(np_t).reshape(n)
        valid = torch.from_numpy(rng.random(n) < 0.7) if i % 5 else None
        cpu_cols.append(Array(t, torch.from_numpy(v), valid))
    gpu_cols = [a.to(cuda_device) for a in cpu_cols]
    cmat, spec = planes.pack_columns(cpu_cols)
    gmat, gspec = planes.pack_columns(gpu_cols)
    assert gspec == spec and torch.equal(gmat.cpu(), cmat)
    idx = torch.from_numpy(rng.integers(0, n, 20_000))
    out = planes.unpack_columns(gmat[idx.to(cuda_device)], spec, 20_000)
    for a, src in zip(out, cpu_cols):
        _same_array(a, Array(src.type,
                             planes.as_signed_bits(src.values)[idx]
                             .view(src.values.dtype),
                             None if src.validity is None
                             else src.validity[idx]))


@pytest.mark.parametrize("shape,impl", [("unique", "packed_u"),
                                        ("duplicates", "packed"),
                                        ("wide", "sort")])
@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "left semi", "left anti",
                                       "right anti"])
def test_join_routes_on_card_match_cpu(cuda_device, shape, impl, join_type):
    """The three probe routes as ``join_routed`` picks them: the card's
    rows equal the CPU's as a multiset (the row order of a join is free),
    floats by their bits."""
    from arrow_tpu_torch.entry import entry_join, join_routed
    kw = {"unique": {}, "duplicates": {"build_keys": 1 << 10,
                                       "fanout_capacity": 1 << 19},
          "wide": {"wide": True}}[shape]

    def rows(out, tail):
        parts = []
        for b in (out, tail):
            if b is None:
                continue
            n = int(b.length)
            cols = []
            for c in b.column_names:
                a = b.column(c)
                v = a.values[:n]
                if v.dtype.is_floating_point:
                    v = v.view(torch.int32 if v.dtype == torch.float32
                               else torch.int64)
                v = v.to(torch.int64).cpu()
                if a.validity is not None:
                    ok = a.validity[:n].cpu()
                    v = torch.where(ok, v, 0) * 2 + ok
                cols.append(v)
            parts.append(torch.stack(cols, dim=1))
        m = torch.cat(parts).numpy()
        return m[np.lexsort(m.T[::-1])]

    res = []
    for dev in ("cpu", cuda_device):
        step, args = entry_join(dev, 1 << 12, 1 << 16, 5, join_type, **kw)
        _, got_impl = join_routed(step.join, args[0])
        want = impl
        if impl == "packed_u" and not step.join.supports_unique_fast():
            want = "packed"
        assert got_impl == want
        res.append(rows(*step(*args)))
    a, b = res
    assert a.shape == b.shape and (a == b).all()


def test_sorted_dense_route_on_card_matches_cpu(cuda_device):
    """``consume_routed`` on a key domain past the dense kernel's slots
    (the sorted dense reduction): integers exact, f32 sums within
    1e-5 * sum|v| + 1e-6."""
    from arrow_tpu_torch.core.batch import batch_from_numpy
    from arrow_tpu_torch.entry import AGGREGATES, consume_routed, \
        example_columns
    from arrow_tpu_torch.ops.hash_aggregate import HashAggregate
    cols = example_columns(200_000, 50_000, 3)
    outs = []
    for dev in ("cpu", cuda_device):
        b = batch_from_numpy(cols, device=dev)
        ha = HashAggregate(b.schema, ["k"], AGGREGATES, max_groups=1 << 16)
        vals = {k: v.cpu().numpy() for k, v in ha.probe_scalars(b).items()}
        kind, cfg = ha.probe_route(b, vals)
        assert kind == "dense" and cfg["impl"] == "sorted"
        out = ha.finalize(consume_routed(ha, ha.init_state(dev), b))
        n = int(out.length)
        outs.append({c: out.column(c).values[:n].cpu()
                     for c in out.column_names})
    c, g = outs
    for name in ("k", "v_min", "w_sum", "w_min", "count_all"):
        assert torch.equal(c[name], g[name]), name
    abs_sum = np.bincount(cols["k"], weights=np.abs(cols["v"]),
                          minlength=50_000)[c["k"].numpy()]
    d = (c["v_sum"].double() - g["v_sum"].double()).abs().numpy()
    assert (d <= 1e-5 * abs_sum + 1e-6).all()


@pytest.mark.parametrize("L", [1, 2, 3, 4, 5, 6, 16])
@pytest.mark.parametrize("n", [1, 1000, (1 << 20) + 3])
def test_pack_key_lanes_kernel_vs_plain(cuda_device, n, L):
    """Kernel against plain version: lanes as the strided columns of a
    matrix and as tensors of their own, windows across the 2^32 wrap, lanes
    outside their window, shifts of 32 and more, with and without the
    active flag."""
    g = torch.Generator(device=cuda_device).manual_seed(n + L)
    i64 = dict(generator=g, device=cuda_device, dtype=torch.int64)
    per = max(34 // L, 1)
    lo = torch.randint(0, 1 << 32, (L,), **i64)
    lo[0] = (1 << 32) - 3
    span = torch.full((L,), (1 << per) - 1, device=cuda_device,
                      dtype=torch.int64)
    shift = torch.arange(L - 1, -1, -1, device=cuda_device) * per
    mat = (lo[None, :] + torch.randint(0, (1 << per) + 2, (n, L), **i64)) \
        % (1 << 32)
    active = torch.rand(n, generator=g, device=cuda_device) < 0.8
    for lanes in (mat.unbind(1), [mat[:, j].contiguous() for j in range(L)]):
        for act in (None, active):
            before = ck.LAUNCHES["pack_key_lanes"]
            got = ck.pack_key_lanes(lanes, lo, span, shift, act)
            assert ck.LAUNCHES["pack_key_lanes"] == before + 1
            want = ck.pack_key_lanes_plain(lanes, lo, span, shift, act)
            assert torch.equal(got, want)
    assert bool((want == ck.PACK_MISS).any()) or n == 1
    with pytest.raises(ValueError, match="several devices"):
        ck.pack_key_lanes(list(mat.unbind(1)), lo.cpu(), span, shift)


def _table_rows(table, names):
    """A Table's rows on the host as an int64 matrix (floats by their bits,
    a null as 0 with a flag column), sorted: a multiset of rows."""
    parts = []
    for b in table.batches:
        n = int(b.length)
        cols = []
        for c in names:
            a = b.column(c)
            v = a.values[:n]
            if v.dtype.is_floating_point:
                v = v.view(torch.int32 if v.dtype == torch.float32
                           else torch.int64)
            cols.append(v.to(torch.int64).cpu())
            ok = torch.ones(n, dtype=torch.bool) if a.validity is None \
                else a.validity[:n].cpu()
            cols.append(ok.to(torch.int64))
        parts.append(torch.stack(cols, dim=1))
    m = torch.cat(parts).numpy() if parts else np.zeros((0, 2 * len(names)))
    return m[np.lexsort(m.T[::-1])]


def test_q3_plan_on_card_matches_cpu(cuda_device):
    """``entry_q3``'s Declaration on the card and on the CPU, multi-batch,
    with the group table doubling from 256: keys and order exact, float64
    revenue within 1e-12 * revenue + 1e-12 (a sum of positive terms)."""
    from arrow_tpu_torch.entry import entry_q3
    outs = []
    for dev in ("cpu", cuda_device):
        step, args = entry_q3(dev, 1 << 16, 7, 256, 1 << 13)
        t = step(*args)
        assert [b.device.type for b in t.batches] == [torch.device(dev).type]
        b = t.batches[0]
        n = int(b.length)
        outs.append({c: b.column(c).values[:n].cpu() for c in
                     ("l_orderkey", "o_date", "revenue")})
    c, g = outs
    assert c["l_orderkey"].shape[0] == 10
    assert torch.equal(c["l_orderkey"], g["l_orderkey"])
    assert torch.equal(c["o_date"], g["o_date"])
    d = (c["revenue"] - g["revenue"]).abs()
    assert bool((d <= 1e-12 * c["revenue"].abs() + 1e-12).all())


def test_bloom_join_plan_on_card_matches_cpu(cuda_device, monkeypatch):
    """Path 6b of ``chip_smoke.py`` at a small size: table_source ->
    filter -> hashjoin on two wide keys (the "sort" route), so the Bloom
    pushdown runs; the card's rows equal the CPU's as a multiset and the
    Bloom split launches the compaction kernel."""
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       HashJoinNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.compute.expressions import field, literal
    from arrow_tpu_torch.entry import example_columns_join, \
        table_from_numpy
    from arrow_tpu_torch.ops import join as join_mod
    built = []
    inner = join_mod.HashJoin.bloom_build
    monkeypatch.setattr(join_mod.HashJoin, "bloom_build",
                        lambda self, bs: built.append(1) or inner(self, bs))
    bcols, pcols = example_columns_join(1 << 12, 1 << 16, 2, wide=True)
    res = []
    for dev in ("cpu", cuda_device):
        probe = table_from_numpy(pcols, 1 << 14, dev)
        build = table_from_numpy(bcols, 1 << 14, dev)
        decl = Declaration("hashjoin", HashJoinNodeOptions(
            "inner", left_keys=["k", "k2"], right_keys=["k", "k2"],
            left_output=["k", "k2", "lv"], right_output=["rv"],
            max_build_rows=1 << 12), [
                Declaration.from_sequence([
                    Declaration("table_source",
                                TableSourceNodeOptions(probe)),
                    Declaration("filter", FilterNodeOptions(
                        field("lv") > literal(-1.0)))]),
                Declaration("table_source", TableSourceNodeOptions(build))])
        before = ck.LAUNCHES["filter_compact_chunks"]
        res.append(_table_rows(decl.to_table(), ["k", "k2", "lv", "rv"]))
        launched = ck.LAUNCHES["filter_compact_chunks"] - before
    assert len(built) == 2
    # the filter's 4 batches and the Bloom split's 4
    assert launched == 8
    a, b = res
    assert a.shape == b.shape and a.shape[0] > 0 and (a == b).all()


def test_filter_node_batch_launches_the_compaction_kernel(cuda_device):
    from arrow_tpu_torch.acero import (Declaration, FilterNodeOptions,
                                       TableSourceNodeOptions)
    from arrow_tpu_torch.compute.expressions import field, literal
    from arrow_tpu_torch.entry import example_columns_q3, table_from_numpy
    li, _, _ = example_columns_q3(5000, 1)
    t = table_from_numpy(li, 5000, cuda_device)
    decl = Declaration.from_sequence([
        Declaration("table_source", TableSourceNodeOptions(t)),
        Declaration("filter", FilterNodeOptions(
            field("l_ship") > literal(40)))])
    before = ck.LAUNCHES["filter_compact_chunks"]
    out = decl.to_table()
    assert ck.LAUNCHES["filter_compact_chunks"] == before + 1
    assert out.num_rows == int((li["l_ship"] > 40).sum())


@pytest.mark.parametrize("null_placement", ["at_end", "at_start"])
def test_dist_sort_null_primary_on_card_matches_cpu(cuda_device,
                                                   null_placement):
    """``DistContext.sort_by`` over 4 logical shards of the card, a
    primary key with 20 % nulls (ROADMAP C18): the same rows on the same
    shards as on the CPU, the null rows all on the last shard (at the end)
    or the first (at the start), and the order numpy's stable lexsort
    gives."""
    from arrow_tpu_torch.core.array import array_from_numpy
    from arrow_tpu_torch.core.batch import batch
    from arrow_tpu_torch.parallel import DistContext
    rng = np.random.default_rng(5)
    n = 50_000
    a = rng.integers(-1000, 1000, n)
    ok = rng.random(n) >= 0.2
    b = rng.standard_normal(n)
    tables = []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = DistContext(devices=[dev] * 4)
        tb = batch({"a": array_from_numpy(a, validity=ok, device=dev),
                    "b": array_from_numpy(b, device=dev)})
        tables.append(ctx.sort_by(tb, [("a", "ascending"),
                                       ("b", "descending")],
                                  null_placement=null_placement))
    got, want = tables
    assert [len(x) for x in got.batches] == [len(x) for x in want.batches]
    for gb, wb in zip(got.batches, want.batches):
        _assert_same_columns(_host_columns(gb), _host_columns(wb))
    nulls = [int((~x.column("a").validity[:len(x)]).sum())
             for x in got.batches]
    held = nulls[-1] if null_placement == "at_end" else nulls[0]
    assert held == int((~ok).sum()) == sum(nulls)
    last = (~ok) if null_placement == "at_end" else ok
    perm = np.lexsort((-b, np.where(ok, a, 0), last))
    rows = np.concatenate([_host_columns(x)["b"][0] for x in got.batches])
    np.testing.assert_array_equal(rows, b[perm])


def test_dist_join_two_shards_on_card_matches_cpu(cuda_device):
    """``DistContext.join`` (full outer, duplicate build keys) and the
    streaming ``DistHashJoin`` (inner) over 2 logical shards of the card:
    the same rows on the same shards as on the CPU; every shuffle launches
    the partition-histogram kernel on the card."""
    from arrow_tpu_torch.acero.options import HashJoinNodeOptions
    from arrow_tpu_torch.core.batch import Table, batch_from_numpy
    from arrow_tpu_torch.parallel import DistContext, DistHashJoin
    rng = np.random.default_rng(9)
    left = {"k": rng.integers(0, 3000, 20_000), "lv": rng.random(20_000)}
    right = {"k": rng.integers(0, 3000, 4000),
             "rv": rng.integers(0, 1 << 40, 4000)}
    names = ["k", "lv", "k_r", "rv"]
    opts = HashJoinNodeOptions("full outer", ["k"], ["k"],
                               max_build_rows=1 << 12,
                               output_suffix_for_right="_r")
    res, launched = [], []
    for dev in (cuda_device, torch.device("cpu")):
        ctx = DistContext(devices=[dev] * 2)
        lb = batch_from_numpy(left, device=dev)
        rb = batch_from_numpy(right, device=dev)
        before = ck.LAUNCHES["partition_histogram"]
        one_shot = ctx.join(lb, rb, opts, fanout_per_shard=1 << 16)
        dhj = DistHashJoin(ctx, lb.schema, rb.schema, HashJoinNodeOptions(
            "inner", ["k"], ["k"], max_build_rows=1 << 12,
            output_suffix_for_right="_r"), fanout_per_shard=1 << 16)
        ps = dhj.finish_build(dhj.consume_build(dhj.init_build(), rb))
        outs, ps = dhj.probe(ps, lb)
        outs += dhj.finish(ps)
        launched.append(ck.LAUNCHES["partition_histogram"] - before)
        res.append([[_table_rows(Table(one_shot.schema, [x]), names)
                     for x in one_shot.batches],
                    [_table_rows(Table(outs[0].schema, [x]), names)
                     for x in outs]])
    (g1, g2), (w1, w2) = res
    # four shuffles over two shards on the card; none on the CPU
    assert launched == [8, 0]
    for got, want in ((g1, w1), (g2, w2)):
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.shape[0] > 0 and (a == b).all()
