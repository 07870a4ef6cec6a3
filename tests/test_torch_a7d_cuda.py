"""The ordered plan nodes, the wider column types and the C31 / C32 repairs
on the card against the same calls on the CPU, on tensors only (the card's
machine may lack pyarrow's export): the string take past its pool, the
dense kernel's NaN-skipping min / max, and the paths of
``chip_smoke.py`` (``entry_sorted_merge``, ``entry_asof`` past and future,
``entry_tpch_gen_q1``, ``entry_decimal_q1``) at a small size. Exact,
except Q1's float sums (1e-12 of the sums of |x|).

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a7d_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch import entry as E

pytestmark = pytest.mark.cuda

SF = 0.01


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _columns(table) -> dict:
    """name -> (values, validity) over a Table's batches, on the host."""
    out = {}
    for name in table.column_names:
        vals, valid = [], []
        for b in table.batches:
            a = b.column(name)
            n = int(b.length)
            v = a.values[:n] if a.offsets is None else \
                a.values[:int(a.offsets[n])]
            vals.append(v.cpu().numpy())
            valid.append(a.validity_or_true()[:n].cpu().numpy())
        out[name] = (np.concatenate(vals), np.concatenate(valid))
    return out


def _assert_same_tables(got, want, rtol=0.0, scale=None):
    g, w = _columns(got), _columns(want)
    assert g.keys() == w.keys()
    for name in g:
        (gv, gok), (wv, wok) = g[name], w[name]
        np.testing.assert_array_equal(gok, wok, err_msg=name)
        if rtol and gv.dtype.kind == "f":
            s = scale if scale is not None else np.abs(wv)
            assert np.all(np.abs(gv - wv)[wok] <= (rtol * s + 1e-12)[wok]), \
                name
        else:
            np.testing.assert_array_equal(gv[gok], wv[wok], err_msg=name)


def test_string_take_past_its_pool(cuda_device):
    from arrow_tpu_torch.core.array import array_from_numpy
    from arrow_tpu_torch.ops.selection import take_array
    words = np.array([b"x" * 40, b"a"])
    idx = np.array([0, 0, 0, 0, 1])
    out = []
    for dev in (cuda_device, "cpu"):
        got = take_array(array_from_numpy(words, device=dev),
                         array_from_numpy(idx, device=dev))
        out.append((got.offsets[:6].cpu(), got.values[:161].cpu()))
    a, b = out
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(a[0][-1]) == 161


def test_dense_kernel_min_max_skip_nan(cuda_device):
    from arrow_tpu_torch.ops import cuda_kernels as ck
    gen = torch.Generator().manual_seed(3)
    n = 1 << 16
    gid = torch.randint(-1, 140, (n,), generator=gen, dtype=torch.int32)
    x = torch.randn(n, generator=gen)
    x[gid == 3] = float("nan")                          # NaN alone
    x[(gid == 7) & (torch.rand(n, generator=gen) < 0.5)] = float("nan")
    kinds = ("min", "max", "sum")
    rows, outs = ck.dense_group_reduce(gid.to(cuda_device),
                                       tuple(x.to(cuda_device)
                                             for _ in kinds), kinds, 128)
    prows, pouts = ck.dense_group_reduce_plain(gid, (x, x, x), kinds, 128)
    assert torch.equal(rows.cpu(), prows)
    for a, b in zip(outs[:2], pouts[:2]):
        a = a.cpu()
        assert bool(((a == b) | (a.isnan() & b.isnan())).all())
    assert bool(outs[0][3].isnan()) and not bool(outs[0][7].isnan())


def test_sorted_merge_on_the_card(cuda_device):
    got_step, got_args = E.entry_sorted_merge(cuda_device, SF, 42,
                                              max_batch_rows=1 << 13)
    cpu_step, cpu_args = E.entry_sorted_merge("cpu", SF, 42,
                                              max_batch_rows=1 << 13)
    got = got_step(*got_args)
    assert not E.sorted_merge_differ(got, got_step.source)
    _assert_same_tables(got, cpu_step(*cpu_args))


@pytest.mark.parametrize("tol", [-1_000_000_000, 1_000_000_000, -3, 2])
def test_asof_on_the_card(cuda_device, tol):
    step, args = E.entry_asof(cuda_device, 1 << 16, 1 << 14, 0, tol,
                              max_batch_rows=1 << 13)
    got = step(*args)
    quotes, trades = step.columns
    assert not E.asof_differ(got, quotes, E.asof_numpy(quotes, trades, tol))
    cstep, cargs = E.entry_asof("cpu", 1 << 16, 1 << 14, 0, tol,
                                max_batch_rows=1 << 13)
    _assert_same_tables(got, cstep(*cargs))


def test_tpch_gen_q1_on_the_card(cuda_device):
    from arrow_tpu_torch.utils.tpch import tpch_table
    step, args = E.entry_tpch_gen_q1(cuda_device, SF, 42, 1 << 14)
    got = step(*args)
    cstep, cargs = E.entry_tpch_gen_q1("cpu", SF, 42, 1 << 14)
    want = cstep(*cargs)
    oracle = E.q1_numpy(tpch_table("lineitem", SF, 42,
                                   columns=E.Q1_COLUMNS))
    scale = np.concatenate(list(oracle["abs"].values()))
    assert scale.size
    _assert_same_tables(got, want, rtol=1e-12,
                        scale=np.max(scale) * np.ones(len(oracle[
                            "count_order"])))


def test_decimal_q1_on_the_card(cuda_device):
    step, args = E.entry_decimal_q1(cuda_device, SF, 42, 1 << 13)
    got = step(*args)
    assert not E.decimal_q1_differ(got, E.decimal_q1_numpy(step.cents,
                                                           step.source))
    cstep, cargs = E.entry_decimal_q1("cpu", SF, 42, 1 << 13)
    for g, w in zip(got, cstep(*cargs)):
        _assert_same_tables(g, w)
