"""The nested layouts and their functions on the card against the same
calls on the CPU: every entry of the A7c sweep (``entry.A7C_SWEEP``: the
19 functions, take / filter / concat of each nested layout,
``hash_list`` and ``hash_pivot_wider`` through ``Table.group_by``, the
pivot_longer node, the sparse tensors' to_dense / mv / mm) at a small size,
and the word count, the order baskets and the run-end encoding of
l_orderkey at SF 0.01 on the card against pyarrow and numpy.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a7c_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch import entry as E

pytestmark = pytest.mark.cuda

N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _columns(device):
    from arrow_tpu_torch.utils.tpch import tpch_table
    comments = tpch_table("orders", 0.01, 42, columns=["o_comment"])[
        "o_comment"].slice(0, N).combine_chunks()
    return E.a7c_sweep_columns(N, 42, comments, device=device)


@pytest.mark.parametrize("entry", E.A7C_SWEEP, ids=[e[0] for e in
                                                     E.A7C_SWEEP])
def test_a7c_sweep_card_equals_cpu(cuda_device, entry):
    label, _, tol, fn = entry
    cols, cols_cpu = _columns(cuda_device), _columns("cpu")
    got, want = fn(cols), fn(cols_cpu)
    if tol == "random":
        assert torch.equal(got.values, fn(cols).values)
        assert bool(((got.values >= 0) & (got.values < 1)).all())
    elif tol == "product":
        scale = E.a7c_product_scale(label, cols_cpu)
        assert np.all(np.abs(got.cpu().numpy() - want.numpy())
                      <= 1e-12 * scale)
    else:
        assert E.nested_parts(got) == E.nested_parts(want)


def test_paths_on_the_card(cuda_device):
    step, args = E.entry_wordcount(cuda_device, 0.01)
    assert step(*args).to_pyarrow().equals(E.wordcount_pyarrow(step.source))
    step, args = E.entry_baskets(cuda_device, 0.01)
    assert E.baskets_differ(E.baskets_arrays(step(*args)),
                            E.baskets_numpy(step.source)) == []
    step, args = E.entry_ree_keys(cuda_device, 0.01, max_batch_rows=1 << 14)
    for (enc, dec), b in zip(step(*args), args[0].batches):
        col = b.column("l_orderkey")
        n = len(col)
        assert torch.equal(dec.values[:n], col.values[:n])
        assert np.array_equal(enc.offsets[1:len(enc) + 1].cpu().numpy(),
                              E.ree_runs_numpy(col.values[:n].cpu().numpy()))
