"""The casts, temporal functions, checked arithmetic, vector_misc and set
lookup on the card against the same calls on the CPU: every entry of the
A7b sweep (``entry.A7B_SWEEP``: the 83 functions and every pair of types
``cast`` dispatches) at a small size, float -> integer saturation on the
card (XLA's answer, where CUDA's own conversion differs), a checked call
that wraps raising on the card, and TPC-H Q12 and Q7 at SF 0.01 on the
card against pyarrow.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a7b_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch import entry as E
from arrow_tpu_torch.compute import call_function
from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.array import array_from_numpy
from arrow_tpu_torch.utils.errors import ArrowInvalid

pytestmark = pytest.mark.cuda

N = 4096


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _columns(device):
    rng = np.random.default_rng(3)
    return E.a7b_sweep_columns(N, 42, rng.integers(8000, 10500, N),
                               rng.integers(0, 7, N), device=device)


def _parts(a):
    """An Array (or Batch) as host bytes: length, validity, offsets and
    bytes, children, or valid fixed-width values."""
    if hasattr(a, "arrays"):
        return [p for c in a.arrays for p in _parts(c)]
    if a.children:
        return [p for c in a.children
                for p in _parts(c.with_validity(a.validity))]
    n = int(a.length)
    ok = a.validity_or_true()[:n].cpu()
    out = [n, ok.numpy().tobytes()]
    if a.offsets is not None:
        off = a.offsets[:n + 1].cpu()
        return out + [off.numpy().tobytes(),
                      a.values[:int(off[-1])].cpu().numpy().tobytes()]
    return out + [str(a.type), a.values[:n].cpu()[ok].numpy().tobytes()]


@pytest.mark.parametrize("entry", E.A7B_SWEEP, ids=[e[0] for e in
                                                     E.A7B_SWEEP])
def test_a7b_sweep_card_equals_cpu(cuda_device, entry):
    got = E.a7b_sweep_call(entry, _columns(cuda_device))
    want = E.a7b_sweep_call(entry, _columns("cpu"))
    tol = entry[4]
    if tol is None and getattr(want, "offsets", 1) is None and \
            not want.children and want.values.dtype.is_floating_point:
        tol = ("ulps", 0)   # a NaN's bits: the card's is canonical
    if tol is None:
        assert _parts(got) == _parts(want)
        return
    n = int(want.length)
    ok = want.validity_or_true()[:n].cpu().numpy()
    g = got.values[:n].cpu().numpy()[ok].astype(np.float64)
    w = want.values[:n].cpu().numpy()[ok].astype(np.float64)
    if tol[0] == "ulps":
        mag = np.maximum(np.abs(g), np.abs(w)).astype(
            want.values.cpu().numpy().dtype)
        bound = tol[1] * np.spacing(mag).astype(np.float64)
    else:
        x = _columns("cpu")[entry[2][0]]
        bound = tol[1] * np.cumsum(np.nan_to_num(np.abs(
            x.values.numpy().astype(np.float64)) *
            x.validity_or_true().numpy()))[:n][ok] + 1e-6
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    assert np.all(same | (np.abs(g - w) <= bound))


def test_float_to_int_saturates_on_the_card(cuda_device):
    v = np.array([np.nan, np.inf, -np.inf, 3e10, -2.9, -0.5])
    a = array_from_numpy(v, device=cuda_device)
    got = call_function("cast", [a], target_type=dt.int32)
    assert got.values.cpu().tolist() == [0, 2147483647, -2147483648,
                                         2147483647, -2, 0]
    got = call_function("cast", [a], target_type=dt.uint8)
    assert got.values.cpu().tolist() == [0, 255, 0, 255, 0, 0]


def test_checked_wrap_raises_on_the_card(cuda_device):
    a = array_from_numpy(np.array([1, (1 << 63) - 1]), device=cuda_device)
    with pytest.raises(ArrowInvalid, match="overflow"):
        call_function("add_checked", [a, a])


@pytest.mark.parametrize("make,oracle", [(E.entry_q12, E.q12_pyarrow),
                                         (E.entry_q7, E.q7_pyarrow)])
def test_q12_q7_on_the_card(cuda_device, make, oracle):
    step, args = make(cuda_device, 0.01)
    got = step(*args).to_pydict()
    want = oracle(step.source).to_pydict()
    if "revenue" in want:
        g, w = np.array(got.pop("revenue")), np.array(want.pop("revenue"))
        assert np.all(np.abs(g - w) <= 1e-12 * np.abs(w))
    assert got == want
