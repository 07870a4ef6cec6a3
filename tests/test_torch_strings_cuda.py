"""String columns on the card against the same calls on the CPU (where the
kernel wrappers take their plain versions): path 8's filter (the row
compaction and the pool's second launch), the varlen take, the per-byte
selection, the fingerprints' mod-2^64 running sum, and the string sweep:
each of the string family's 71 functions (``entry.STRING_SWEEP``) at a
small size, its result on the card byte for byte its result on the CPU.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_strings_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.core import datatype as dt
from arrow_tpu_torch.core.array import Array, array_from_numpy, \
    varlen_from_numpy
from arrow_tpu_torch.core.batch import batch
from arrow_tpu_torch.entry import STRING_SWEEP, numbered_strings, \
    sweep_call, sweep_column
from arrow_tpu_torch.ops import cuda_kernels as ck
from arrow_tpu_torch.ops import hashing, selection

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _names(n, seed, device, ragged=False):
    """Path 8's ``Customer#%09d`` strings (or, ``ragged``, the same with
    0-7 bytes cut off each), float64 ``v``, int64 ``w``."""
    rng = np.random.default_rng(seed)
    off, pool = numbered_strings(b"Customer#", rng.integers(1, 10**6, n), 9)
    if ragged:
        lens = 18 - rng.integers(0, 8, n)
        pool = pool.reshape(n, 18)[np.arange(18)[None, :] < lens[:, None]]
        off = np.concatenate([[0], np.cumsum(lens)])
    return batch({"name": varlen_from_numpy(offsets=off, pool=pool,
                                            device=device),
                  "v": array_from_numpy(rng.standard_normal(n),
                                        device=device),
                  "w": array_from_numpy(rng.integers(-100, 100, n),
                                        device=device)})


def _assert_same(got, want):
    n = int(want.length)
    assert int(got.length) == n
    off = want.offsets[:n + 1].cpu()
    assert torch.equal(got.offsets[:n + 1].cpu(), off)
    assert torch.equal(got.values[:int(off[-1])].cpu(),
                       want.values[:int(off[-1])].cpu())


@pytest.mark.parametrize("ragged", [False, True], ids=["c_name", "ragged"])
def test_varlen_filter_on_card_vs_plain(cuda_device, ragged):
    """``w > 0`` over path 8's columns: two B1 launches on the card (the
    rows, the pool); the same rows and bytes as the plain versions on the
    CPU."""
    n = 1 << 20
    b = _names(n, 1, cuda_device, ragged)
    mask = Array(dt.bool_, b.column("w").values > 0, None, length=n)
    before = ck.LAUNCHES["filter_compact_chunks"]
    got = selection.filter_batch(b, mask)
    torch.cuda.synchronize()
    assert ck.LAUNCHES["filter_compact_chunks"] - before == 2
    want = selection.filter_batch(b.to("cpu"), mask.to("cpu"))
    _assert_same(got.column("name"), want.column("name"))
    for c in ("v", "w"):
        k = int(want.length)
        assert torch.equal(got.column(c).values[:k].cpu(),
                           want.column(c).values[:k])


def test_varlen_take_on_card_vs_plain(cuda_device):
    """The varlen take (its gather from ``rows_of_positions``) with
    repeated and null indices, a pool past the input's."""
    n = 1 << 20
    b = _names(n, 2, cuda_device, ragged=True)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    idx = torch.randint(0, n, (2 * n,), generator=g, device=cuda_device)
    valid = torch.rand(2 * n, generator=g, device=cuda_device) > 0.1
    indices = Array(dt.int64, idx, valid, length=2 * n - 5)
    got = selection.take_array(b.column("name"), indices)
    want = selection.take_array(b.column("name").to("cpu"),
                                indices.to("cpu"))
    _assert_same(got, want)


def test_byte_selection_on_card_vs_cpu(cuda_device):
    n = 1 << 20
    b = _names(n, 3, cuda_device, ragged=True)
    a = b.column("name")
    sel = b.column("w").values > 0
    bcap = a.values.shape[0] + 100
    got = selection._byte_selection(a.offsets, sel, bcap)
    want = selection._byte_selection(a.offsets.cpu(), sel.cpu(), bcap)
    assert torch.equal(got.cpu(), want)


def test_fingerprints_on_card_vs_cpu(cuda_device, monkeypatch):
    """The exact fingerprints' int64 running sum wraps mod 2^64 alike on
    the card (in several steps) and on the CPU; the content lanes too."""
    monkeypatch.setattr(hashing, "_FP_CHUNK", 1 << 16)
    monkeypatch.setattr(hashing, "_CHUNK_POWERS", {})
    b = _names(1 << 18, 4, cuda_device, ragged=True)
    a = b.column("name")
    for mult in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F):
        got = hashing.string_fingerprint_exact(a, mult)
        want = hashing.string_fingerprint_exact(a.to("cpu"), mult)
        assert torch.equal(got.cpu(), want)
    for g, w in zip(hashing.varlen_content_lanes(a),
                    hashing.varlen_content_lanes(a.to("cpu"))):
        assert torch.equal(g.cpu(), w)


def _text(n, seed):
    """n rows of 0-9 words of TPC-H pseudotext and Q13's, space-joined."""
    rng = np.random.default_rng(seed)
    words = np.array(["special", "requests", "about", "blithely", "foxes",
                      "x", "hello", "world", "ab", "", "dolphins", "Xx"])
    k = rng.integers(0, 10, n)
    return [" ".join(words[rng.integers(0, len(words), j)]) for j in k]


def _assert_array_same(got, want):
    """Any Array: length, capacities, validity, the offsets and used bytes
    of a varlen column, the valid rows' values of a fixed-width one."""
    n = int(want.length)
    assert int(got.length) == n and got.capacity == want.capacity
    ok = torch.ones(n, dtype=torch.bool) if want.validity is None \
        else want.validity[:n]
    gv = torch.ones(n, dtype=torch.bool) if got.validity is None \
        else got.validity[:n].cpu()
    assert torch.equal(gv, ok)
    if want.offsets is not None:
        assert got.values.shape[0] == want.values.shape[0]
        _assert_same(got, want)
    else:
        assert torch.equal(got.values[:n].cpu()[ok], want.values[:n][ok])


@pytest.mark.parametrize("name,extra,kw", STRING_SWEEP,
                         ids=[f for f, _, _ in STRING_SWEEP])
def test_string_sweep_on_card_vs_cpu(cuda_device, name, extra, kw):
    col = sweep_column(_text(4096, 5), device=cuda_device)
    got = sweep_call(name, extra, kw, col)
    torch.cuda.synchronize()
    _assert_array_same(got, sweep_call(name, extra, kw, col.to("cpu")))
