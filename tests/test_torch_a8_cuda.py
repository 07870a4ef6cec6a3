"""The distributed operators across processes and the coalesced join keys
on the card (ROADMAP A8, C34), on tensors only (the card's machine may lack
pyarrow's export):

* ``Table.join`` of every join type and key kind (int64, a string, a
  dictionary, two keys; null keys) on the card against the same join on
  the CPU, rows as multisets, exact;
* every case of ``entry.DIST_CASES`` over 2 processes x 4 logical shards
  of the card on gloo (the card's tensors through pinned host buffers),
  and over one process x 8 shards with a one-rank NCCL group, against the
  single-controller port over 8 logical shards of the card: integers,
  validity, dictionaries and row order exact, floats within 1e-12 of
  their magnitude + 1e-10 (the card's float sums may differ from run to
  run: ROADMAP C5);
* NCCL with two ranks on one card: the processes fail, and the test prints
  what NCCL said.

Marked ``cuda``; every test takes the ``cuda_device`` fixture, which skips
it where there is no CUDA device. Run on a machine with a card:

    python -m pytest tests/test_torch_a8_cuda.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from arrow_tpu_torch.core.array import array_from_numpy, \
    dictionary_from_numpy, varlen_from_numpy
from arrow_tpu_torch.core.batch import Table, batch_from_numpy
from arrow_tpu_torch.entry import (DIST_CASES, dist_case_tables,
                                   launch_dist_workers, table_host_arrays)
from arrow_tpu_torch.parallel import DistContext

pytestmark = pytest.mark.cuda

JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "right semi", "left anti", "right anti"]
KEY_KINDS = ["int64", "string", "dictionary", "two_keys"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda:0")


def _side(kind, n, payload, seed, device):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 16, n)
    valid = rng.random(n) >= 1 / 7
    words = np.array([f"key{int(i):02d}" + "x" * int(i % 5) for i in ints])
    if kind == "int64":
        k = array_from_numpy(ints, validity=valid, device=device)
    elif kind == "string":
        k = varlen_from_numpy(words, validity=valid, device=device)
    else:
        vocab = np.unique(words)
        k = dictionary_from_numpy(np.searchsorted(vocab, words), vocab,
                                  validity=valid, device=device)
    cols = {"k": k if kind != "two_keys" else
            array_from_numpy(ints, validity=valid, device=device)}
    if kind == "two_keys":
        cols["j"] = array_from_numpy(rng.integers(0, 3, n),
                                     validity=rng.random(n) >= 0.1,
                                     device=device)
    cols[payload] = rng.integers(0, 1000, n)
    b = batch_from_numpy(cols, device=device)
    return Table(b.schema, [b])


def _rows(t: Table) -> list:
    """The Table's rows as tuples of host values (strings decoded, a
    dictionary's values by code, None for a null), sorted."""
    cols = []
    for i in range(t.num_columns):
        col = []
        for b in t.batches:
            a, n = b.arrays[i], int(b.length)
            ok = a.validity_or_true()[:n].cpu().tolist()
            if a.offsets is not None:
                off = a.offsets[:n + 1].cpu().tolist()
                pool = bytes(a.values[:off[-1]].cpu().tolist())
                vals = [pool[off[r]:off[r + 1]] for r in range(n)]
            elif a.dictionary is not None:
                d = a.dictionary
                dn = int(d.length)
                off = d.offsets[:dn + 1].cpu().tolist()
                pool = bytes(d.values[:off[-1]].cpu().tolist())
                vals = [pool[off[c]:off[c + 1]] if 0 <= c < dn else None
                        for c in a.values[:n].cpu().tolist()]
            else:
                vals = a.values[:n].cpu().tolist()
            col += [v if o else None for v, o in zip(vals, ok)]
        cols.append(col)
    return sorted(zip(*cols), key=repr)


@pytest.mark.parametrize("kind", KEY_KINDS)
@pytest.mark.parametrize("join_type", JOIN_TYPES)
def test_join_coalesced_keys_on_card(cuda_device, kind, join_type):
    keys = ["k", "j"] if kind == "two_keys" else ["k"]
    outs = []
    for device in (cuda_device, torch.device("cpu")):
        left = _side(kind, 40, "a", 3, device)
        right = _side(kind, 24, "b", 4, device)
        outs.append(left.join(right, keys, join_type=join_type,
                              max_build_rows=64))
    got, want = outs
    assert got.column_names == want.column_names
    assert _rows(got) == _rows(want)


def _assert_close_arrays(got: dict, want: dict, label: str) -> None:
    assert sorted(got) == sorted(want), label
    for k in want:
        a, b = got[k], want[k]
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k)
        if a.dtype.kind == "f":
            assert np.all(np.abs(a - b) <= 1e-12 * np.abs(b) + 1e-10), \
                (label, k)
        else:
            assert np.array_equal(a, b), (label, k)


@pytest.fixture(scope="module")
def card_reference():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    ctx = DistContext(devices=[torch.device("cuda:0")] * 8)
    return table_host_arrays(dist_case_tables(ctx))


def test_two_gloo_processes_on_card(cuda_device, card_reference):
    got, _ = launch_dist_workers(2, [cuda_device] * 4, "gloo", DIST_CASES,
                                 timeout=400)
    for rank, arrays in enumerate(got):
        assert not bool(arrays.pop("imported_jax"))
        _assert_close_arrays(arrays, card_reference, f"rank {rank}")


def test_one_rank_nccl_group_on_card(cuda_device, card_reference):
    got, _ = launch_dist_workers(1, [cuda_device] * 8, "nccl", DIST_CASES,
                                 timeout=400)
    arrays = got[0]
    assert not bool(arrays.pop("imported_jax"))
    _assert_close_arrays(arrays, card_reference, "nccl")


def test_nccl_two_ranks_on_one_card_fail(cuda_device):
    """NCCL refuses two ranks on one card: both processes fail (within
    the launcher's time limit), and the message is printed for the
    record."""
    with pytest.raises(RuntimeError) as err:
        launch_dist_workers(2, [cuda_device] * 4, "nccl", ["group_by"],
                            timeout=180)
    text = str(err.value)
    print(text[-3000:])
    assert "failed" in text


_NCCL_TYPES = r"""
import datetime, sys, torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + sys.argv[1],
                        world_size=1, rank=0,
                        timeout=datetime.timedelta(seconds=60))
for name in ("bool", "uint8", "int16", "uint16", "int32", "uint32", "int64",
             "uint64", "float32", "float64"):
    x = torch.arange(8, dtype=torch.uint8, device="cuda").repeat(8)
    x = x.view(getattr(torch, name)) if name != "bool" else x.bool()
    y = torch.empty_like(x)
    try:
        dist.all_to_all_single(y, x)
        torch.cuda.synchronize()
        same = torch.equal(y.view(torch.uint8).cpu(), x.view(torch.uint8).cpu())
        print("NCCL", name, "taken" if same else "wrong bytes")
    except Exception as e:
        print("NCCL", name, "refused:", type(e).__name__,
              str(e).splitlines()[0][:160])
dist.destroy_process_group()
"""


def test_nccl_element_types_on_card(cuda_device):
    """Which element types NCCL's ``all_to_all_single`` takes (printed for
    the record; the exchange sends every leaf as bytes either way): each
    type is either taken with its bytes intact or refused."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    out = subprocess.run([sys.executable, "-c", _NCCL_TYPES, port],
                         capture_output=True, text=True, timeout=120)
    print(out.stdout)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("NCCL ")]
    assert out.returncode == 0 and len(lines) == 10, out.stderr[-3000:]
    assert not any("wrong bytes" in ln for ln in lines), lines
