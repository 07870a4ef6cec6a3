"""Spill to disk: the external sort and the Grace join's partitions.

The counterpart of the JAX package's ``acero/spill.py``. The reference
acknowledges its own spill gap (``acero/aggregate_internal.h:297-302``:
"spilling is not yet implemented"); the engine goes past it for the two
breakers where device memory bites first:

  * ``order_by`` (``SpillSorter``): once the accumulated device bytes pass
    the budget, each batch is sorted on the device with a trailing
    ``__seq`` column (its rows' arrival positions) and written as a sorted
    RUN to an ATB file (``native.py``); ``finish`` streams the runs back in
    morsels through the bounded-memory k-way ``streaming_sorted_merge``
    (``acero/nodes.py``) with ``__seq`` as the last key, so the output's
    tie order is the in-memory sort's exactly;
  * ``hashjoin`` (``GracePartitioner``): both sides hash-partition by join
    key into K groups of ATB files, and the join runs partition by
    partition (``HashJoinNode._batches_grace``).

Moving data: a batch leaves the device as one copy of each buffer's live
prefix into pinned host memory (the length and each string pool's used
bytes come in ONE host read first), and comes back in morsels of
``pad_capacity`` rows (the JAX package's capacities, so the merge sees the
same shapes) staged from pinned buffers. The Grace split orders a batch's
rows by partition on the device with the exchange's two kernels (B4's
``partition_histogram_segments`` and ``partition_positions``, stable), then
makes one gather a column and one host copy, and writes K contiguous
slices: each partition file holds its rows in arrival order, as the JAX
package's K boolean masks give them.

Budget: the options' ``spill_bytes`` if set, else the
``ARROW_TPU_SPILL_BYTES`` environment variable, else unbounded (no spill).

Column layouts that spill: fixed-width (numeric, bool, temporal, decimal
storage) and varlen (string, binary), with validity. Nested, dictionary,
run-end encoded and fixed-size binary columns do not (as in the JAX
package): a plan over them runs in memory.

``STATS`` counts what the spills of this process did (runs and partition
files written, bytes to and from disk, seconds writing and merging, the
last Grace join's rows a partition by side); ``reset_stats`` clears it.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, value_row_shape
from ..core.batch import Batch
from ..core.interop import pad_capacity
from ..core.schema import Field, Schema
from ..ops.cuda_kernels import (partition_histogram_segments,
                                partition_positions)

__all__ = ["spill_budget_bytes", "spill_supported", "batch_device_bytes",
           "SpillSorter", "GracePartitioner", "write_run", "read_run",
           "write_run_masked", "partition_order", "STATS", "reset_stats"]

STATS: Dict[str, object] = {}


def reset_stats() -> None:
    STATS.clear()
    STATS.update(runs=0, run_rows=0, partition_files=0, bytes_written=0,
                 bytes_read=0, write_s=0.0, merge_s=0.0, last_dir=None,
                 partition_rows={})


reset_stats()


def spill_budget_bytes(options=None) -> Optional[int]:
    """The device-byte budget: ``options.spill_bytes``, else the
    ``ARROW_TPU_SPILL_BYTES`` environment variable, else None
    (unbounded)."""
    v = getattr(options, "spill_bytes", None)
    if v is not None:
        return int(v)
    env = os.environ.get("ARROW_TPU_SPILL_BYTES")
    return int(env) if env else None


def spill_supported(schema: Schema) -> bool:
    """Whether every column's layout can go to an ATB file."""
    for f in schema.fields:
        t = f.type
        if isinstance(t, dt.DictionaryType):
            return False
        if t.is_varlen:
            continue
        if t.is_nested or isinstance(t, (dt.RunEndEncodedType,
                                         dt.FixedSizeBinaryType,
                                         dt.NullType)):
            return False
    return True


def batch_device_bytes(b: Batch) -> int:
    """Bytes of a batch's buffers."""
    total = 0
    for a in b.arrays:
        total += a.values.nbytes
        if a.validity is not None:
            total += a.validity.nbytes
        if a.offsets is not None:
            total += a.offsets.nbytes
    return total


# ---- device <-> host ------------------------------------------------------------

def _pinned_empty(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host buffer, page-locked where the batch lives on a card (so its
    copies run as DMA, asynchronously)."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _to_host(t: torch.Tensor, pinned: bool) -> torch.Tensor:
    """One copy of ``t`` into (pinned) host memory; the caller
    synchronises once after all of a batch's copies."""
    if not pinned:
        return t.cpu()
    out = _pinned_empty(t.shape, t.dtype, t.device)
    out.copy_(t, non_blocking=True)
    return out


def host_columns(b: Batch, n: int, used: List[int]) -> List[dict]:
    """The live prefix of each of ``b``'s columns on the host: ``n`` rows
    (its host length) and, for each varlen column in order, ``used`` pool
    bytes. Each buffer is ONE copy into pinned host memory; one
    synchronise at the end. Returns per column {"data", "validity"?,
    "offsets"?} numpy arrays (``data`` flat: a multi-lane storage's lanes
    row after row)."""
    pinned = b.device.type == "cuda"
    used_it = iter(used)
    staged = []
    for a in b.arrays:
        col = {}
        if a.type.is_varlen:
            u = next(used_it)
            col["offsets"] = _to_host(a.offsets[:n + 1], pinned)
            col["data"] = _to_host(a.values[:u], pinned)
        else:
            col["data"] = _to_host(a.values[:n].reshape(-1), pinned)
        if a.validity is not None:
            col["validity"] = _to_host(a.validity[:n], pinned)
        staged.append(col)
    if pinned:
        torch.cuda.current_stream(b.device).synchronize()
    return [{k: v.numpy() for k, v in col.items()} for col in staged]


def _atb_columns(b: Batch, cols: List[dict], lo: int, hi: int) -> dict:
    """Rows [lo, hi) of ``host_columns``' output as ``write_atb``'s
    columns (a varlen slice rebased to offset 0)."""
    out = {}
    for name, a, c in zip(b.schema.names, b.arrays, cols):
        col = {}
        if "offsets" in c:
            off = c["offsets"][lo:hi + 1]
            base = int(off[0])
            col["offsets"] = off - base
            col["data"] = c["data"][base:int(off[-1])]
        else:
            k = int(np.prod(value_row_shape(a.type), dtype=np.int64))
            col["data"] = c["data"][lo * k:hi * k]
        if "validity" in c:
            col["validity"] = c["validity"][lo:hi]
        out[name] = col
    return out


def _write(path: str, columns: dict, n: int) -> int:
    from .. import native
    t0 = time.perf_counter()
    size = native.write_atb(path, columns, n)
    STATS["bytes_written"] += size
    STATS["write_s"] += time.perf_counter() - t0
    return size


def write_run(path: str, b: Batch) -> int:
    """Device batch -> one ATB run file (its live prefix only); returns the
    file's bytes."""
    from .nodes import compact_scalars, host_ints
    n, *used = host_ints(compact_scalars(b))
    cols = host_columns(b, n, used)
    return _write(path, _atb_columns(b, cols, 0, n), n)


def read_run(path: str, schema: Schema, morsel_rows: int = 1 << 16,
             device=None) -> Iterator[Batch]:
    """Stream one ATB run back as batches of at most ``morsel_rows`` rows
    on ``device``, each of ``pad_capacity`` rows (and pool bytes), staged
    from pinned host buffers. A run of no rows gives one empty batch."""
    from .. import native
    from ..core.array import resolve_device
    device = resolve_device(device)
    pinned = device.type == "cuda"
    with native.open_atb(path) as f:
        nrows = f.nrows
        STATS["bytes_read"] += os.path.getsize(path)
        start = 0
        idx = 0
        while start < nrows or (nrows == 0 and idx == 0):
            n = min(morsel_rows, nrows - start)
            cap = pad_capacity(max(n, 1))
            arrays: List[Array] = []
            for fld in schema.fields:
                c = f.columns[fld.name]
                validity = None
                if "validity" in c:
                    v = _pinned_empty((cap,), torch.bool, device)
                    v.numpy()[:n] = c["validity"][start:start + n]
                    v[n:] = False
                    validity = v.to(device, non_blocking=True)
                if fld.type.is_varlen:
                    off = c["offsets"][start:start + n + 1]
                    base = int(off[0]) if n else 0
                    used = int(off[-1]) - base if n else 0
                    data = _pinned_empty((pad_capacity(max(used, 1)),),
                                         torch.uint8, device)
                    data.numpy()[:used] = c["data"][base:base + used]
                    data[used:] = 0
                    offs = _pinned_empty((cap + 1,), torch.int32, device)
                    offs.numpy()[:n + 1] = off - base if n else 0
                    offs[n + 1:] = used
                    arrays.append(Array(
                        fld.type, data.to(device, non_blocking=True),
                        validity, length=n,
                        offsets=offs.to(device, non_blocking=True)))
                else:
                    shape = value_row_shape(fld.type)
                    k = int(np.prod(shape, dtype=np.int64))
                    src = c["data"][start * k:(start + n) * k]
                    buf = _pinned_empty((cap,) + shape,
                                        _torch_dtype(fld.type), device)
                    flat = buf.view(-1)
                    flat.numpy()[:n * k] = src.view(flat.numpy().dtype)
                    flat[n * k:] = 0
                    arrays.append(Array(fld.type,
                                        buf.to(device, non_blocking=True),
                                        validity, length=n))
            yield Batch(schema, arrays, n, idx)
            idx += 1
            start += n
            if nrows == 0:
                break


def _torch_dtype(t: dt.DataType) -> torch.dtype:
    """The torch dtype of a fixed-width type's storage."""
    return torch.from_numpy(np.zeros((0,), t.storage_np)).dtype


def write_run_masked(path: str, b: Batch, mask: np.ndarray,
                     host_cols=None) -> int:
    """Write the ``mask``-selected rows of a batch as one ATB run (the JAX
    package's per-partition write; the Grace split here does not use it:
    ``partition_order``); returns the row count. ``host_cols``: the
    batch's columns from ``host_columns`` when the caller has them."""
    from .nodes import compact_scalars, host_ints
    if host_cols is None:
        n, *used = host_ints(compact_scalars(b))
        host_cols = host_columns(b, n, used)
    sel = np.flatnonzero(mask)
    cols = {}
    for name, a, c in zip(b.schema.names, b.arrays, host_cols):
        col = {}
        if "offsets" in c:
            offsets = c["offsets"].astype(np.int64)
            lens = offsets[sel + 1] - offsets[sel]
            off = np.zeros((sel.shape[0] + 1,), np.int64)
            off[1:] = np.cumsum(lens)
            total = int(off[-1])
            src = np.repeat(offsets[sel] - off[:-1], lens) + \
                np.arange(total, dtype=np.int64)
            col["data"] = c["data"][src] if total else \
                np.zeros((0,), np.uint8)
            col["offsets"] = off.astype(np.int32)
        else:
            k = int(np.prod(value_row_shape(a.type), dtype=np.int64))
            col["data"] = c["data"].reshape(-1, k)[sel].reshape(-1) \
                if k > 1 else c["data"][sel]
        if "validity" in c:
            col["validity"] = c["validity"][sel]
        cols[name] = col
    _write(path, cols, int(sel.shape[0]))
    return int(sel.shape[0])


# ---- the Grace join's partitions ------------------------------------------------

def partition_order(b: Batch, pids: torch.Tensor, K: int):
    """(a take order of ``b``'s rows grouped by partition, (K,) int32
    counts on the device): the live rows of partition 0 first, each
    partition's rows in arrival order. B4 counts the rows per partition
    and writes each tile's offsets, ``partition_positions`` gives each
    row's stable rank in its partition (one launch each on the card; the
    plain versions on the CPU); a scatter of the row numbers to (the
    partition's start + rank) makes the order. ``pids``: int32 (cap,),
    values in [0, K); rows past the length are ignored."""
    cap = b.capacity
    dest = torch.where(b.row_mask(), pids.to(torch.int32),
                       torch.full((), K, dtype=torch.int32,
                                  device=pids.device)).contiguous()
    counts, tiles = partition_histogram_segments([dest], K)
    (pos,) = partition_positions([dest], K, cap, tiles)
    counts = counts[0]
    starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    live = pos < K * cap
    part = torch.div(pos, cap, rounding_mode="floor").clamp_(max=K - 1)
    target = torch.where(live, starts[part] + (pos - part * cap),
                         torch.full((), cap, dtype=torch.int64,
                                    device=pos.device))
    order = torch.zeros((cap + 1,), dtype=torch.int64, device=pos.device)
    order.scatter_(0, target, torch.arange(cap, dtype=torch.int64,
                                           device=pos.device))
    return order[:cap], counts


class GracePartitioner:
    """Hash-partition a stream of batches into K groups of ATB files (one
    side of a Grace hash join: spill to disk by join-key hash, then join
    partition by partition)."""

    def __init__(self, schema: Schema, K: int, tag: str, base_dir: str):
        self.schema = schema
        self.K = K
        self._dir = os.path.join(base_dir, tag)
        os.makedirs(self._dir, exist_ok=True)
        self.files: List[List[str]] = [[] for _ in range(K)]
        self.rows = [0] * K
        STATS["partition_rows"][tag] = self.rows
        self._seq = 0

    def add(self, b: Batch, pids: torch.Tensor) -> None:
        """``pids``: the partition of each row, int32 on ``b``'s device
        (rows past the length ignored)."""
        from ..ops.selection import take_batch
        from .nodes import compact_scalars, host_ints
        order, counts = partition_order(b, pids, self.K)
        grouped = take_batch(b, Array(dt.int64, order, None,
                                      length=b.length))
        scal = compact_scalars(grouped)
        vals = host_ints(scal + list(counts.unbind()))
        n, used = vals[0], vals[1:len(scal)]
        per = vals[len(scal):]
        cols = host_columns(grouped, n, used)
        lo = 0
        for p, c in enumerate(per):
            if c:
                path = os.path.join(self._dir, f"p{p}_{self._seq}.atb")
                _write(path, _atb_columns(grouped, cols, lo, lo + c), c)
                self.files[p].append(path)
                self.rows[p] += c
                STATS["partition_files"] += 1
            lo += c
        self._seq += 1

    def read_partition(self, p: int, morsel_rows: int = 1 << 16,
                       device=None) -> Iterator[Batch]:
        for path in self.files[p]:
            yield from read_run(path, self.schema, morsel_rows, device)


# ---- the external sort ----------------------------------------------------------

def _live_prefix(b: Batch, n: int, used: List[int]) -> Batch:
    """``b``'s first ``n`` rows as views (each string pool its ``used``
    bytes, in column order)."""
    used_it = iter(used)
    return Batch(b.schema, [
        Array(a.type, a.values[:max(next(used_it), 1)] if a.type.is_varlen
              else a.values[:n],
              None if a.validity is None else a.validity[:n], length=n,
              offsets=None if a.offsets is None else a.offsets[:n + 1],
              dictionary=a.dictionary)
        for a in b.arrays], n, b.index)


def _coalesced(batches: Iterator[Batch], rows: int) -> Iterator[Batch]:
    """The live rows of ``batches`` in order, gathered into batches of at
    least ``rows`` rows (the last: the rest) whose buffers hold exactly
    their rows. A merge round's batch keeps its round's capacity, many
    times its rows when the round emits few, and the sort's consumer
    keeps every batch: at SF 10 the merged batches held 2.1 times their
    live bytes. One host read a batch (its length and pools' used
    bytes)."""
    from ..ops.concat import concat_batches
    from .nodes import _owned, compact_scalars, host_ints
    held: List[Batch] = []
    n_held = 0
    for b in batches:
        n, *used = host_ints(compact_scalars(b))
        if n == 0:
            continue
        # copied at once: a held view would keep its round's buffers
        held.append(_owned(_live_prefix(b, n, used)))
        n_held += n
        if n_held >= rows:
            yield concat_batches(held)
            held, n_held = [], 0
    if held:
        yield concat_batches(held)


_SEQ = "__arrow_tpu_seq"


class SpillSorter:
    """Per-node external-sort state: add sorted runs, then merge.

    STABILITY: the in-memory sort is stable, so the external one must be
    too. Every row carries its global arrival position in a trailing
    ``__seq`` int64 column; the run sort is stable (it keeps ``__seq``
    ascending within ties) and the k-way merge breaks cross-run ties on
    it, so the output's tie order equals the in-memory path's exactly.
    The column is dropped at emission. ``close`` (also when ``finish``'s
    consumer stops early) removes the run directory."""

    def __init__(self, schema: Schema, sort_keys, null_placement: str,
                 morsel_rows: int = 1 << 16, device=None):
        from ..core.array import resolve_device
        self.schema = schema
        self._spill_schema = Schema(tuple(
            list(schema.fields) + [Field(_SEQ, dt.int64, False)]))
        self._keys = list(sort_keys)
        self._npl = null_placement
        self._morsel = morsel_rows
        self._device = resolve_device(device)
        self._dir = tempfile.mkdtemp(prefix="arrow_tpu_spill_")
        STATS["last_dir"] = self._dir
        self._runs: List[str] = []
        self._next_seq = 0
        self._batch_rows = 1

    def _sorted_with_seq(self, b: Batch) -> tuple:
        """(``b`` with its ``__seq`` column, sorted; its host length)."""
        from ..ops.selection import take_batch
        from ..ops.sorting import _composite_sort_perm
        from .nodes import host_ints, probe_varlen_sort_words
        n = host_ints([b.length])[0]
        cap = b.capacity
        seq = Array(dt.int64, self._next_seq + torch.arange(
            cap, dtype=torch.int64, device=b.device), None, length=n)
        full = Batch(self._spill_schema, list(b.arrays) + [seq], n)
        perm = _composite_sort_perm(
            [full.column(k.name) for k in self._keys],
            [k.order for k in self._keys], self._npl, cap, n,
            varlen_words=probe_varlen_sort_words(full, self._keys))
        self._next_seq += n
        self._batch_rows = max(self._batch_rows, n)
        return take_batch(full, Array(dt.int64, perm, None, length=n)), n

    def add(self, b: Batch) -> None:
        sb, n = self._sorted_with_seq(b)
        path = os.path.join(self._dir, f"run{len(self._runs)}.atb")
        write_run(path, sb)
        self._runs.append(path)
        STATS["runs"] += 1
        STATS["run_rows"] += n

    def finish(self) -> Iterator[Batch]:
        """The merged rows, in batches of at least the largest input
        batch's rows that hold exactly their rows (``_coalesced``); the
        run directory goes when the stream ends or its consumer closes
        it."""
        from ..ops.sorting import SortKey
        from .nodes import streaming_sorted_merge
        try:
            if not self._runs:
                return
            its = [read_run(p, self._spill_schema, self._morsel,
                            self._device) for p in self._runs]
            merge_keys = self._keys + [SortKey(_SEQ, "ascending")]
            names = list(self.schema.names)
            merged = streaming_sorted_merge(its, self._spill_schema,
                                            merge_keys, self._npl,
                                            device=self._device)
            t0 = time.perf_counter()
            for b in _coalesced((m.select(names) for m in merged),
                                self._batch_rows):
                STATS["merge_s"] += time.perf_counter() - t0
                yield b
                t0 = time.perf_counter()
            STATS["merge_s"] += time.perf_counter() - t0
        finally:
            self.close()

    def close(self) -> None:
        shutil.rmtree(self._dir, ignore_errors=True)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
