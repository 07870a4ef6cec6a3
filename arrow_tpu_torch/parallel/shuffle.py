"""Hash-partitioned shuffle (the exchange operator) over a single-controller
mesh; the counterpart of the JAX package's ``parallel/shuffle.py``.

The JAX package runs one SPMD program under ``shard_map`` with
``all_to_all`` in its middle. Here one process drives every shard: a mesh
is an ordered list of ``torch.device``s (which may repeat one device: n
logical shards on one card), the per-shard steps are plain functions of the
shard's LOCAL tensors, run for each shard in turn on its device, and
``exchange`` is the one collective between them:

  1. ``partition_for_exchange`` / ``shuffle_rows_send`` (per shard): hash
     keys -> dest shard = h mod P; every row's slot in its destination's
     bucket, in row order, places it in a fixed, zero-filled (P, B) send
     buffer per leaf (B = per-destination capacity). The slots come from
     two kernels, ``partition_histogram_segments`` (the counts, and each
     tile's offsets) and ``partition_positions`` (each row's stable rank
     in its bucket), each launched ONCE per device for all the shards that
     lie there (``_over_mesh``: every shard's destinations first, then the
     two launches, then each shard's scatter); called alone, a shard makes
     its own pair of launches. A bucket with more than B rows raises the
     deferred error flag, a device scalar that only the caller of the
     whole exchange fetches.
  2. ``exchange`` (all shards): bucket p of shard s goes to shard p,
     ``recv[p][s] = send[s][p]``, copied between devices where they differ.
  3. ``flatten_received`` / ``shuffle_rows_receive`` (per shard): the
     received (P, B) buckets compact to the front of one local buffer.

``shuffle_rows`` and ``shuffle_batch`` compose the three over per-shard
lists. The per-shard steps see local tensors only, so a multi-process
``torch.distributed`` form of ``exchange`` can take this one's place
without touching them (ROADMAP A8).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.array import Array, row_mask
from ..core.batch import Batch
from ..core.schema import Schema
from ..ops.bits import as_signed_bits
from ..ops.cuda_kernels import partition_histogram_segments, \
    partition_positions
from ..ops.hashing import hash32

__all__ = ["partition_for_exchange", "exchange", "flatten_received",
           "shuffle_batch", "shuffle_rows", "shuffle_rows_send",
           "shuffle_rows_receive", "EXCHANGE_SEED"]

# decorrelated from the grouper's hash: a shared hash would funnel every
# key of one local grouper slot to one shard
EXCHANGE_SEED = 0x5108FF1E

def _scatter_rows(size: int, pos: torch.Tensor, src: torch.Tensor
                  ) -> torch.Tensor:
    """A zero-filled buffer of ``size`` rows with ``src``'s rows written at
    ``pos``; position ``size`` is the dump slot that is sliced off (JAX's
    ``.at[pos].set(src, mode="drop")``)."""
    bits = as_signed_bits(src)      # no index_copy_ for wide unsigned types
    buf = bits.new_zeros((size + 1,) + tuple(src.shape[1:]))
    return buf.index_copy_(0, pos, bits)[:size].view(src.dtype)


def _exclusive_starts(counts: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(counts, 0) - counts


def _bucket_positions(dests: Sequence[torch.Tensor], P: int, B: int):
    """Counts (S, P) int32 and every row's send-buffer slot (S (n_s,) int64
    tensors) of the shards whose int32 ``dests`` lie on one device: one
    histogram launch and one positions launch for all of them."""
    counts, tiles = partition_histogram_segments(dests, P)
    return counts, partition_positions(dests, P, B, tiles)


def _bucket_rows(leaves: Sequence[Optional[torch.Tensor]],
                 dest: torch.Tensor, P: int, B: int,
                 counts: Optional[torch.Tensor] = None,
                 positions: Optional[torch.Tensor] = None):
    """Rows whose ``dest`` (int32; any value outside [0, P) drops the row)
    is below P, bucketed in row order into one (P, B) send buffer per leaf
    at their ``positions`` (``_bucket_positions``'; computed here from
    ``dest`` when not given). Returns (send, counts (P,) int32, error 0-d
    int32: some bucket got more than B)."""
    if positions is None:
        c, (positions,) = _bucket_positions([dest], P, B)
        counts = c[0]
    error = (counts > B).any().to(torch.int32)
    send = []
    for leaf in leaves:
        if leaf is None:
            send.append(None)
            continue
        buf = _scatter_rows(P * B, positions, leaf)
        send.append(buf.reshape((P, B) + tuple(leaf.shape[1:])))
    return send, counts, error


# ---- per shard: before the exchange ------------------------------------------

def shuffle_rows_send(leaves: Sequence[Optional[torch.Tensor]],
                      dest: torch.Tensor, num_partitions: int,
                      bucket_capacity: int,
                      counts: Optional[torch.Tensor] = None,
                      positions: Optional[torch.Tensor] = None):
    """Per shard: bucket arbitrary per-row leaves by explicit destination.
    Rows whose ``dest`` lies in [0, P) go to bucket ``dest``; any other
    value drops the row (padding). ``counts`` / ``positions``: the shard's
    row of ``_bucket_positions`` over ``dest.to(torch.int32)``, where the
    caller computed them for several shards at once. Returns (send: (P, B,
    ...) buffers, None passing through; counts (P,) int32, capped at B;
    error 0-d int32)."""
    send, counts, error = _bucket_rows(
        leaves, None if positions is not None else dest.to(torch.int32),
        num_partitions, bucket_capacity, counts, positions)
    return send, counts.clamp(max=bucket_capacity), error


def _column_leaves(b: Batch) -> List[Optional[torch.Tensor]]:
    """Flat list of a batch's per-row buffers: values, then validity (or
    None), per column."""
    leaves = []
    for i in range(b.num_columns):
        a = b.column(i)
        if a.type.is_varlen:
            raise NotImplementedError(
                "shuffle of raw string columns: dictionary-encode first")
        leaves.append(a.values)
        leaves.append(a.validity)
    return leaves


def _rebuild_batch(schema: Schema, leaves, length) -> Batch:
    it = iter(leaves)
    arrays = [Array(f.type, next(it), next(it), length=length)
              for f in schema.fields]
    return Batch(schema, arrays, length)


def _batch_dest(b: Batch, key_names: Sequence[str], P: int, seed: int,
                dest: Optional[torch.Tensor]) -> torch.Tensor:
    """A local batch's int32 destinations: the hash of the key columns mod
    P, or ``dest``; P for the rows past the batch's length."""
    if dest is None:
        h = hash32([b.column(k) for k in key_names], seed=seed)
        dest = h % P                    # h is non-negative: the u32 remainder
    return torch.where(row_mask(b.capacity, b.length, b.device),
                       dest.to(torch.int32), P)


def partition_for_exchange(b: Batch, key_names: Sequence[str],
                           num_partitions: int, bucket_capacity: int,
                           seed: int = EXCHANGE_SEED,
                           dest: Optional[torch.Tensor] = None,
                           counts: Optional[torch.Tensor] = None,
                           positions: Optional[torch.Tensor] = None):
    """Per shard: bucket a local batch's rows by destination (the hash of
    the key columns by default; pass ``dest`` for range partitioning).
    ``counts`` / ``positions``: the shard's row of ``_bucket_positions``
    over ``_batch_dest``, where the caller computed them for several shards
    at once (key_names, seed and dest are then not read).

    Returns (send buffers: (P, B) tensors in ``_column_leaves`` order,
    counts (P,) int32 — NOT capped at B, error 0-d int32)."""
    P, B = num_partitions, bucket_capacity
    d = None if positions is not None else \
        _batch_dest(b, key_names, P, seed, dest)
    return _bucket_rows(_column_leaves(b), d, P, B, counts, positions)


# ---- all shards: the collective ----------------------------------------------

def exchange(send_buffers, counts, devices: Sequence[torch.device]):
    """The all-to-all of the (P, B) buckets and their counts over the mesh.

    ``send_buffers[s]`` is shard s's list of (P, B, ...) buffers (None
    passes through) and ``counts[s]`` its (P,) counts; ``devices[p]`` is
    where shard p lives. Returns (recv, recv_counts) with
    ``recv[p][leaf][s] = send_buffers[s][leaf][p]`` and
    ``recv_counts[p][s] = counts[s][p]``, on ``devices[p]``."""
    n = len(devices)

    def gather(per_shard, p):
        return torch.stack([per_shard[s][p].to(devices[p], non_blocking=True)
                            for s in range(n)])

    recv, recv_counts = [], []
    for p in range(n):
        recv.append([
            None if send_buffers[0][j] is None
            else gather([send_buffers[s][j] for s in range(n)], p)
            for j in range(len(send_buffers[0]))])
        recv_counts.append(gather(counts, p))
    return recv, recv_counts


# ---- per shard: after the exchange -------------------------------------------

def shuffle_rows_receive(recv_buffers, recv_counts: torch.Tensor):
    """Per shard: front-compact the received (P, B) buckets. Returns
    (leaves of P*B rows with the received rows at the front and zeros past
    them, total received rows 0-d int32)."""
    P = recv_counts.shape[0]
    B = next(buf.shape[1] for buf in recv_buffers if buf is not None)
    dev = recv_counts.device
    rc = recv_counts.long()
    total = rc.sum().to(torch.int32)
    ii = torch.arange(B, device=dev)[None, :]
    pos = _exclusive_starts(rc)[:, None] + ii
    # counts past B (an overflowed sender) leave gaps and may point past
    # the buffer: those rows drop, the error flag says so
    outpos = torch.where((ii < rc[:, None]) & (pos < P * B), pos,
                         P * B).reshape(P * B)
    leaves = []
    for buf in recv_buffers:
        if buf is None:
            leaves.append(None)
            continue
        flat = buf.reshape((P * B,) + tuple(buf.shape[2:]))
        leaves.append(_scatter_rows(P * B, outpos, flat))
    return leaves, total


def flatten_received(schema: Schema, recv_buffers,
                     recv_counts: torch.Tensor) -> Batch:
    """Per shard: the received (P, B) buckets as one local batch of
    capacity P*B whose length, the sum of the counts, stays on the
    device."""
    leaves, total = shuffle_rows_receive(recv_buffers, recv_counts)
    return _rebuild_batch(schema, leaves, total)


# ---- the three composed over the mesh ----------------------------------------

def _over_mesh(dest_step, send_step, receive_step, devices, B: int):
    """``dest_step(s)`` -> shard s's int32 destinations for every shard;
    per device ONE ``_bucket_positions`` call over the shards whose
    destinations lie there; ``send_step(s, counts, positions)`` -> (send,
    counts, error) for every shard; the exchange; then
    ``receive_step(p, recv, recv_counts)`` for every shard. Each shard's
    buffers are dropped as soon as the next step has them. Returns per
    shard (what receive_step gave, error)."""
    n = len(devices)
    dests = [dest_step(s) for s in range(n)]
    by_device = {}
    for s, d in enumerate(dests):
        by_device.setdefault(d.device, []).append(s)
    counts, positions = [None] * n, [None] * n
    for shards in by_device.values():
        c, pos = _bucket_positions([dests[s] for s in shards], n, B)
        for i, s in enumerate(shards):
            counts[s], positions[s] = c[i], pos[i]
    del dests
    sends, counts, errors = map(list, zip(*[
        send_step(s, counts[s], positions[s]) for s in range(n)]))
    del positions
    recv, recv_counts = exchange(sends, counts, devices)
    del sends
    out = []
    for p in range(n):
        out.append((receive_step(p, recv[p], recv_counts[p]), errors[p]))
        recv[p] = None
    return out


def shuffle_rows(leaves, dest, bucket_capacity: int,
                 devices: Sequence[torch.device]):
    """Exchange arbitrary per-row leaves by explicit destination: the
    leaf-level core of the exchange, shared by batch shuffles and the
    exchange of pre-aggregated state rows (``parallel/dist_agg``).

    ``leaves[s]`` / ``dest[s]``: shard s's leaves and (rows,) destinations.
    Returns per shard (recv_leaves of P*B rows, total 0-d int32, error 0-d
    int32: one of this shard's SEND buckets overflowed)."""
    n = len(devices)
    B = bucket_capacity
    out = _over_mesh(
        lambda s: dest[s].to(torch.int32),
        lambda s, counts, pos: shuffle_rows_send(
            leaves[s], dest[s], n, B, counts=counts, positions=pos),
        lambda p, recv, recv_counts: shuffle_rows_receive(recv, recv_counts),
        devices, B)
    return [(recv_leaves, total, err) for (recv_leaves, total), err in out]


def shuffle_batch(batches: Sequence[Batch], key_names: Sequence[str],
                  devices: Sequence[torch.device],
                  bucket_capacity: Optional[int] = None,
                  seed: int = EXCHANGE_SEED,
                  dest=None) -> List[Tuple[Batch, torch.Tensor]]:
    """Full shuffle of the shards' local batches by key hash (or explicit
    per-shard ``dest``). Returns per shard (re-partitioned local batch of
    capacity P * bucket_capacity, error flag)."""
    n = len(devices)
    B = bucket_capacity or batches[0].capacity
    return _over_mesh(
        lambda s: _batch_dest(batches[s], key_names, n, seed,
                              None if dest is None else dest[s]),
        lambda s, counts, pos: partition_for_exchange(
            batches[s], key_names, n, B, counts=counts, positions=pos),
        lambda p, recv, recv_counts: flatten_received(
            batches[p].schema, recv, recv_counts),
        devices, B)
