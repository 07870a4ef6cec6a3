"""Segment-reduction primitives over sort-grouped batches; the counterpart
of the JAX package's ``ops/segment.py``.

The batch is sorted by key once (``ops/distinct.sort_group``), so each
group is one contiguous run of sorted positions, and every aggregate
reduces its run and then writes ONE element per distinct group:

  * integer sums and counts: padded cumsum + boundary differences, exact
    in any order (modular arithmetic);
  * min / max of types of at most 32 bits: one cummax over
    (run id << 32 | order-preserving code), read at each run's last
    position;
  * float sums: one ``torch.segment_reduce`` pass over the run offsets,
    each run summed from its first row to its last (the same order on every
    run of the program). Floats are never summed by cumsum differences:
    prefixes of other runs would leak cancellation error into a run's sum;
  * min / max of 64-bit types: one ``scatter_reduce_`` pass that folds each
    sorted row into its run's slot (``segment_reduce`` takes no integers
    on the card).

The JAX package runs a head-reset doubling scan for the last two (log2(n)
full passes) because a TPU scatter serializes; the value wanted is the
per-run reduction, which one pass gives: min and max exactly, a float sum
in another order.

Per-run results are (R,) tensors, R = the grouper's rep capacity; slots of
runs that do not exist hold the reduction's identity (the JAX package
leaves them unspecified; callers drop them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bits import SIGNED_OF, as_signed_bits, from_ordered_signed, \
    ordered_signed

__all__ = ["SegmentContext", "make_segment_context", "rows_of_positions",
           "segmented_scan", "last_marked",
           "segmented_carry_last", "running_scan", "seg_sum",
           "seg_reduce_min", "seg_reduce_max", "seg_prod", "seg_any",
           "seg_all", "seg_first_row", "seg_last_row"]

_U32 = 0xFFFFFFFF
_BIAS32 = 0x80000000


def _scatter(size: int, fill, index: torch.Tensor, src: torch.Tensor
             ) -> torch.Tensor:
    """out = full(size, fill); out[index] = src with every index past
    ``size - 1`` dropped (into a dump slot): JAX's ``.at[index].set(src,
    mode="drop")``. Wide unsigned types move as their signed bits (no
    ``index_copy_`` for them)."""
    buf = torch.full((size + 1,) + tuple(src.shape[1:]), fill,
                     dtype=src.dtype, device=src.device)
    return as_signed_bits(buf).index_copy_(
        0, index.clamp(max=size), as_signed_bits(src))[:size].view(src.dtype)


def rows_of_positions(new_off: torch.Tensor, out_cap: int) -> torch.Tensor:
    """(out_cap,) int32 source-row index per output position p: the r with
    ``new_off[r] <= p < new_off[r+1]`` (-1 before the first non-empty row,
    junk past the total: clamp before use).

    The JAX package scatters each non-empty row's id at its start and
    forward-fills with a cummax. ``torch.cummax`` also tracks indices and
    is far slower on the card than a cumsum (``PERF.md`` has both times),
    so the fill is a cumsum here: each non-empty row scatters its id MINUS
    the id of the non-empty row before it, and the running sum of those
    steps is the row id. Same values."""
    dev = new_off.device
    starts = new_off[:-1]
    nonempty = new_off[1:] > starts
    n = starts.shape[0]
    ridx = torch.arange(n, dtype=torch.int32, device=dev)
    # id of the non-empty row before each row: compact the non-empty ids
    # by their rank, then read rank - 2 (-1 where there is none)
    rank = torch.cumsum(nonempty, 0)
    ids = _scatter(n, -1, torch.where(nonempty, rank - 1, n), ridx)
    before = torch.where(rank >= 2, ids[(rank - 2).clamp_(0)], -1)
    pos = torch.where(nonempty, starts, out_cap).long()  # empty rows: dropped
    steps = _scatter(out_cap, 0, pos, ridx - before)
    return torch.cumsum(steps, 0, dtype=torch.int32).sub_(1)


class SegmentContext(NamedTuple):
    """Per-batch grouping context shared by all aggregators.

    Tensors indexed by SORTED position (cap,) unless noted:
      perm          sorted position -> original row
      s_active      row participates (in-range, in-group)
      head          first position of each run
      seg           run id per position
      starts (R,)   run start position (cap pad)
      ends   (R,)   run end position (exclusive; == starts for pads)
      gid_global    (R,) run -> persistent group id (unique; -1 pads)
      row_gids      per ORIGINAL row: persistent group id (-1 inactive), or
                    None when the sort skipped the per-row codes
      num_segs      0-d int32
      sorted_cols   dict: id(values buffer) -> (values in sorted order,
                    validity in sorted order | None) for the columns that
                    rode the sort as payloads
      slot          (cap,) int64 run slot per position for the one-pass
                    min / max: seg where active and seg < R, else R (dump)
      offsets       (R + 1,) int64 run boundaries for the one-pass float
                    sums: run s is [offsets[s], offsets[s + 1]); runs not
                    in use are empty (both ends the active row count)
    """

    perm: torch.Tensor
    s_active: torch.Tensor
    head: torch.Tensor
    seg: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor
    gid_global: torch.Tensor
    row_gids: Optional[torch.Tensor]
    num_segs: torch.Tensor
    sorted_cols: dict
    slot: torch.Tensor
    offsets: torch.Tensor


def make_segment_context(g, rep_gids: torch.Tensor,
                         sorted_cols=None) -> SegmentContext:
    """``g``: a ``distinct.SortGroup``; ``rep_gids``: (R,) persistent gid
    per batch-local first-appearance id (from the grouper's table pass over
    the unique reps). All run-granular tensors are R-sized."""
    cap = g.perm.shape[0]
    R = rep_gids.shape[0]
    assert g.head_pos_seg.shape[0] == R, \
        "sort_group rep_capacity must match the grouper table size"
    dev = g.perm.device
    sidx = torch.arange(R, dtype=torch.int32, device=dev)
    starts = g.head_pos_seg
    nxt = torch.cat([starts[1:],
                     torch.full((1,), cap, dtype=torch.int32, device=dev)])
    in_use = sidx < g.num_unique
    ends = torch.where(sidx < g.num_unique - 1, nxt, g.n_active)
    ends = torch.where(in_use, ends, starts).to(torch.int32)
    hi = max(R - 1, 0)
    gid_global = torch.where(
        in_use, rep_gids[g.gid_of_seg.clamp(0, hi).long()], -1) \
        .to(torch.int32)
    row_gids = None
    if g.codes is not None:
        row_gids = torch.where(
            g.codes >= 0, rep_gids[g.codes.clamp(0, hi).long()], -1) \
            .to(torch.int32)
    slot = torch.where(g.s_active & (g.seg < R), g.seg, R).long()
    offsets = torch.cat([torch.where(in_use, starts, g.n_active),
                         g.n_active.reshape(1)]).long()
    return SegmentContext(g.perm, g.s_active, g.head, g.seg, starts, ends,
                          gid_global, row_gids, g.num_unique,
                          sorted_cols if sorted_cols is not None else {},
                          slot, offsets)


def _fold_runs(ctx: SegmentContext, x_sorted: torch.Tensor, ident,
               reduce: str) -> torch.Tensor:
    """(R,) per-run ``reduce`` ("amin" / "amax", which propagate NaN on the
    CPU and on the card as jnp.minimum / jnp.maximum do) of the active rows
    in one pass."""
    R = ctx.starts.shape[0]
    buf = torch.full((R + 1,), ident, dtype=x_sorted.dtype,
                     device=x_sorted.device)
    return buf.scatter_reduce_(0, ctx.slot, x_sorted, reduce)[:R]


def seg_sum(ctx: SegmentContext, x_sorted: torch.Tensor) -> torch.Tensor:
    """(R,) sums per run. Integers: padded-cumsum boundary differences,
    bit-exact in any order. Floats: one ``segment_reduce`` pass over the
    run offsets, so partial sums stay run-local (its checks of the offsets
    would read them on the host, so they are off: ``make_segment_context``
    builds them nondecreasing and in range)."""
    if x_sorted.dtype.is_floating_point:
        return torch.segment_reduce(x_sorted, "sum", offsets=ctx.offsets,
                                    unsafe=True)
    C = torch.cat([x_sorted.new_zeros((1,)),
                   torch.cumsum(x_sorted, 0, dtype=x_sorted.dtype)])
    return C[ctx.ends.long()] - C[ctx.starts.long()]


def running_scan(v: torch.Tensor, combine, fill) -> torch.Tensor:
    """Unsegmented inclusive scan: cummax / cummin / cumsum where
    ``combine`` is torch.maximum / torch.minimum / torch.add, else
    doubling with ``fill`` as the identity."""
    if combine is torch.maximum:
        return torch.cummax(v, 0).values
    if combine is torch.minimum:
        return torch.cummin(v, 0).values
    if combine is torch.add:
        return torch.cumsum(v, 0, dtype=v.dtype)
    cap = v.shape[0]
    d = 1
    while d < cap:
        vs = torch.cat([v.new_full((d,), fill), v[:-d]])
        v = combine(v, vs)
        d *= 2
    return v


def segmented_scan(v: torch.Tensor, head: torch.Tensor, combine
                   ) -> torch.Tensor:
    """Inclusive segmented scan by Hillis-Steele doubling (log2(n) shifted
    elementwise passes); ``head`` marks the first position of each run and
    ``combine`` is an elementwise binary op (e.g. ``torch.minimum``). For
    small tensors: the per-run reductions above do not use it."""
    cap = v.shape[0]
    f = head
    idx = torch.arange(cap, device=v.device)
    d = 1
    while d < cap:
        vs = torch.cat([v[:d], v[:-d]])          # v[i-d] (prefix junk)
        fs = torch.cat([torch.ones((d,), dtype=torch.bool,
                                   device=v.device), f[:-d]])
        take = (idx >= d) & ~f
        v = torch.where(take, combine(vs, v), v)
        f = f | fs  # fs is True for i < d (array start = implicit head)
        d *= 2
    return v


def last_marked(mark: torch.Tensor) -> torch.Tensor:
    """(n,) int64: for every position the latest position <= it where
    ``mark`` is True, -1 before the first one. A forward fill is a copy of
    the last marked position's value, so it needs no running max
    (``torch.cummax`` tracks indices as well and is far slower on the card
    than a cumsum; ``PERF.md`` has both times): the marks are counted by a
    cumsum, the marked positions compacted by their count, and every
    position reads entry count - 1."""
    n = mark.shape[0]
    rank = torch.cumsum(mark, 0)
    pos = torch.arange(n, device=mark.device)
    marked = _scatter(n, 0, torch.where(mark, rank - 1, n), pos)
    return torch.where(rank > 0, marked[(rank - 1).clamp_(0)], -1)


def segmented_carry_last(values_i32: torch.Tensor,
                         head: torch.Tensor) -> torch.Tensor:
    """Within each head-delimited run, carry the value of the LATEST
    position whose value >= 0 (-1 where the run has none yet): the last
    position with a value (``last_marked``), kept where it lies at or after
    the position's run head."""
    cap = values_i32.shape[0]
    if cap == 0:
        return values_i32.to(torch.int32)
    src = last_marked(values_i32 >= 0)
    run_head = last_marked(head)
    ok = (src >= 0) & (src >= run_head)
    return torch.where(ok, values_i32[src.clamp(0)], -1).to(torch.int32)


# ---- packed-cummax segmented extremes ----------------------------------------
#
# For orderable dtypes of at most 32 bits, a segmented min/max is ONE cummax
# over (run id << 32 | order-preserving code): higher runs always dominate,
# so the scan cannot leak across run boundaries. Codes are u32 values held
# in int64 (torch has no u32 arithmetic). NaNs are forced to the winning
# code in both directions, as torch.minimum / maximum propagate them.

_PACKED_INTS = (torch.int8, torch.int16, torch.int32)
# wider unsigned types reach the reductions as their ordered signed values
_PACKED_UINTS = (torch.bool, torch.uint8)


def _asc_enc32(x: torch.Tensor):
    """(order-preserving u32 codes as int64, kind) or (None, None)."""
    d = x.dtype
    if d in _PACKED_UINTS:
        return x.to(torch.int64), "u32"
    if d in _PACKED_INTS:
        return (x.to(torch.int64) & _U32) ^ _BIAS32, "i32"
    if d == torch.float32:
        bits = x.view(torch.int32).to(torch.int64) & _U32
        enc = torch.where(bits >= _BIAS32, bits ^ _U32, bits | _BIAS32)
        return torch.where(torch.isnan(x), _U32, enc), "f32"
    return None, None


def _asc_dec32(code: torch.Tensor, kind: str, out_dtype) -> torch.Tensor:
    if kind == "u32":
        return code.to(out_dtype)
    if kind == "i32":
        return (code - _BIAS32).to(out_dtype)
    # f32: invert the sign-split encoding; 0xFFFFFFFF == forced NaN
    bits = torch.where(code < _BIAS32, code ^ _U32, code ^ _BIAS32)
    v = ((bits ^ _BIAS32) - _BIAS32).to(torch.int32).view(torch.float32)
    return torch.where(code == _U32, float("nan"), v).to(out_dtype)


def _seg_extreme_packed(ctx: SegmentContext, enc: torch.Tensor,
                        is_max: bool) -> torch.Tensor:
    """(R,) winning u32 code per run (max of enc / min via ~enc)."""
    work = enc if is_max else enc ^ _U32
    cm = torch.cummax((ctx.seg.to(torch.int64) << 32) | work, 0).values
    last = (ctx.ends - 1).clamp(0, max(enc.shape[0] - 1, 0)).long()
    code = cm[last] & _U32
    return code if is_max else code ^ _U32


def extreme_identity(dtype: torch.dtype, is_min: bool):
    """What a min (max) over no rows holds: +inf (-inf), or the integer
    type's largest (smallest) value."""
    if dtype.is_floating_point:
        return float("inf") if is_min else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if is_min else info.min


def seg_reduce_min(ctx: SegmentContext, x_sorted: torch.Tensor
                   ) -> torch.Tensor:
    """(R,) minimum per run (NaN wins)."""
    if x_sorted.dtype in SIGNED_OF:
        return from_ordered_signed(
            seg_reduce_min(ctx, ordered_signed(x_sorted)), x_sorted.dtype)
    enc, kind = _asc_enc32(x_sorted)
    if enc is None:
        return _fold_runs(ctx, x_sorted,
                          extreme_identity(x_sorted.dtype, True), "amin")
    if kind == "f32":
        # NaN must WIN a min too: the smallest code (no real value has it)
        enc = torch.where(torch.isnan(x_sorted), 0, enc)
        code = _seg_extreme_packed(ctx, enc, False)
        return torch.where(code == 0, float("nan"),
                           _asc_dec32(code, kind, x_sorted.dtype))
    return _asc_dec32(_seg_extreme_packed(ctx, enc, False), kind,
                      x_sorted.dtype)


def seg_reduce_max(ctx: SegmentContext, x_sorted: torch.Tensor
                   ) -> torch.Tensor:
    """(R,) maximum per run (NaN wins)."""
    if x_sorted.dtype in SIGNED_OF:
        return from_ordered_signed(
            seg_reduce_max(ctx, ordered_signed(x_sorted)), x_sorted.dtype)
    enc, kind = _asc_enc32(x_sorted)
    if enc is None:
        return _fold_runs(ctx, x_sorted,
                          extreme_identity(x_sorted.dtype, False), "amax")
    return _asc_dec32(_seg_extreme_packed(ctx, enc, True), kind,
                      x_sorted.dtype)


def seg_prod(ctx: SegmentContext, x_sorted: torch.Tensor) -> torch.Tensor:
    """(R,) product per run (rows outside a run hold the caller's 1).
    Floats: one ``segment_reduce`` pass over the run offsets; integers (which
    ``segment_reduce`` does not take on the card): the JAX package's
    doubling segmented scan, read at each run's last position (products
    wrap mod 2^64 as its do)."""
    if x_sorted.dtype.is_floating_point:
        return torch.segment_reduce(x_sorted, "prod", offsets=ctx.offsets,
                                    unsafe=True)
    v = segmented_scan(x_sorted, ctx.head, torch.mul)
    last = (ctx.ends - 1).clamp(0, max(x_sorted.shape[0] - 1, 0)).long()
    return torch.where(ctx.ends > ctx.starts, v[last], 1)


def seg_any(ctx: SegmentContext, flags_sorted: torch.Tensor) -> torch.Tensor:
    """(R,) bool: any flag set in the run."""
    return seg_reduce_max(ctx, flags_sorted.to(torch.uint8)) != 0


def seg_all(ctx: SegmentContext, flags_sorted: torch.Tensor) -> torch.Tensor:
    """(R,) bool: every flag of the run set."""
    return seg_reduce_min(ctx, flags_sorted.to(torch.uint8)) != 0


def seg_first_row(ctx: SegmentContext, valid_sorted: torch.Tensor
                  ) -> torch.Tensor:
    """(R,) ORIGINAL row id of the first valid row of each run (cap if
    none): the least of ``ctx.perm`` over the run's valid rows."""
    cap = valid_sorted.shape[0]
    return seg_reduce_min(ctx, torch.where(valid_sorted, ctx.perm, cap))


def seg_last_row(ctx: SegmentContext, valid_sorted: torch.Tensor
                 ) -> torch.Tensor:
    """(R,) ORIGINAL row id of the last valid row of each run (-1 if
    none)."""
    return seg_reduce_max(ctx, torch.where(valid_sorted, ctx.perm, -1))
