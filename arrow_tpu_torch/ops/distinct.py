"""Sort-based distinct detection over fixed-width key lanes.

The counterpart of the JAX package's ``ops/distinct.py``: one lexicographic
sort groups equal keys into contiguous runs, after which distinct ids,
first-appearance numbering and segment boundaries fall out of prefix ops,
and every scatter writes unique indices.

Where the two frameworks differ:
  * ``lax.sort(..., num_keys=k)`` sorts by k keys at once; ``torch.sort``
    takes one. ``_lexsort_perm`` packs the keys into as few int64 words of
    at most 63 bits as fit and runs one stable sort per word, least
    significant word first (LSD). Lanes are u32 values in int64
    (``ops/bits.py``), so each lane is a 32-bit key.
  * JAX drops out-of-range scatter indices; torch raises. Every scatter
    here writes into a buffer with one extra dump slot, sliced off after.
  * JAX clamps out-of-range gathers; torch does not, so gathers clamp
    explicitly where the JAX code relies on it.
The JAX sorts are unstable and recover each run's first row with a packed
cummax; the sorts here are stable, so a run's first row sits at its head.
The results are the same: they depend only on the order of distinct keys
and on each run's smallest row.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .bits import gather_rows
from .segment import _scatter, segmented_carry_last

__all__ = ["SortGroup", "sort_group", "sort_distinct", "merge_find",
           "merge_insert"]

_I32MAX = (1 << 31) - 1
# lane 0 of an inactive row when the caller folds the inactive flag into
# the sort lanes (range-packed lanes never reach it)
_FOLD_SENTINEL = 0xFFFFFFFF


class SortGroup(NamedTuple):
    """Result of grouping rows by equal key lanes via one sort.

    All tensors have length cap (= lanes.shape[0]) unless noted.
      perm         sorted-position -> original row (inactive rows last)
      s_active     active flag per sorted position
      head         True at the first sorted position of each distinct run
      seg          run id per sorted position (garbage where inactive)
      codes        per ORIGINAL row: first-appearance group id, -1 inactive
                   (None when the caller asked for no codes)
      gid_of_seg   run id -> first-appearance group id (R,)
      seg_of_gid   first-appearance group id -> run id (R,)
      unique_rows  gid -> original row of first occurrence (INT32_MAX pad)
      head_pos     gid -> sorted position of its run head (cap pad)
      head_pos_seg seg -> sorted position of its run head (cap pad)
      n_active     0-d int32 — count of active rows
      num_unique   0-d int32
    """

    perm: torch.Tensor
    s_active: torch.Tensor
    head: torch.Tensor
    seg: torch.Tensor
    codes: Optional[torch.Tensor]
    gid_of_seg: torch.Tensor
    seg_of_gid: torch.Tensor
    unique_rows: torch.Tensor
    head_pos: torch.Tensor
    head_pos_seg: torch.Tensor
    n_active: torch.Tensor
    num_unique: torch.Tensor


def _lexsort_perm(keys: Sequence[Tuple[torch.Tensor, int]]) -> torch.Tensor:
    """Stable lexicographic argsort over (int64 key, bit width) pairs, most
    significant first; each key holds values in [0, 2^bits)."""
    words: List[torch.Tensor] = []       # least significant first
    cur, used = None, 0
    for k, bits in reversed(keys):
        if cur is not None and used + bits <= 63:
            cur = cur | (k << used)
            used += bits
        else:
            if cur is not None:
                words.append(cur)
            cur, used = k, bits
    words.append(cur)
    perm = torch.argsort(words[0], stable=True)
    for w in words[1:]:
        perm = perm[torch.argsort(w[perm], stable=True)]
    return perm


def _lane_runs(s_lanes: torch.Tensor, s_act: torch.Tensor) -> torch.Tensor:
    """head flags of the runs of equal lanes among active sorted rows."""
    diff = (s_lanes[1:] != s_lanes[:-1]).any(dim=1)
    first = torch.ones((1,), dtype=torch.bool, device=s_act.device)
    return s_act & torch.cat([first, diff | ~s_act[:-1]])


def sort_group(lanes: torch.Tensor, active: torch.Tensor,
               rep_capacity: Optional[int] = None,
               payloads: Tuple[torch.Tensor, ...] = (),
               folded: bool = False, need_codes: bool = True):
    """Returns (SortGroup, sorted_payloads). ``lanes`` (cap, L) int64 u32
    lanes; ``rep_capacity`` bounds the per-distinct-key arrays to R rows
    (runs past R are dropped; the caller flags overflow); ``payloads`` come
    back in sorted order (one gather through ``perm`` each).

    ``folded=True``: the caller already wrote 0xFFFFFFFF into lane 0 of
    every inactive row and guarantees that real lane-0 values never reach
    it (range-packed lanes, the grouper's packed consume), so the separate
    inactive sort key is dropped.

    ``need_codes=False`` skips the per-ORIGINAL-row group ids (``codes`` is
    None): a capacity-sized scatter that the segment reductions
    (``ops/segment``, through head / seg / perm) never read."""
    cap, L = lanes.shape
    R = min(rep_capacity, cap) if rep_capacity else cap
    dev = lanes.device
    lane_keys = [(lanes[:, j], 32) for j in range(L)]
    if folded:
        perm = _lexsort_perm(lane_keys)
        s_lanes = lanes[perm]
        s_active = s_lanes[:, 0] != _FOLD_SENTINEL
    else:
        perm = _lexsort_perm([((~active).long(), 1)] + lane_keys)
        s_lanes = lanes[perm]
        s_active = active[perm]
    s_payloads = tuple(gather_rows(p, perm) for p in payloads)
    head = _lane_runs(s_lanes, s_active)
    seg = (torch.cumsum(head, 0) - 1).to(torch.int32)
    if cap > 0:
        num_unique = torch.where(active.any(), seg[-1] + 1, 0).to(torch.int32)
    else:
        num_unique = torch.zeros((), dtype=torch.int32, device=dev)
    spos = torch.arange(cap, dtype=torch.int32, device=dev)
    ridx = torch.arange(R, dtype=torch.int32, device=dev)
    head_pos_of_seg = _scatter(R, cap, torch.where(head & (seg < R), seg, R)
                               .long(), spos)
    n_active = active.sum(dtype=torch.int32)
    in_use = ridx < num_unique
    # first (min-row) occurrence of each run: the sort is stable, so it is
    # the row at the run's head (the JAX sort is unstable and recovers it
    # with a packed cummax over the run). Runs past R fold into slot R - 1
    # there, so that slot takes the smallest row of all of them.
    if cap > 0:
        rep = perm[head_pos_of_seg.clamp(0, cap - 1).long()]
        rep[R - 1] = torch.where(s_active & (seg >= R - 1), perm, cap).min()
        rep = torch.where(in_use, rep, _I32MAX).to(torch.int32)
    else:
        rep = torch.full((R,), _I32MAX, dtype=torch.int32, device=dev)
    # first-appearance rank: runs ordered by their first original row
    order = torch.argsort(rep, stable=True)          # gid -> seg
    gid_of_seg = torch.zeros((R,), dtype=torch.int32, device=dev)
    gid_of_seg[order] = ridx
    unique_rows = rep[order]
    codes = None
    if need_codes:
        codes_sorted = gid_of_seg[seg.clamp(0, max(R - 1, 0)).long()]
        codes = torch.zeros((cap,), dtype=torch.int32, device=dev)
        codes[perm] = codes_sorted
        codes = torch.where(active, codes, -1)
    head_pos = head_pos_of_seg[order]
    g = SortGroup(perm, s_active, head, seg, codes, gid_of_seg,
                  order.to(torch.int32), unique_rows, head_pos,
                  head_pos_of_seg, n_active, num_unique)
    return g, s_payloads


def sort_distinct(lanes: torch.Tensor, active: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(codes, unique_rows, num_unique): the compact interface of
    unique / value_counts / dictionary_encode (``ops/vector_hash``)."""
    g, _ = sort_group(lanes, active)
    return g.codes, g.unique_rows, g.num_unique


def _merge_sorted(table_lanes, table_gid, lanes, active, pay):
    """Sort table rows (side 0) and other rows (side 1) together by
    (inactive, lanes, side): equal keys form runs with the table row
    first. Returns (s_act, s_lanes, s_gpay, s_pay, head)."""
    S = table_lanes.shape[0]
    P = lanes.shape[0]
    dev = lanes.device
    lanesA = torch.cat([table_lanes, lanes])
    actA = torch.cat([table_gid >= 0, active])
    side = torch.cat([torch.zeros((S,), dtype=torch.int64, device=dev),
                      torch.ones((P,), dtype=torch.int64, device=dev)])
    gpay = torch.cat([table_gid, torch.full((P,), -1, dtype=torch.int32,
                                            device=dev)])
    pay = torch.cat([torch.full((S,), -1, dtype=torch.int32, device=dev),
                     pay])
    L = lanesA.shape[1]
    perm = _lexsort_perm([((~actA).long(), 1)] +
                         [(lanesA[:, j], 32) for j in range(L)] +
                         [(side, 1)])
    s_act = actA[perm]
    s_lanes = lanesA[perm]
    return s_act, s_lanes, gpay[perm], pay[perm], _lane_runs(s_lanes, s_act)


def merge_find(table_lanes: torch.Tensor, table_gid: torch.Tensor,
               probe_lanes: torch.Tensor, probe_active: torch.Tensor
               ) -> torch.Tensor:
    """Sort-merge find: gid per probe row (-1 miss / inactive)."""
    capP = probe_lanes.shape[0]
    piota = torch.arange(capP, dtype=torch.int32, device=probe_lanes.device)
    s_act, _, s_gpay, s_outp, head = _merge_sorted(
        table_lanes, table_gid, probe_lanes, probe_active, piota)
    val = torch.where(s_act, segmented_carry_last(s_gpay, head), -1)
    return _scatter(capP, -1, torch.where(s_outp >= 0, s_outp, capP).long(),
                    val.to(torch.int32))


def merge_insert(table_lanes: torch.Tensor, table_gid: torch.Tensor,
                 num_groups, rep_lanes: torch.Tensor,
                 rep_active: torch.Tensor):
    """Sort-merge INSERT into a lane-SORTED table: new reps get gids
    num_groups + first-appearance rank (rep order IS first-appearance
    order); the returned table is again lane-sorted with pad rows (gid -1)
    at the end.

    Returns (new_table_lanes, new_table_gid, rep_gids (R,), new_count)."""
    S, L = table_lanes.shape
    R = rep_lanes.shape[0]
    dev = rep_lanes.device
    ridx = torch.arange(R, dtype=torch.int32, device=dev)
    s_act, s_lanes, s_gpay, s_ipay, head = _merge_sorted(
        table_lanes, table_gid, rep_lanes, rep_active, ridx)
    carried = segmented_carry_last(s_gpay, head)
    # each rep's existing gid (or -1 new), scattered back to rep order
    found = _scatter(R, -1, torch.where(s_ipay >= 0, s_ipay, R).long(),
                     torch.where(s_act, carried, -1).to(torch.int32))
    is_new = rep_active & (found < 0)
    new_rank = (torch.cumsum(is_new, 0) - 1).to(torch.int32)
    new_count = (new_rank[-1] + 1) if R > 0 else \
        torch.zeros((), dtype=torch.int32, device=dev)
    rep_gids = torch.where(is_new, num_groups + new_rank, found)
    rep_gids = torch.where(rep_active, rep_gids, -1).to(torch.int32)
    # rebuild the sorted table: keep table rows + FIRST new rep of each
    # all-new run (dedup: a run head that is a new rep)
    ipc = s_ipay.clamp(0, max(R - 1, 0)).long()
    is_new_sorted = (s_ipay >= 0) & is_new[ipc] if R > 0 else \
        torch.zeros_like(s_act)
    keep = s_act & ((s_gpay >= 0) | (is_new_sorted & head))
    gid_kept = torch.where(s_gpay >= 0, s_gpay, rep_gids[ipc]) if R > 0 \
        else s_gpay
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep & (pos < S), pos, S)  # overflow rows drop
    new_gid = _scatter(S, -1, pos, gid_kept.to(torch.int32))
    new_lanes = _scatter(S, 0, pos, s_lanes)
    return new_lanes, new_gid, rep_gids, new_count
