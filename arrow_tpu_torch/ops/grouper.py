"""Grouper: sort-based grouping into persistent first-appearance group ids.

Reference contract: ``cpp/src/arrow/compute/row/grouper.h:105`` — Consume
(keys) -> dense group ids in ORDER OF FIRST APPEARANCE, persisting across
calls; GetUniques() returns the unique key rows in group-id order. The
counterpart of the JAX package's ``ops/grouper.py``:

  1. Keys normalize to u32 lanes (raw bits + a validity lane per nullable
     column), held as int64 (``ops/bits.py``). Group equality is Arrow's
     byte equality: -0.0 != 0.0, NaN == NaN, null == null.
  2. One lexicographic sort groups the batch's equal keys
     (ops/distinct.sort_group); its unique representatives then
     sort-merge into the persistent lane-sorted table
     (ops/distinct.merge_insert): existing keys pick up their gid, new keys
     get num_groups + rank. On an empty state (``first``) the table builds
     directly from the batch's sort, and ``pack`` range-packs the key
     lanes into fewer sort keys.

The JAX package lets the original lanes ride the sort as payloads and
scatters each run's head row into the rep table, because a TPU gather is
slow; here the R rep rows are gathered through ``perm`` at the run heads
(R x L elements instead of cap x L), which gives the same rows.

String keys (varlen, or dictionary by its values' content) key by
``ops/hashing``'s content lanes: 5 lanes a column. Their unique values
live in fixed byte slots (``SlotStrings``) until finalize.

Overflow (more groups than capacity) sets ``state.error`` (a deferred
error, checked at the host boundary).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import datatype as dt
from ..core.array import Array, resolve_device, row_mask
from .bits import U32, as_signed_bits, gather_rows, value_lanes32
from .distinct import _FOLD_SENTINEL, merge_insert, sort_group

__all__ = ["Grouper", "GrouperState", "SlotStrings", "group_key_lanes",
           "group_key_lane_list"]


@dataclass
class SlotStrings:
    """Per-group varlen key uniques in fixed byte slots: the analog of the
    reference row table's varbinary region (``row_internal.h:33``). Each
    group's key bytes live in a ``(G, W)`` slot, true lengths apart;
    ``to_array`` compacts them to a varlen Array at finalize. A string
    longer than W sets the deferred ``error`` (2); the recovery is a run
    with a larger ``varlen_slot_bytes``."""

    slots: torch.Tensor     # (G, W) uint8
    lens: torch.Tensor      # (G,) int32 true byte length
    valid: torch.Tensor     # (G,) bool
    error: torch.Tensor     # 0-d int32, nonzero = slot overflow

    @classmethod
    def init(cls, num_groups: int, slot_bytes: int, device) -> "SlotStrings":
        return cls(torch.zeros((num_groups, slot_bytes), dtype=torch.uint8,
                               device=device),
                   torch.zeros((num_groups,), dtype=torch.int32,
                               device=device),
                   torch.zeros((num_groups,), dtype=torch.bool,
                               device=device),
                   torch.zeros((), dtype=torch.int32, device=device))

    def scatter_from(self, src: Array, rows: torch.Tensor,
                     pos: torch.Tensor) -> "SlotStrings":
        """Write src row ``rows[i]``'s bytes into slot ``pos[i]`` (pos >= G
        is dropped)."""
        G, W = self.slots.shape
        dev = self.slots.device
        cap = src.capacity
        rows = rows.clamp(0, max(cap - 1, 0)).long()
        starts = src.offsets[rows]
        lens = src.offsets[rows + 1] - starts
        bcap = src.values.shape[0]
        col = torch.arange(W, dtype=torch.int32, device=dev)
        if bcap == 0:
            block = torch.zeros((rows.shape[0], W), dtype=torch.uint8,
                                device=dev)
        else:
            idx = (starts[:, None] + col[None, :]).clamp_(0, bcap - 1)
            block = src.values.index_select(0, idx.reshape(-1)) \
                .reshape(-1, W).masked_fill_(col[None, :] >= lens[:, None],
                                             0)
        pos = pos.clamp(max=G).long()
        written = pos < G
        valid_src = src.validity_or_true()[rows]

        def put(buf, x):
            return torch.cat([buf, buf[:1]]).index_copy_(0, pos, x)[:G]

        error = self.error | torch.where(
            (written & (lens > W)).any(), 2, 0).to(torch.int32)
        return SlotStrings(put(self.slots, block),
                           put(self.lens, lens.to(torch.int32)),
                           put(self.valid, valid_src), error)

    def to_array(self, type: dt.DataType, length=None) -> Array:
        """The slots as a varlen Array (pool capacity G * W)."""
        from .selection import _gather_bytes
        G, W = self.slots.shape
        dev = self.slots.device
        lens = torch.clamp(self.lens, max=W)
        offsets = torch.cat([lens.new_zeros((1,)),
                             torch.cumsum(lens, 0, dtype=torch.int32)])
        starts = torch.arange(G, dtype=torch.int32, device=dev) * W
        pool = _gather_bytes(self.slots.reshape(-1), starts, offsets,
                             max(G * W, 1))
        return Array(type, pool, self.valid, length=length, offsets=offsets)


def _raw_lanes(a: Array) -> List[torch.Tensor]:
    """Key column -> u32 lanes (int64) of bit equality. A varlen key: its
    length and 4 content lanes (``hashing.varlen_content_lanes``); a
    dictionary key: the content lanes of its values, not its codes, which
    are only comparable under one dictionary."""
    if a.type.is_varlen:
        from .hashing import varlen_content_lanes
        return varlen_content_lanes(a)
    if isinstance(a.type, dt.DictionaryType):
        from .hashing import dict_content_lanes
        return dict_content_lanes(a)
    return value_lanes32(a.values, a.type)


def group_key_lane_list(columns: Sequence[Array],
                        nullable: Optional[Sequence[bool]] = None
                        ) -> List[torch.Tensor]:
    """The L columns of ``group_key_lanes``'s matrix as separate (capacity,)
    tensors, for a caller that reads them one by one."""
    lanes = []
    for i, c in enumerate(columns):
        is_nullable = c.validity is not None if nullable is None \
            else nullable[i]
        col_lanes = _raw_lanes(c)
        if c.validity is not None:
            ok = c.validity
            col_lanes = [torch.where(ok, l, 0) for l in col_lanes]
            lanes.append(ok.long())
        elif is_nullable:
            lanes.append(torch.ones_like(col_lanes[0]))
        lanes.extend(col_lanes)
    return lanes


def group_key_lanes(columns: Sequence[Array],
                    nullable: Optional[Sequence[bool]] = None
                    ) -> torch.Tensor:
    """(capacity, L) int64 u32-lane matrix. Value lanes of null rows are
    zeroed (canonical) and a validity lane distinguishes null from zero."""
    return torch.stack(group_key_lane_list(columns, nullable), dim=1)


@dataclass
class GrouperState:
    """Persistent grouping table.

    table_lanes: (S, L) int64 u32 lanes of inserted unique keys (lane-sorted)
    table_gid:   (S,) int32 group id per slot, -1 empty
    num_groups:  0-d int32
    error:       0-d int32 — nonzero => table overflow
    """

    table_lanes: torch.Tensor
    table_gid: torch.Tensor
    num_groups: torch.Tensor
    error: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.table_gid.shape[0]


class Grouper:
    """Static-config grouping engine over fixed-width normalized keys.

    max_groups: capacity for distinct keys (the sorted table's size).
    """

    def __init__(self, key_types: Sequence[dt.DataType],
                 key_nullable: Sequence[bool],
                 max_groups: int = 1 << 16, varlen_slot_bytes: int = 64):
        self.key_types = tuple(key_types)
        self.key_nullable = tuple(key_nullable)
        self.max_groups = max_groups
        # byte-slot width of varlen key uniques; longer keys set a
        # deferred error
        self.varlen_slot_bytes = varlen_slot_bytes
        self.table_size = max_groups
        self.num_lanes = 0
        for t, nb in zip(self.key_types, self.key_nullable):
            if t.is_varlen:
                width = 5
            elif isinstance(t, dt.DictionaryType):
                from .hashing import dict_value_lane_width
                width = dict_value_lane_width(t)
            elif isinstance(t, dt.DecimalType) and t.wide:
                width = 4          # two limbs
            else:
                width = 2 if t.is_primitive and t.bit_width == 64 else 1
            self.num_lanes += width + (1 if nb else 0)

    def init_state(self, device=None) -> GrouperState:
        device = resolve_device(device)
        S = self.table_size
        return GrouperState(
            table_lanes=torch.zeros((S, self.num_lanes), dtype=torch.int64,
                                    device=device),
            table_gid=torch.full((S,), -1, dtype=torch.int32, device=device),
            num_groups=torch.zeros((), dtype=torch.int32, device=device),
            error=torch.zeros((), dtype=torch.int32, device=device),
        )

    def _lanes_and_active(self, keys: Sequence[Array], length, active,
                          lanes=None):
        cap = keys[0].capacity
        if length is None:
            length = keys[0].length
        if lanes is None:
            lanes = group_key_lanes(keys, self.key_nullable)
        in_range = row_mask(cap, length, lanes.device)
        if active is not None:
            in_range = in_range & active
        return lanes, in_range

    def consume(self, state: GrouperState, keys: Sequence[Array],
                length=None, active=None
                ) -> Tuple[GrouperState, torch.Tensor]:
        """Insert key rows; return (new_state, group_ids int32 (capacity,)).
        Padding / inactive rows get group id -1."""
        lanes, in_range = self._lanes_and_active(keys, length, active)
        return self._consume_lanes(state, lanes, in_range)

    def consume_with_group(self, state: GrouperState,
                           keys: Sequence[Array], length=None, active=None,
                           payloads=(), pack=None, first: bool = False,
                           need_codes: bool = True, lanes=None):
        """Like consume, but returns (new_state, rep_gids, SortGroup,
        sorted_payloads) so callers can run segment-reduction aggregation
        over the sorted batch (ops/segment) instead of row scatters.

        ``pack``: optional (lo, shift, outmap, K, fold) range-packing of the
        L key lanes into K < L sort lanes; lo / shift / outmap are (L,)
        tensors on the keys' device (no host read), K and fold Python
        values. Valid only when the caller verified on the host that the
        per-bin bit totals fit (``HashAggregate.probe_route``). The
        persistent table always stores the ORIGINAL lanes: packing only
        shrinks this batch's sort key.

        ``first``: the state is known empty, so the batch-local
        first-appearance ids ARE the persistent gids and the (S + R)-row
        merge-insert sort is skipped: the lane-sorted table builds directly
        from this batch's sort. ``lanes``: the keys' ``group_key_lanes``
        when the caller has them already."""
        lanes, in_range = self._lanes_and_active(keys, length, active, lanes)
        return self.consume_lanes_grouped(state, lanes, in_range,
                                          payloads=payloads, pack=pack,
                                          first=first, need_codes=need_codes)

    def consume_lanes_grouped(self, state: GrouperState,
                              lanes: torch.Tensor, active: torch.Tensor,
                              payloads=(), pack=None, first: bool = False,
                              need_codes: bool = True):
        """(new_state, rep_gids (R,), SortGroup, sorted_payloads): rep_gids
        maps the batch-local first-appearance ids to persistent group ids.
        See ``consume_with_group`` for pack / first / need_codes."""
        cap, L = lanes.shape
        R = min(cap, self.table_size)
        dev = lanes.device
        folded = False
        sort_lanes = lanes
        if pack is not None:
            lo, shift, outmap, K, fold = pack
            lo, shift, outmap = (x.to(dev) for x in (lo, shift, outmap))
            cols = []
            for k in range(K):
                pk = torch.zeros((cap,), dtype=torch.int64, device=dev)
                for j in range(L):
                    # u32 arithmetic in int64: wrap after subtract and shift
                    d = (lanes[:, j] - lo[j]) & U32
                    pk |= torch.where(outmap[j] == k, (d << shift[j]) & U32,
                                      0)
                cols.append(pk)
            if fold:
                cols[0] = torch.where(active, cols[0], _FOLD_SENTINEL)
                folded = True
            sort_lanes = torch.stack(cols, dim=1)
        g, s_payloads = sort_group(sort_lanes, active, rep_capacity=R,
                                   payloads=tuple(payloads), folded=folded,
                                   need_codes=need_codes)
        del sort_lanes
        ridx = torch.arange(R, dtype=torch.int32, device=dev)
        rep_active = ridx < torch.clamp(g.num_unique, max=R)

        def head_lanes(head_pos, in_use):
            """(n, L) original lanes of the rows at sorted positions
            ``head_pos`` (cap = none), zero where not in use."""
            rows = g.perm[head_pos.clamp(0, max(cap - 1, 0)).long()]
            return torch.where(in_use[:, None], lanes[rows], 0)

        if first:
            S = self.table_size
            rep_gids = torch.where(rep_active, ridx, -1).to(torch.int32)
            # lane-sorted table directly from this batch's sort: run s in
            # slot s
            table_lanes = torch.zeros((S, L), dtype=torch.int64, device=dev)
            table_lanes[:R] = head_lanes(g.head_pos_seg, rep_active)
            gid_pad = torch.full((S,), -1, dtype=torch.int32, device=dev)
            gid_pad[:R] = torch.where(ridx < g.num_unique, g.gid_of_seg, -1)
            num_groups = torch.clamp(g.num_unique, max=R)
            error = state.error | torch.where(
                g.num_unique > self.max_groups, 1, 0).to(torch.int32)
            new_state = GrouperState(table_lanes, gid_pad, num_groups, error)
        else:
            # rep lanes in first-appearance (gid) order
            rep_lanes = head_lanes(g.head_pos, rep_active)
            new_state, rep_gids = self._consume_lanes_table(state, rep_lanes,
                                                            rep_active)
        overflow = torch.where(g.num_unique > R, 4, 0).to(torch.int32)
        new_state = GrouperState(new_state.table_lanes, new_state.table_gid,
                                 new_state.num_groups,
                                 new_state.error | overflow)
        return new_state, rep_gids, g, s_payloads

    def _consume_lanes(self, state: GrouperState, lanes: torch.Tensor,
                       active: torch.Tensor
                       ) -> Tuple[GrouperState, torch.Tensor]:
        """``consume`` of ready key lanes ((cap, L) int64 u32 lanes):
        (new_state, group id per row, -1 where inactive). The count-distinct
        merge replays another pair table's rows through it."""
        state, rep_gids, g, _ = self.consume_lanes_grouped(state, lanes,
                                                           active)
        R = rep_gids.shape[0]
        row_gids = torch.where(
            g.codes >= 0, rep_gids[g.codes.clamp(0, max(R - 1, 0)).long()],
            -1)
        return state, row_gids.to(torch.int32)

    def _consume_lanes_table(self, state: GrouperState, lanes: torch.Tensor,
                             active: torch.Tensor):
        """Insert unique key reps into the SORTED table via one sort-merge
        (ops/distinct.merge_insert)."""
        new_lanes, new_gid, rep_gids, new_count = merge_insert(
            state.table_lanes, state.table_gid, state.num_groups,
            lanes, active)
        num_groups = state.num_groups + new_count
        error = state.error | torch.where(num_groups > self.max_groups,
                                          1, 0).to(torch.int32)
        return (GrouperState(new_lanes, new_gid, num_groups, error),
                rep_gids)

    def uniques_scatter_reps(self, keys: Sequence[Array], g, rep_gids,
                             uniques: Optional[Sequence[Array]] = None
                             ) -> List[Array]:
        """uniques_scatter specialized to first-appearance representatives:
        one write per distinct key (unique indices), not per row."""
        cap = keys[0].capacity
        R = rep_gids.shape[0]
        dev = rep_gids.device
        rep_rows = g.unique_rows[:R].clamp(0, max(cap - 1, 0)).long()
        ridx = torch.arange(R, dtype=torch.int32, device=dev)
        rep_active = ridx < torch.clamp(g.num_unique, max=R)
        pos = torch.where(rep_active & (rep_gids >= 0), rep_gids,
                          self.max_groups).long()
        out = []
        for i, k in enumerate(keys):
            if k.type.is_varlen:
                out.append(self._slots(uniques, i, k.device)
                           .scatter_from(k, rep_rows, pos))
                continue
            out.append(self._scatter_unique(
                k, uniques, i, pos, gather_rows(k.values, rep_rows),
                k.validity_or_true()[rep_rows]))
        return out

    def _slots(self, uniques, i: int, device) -> SlotStrings:
        return uniques[i] if uniques is not None else \
            SlotStrings.init(self.max_groups, self.varlen_slot_bytes, device)

    def _scatter_unique(self, k: Array, uniques, i: int, pos: torch.Tensor,
                        vals_src: torch.Tensor, valid_src: torch.Tensor
                        ) -> Array:
        """Key column ``i``'s unique buffer (max_groups rows) with
        ``vals_src`` / ``valid_src`` written at ``pos``; positions from
        max_groups up are dropped. A dictionary key's buffer holds indices
        into this batch's dictionary (neither package unifies dictionaries
        across batches: ROADMAP C24)."""
        G = self.max_groups
        # gids past a full table (the error flag is set) are dropped
        pos = torch.clamp(pos, max=G)
        if uniques is None:
            vals = torch.zeros((G,) + tuple(k.values.shape[1:]),
                               dtype=k.values.dtype, device=k.device)
            valid = torch.zeros((G,), dtype=torch.bool, device=k.device)
        else:
            vals = uniques[i].values
            valid = uniques[i].validity_or_true()
        # wide unsigned keys move as their signed bits (no index_copy_)
        vals = torch.cat([as_signed_bits(vals), as_signed_bits(vals[:1])]) \
            .index_copy_(0, pos, as_signed_bits(vals_src))[:G] \
            .view(vals.dtype)
        valid = torch.cat([valid, valid[:1]]).index_copy_(
            0, pos, valid_src)[:G]
        return Array(k.type, vals, valid, dictionary=k.dictionary)

    def uniques_scatter(self, keys: Sequence[Array],
                        group_ids: torch.Tensor,
                        uniques: Optional[Sequence[Array]] = None
                        ) -> List[Array]:
        """Scatter this batch's key values into per-group unique buffers
        (GetUniques building block); capacity = max_groups. Rows with a
        negative group id go to the dump slot."""
        pos = torch.where(group_ids >= 0, group_ids, self.max_groups).long()
        rows = torch.arange(group_ids.shape[0], device=group_ids.device)
        return [self._slots(uniques, i, k.device).scatter_from(k, rows, pos)
                if k.type.is_varlen else
                self._scatter_unique(k, uniques, i, pos, k.values,
                                     k.validity_or_true())
                for i, k in enumerate(keys)]
