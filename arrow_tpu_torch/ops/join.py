"""Hash join (the SwissJoin analog).

Reference: ``cpp/src/arrow/acero/swiss_join.cc`` + ``swiss_join_internal.h``
(build, probe = hash -> early_filter -> find -> materialize, match
bit-vectors for outer joins, ``key_to_payload`` offsets for duplicate keys).
The counterpart of the JAX package's ``ops/join.py`` for fixed-width
columns, with its structure and names: build / spans / expand /
materialize / finish, and the three probe ``impl``s.

  * Build: ONE sort-group pass (``ops/distinct``) over the build side
    yields contiguous payload runs per distinct key, per-seg [start, end)
    spans in sorted-payload space, and the unique key lanes per seg. The
    right-output columns are packed into a (rows, W) plane matrix
    (``ops/planes``) and permuted into run order by one row gather. No
    host read.

  * Probe find, ``impl="packed"`` / ``"packed_u"``: when the build key's
    per-lane value ranges fit 30 bits in all (``BuildState.pack_bits``,
    which the caller reads once after the build), every key packs into ONE
    word (one pass of the ``pack_key_lanes`` kernel). The build sorts by
    the packed key, so ``packed_seg`` ascends with the seg index and the
    find is a binary search of every probe key in it plus one equality
    test. The JAX package sorts build segs and probe rows together by
    (key, side) and forward-fills instead, because a TPU gathers slowly; on
    an NVIDIA H100 80GB HBM3 (700.00 W) that form took 24.238 ms against
    the search's 7.135 ms for 100M probe keys into 2^20 segs
    (``bench_reductions``, ``PERF.md`` section 6). Probe
    keys outside the build's lane ranges clamp to a miss sentinel.

  * ``impl="sort"``, the generic multi-lane find for keys that do not
    pack: seg-ordered build lanes and probe lanes sort together
    (``distinct.merge_find``) and each probe row picks up its seg.

  * Unique build keys (``"packed_u"``, the PK-FK shape, which the caller
    detects from ``num_groups == num_active``): fanout <= 1, so pair
    expansion degenerates to a row COMPACTION: take indices of the kept
    probe rows (``selection.get_take_indices``: the tile-compaction
    kernels on the card), then the materialization below.

  * General fanout: an exclusive prefix sum of the per-row match counts
    gives every probe row its first pair slot; ``rows_of_positions`` maps
    slots back to rows.

  * Materialize: the fixed-width output columns of a side (dictionary
    columns as their indices) pack into ONE (rows, W) plane matrix and
    gather by ROW, then unpack; the other columns gather through
    ``take_arrays``, their pools sized by one host read a side.

  * Outer joins: matched bits are kept in sorted-payload space (per pair)
    plus per-seg group hits; ``finish`` rebases them to original rows.

The output size is bounded by a static ``fanout_capacity`` with a deferred
error flag (``BuildState.error``); running again at a larger capacity is
the caller's recovery. Output row ORDER is unspecified. String and
dictionary keys match by content (``group_key_lanes``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, nulls, resolve_device, row_mask
from ..core.batch import Batch
from ..core.schema import Field, Schema
from .bits import lane_windows
from .cuda_kernels import PACK_MISS, pack_key_lanes
from .distinct import merge_find, sort_group
from .grouper import Grouper, group_key_lane_list, group_key_lanes
from .planes import pack_columns, pack_spec, plane_width, unpack_columns
from .segment import rows_of_positions
from .selection import filter_batch, get_take_indices, take_arrays

__all__ = ["HashJoin", "BuildState", "build_state_from_numpy"]

# packed-key sentinels (> any real packed value, which is < 2^30)
_MISS_B = 0x7FFFFFFF   # inactive build slot
_MISS_P = PACK_MISS    # miss / inactive probe row


@dataclass
class BuildState:
    """Device-side build result. Spans and payload live in SORTED payload
    space (the one sort's output order); ``perm`` maps sorted position ->
    original build row for ``finish``. Lanes and packed keys are u32 values
    in int64 tensors; the payload matrix holds 32-bit words as int32."""

    num_groups: torch.Tensor    # 0-d int32: distinct build keys
    batch: Batch
    starts_seg: torch.Tensor    # (G,) int32 run start (sorted space)
    ends_seg: torch.Tensor      # (G,) int32 run end (exclusive)
    seg_lanes: torch.Tensor     # (G, L) run-head lanes, seg order
    gid_of_seg: torch.Tensor    # (G,) int32 seg -> first-appearance gid
    perm: torch.Tensor          # (cap,) int64 sorted pos -> build row
    bsegs: torch.Tensor         # (cap,) int32 build row -> seg (-1 null)
    matched: torch.Tensor       # (cap,) bool per-pair hits, SORTED space
    matched_seg: torch.Tensor   # (G,) bool group-level hits, seg index
    num_rows: object            # rows of the build batch (int or 0-d)
    num_active: torch.Tensor    # 0-d int32: non-null-key build rows
    error: torch.Tensor         # 0-d int32: nonzero => capacity exceeded
    pack_lo: torch.Tensor       # (L,) per-lane window start
    pack_span: torch.Tensor     # (L,) per-lane window width - 1
    pack_shift: torch.Tensor    # (L,) bit offsets
    pack_bits: torch.Tensor     # 0-d int32: total packed bits
    packed_seg: torch.Tensor    # (G,) packed key per seg, ascending
    payload_mat: Optional[torch.Tensor]     # (cap, WR) planes or None

    def _replace(self, **kw) -> "BuildState":
        return replace(self, **kw)

    def _with_error(self, error) -> "BuildState":
        return replace(self, error=self.error | error)


def build_state_from_numpy(hj: "HashJoin", leaves, device=None
                           ) -> BuildState:
    """The port's ``BuildState`` from a JAX ``BuildState`` whose leaves were
    fetched as numpy (``jax.tree_util.tree_map(np.asarray, bs)``), read by
    attribute, so that a state built by the JAX package can be probed
    here: u32 lanes and packed keys widen to int64, the payload planes
    keep their bits as int32, ``perm`` becomes int64."""
    device = resolve_device(device)

    def t(x, dtype=None):
        x = np.array(x)
        if dtype is not None:
            x = x.astype(dtype)
        return torch.from_numpy(x).to(device)

    jb = leaves.batch
    arrays = [Array(f.type, t(a.values),
                    None if a.validity is None else t(a.validity))
              for f, a in zip(hj.right_schema.fields, jb.arrays)]
    batch = Batch(hj.right_schema, arrays, t(jb.length, np.int32))
    pm = leaves.payload_mat
    return BuildState(
        t(leaves.num_groups), batch, t(leaves.starts_seg),
        t(leaves.ends_seg), t(leaves.seg_lanes, np.int64),
        t(leaves.gid_of_seg), t(leaves.perm, np.int64), t(leaves.bsegs),
        t(leaves.matched), t(leaves.matched_seg), t(leaves.num_rows),
        t(leaves.num_active), t(leaves.error), t(leaves.pack_lo, np.int64),
        t(leaves.pack_span, np.int64), t(leaves.pack_shift, np.int64),
        t(leaves.pack_bits), t(leaves.packed_seg, np.int64),
        None if pm is None else t(np.asarray(pm).view(np.int32)))


def _all_valid(keys: Sequence[Array], cap: int) -> torch.Tensor:
    ok = torch.ones((cap,), dtype=torch.bool, device=keys[0].device)
    for k in keys:
        if k.validity is not None:
            ok = ok & k.validity
    return ok


def _pack_lanes(lanes, lo, span, shift, active=None) -> torch.Tensor:
    """L u32 lanes, an (n, L) matrix or a list of (n,) tensors -> (n,)
    packed keys (u32 values); rows with any lane outside [lo, lo + span],
    and inactive rows, -> _MISS_P (cannot equal any build key). One pass of
    the ``pack_key_lanes`` kernel on the card."""
    if isinstance(lanes, torch.Tensor):
        lanes = lanes.unbind(dim=1)
    return pack_key_lanes(lanes, lo, span, shift, active)


def _filter_columns(b: Batch, names, sel: torch.Tensor, length) -> Batch:
    """The columns ``names`` of the rows of ``b`` that ``sel`` selects. With
    no names the whole batch is filtered for its length."""
    mask = Array(dt.bool_, sel, None, length=length)
    if names:
        return filter_batch(b.select(names), mask)
    return filter_batch(b, mask).select([])


def _mark(size: int, index: torch.Tensor) -> torch.Tensor:
    """(size,) bool, True at every index; index == size is dropped."""
    buf = torch.zeros((size + 1,), dtype=torch.bool, device=index.device)
    return buf.index_fill_(0, index, True)[:size]


class HashJoin:
    """Static-config hash join. Build side = right input (acero
    convention, ``hash_join_node.cc``)."""

    def __init__(self, left_schema: Schema, right_schema: Schema,
                 options):
        from ..acero.options import HashJoinNodeOptions
        assert isinstance(options, HashJoinNodeOptions)
        self.options = options
        self.join_type = options.join_type
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.left_keys = list(options.left_keys)
        self.right_keys = list(options.right_keys)
        key_fields = [right_schema.field(k) for k in self.right_keys]
        self.max_build_rows = options.max_build_rows
        self.grouper = Grouper([f.type for f in key_fields],
                               [f.nullable for f in key_fields],
                               max_groups=options.max_build_rows)

        # [] means "no columns from this side"; only None means all
        self.left_out = options.left_output \
            if options.left_output is not None else list(left_schema.names)
        self.right_out = options.right_output \
            if options.right_output is not None else list(right_schema.names)
        if self.join_type in ("left semi", "left anti"):
            self.right_out = []
        if self.join_type in ("right semi", "right anti"):
            self.left_out = []
        # residual (non-equi) filter: ``acero/options.h:571`` filter,
        # evaluated per matched key pair (``swiss_join.cc``
        # JoinResidualFilter). A pair whose filter comes out false / null
        # is treated as a non-match for every join type.
        self.residual = getattr(options, "filter", None)
        if self.residual is not None and \
                self.residual.kind == self.residual.KIND_LITERAL:
            if self.residual.value.as_py():
                self.residual = None   # literal(true) = no filter
        if self.residual is not None:
            refs = set(self.residual.field_names())
            self._resid_left = [n for n in left_schema.names if n in refs]
            self._resid_right = [n for n in right_schema.names if n in refs]
            dup = set(self._resid_left) & set(self._resid_right)
            if dup:
                raise ValueError(
                    f"hash join filter field(s) {sorted(dup)} exist on "
                    "both sides; rename before the join")
            missing = refs - set(self._resid_left) - set(self._resid_right)
            if missing:
                raise KeyError(
                    f"hash join filter references unknown field(s) "
                    f"{sorted(missing)}")

        right_nullable = self.join_type in ("left outer", "full outer")
        left_nullable = self.join_type in ("right outer", "full outer")
        fields = []
        lsuf = options.output_suffix_for_left
        rsuf = options.output_suffix_for_right
        rnames = set(self.right_out)
        for n in self.left_out:
            f = left_schema.field(n)
            name = n + lsuf if (n in rnames and (lsuf or rsuf)) else n
            fields.append(Field(name, f.type, f.nullable or left_nullable))
        lnames = set(self.left_out)
        for n in self.right_out:
            f = right_schema.field(n)
            name = n + rsuf if (n in lnames and (lsuf or rsuf)) else n
            fields.append(Field(name, f.type, f.nullable or right_nullable))
        self.out_schema = Schema(tuple(fields))

        # the plane-packable output columns of each side gather through
        # its plane matrix; the others through take_arrays
        self._rpack = [n for n in self.right_out
                       if plane_width(right_schema.field(n).type) is not None]
        self._lpack = [n for n in self.left_out
                       if plane_width(left_schema.field(n).type) is not None]

    # ------------------------------------------------------------------
    def build(self, right: Batch) -> BuildState:
        """Insert the (accumulated) build side. One call; use
        ``ops.concat.concat_batches`` upstream for multi-batch builds.

        One sort-group pass yields everything: payload runs in sorted
        space, per-seg [start, end) spans and seg-ordered unique key
        lanes; the right-output plane matrix follows the sort by one row
        gather through its permutation. Nothing is read on the host."""
        cap = right.capacity
        dev = right.device
        keys = [right.column(k) for k in self.right_keys]
        ok = _all_valid(keys, cap)
        lanes = group_key_lanes(keys, self.grouper.key_nullable)
        active = row_mask(cap, right.length, dev) & ok
        G = self.max_build_rows
        R = min(cap, G)
        L = lanes.shape[1]

        # packing spec BEFORE the sort: the build sorts by the PACKED key
        # first (lanes as tiebreakers for the unpackable case), so seg
        # order == packed-key order and ``packed_seg`` ascends. Each lane's
        # window is the tighter of its unsigned and signed one.
        lo, span = lane_windows(lanes, active)
        # bits of a span: the powers of two not above it (no clz in torch)
        pow2 = 1 << torch.arange(32, dtype=torch.int64, device=dev)
        bits = (span[:, None] >= pow2[None, :]).sum(dim=1)
        # shift_j = sum of bits of lanes AFTER j (lane 0 in the top bits)
        shift = torch.flip(torch.cumsum(torch.flip(bits, [0]), 0), [0]) - bits
        pack_bits = bits.sum().to(torch.int32)
        pk_rows = _pack_lanes(lanes, lo, span, shift)
        sort_lanes = torch.cat([pk_rows[:, None], lanes], dim=1)

        g, _ = sort_group(sort_lanes, active, rep_capacity=R)
        sidx = torch.arange(G, dtype=torch.int32, device=dev)
        ridx = sidx[:R]
        capv = torch.full((G - R,), cap, dtype=torch.int32, device=dev)
        starts_seg = torch.cat([g.head_pos_seg, capv])
        nxt = torch.cat([g.head_pos_seg[1:], capv.new_full((1,), cap)])
        in_use_r = ridx < g.num_unique
        ends_r = torch.where(ridx < g.num_unique - 1, nxt, g.n_active)
        ends_r = torch.where(in_use_r, ends_r, g.head_pos_seg)
        ends_seg = torch.cat([ends_r.to(torch.int32), capv])

        # seg-ordered (== packed-key-ordered) unique key lanes: the rows at
        # the run heads, R x L elements gathered through the permutation
        if cap > 0:
            head_rows = g.perm[g.head_pos_seg.clamp(0, cap - 1).long()]
            seg_lanes = torch.where(in_use_r[:, None], lanes[head_rows], 0)
        else:
            seg_lanes = lanes.new_zeros((R, L))
        seg_lanes = torch.cat([seg_lanes, lanes.new_zeros((G - R, L))])
        gid_of_seg = torch.cat([g.gid_of_seg,
                                capv.new_full((G - R,), -1)])

        packed_seg = _pack_lanes(seg_lanes, lo, span, shift)
        packed_seg = torch.where(sidx < g.num_unique, packed_seg, _MISS_B)

        payload_mat = None
        if self._rpack:
            rp_mat, _ = pack_columns([right.column(n) for n in self._rpack])
            payload_mat = rp_mat[g.perm]

        bsegs = torch.where(
            g.codes >= 0,
            g.seg_of_gid[g.codes.clamp(0, max(R - 1, 0)).long()], -1) \
            .to(torch.int32) if R > 0 else g.codes
        matched = torch.zeros((cap,), dtype=torch.bool, device=dev)
        matched_seg = torch.zeros((G,), dtype=torch.bool, device=dev)
        error = (g.num_unique > G).to(torch.int32)
        return BuildState(
            g.num_unique, right, starts_seg, ends_seg, seg_lanes,
            gid_of_seg, g.perm, bsegs, matched, matched_seg, right.length,
            g.n_active, error, lo, span, shift, pack_bits, packed_seg,
            payload_mat)

    # ------------------------------------------------------------------
    def packed_eligible(self) -> bool:
        """Static capacity guard of the packed probe paths (the dynamic
        total-bits check reads ``BuildState.pack_bits``)."""
        return self.max_build_rows < (1 << 26)

    # ------------------------------------------------------------------
    def bloom_build(self, bs: BuildState) -> torch.Tensor:
        """Bloom bitset over the build side's distinct key lanes
        (``bloom_filter.h:42`` BlockedBloomFilter; see ``ops/bloom.py``)."""
        from .bloom import bloom_m_log2, build_bloom
        G = self.max_build_rows
        gidx = torch.arange(G, dtype=torch.int32, device=bs.seg_lanes.device)
        return build_bloom(bs.seg_lanes, gidx < bs.num_groups,
                           bloom_m_log2(G))

    def bloom_mask(self, bits: torch.Tensor, left: Batch) -> Array:
        """bool mask: True where the probe row's key MAY match the build
        side. Null-key / out-of-range rows -> False (they never key-match
        any build row, for every join type)."""
        from .bloom import query_bloom
        cap = left.capacity
        keys = [left.column(k) for k in self.left_keys]
        ok = _all_valid(keys, cap) & left.row_mask()
        lanes = group_key_lanes(keys, self.grouper.key_nullable)
        return Array(dt.bool_, query_bloom(bits, lanes, ok), None,
                     length=left.length)

    def partition_ids(self, b: Batch, side: str, K: int) -> torch.Tensor:
        """Grace-join hash partition per row: hash(normalized key lanes)
        & (K - 1), int32. Both sides use the SAME lane normalization, so
        equal keys always co-partition; null-key rows land
        deterministically."""
        from .bloom import _lane_hashes
        names = self.right_keys if side == "build" else self.left_keys
        keys = [b.column(k) for k in names]
        lanes = group_key_lanes(keys, self.grouper.key_nullable)
        h1, _ = _lane_hashes(lanes)
        return (h1 & (K - 1)).to(torch.int32)

    # ------------------------------------------------------------------
    def _find_packed(self, bs: BuildState, left: Batch,
                     keys: Sequence[Array], ok: torch.Tensor):
        """Packed single-key find in ROW order: (seg, hit), seg the index
        of the build seg whose packed key equals the probe row's (junk
        where not hit). ``packed_seg`` ascends (active segs by key, then
        the inactive sentinel), so a binary search gives the only
        candidate."""
        capP = left.capacity
        G = self.max_build_rows
        # the lanes one by one: no (capP, L) matrix is built to be read once
        lanes_p = group_key_lane_list(keys, self.grouper.key_nullable)
        act_p = left.row_mask() & ok
        packed_p = _pack_lanes(lanes_p, bs.pack_lo, bs.pack_span,
                               bs.pack_shift, act_p)
        del lanes_p
        if G == 0:
            z = torch.zeros((capP,), dtype=torch.int64, device=left.device)
            return z, z.bool()
        seg = torch.searchsorted(bs.packed_seg, packed_p).clamp_(max=G - 1)
        return seg, bs.packed_seg[seg] == packed_p

    def _probe_spans_packed(self, bs: BuildState, left: Batch,
                            keys: Sequence[Array], ok: torch.Tensor,
                            want_seg: bool):
        """Packed find -> (start, cnt, seg) per probe row."""
        seg, hit = self._find_packed(bs, left, keys, ok)
        s = bs.starts_seg[seg]
        start = torch.where(hit, s, -1)
        cnt = torch.where(hit, bs.ends_seg[seg] - s, 0)
        return start, cnt, \
            (torch.where(hit, seg, -1).to(torch.int32) if want_seg else None)

    def _probe_spans_sort(self, bs: BuildState, left: Batch,
                          keys: Sequence[Array], ok: torch.Tensor,
                          want_seg: bool):
        """Generic multi-lane merge find (the fallback when keys do not
        pack): seg-ordered build lanes and probe lanes sort together,
        equal keys group with the build row first, and every probe row
        picks up its seg (``distinct.merge_find``); spans gather per
        row."""
        G = self.max_build_rows
        lanes_p = group_key_lanes(keys, self.grouper.key_nullable)
        act_p = left.row_mask() & ok
        sidx = torch.arange(G, dtype=torch.int32, device=left.device)
        seg = merge_find(bs.seg_lanes,
                         torch.where(sidx < bs.num_groups, sidx, -1),
                         lanes_p, act_p)
        segc = seg.clamp(0, max(G - 1, 0)).long()
        s = bs.starts_seg[segc]
        start = torch.where(seg >= 0, s, -1)
        cnt = torch.where(seg >= 0, bs.ends_seg[segc] - s, 0)
        return start, cnt, (seg if want_seg else None)

    def supports_unique_fast(self) -> bool:
        """Static eligibility for the unique-build compaction probe
        ("packed_u"): the caller additionally verifies (on the host, from
        the build's scalars) that every build key is distinct."""
        return (self.join_type in ("inner", "left outer", "left semi",
                                   "left anti")
                and self.residual is None and self.packed_eligible())

    def _probe_unique_compact(self, bs: BuildState, left: Batch):
        """Unique-build-key probe (the PK-FK join shape): every probe row
        matches at most ONE build row, so pair expansion degenerates to a
        row COMPACTION: the kept rows' take indices (the tile-compaction
        kernels on the card), one row gather per side. No host read. The
        output has the probe batch's capacity: no fanout capacity applies,
        since at most one row leaves per probe row."""
        cap = left.capacity
        keys = [left.column(k) for k in self.left_keys]
        seg, hit = self._find_packed(bs, left, keys, _all_valid(keys, cap))
        jt = self.join_type
        if jt in ("inner", "left semi"):
            keep = hit
        elif jt == "left anti":
            keep = left.row_mask() & ~hit
        else:                       # left outer
            keep = left.row_mask()
        idx = get_take_indices(Array(dt.bool_, keep, None, length=cap))
        r = idx.values.long()
        brow = bvalid = None
        if self.right_out:
            bvalid = hit[r]
            brow = torch.where(bvalid, bs.starts_seg[seg[r]], 0)
        return self._materialize(bs, left, r, brow, bvalid, idx.length), bs

    def _probe_spans(self, bs, left, keys, ok, impl: str, want_seg: bool):
        if impl == "packed" and self.packed_eligible() and \
                bs.batch.capacity < (1 << 26) and \
                left.capacity < (1 << 27):
            return self._probe_spans_packed(bs, left, keys, ok, want_seg)
        return self._probe_spans_sort(bs, left, keys, ok, want_seg)

    # ------------------------------------------------------------------
    def probe(self, bs: BuildState, left: Batch,
              fanout_capacity: Optional[int] = None,
              impl: str = "sort"
              ) -> Tuple[Optional[Batch], BuildState]:
        """Probe one batch. Returns (output batch or None for right-side
        joins, updated build state). "packed" uses the single-key packed
        find (valid only when the caller verified ``BuildState.pack_bits
        <= 30`` on the host), "packed_u" the unique-build compaction on
        top of it (the caller also verified unique build keys), "sort" the
        generic multi-lane find."""
        if impl == "packed_u" and self.supports_unique_fast():
            return self._probe_unique_compact(bs, left)
        if impl == "packed_u":
            impl = "packed"
        cap = left.capacity
        keys = [left.column(k) for k in self.left_keys]
        ok = _all_valid(keys, cap)
        in_range = left.row_mask()
        jt = self.join_type
        want_seg = jt in ("right semi", "right anti", "right outer",
                          "full outer")
        start, cnt, seg = self._probe_spans(bs, left, keys, ok, impl,
                                            want_seg)

        if jt in ("left semi", "left anti"):
            if self.residual is None:
                sel = (cnt > 0) if jt == "left semi" else \
                    (in_range & (cnt == 0))
            else:
                pass_any, err = self._pass_any(bs, left, start, cnt,
                                               fanout_capacity)
                bs = bs._with_error(err)
                sel = pass_any if jt == "left semi" else \
                    (in_range & ~pass_any)
            out = _filter_columns(left, self.left_out, sel, left.length)
            return self._rename(out), bs

        if jt in ("right semi", "right anti", "right outer"):
            if self.residual is None:
                bs = self._update_matched_seg(bs, seg, cnt)
            else:
                bs = self._update_matched_residual(bs, left, start, cnt,
                                                   fanout_capacity)
            if jt == "right outer":
                return self._expand(bs, left, start, cnt, fanout_capacity,
                                    emit_unmatched_probe=False,
                                    update_matched=False)
            return None, bs

        if jt == "full outer":
            if self.residual is None:
                bs = self._update_matched_seg(bs, seg, cnt)
                return self._expand(bs, left, start, cnt, fanout_capacity,
                                    emit_unmatched_probe=True,
                                    update_matched=False)
            return self._expand(bs, left, start, cnt, fanout_capacity,
                                emit_unmatched_probe=True,
                                update_matched=True)

        return self._expand(bs, left, start, cnt, fanout_capacity,
                            emit_unmatched_probe=jt == "left outer",
                            update_matched=False)

    def _update_matched_seg(self, bs: BuildState, seg, cnt) -> BuildState:
        """Group-level matched update (no residual): every build row of a
        probed seg is matched."""
        G = self.max_build_rows
        hit = _mark(G, torch.where((seg >= 0) & (cnt > 0), seg, G).long())
        return bs._replace(matched_seg=bs.matched_seg | hit)

    # ------------------------------------------------------------------
    def _pair_geometry(self, bs: BuildState, left: Batch, start, cnt,
                       fanout_capacity, emit_unmatched_probe: bool):
        """Expand (probe row, span) matches into flat pair slots.

        Returns (r, o, brow_sorted, has_match, valid_j, pass_, total,
        overflow): ``r`` probe row per slot, ``o`` the match ordinal,
        ``brow_sorted`` the build row in SORTED payload space, ``pass_``
        = has_match AND the residual filter (``swiss_join.cc``
        JoinResidualFilter semantics).

        Every row's first slot is the exclusive prefix sum of the emit
        counts; ``rows_of_positions`` maps the T slots back to their rows
        (one scatter of the non-empty rows and one cumsum)."""
        cap = left.capacity
        dev = left.device
        T = fanout_capacity or self.options.fanout_capacity or cap
        in_range = left.row_mask()
        cnt = torch.where(in_range, cnt, 0)
        emit = cnt
        if emit_unmatched_probe:
            emit = torch.where(in_range & (cnt == 0), 1, cnt)
        ends = torch.cumsum(emit, 0)
        offsets = ends - emit                      # exclusive prefix sum
        total = ends[-1].to(torch.int32) if cap > 0 else \
            torch.zeros((), dtype=torch.int32, device=dev)
        overflow = (total > T).to(torch.int32)
        jidx = torch.arange(T, dtype=torch.int64, device=dev)
        bcap = bs.batch.capacity

        # slots past T do not exist: rows that start there emit nothing
        off = torch.cat([ends.new_zeros((1,)), ends]).clamp_(max=T)
        r_of_j = rows_of_positions(off, T)
        valid_j = (jidx < total) & (r_of_j >= 0)
        r = r_of_j.clamp(0, max(cap - 1, 0)).long()
        o = jidx - offsets[r]
        cnt_r = cnt[r]
        has_match = valid_j & (cnt_r > 0) & (o < cnt_r)
        brow_sorted = (start[r] + o).clamp(0, max(bcap - 1, 0))
        brow_sorted = torch.where(has_match, brow_sorted, 0)

        pass_ = has_match
        if self.residual is not None:
            pass_ = has_match & self._residual_pass(
                bs, left, r, brow_sorted, has_match, total)
        return r, o, brow_sorted, has_match, valid_j, pass_, total, \
            overflow

    def _residual_pass(self, bs: BuildState, left: Batch, r, brow_sorted,
                       has_match, total) -> torch.Tensor:
        """Evaluate the residual filter on the materialized pairs; null
        results count as false (Arrow filter-null semantics)."""
        from ..compute.expressions import execute_scalar_expression
        from ..compute.scalar import Scalar
        T = r.shape[0]
        brow = bs.perm[brow_sorted]
        left_idx = Array(dt.int64, r, None, length=total)
        right_idx = Array(dt.int64, brow, None, length=total)
        fields = [self.left_schema.field(n) for n in self._resid_left] + \
            [self.right_schema.field(n) for n in self._resid_right]
        arrays = take_arrays([left.column(n) for n in self._resid_left],
                             left_idx)
        for a in take_arrays([bs.batch.column(n)
                              for n in self._resid_right], right_idx):
            v = a.validity
            arrays.append(a.with_validity(
                has_match if v is None else (v & has_match)))
        pb = Batch(Schema(tuple(fields)), arrays, total)
        res = execute_scalar_expression(self.residual, pb)
        if isinstance(res, Scalar):
            ok = bool(res.is_valid) and bool(res.as_py())
            return torch.full((T,), ok, dtype=torch.bool, device=r.device)
        pv = res.values.to(torch.bool)
        if res.validity is not None:
            pv = pv & res.validity
        return pv

    def _pass_any(self, bs: BuildState, left: Batch, start, cnt,
                  fanout_capacity):
        """(probe row -> any pair passes the residual filter, overflow)."""
        cap = left.capacity
        r, o, brow, has_match, valid_j, pass_, total, overflow = \
            self._pair_geometry(bs, left, start, cnt, fanout_capacity,
                                emit_unmatched_probe=False)
        return _mark(cap, torch.where(pass_, r, cap)), overflow

    def _update_matched_residual(self, bs: BuildState, left: Batch, start,
                                 cnt, fanout_capacity) -> BuildState:
        """Per-pair matched update: with a residual filter a build ROW is
        matched only if one of its own pairs passed (group-level hit
        tracking is not enough). Matched bits live in SORTED space."""
        r, o, brow, has_match, valid_j, pass_, total, overflow = \
            self._pair_geometry(bs, left, start, cnt, fanout_capacity,
                                emit_unmatched_probe=False)
        bcap = bs.batch.capacity
        matched = bs.matched | _mark(bcap, torch.where(pass_, brow, bcap))
        return bs._replace(matched=matched, error=bs.error | overflow)

    # ------------------------------------------------------------------
    def _materialize(self, bs: BuildState, left: Batch, r, brow_sorted,
                     bvalid, total) -> Batch:
        """Gather the output columns: ONE packed row gather per side for
        the plane-packable columns, ``take_arrays`` of the others (one
        host read of their pools' sizes per side). ``r``: probe row
        per output row; ``brow_sorted``: build row in sorted payload space;
        ``bvalid``: the output row has a build row (else its right columns
        are null)."""
        T = r.shape[0]
        cols = {}
        if self._lpack:
            lmat, lspec = pack_columns([left.column(n) for n in self._lpack])
            for n, a in zip(self._lpack, unpack_columns(
                    lmat[r], lspec, total,     # (T, WL) row gather
                    dictionaries=[left.column(n).dictionary
                                  for n in self._lpack])):
                cols[("l", n)] = a
        if self._rpack:
            rcols = [bs.batch.column(n) for n in self._rpack]
            for n, a in zip(self._rpack, unpack_columns(
                    bs.payload_mat[brow_sorted], pack_spec(rcols), total,
                    extra_valid=bvalid,        # (T, WR) row gather
                    dictionaries=[c.dictionary for c in rcols])):
                cols[("r", n)] = a
        rest = [n for n in self.left_out if ("l", n) not in cols]
        if rest:
            left_idx = Array(dt.int64, r, None, length=total)
            cols.update(zip((("l", n) for n in rest), take_arrays(
                [left.column(n) for n in rest], left_idx)))
        rest = [n for n in self.right_out if ("r", n) not in cols]
        if rest:
            bcap = bs.batch.capacity
            brow = bs.perm[brow_sorted.clamp(0, max(bcap - 1, 0))]
            right_idx = Array(dt.int64, brow, None, length=total)
            for n, a in zip(rest, take_arrays(
                    [bs.batch.column(n) for n in rest], right_idx)):
                v = a.validity
                cols[("r", n)] = a.with_validity(
                    bvalid if v is None else (v & bvalid))
        arrays = [cols[("l", n)] for n in self.left_out] + \
            [cols[("r", n)] for n in self.right_out]
        return Batch(self.out_schema, arrays, total)

    def _expand(self, bs: BuildState, left: Batch, start, cnt,
                fanout_capacity, emit_unmatched_probe: bool,
                update_matched: bool):
        cap = left.capacity
        r, o, brow_sorted, has_match, valid_j, pass_, total, overflow = \
            self._pair_geometry(bs, left, start, cnt, fanout_capacity,
                                emit_unmatched_probe)
        error = bs.error | overflow
        out = self._materialize(bs, left, r, brow_sorted, pass_, total)

        if self.residual is not None:
            # drop pairs the filter rejected; probe rows whose every pair
            # failed fall back to a single null-right emission for
            # left / full outer (JoinResidualFilter outer semantics)
            keep = pass_ | (valid_j & ~has_match)
            if emit_unmatched_probe:
                pass_any = _mark(cap, torch.where(pass_, r, cap))
                keep = keep | (valid_j & has_match & (o == 0) &
                               ~pass_any[r])
            out = filter_batch(out, Array(dt.bool_, keep, None,
                                          length=total))

        if update_matched:
            bcap = bs.batch.capacity
            matched = bs.matched | _mark(
                bcap, torch.where(pass_, brow_sorted, bcap))
            bs = bs._replace(matched=matched, error=error)
        else:
            bs = bs._with_error(overflow)
        return out, bs

    # ------------------------------------------------------------------
    def finish(self, bs: BuildState) -> Optional[Batch]:
        """Emit trailing rows for right-side join types."""
        jt = self.join_type
        if jt not in ("right outer", "full outer", "right semi",
                      "right anti"):
            return None
        cap = bs.batch.capacity
        dev = bs.perm.device
        G = self.max_build_rows
        # matched bits: per-pair (sorted space) -> original rows, plus
        # group-level seg hits
        m_orig = torch.zeros((cap,), dtype=torch.bool, device=dev)
        m_orig[bs.perm] = bs.matched
        seg_hit = (bs.bsegs >= 0) & \
            bs.matched_seg[bs.bsegs.clamp(0, max(G - 1, 0)).long()] \
            if G > 0 else torch.zeros_like(m_orig)
        matched = m_orig | seg_hit
        if jt == "right semi":
            sel = matched
        else:
            sel = ~matched & row_mask(cap, bs.num_rows, dev)
        picked = _filter_columns(bs.batch, self.right_out, sel, bs.num_rows)
        n_out = picked.length
        arrays = []
        for n in self.left_out:
            t = self.left_schema.field(n).type
            arrays.append(nulls(0, t, capacity=cap, device=dev)
                          .with_length(n_out))
        for n in self.right_out:
            arrays.append(picked.column(n))
        return Batch(self.out_schema, arrays, n_out)

    def _rename(self, b: Batch) -> Batch:
        return Batch(self.out_schema, b.arrays, b.length, b.index)
