"""Sort kernels: sort_indices / rank / select_k / partition_nth.

Reference: ``vector_sort.cc:911`` (SortIndicesMetaFunction),
``vector_array_sort.cc`` (single-array sorters), the multi-key
``RadixRecordBatchSorter`` (``vector_sort.cc:391``), null partitioning
(``vector_sort_internal.h:173-233``). The counterpart of the JAX package's
``ops/sorting.py``.

Arrow's radix sorter normalizes keys to a byte-comparable encoding; so does
this module, in whole words: every key column becomes u32 lanes whose
unsigned lexicographic order is the column's sort order (sign flip for
integers, the IEEE bit trick for floats), plus a null lane for null
placement and a leading padding lane that pushes rows >= length to the very
end. The JAX package hands all lanes to one multi-operand stable
``lax.sort``; ``torch.sort`` takes one key, so the lanes pack into as few
int64 words as they fit (``distinct._lexsort_perm``: the pad and null lanes
take one bit each, a value lane 32) and one stable sort runs per word, least
significant first. Both sorts are stable, so the permutations are equal
index for index.

Semantics matched to Arrow:
  * stable (equal keys keep input order)
  * NaN sorts between the numbers and the nulls, ascending or
    descending: after the numbers at_end, before them at_start
  * null_placement at_start / at_end applies per batch, independent of
    ascending / descending
  * varlen (string / binary) keys sort by unsigned bytes: big-endian u32
    prefix words, then the length. The order is exact up to the prefix
    (``varlen_words`` words, default 32 bytes); the plan's order_by reads
    the longest key once on the host and widens the prefix to it
  * dictionary keys sort by the rank of their value in the sorted
    dictionary (``vector_array_sort.cc:179``)
"""

from __future__ import annotations

from dataclasses import dataclass
import os
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import datatype as dt
from ..core.array import Array, row_mask
from ..core.batch import Batch
from ..compute.registry import Kind, NullHandling, register_function
from .bits import U32, as_signed_bits, ascending_lanes32
from .distinct import _lexsort_perm
from .segment import _scatter

__all__ = ["SortKey", "SortOptions", "ArraySortOptions", "SelectKOptions",
           "RankOptions", "PartitionNthOptions", "sort_indices_batch",
           "sort_indices_array", "sortable_lanes", "batch_key_lanes",
           "merge_key_lanes", "lex_leq"]


@dataclass(frozen=True)
class SortKey:
    name: str
    order: str = "ascending"  # ascending | descending


def _sort_keys(sort_keys) -> List[SortKey]:
    """SortKeys from SortKeys or (name, order) pairs; a bare order string
    (pyarrow's ``RankOptions(sort_keys="descending")``) is one key with
    that order."""
    if isinstance(sort_keys, str):
        return [SortKey("", sort_keys)]
    return [k if isinstance(k, SortKey) else SortKey(*k) for k in sort_keys]


class SortOptions:
    def __init__(self, sort_keys: Sequence, null_placement: str = "at_end"):
        self.sort_keys = _sort_keys(sort_keys)
        assert null_placement in ("at_start", "at_end")
        self.null_placement = null_placement


class ArraySortOptions:
    def __init__(self, order: str = "ascending",
                 null_placement: str = "at_end"):
        self.order = order
        self.null_placement = null_placement


class SelectKOptions:
    def __init__(self, k: int, sort_keys: Sequence):
        self.k = k
        self.sort_keys = _sort_keys(sort_keys)


class RankOptions:
    def __init__(self, sort_keys: Sequence = (), null_placement="at_end",
                 tiebreaker: str = "first"):
        self.sort_keys = _sort_keys(sort_keys)
        self.null_placement = null_placement
        assert tiebreaker in ("min", "max", "first", "dense")
        self.tiebreaker = tiebreaker


class PartitionNthOptions:
    def __init__(self, pivot: int, null_placement: str = "at_end"):
        self.pivot = pivot
        self.null_placement = null_placement


# ---- key normalization -----------------------------------------------------

def _varlen_words_default() -> int:
    """u32 prefix words of a varlen sort key (ARROW_TPU_SORT_PREFIX_BYTES,
    default 32 bytes = 8 words)."""
    return max(1, int(os.environ.get("ARROW_TPU_SORT_PREFIX_BYTES",
                                     "32")) // 4)


def sortable_lanes(a: Array, varlen_words: Optional[int] = None,
                   cross_batch: bool = False) -> List[torch.Tensor]:
    """u32 lanes (int64 tensors) whose lexicographic unsigned order is the
    column's ascending sort order. Null handling is SEPARATE (null lane).

    Varlen: ``_string_sort_lanes``. Dictionary: the rank of the row's
    value in this dictionary's sorted order (one lane), or with
    ``cross_batch`` the lanes of the value itself, which compare across
    batches with different dictionaries."""
    t = a.type
    if isinstance(t, dt.DictionaryType):
        d = a.dictionary
        idx = a.values.long().clamp(0, max(d.capacity, 1) - 1)
        if cross_batch:
            return [l[idx] for l in sortable_lanes(d, varlen_words)]
        return [_dictionary_rank(d, varlen_words)[idx]]
    if t.is_varlen:
        return _string_sort_lanes(a, varlen_words or _varlen_words_default())
    return ascending_lanes32(a.values, t)


def _string_sort_lanes(a: Array, nwords: int) -> List[torch.Tensor]:
    """Big-endian u32 words of the first 4 * nwords bytes (zero past the
    row's end), then the length: unsigned lane order is byte-lexicographic
    order up to the prefix (the length breaks prefix-of ties; longer
    strings equal over the prefix tie).

    The words come from 4-byte windows of the pool (``_pool_windows``):
    one int32 word per pool position, built once, then one gather per word
    and row (not four byte gathers), widened to int64 per row, and a mask
    of the bytes past the row's end."""
    off = a.offsets
    lens = (off[1:] - off[:-1]).to(torch.int64)
    starts = off[:-1].to(torch.int64)
    windows = _pool_windows(a.values)
    lanes = []
    for w in range(nwords):
        word = windows[(starts + 4 * w).clamp_(0, windows.shape[0] - 1)]
        have = (lens - 4 * w).clamp(0, 4)          # bytes of the row here
        keep = (U32 << (8 * (4 - have))) & U32     # their high bits
        lanes.append(word.to(torch.int64) & keep)
    lanes.append(lens)
    return lanes


_WINDOW_STEP = 1 << 26


def _pool_windows(pool: torch.Tensor) -> torch.Tensor:
    """(max(B, 1),) int32: the big-endian 4-byte window at each position of
    the u8 pool (bytes past its end are 0; the bits of a u32). Built in
    steps of 2^26 positions, so the only array of the pool's length is the
    result (4 bytes a pool byte)."""
    bcap = pool.shape[0]
    out = torch.zeros((max(bcap, 1),), dtype=torch.int32, device=pool.device)
    for s in range(0, bcap, _WINDOW_STEP):
        m = min(_WINDOW_STEP, bcap - s)
        chunk = torch.zeros((m + 3,), dtype=torch.int32, device=pool.device)
        tail = min(m + 3, bcap - s)
        chunk[:tail] = pool[s:s + tail]
        w = out[s:s + m]
        for k in range(4):
            w |= chunk[k:k + m] << (8 * (3 - k))
    return out


def _dictionary_rank(dictionary: Array,
                     varlen_words: Optional[int] = None) -> torch.Tensor:
    """rank[i] = position of dictionary value i in sorted order (a stable
    sort of the values' lanes), int64."""
    lanes = sortable_lanes(dictionary, varlen_words)
    n = lanes[0].shape[0]
    perm = _lexsort_perm([(l, 32) for l in lanes])
    rank = torch.empty((n,), dtype=torch.int64, device=perm.device)
    rank[perm] = torch.arange(n, dtype=torch.int64, device=perm.device)
    return rank


def _key_lanes(a: Array, order: str, null_placement: str,
               capacity: int, cross_batch: bool = False,
               varlen_words: Optional[int] = None) -> List[torch.Tensor]:
    """[null_lane, value_lanes...] for one sort key. The null lane holds 0
    or 1; a descending key's value lanes are the ascending ones with all 32
    bits flipped; value lanes of null rows are 0. A NaN's lanes are all
    ones at_end and all zero at_start, which no number's are: NaN sorts
    between the numbers and the nulls in either order, as in pyarrow (the
    JAX package puts NaN after the numbers of an ascending sort and before
    those of a descending one, whatever the null placement)."""
    lanes = sortable_lanes(a, varlen_words, cross_batch)
    if order == "descending":
        lanes = [l ^ U32 for l in lanes]
    if a.type.is_floating:
        nan = torch.isnan(a.values)
        edge = U32 if null_placement == "at_end" else 0
        lanes = [torch.where(nan, edge, l) for l in lanes]
    if a.validity is not None:
        null_lane = (~a.validity if null_placement == "at_end"
                     else a.validity).to(torch.int64)
        return [null_lane] + [torch.where(a.validity, l, 0) for l in lanes]
    return [torch.zeros((capacity,), dtype=torch.int64,
                        device=a.device)] + lanes


def _lane_bits(lanes: Sequence[torch.Tensor]
               ) -> List[Tuple[torch.Tensor, int]]:
    """One key's ``_key_lanes`` with their widths: the null lane 1 bit."""
    return [(lanes[0], 1)] + [(l, 32) for l in lanes[1:]]


def _composite_sort_perm(columns: Sequence[Array], orders: Sequence[str],
                         null_placement: str, capacity: int, length,
                         varlen_words: Optional[int] = None
                         ) -> torch.Tensor:
    """Stable multi-key sort permutation, int64 (padding rows pushed to the
    end, in input order)."""
    dev = columns[0].device
    pad_lane = (~row_mask(capacity, length, dev)).to(torch.int64)
    keys = [(pad_lane, 1)]
    for col, order in zip(columns, orders):
        keys.extend(_lane_bits(_key_lanes(col, order, null_placement,
                                          capacity,
                                          varlen_words=varlen_words)))
    return _lexsort_perm(keys)


def batch_key_lanes(b: Batch, sort_keys, null_placement: str):
    """Flat per-row lane list for a batch's sort keys: the total order used
    by sort / merge within ONE batch (dictionary keys: batch-local
    ranks)."""
    lanes = []
    for sk in sort_keys:
        lanes.extend(_key_lanes(b.column(sk.name), sk.order,
                                null_placement, b.capacity))
    return lanes


def merge_key_lanes(b: Batch, sort_keys, null_placement: str,
                    varlen_words: Optional[int] = None):
    """The lane list that compares ACROSS batches (the streaming
    sorted_merge's bound test): dictionary keys decode to their values'
    lanes, varlen keys take prefix-word lanes, so one key spec gives lanes
    of one shape for every batch."""
    lanes = []
    for sk in sort_keys:
        lanes.extend(_key_lanes(b.column(sk.name), sk.order,
                                null_placement, b.capacity,
                                cross_batch=True,
                                varlen_words=varlen_words))
    return lanes


def lex_leq(lanes, bound):
    """Rowwise lexicographic ``row <= bound`` over parallel lane lists
    (bound entries are scalars)."""
    res = lanes[-1] <= bound[-1]
    for i in range(len(lanes) - 2, -1, -1):
        res = (lanes[i] < bound[i]) | ((lanes[i] == bound[i]) & res)
    return res


def _index_array(perm: torch.Tensor, length) -> Array:
    """A non-negative int64 permutation as Arrow's uint64 indices (the same
    bits, no copy)."""
    return Array(dt.uint64, perm.view(torch.uint64), None, length=length)


def sort_indices_array(a: Array, order: str = "ascending",
                       null_placement: str = "at_end",
                       varlen_words: Optional[int] = None) -> Array:
    perm = _composite_sort_perm([a], [order], null_placement,
                                a.capacity, a.length, varlen_words)
    return _index_array(perm, a.length)


def sort_indices_batch(b: Batch, options: SortOptions,
                       varlen_words: Optional[int] = None) -> Array:
    """``varlen_words``: u32 prefix words of varlen keys (default 8; the
    plan's order_by passes what the longest key needs)."""
    cols = [b.column(k.name) for k in options.sort_keys]
    orders = [k.order for k in options.sort_keys]
    perm = _composite_sort_perm(cols, orders, options.null_placement,
                                b.capacity, b.length, varlen_words)
    return _index_array(perm, b.length)


# ---- registry --------------------------------------------------------------

@register_function("sort_indices", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=SortOptions)
def _sort_indices(args, options):
    (x,) = args
    if isinstance(x, Batch):
        if options is None:
            raise ValueError("sort_indices on a batch needs SortOptions")
        return sort_indices_batch(x, options)
    if options is not None and options.sort_keys:
        k = options.sort_keys[0]
        return sort_indices_array(x, k.order, options.null_placement)
    return sort_indices_array(x)


@register_function("array_sort_indices", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=ArraySortOptions)
def _array_sort_indices(args, options):
    (x,) = args
    opts = options or ArraySortOptions()
    return sort_indices_array(x, opts.order, opts.null_placement)


@register_function("select_k_unstable", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=SelectKOptions)
def _select_k(args, options):
    """Top-k indices (``vector_select_k.cc``). Arrow's select_k treats
    nulls as absent (never selected): a full sort with nulls at_end, cut at
    k. The length is a host int when the input's is and no key has nulls,
    else a 0-d tensor."""
    (x,) = args
    if options is None:
        raise ValueError("select_k_unstable needs SelectKOptions")
    if isinstance(x, Batch):
        perm_arr = sort_indices_batch(
            x, SortOptions(options.sort_keys, "at_end"))
        nv = None
        for kk in options.sort_keys:
            c = x.column(kk.name)
            if c.validity is not None:
                nv = c.validity if nv is None else (nv & c.validity)
        n_valid = None if nv is None else \
            torch.sum(nv & x.row_mask(), dtype=torch.int32)
    else:
        k0 = options.sort_keys[0]
        perm_arr = sort_indices_array(x, k0.order, "at_end")
        n_valid = None if x.validity is None else \
            torch.sum(x.present_mask(), dtype=torch.int32)
    n = x.length
    if isinstance(n, torch.Tensor):
        k = n.to(torch.int32).clamp(max=options.k)
    else:
        k = min(options.k, int(n))
    if n_valid is not None:
        k = n_valid.clamp(max=k) if not isinstance(k, torch.Tensor) \
            else torch.minimum(k, n_valid)
    return perm_arr.with_length(k)


@register_function("rank", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=RankOptions)
def _rank(args, options):
    """``vector_rank.cc``: 1-based rank with tiebreakers
    (min / max / first / dense).

    A tie group's min rank is the sorted position of its head and its max
    rank that of the next group's head. The JAX package forward-fills the
    head positions with a running max (and a reversed running min); here
    the groups are numbered by a cumsum of the head flags and every row
    reads its group's head position from the compacted list of heads."""
    (x,) = args
    opts = options or RankOptions()
    order = opts.sort_keys[0].order if opts.sort_keys else "ascending"
    a = x if isinstance(x, Array) else x.column(opts.sort_keys[0].name)
    cap = a.capacity
    dev = a.device
    perm = _composite_sort_perm([a], [order], opts.null_placement,
                                cap, a.length)
    iota = torch.arange(cap, dtype=torch.int64, device=dev)
    if opts.tiebreaker == "first" or cap == 0:
        rank_sorted = iota + 1
    else:
        # group equal keys in sorted order; padding rows form their own
        # trailing group, so their keys never join the last real group
        sorted_pad = (~row_mask(cap, a.length, dev))[perm]
        boundary = sorted_pad[1:] != sorted_pad[:-1]
        for l in sortable_lanes(a):
            if a.validity is not None:      # null rows tie, as in pyarrow
                l = torch.where(a.validity, l, 0)
            sl = l[perm]
            boundary = boundary | (sl[1:] != sl[:-1])
        if a.validity is not None:
            sorted_null = (~a.validity)[perm]
            boundary = boundary | (sorted_null[1:] != sorted_null[:-1])
        new_grp = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                             boundary])
        grp = torch.cumsum(new_grp, 0)              # 1-based group number
        if opts.tiebreaker == "dense":
            rank_sorted = grp
        else:
            # head position of group g at slot g - 1; slot of the group
            # after the last one: cap
            heads = _scatter(cap + 1, cap,
                             torch.where(new_grp, grp - 1, cap + 1), iota)
            rank_sorted = heads[grp - 1] + 1 if opts.tiebreaker == "min" \
                else heads[grp]
    ranks = torch.empty((cap,), dtype=torch.int64, device=dev)
    ranks[perm] = rank_sorted
    return Array(dt.uint64, ranks.view(torch.uint64), None, length=a.length)


@register_function("partition_nth_indices", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=PartitionNthOptions)
def _partition_nth(args, options):
    """``vector_array_sort.cc:56``: indices such that element N is in its
    sorted position (fully sorted indices: a valid refinement of the
    partial guarantee)."""
    (x,) = args
    return sort_indices_array(x, "ascending",
                              options.null_placement if options else
                              "at_end")


@register_function("rank_quantile", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=RankOptions)
def _rank_quantile(args, options):
    """``vector_rank.cc`` RankQuantile: (r_min + r_max)/2 - 0.5 over n
    (nulls rank at the end and count toward n)."""
    (x,) = args
    opts = options or RankOptions()

    def with_tb(tb):
        o = RankOptions(sort_keys=opts.sort_keys,
                        null_placement=opts.null_placement, tiebreaker=tb)
        return as_signed_bits(_rank([x], o).values).to(torch.float64)

    rmin = with_tb("min")
    rmax = with_tb("max")
    n = torch.as_tensor(x.length, dtype=torch.float64,
                        device=rmin.device).clamp(min=1.0)
    q = ((rmin + rmax) * 0.5 - 0.5) / n
    return Array(dt.float64, q, None, length=x.length)


@register_function("rank_normal", Kind.VECTOR, 1,
                   null_handling=NullHandling.OUTPUT_NOT_NULL,
                   options_class=RankOptions)
def _rank_normal(args, options):
    """RankQuantile mapped through the standard normal inverse CDF."""
    q = _rank_quantile(args, options)
    return Array(dt.float64, torch.special.ndtri(q.values), None,
                 length=q.length)
