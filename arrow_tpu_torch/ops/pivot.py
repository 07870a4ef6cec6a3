"""pivot_wider / hash_pivot_wider: (key, value) pairs -> one struct column
with a field per expected key name; the counterpart of the JAX package's
``ops/pivot.py``.

Reference: ``cpp/src/arrow/compute/kernels/aggregate_pivot.cc`` (the
scalar PivotImpl: keys map through PivotWiderKeyMapper, a second valid
value for one key is an error) and ``hash_aggregate_pivot.cc`` (the
grouped form, one slot per (group, key)). Options: ``api_aggregate.h``
PivotWiderOptions {key_names, unexpected_key_behavior}.

Keys map to their index in ``key_names`` through one set probe
(``set_lookup._set_probe``); each valid value then scatters into a
flattened (G * K,) slot grid, rows that do not take part into a dump slot
one past the end (the JAX scatter's ``mode="drop"``). Among duplicates the
scatter keeps any one value, but a duplicate is an error in both packages,
and the per-slot counter that finds it is exact. The error bits are read
once, through ``error_flag``, as the aggregate node reads every
aggregator's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.registry import Kind, NullHandling, register_function
from .agg_options import PivotWiderOptions
from .aggregates import GROUPED_AGGREGATORS, GroupedAggregator, _fold
from .bits import as_signed_bits, zeros_of
from .set_lookup import SetLookupOptions, _set_probe

__all__ = ["GroupedPivotWider", "PivotWiderOptions"]

# error-flag bits (error_flag(state))
ERR_DUPLICATE = 1       # two valid values for one (group, key) slot
ERR_UNEXPECTED_KEY = 2  # a key outside key_names with behavior="raise"
ERR_NULL_KEY = 4        # a null pivot key (always an error,
#                         pivot_internal.cc NullKeyName)


def _set_at(state: torch.Tensor, pos: torch.Tensor, src: torch.Tensor
            ) -> torch.Tensor:
    """state[pos] = src, positions >= len(state) dropped (one dump slot)."""
    n = state.shape[0]
    ext = torch.cat([state, state.new_zeros((1,))])
    as_signed_bits(ext).index_put_((pos.clamp(max=n),),
                                   as_signed_bits(src.to(state.dtype)))
    return ext[:n]


class GroupedPivotWider(GroupedAggregator):
    """hash_pivot_wider: per group, one struct{key_names...: value_type}.
    The state is the JAX package's: (values, valid, count) over the (G *
    K,) grid and an error word."""

    dist_rows = False

    name = "pivot_wider"

    def __init__(self, in_type: Tuple[dt.DataType, dt.DataType], G: int,
                 options: Optional[PivotWiderOptions] = None):
        if options is None or not isinstance(options, PivotWiderOptions):
            raise ValueError("pivot_wider requires PivotWiderOptions")
        super().__init__(in_type, G, options)
        self.key_type, self.value_type = in_type
        if self.value_type.is_varlen:
            raise NotImplementedError(
                "pivot_wider over var-length values: dictionary-encode the "
                "value column first")
        self.K = max(len(options.key_names), 1)
        self.raise_unexpected = \
            options.unexpected_key_behavior == "raise"

    @property
    def out_type(self):
        return dt.struct([(n, self.value_type)
                          for n in self.options.key_names])

    def init(self, device=None):
        GK = self.G * self.K
        return (zeros_of(self.value_type.storage_np, GK, device),
                torch.zeros((GK,), dtype=torch.bool, device=device),
                torch.zeros((GK,), dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.int32, device=device))

    def consume(self, state, values, group_ids):
        vals, valid, cnt, err = state
        keys, v = values
        kidx, matched, key_present = _set_probe(
            keys, SetLookupOptions(value_set=list(self.options.key_names)))
        in_group = group_ids >= 0
        if keys.validity is not None:
            null_key = in_group & keys.row_mask() & ~keys.validity
            err = err | (null_key.any().to(torch.int32) * ERR_NULL_KEY)
        if self.raise_unexpected:
            unexpected = in_group & key_present & ~matched
            err = err | (unexpected.any().to(torch.int32)
                         * ERR_UNEXPECTED_KEY)
        ok = in_group & key_present & matched & v.row_mask()
        if v.validity is not None:
            ok = ok & v.validity
        GK = self.G * self.K
        pos = torch.where(ok, group_ids.long() * self.K +
                          kidx.long().clamp(0, self.K - 1), GK)
        cnt = _fold(cnt, pos, torch.ones_like(pos, dtype=torch.int32), 0)
        vals = _set_at(vals, pos, v.values)
        valid = _set_at(valid, pos, torch.ones_like(pos, dtype=torch.bool))
        return vals, valid, cnt, err

    def merge(self, state, other, mapping):
        vals, valid, cnt, err = state
        ov, ovalid, ocnt, oerr = other
        G, K = self.G, self.K
        GK = G * K
        OG = ov.shape[0] // K
        our_g = mapping[:OG].long() if mapping.shape[0] >= OG else \
            torch.cat([mapping.long(), mapping.new_full(
                (OG - mapping.shape[0],), -1).long()])
        # groups that map nowhere (-1, or past the table) are dropped
        live = (our_g >= 0) & (our_g < G)
        kcol = torch.arange(K, device=vals.device)
        idx = torch.where(live[:, None], our_g[:, None] * K + kcol,
                          GK).reshape(-1)
        cnt = _fold(cnt, idx, ocnt, 0)
        pos = torch.where(ovalid, idx, GK)
        vals = _set_at(vals, pos, ov)
        valid = _set_at(valid, pos, torch.ones_like(ovalid))
        return vals, valid, cnt, err | oerr

    def finalize(self, state, num_groups) -> Array:
        vals, valid, cnt, err = state
        G, K = self.G, self.K
        v2 = vals.reshape(G, K)
        ok2 = valid.reshape(G, K)
        children = tuple(
            Array(self.value_type, v2[:, k].contiguous(),
                  ok2[:, k].contiguous(), length=num_groups)
            for k in range(len(self.options.key_names)))
        return Array(self.out_type, torch.zeros((G,), dtype=torch.uint8,
                                                device=vals.device), None,
                     length=num_groups, children=children)

    def error_flag(self, state):
        vals, valid, cnt, err = state
        return err | ((cnt > 1).any().to(torch.int32) * ERR_DUPLICATE)

    @staticmethod
    def error_message(flag: int) -> str:
        msgs = []
        if flag & ERR_DUPLICATE:
            msgs.append("duplicate value for the same pivot key")
        if flag & ERR_UNEXPECTED_KEY:
            msgs.append("unexpected pivot key (behavior='raise')")
        if flag & ERR_NULL_KEY:
            msgs.append("pivot key name cannot be null")
        return "pivot_wider: " + "; ".join(msgs or [f"error {flag}"])


GROUPED_AGGREGATORS["pivot_wider"] = GroupedPivotWider


@register_function("pivot_wider", Kind.SCALAR_AGGREGATE, 2,
                   null_handling=NullHandling.COMPUTED,
                   options_class=PivotWiderOptions)
def _pivot_wider(args, options):
    """Whole-array pivot: the grouped form with one group; a struct Scalar
    (reference ``aggregate_pivot.cc`` PivotImpl). One host read of the
    error word."""
    keys, vals = args
    agg = GroupedPivotWider((keys.type, vals.type), 1, options)
    st = agg.consume(agg.init(keys.device), (keys, vals),
                     torch.zeros((keys.capacity,), dtype=torch.int32,
                                 device=keys.device))
    flag = int(agg.error_flag(st))
    if flag:
        raise RuntimeError(agg.error_message(flag))
    out = agg.finalize(st, 1)
    from ..compute.scalar import Scalar
    return Scalar(out.to_pylist()[0], agg.out_type)
