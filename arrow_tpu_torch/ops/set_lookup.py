"""Set-lookup kernels: is_in / index_in; the counterpart of the JAX
package's ``ops/set_lookup.py``.

Reference: ``cpp/src/arrow/compute/kernels/scalar_set_lookup.cc`` (memo
table over the value set, per-row probe).

The value set is small and host-provided. The rows and the value set sort
together: ``vector_hash.sort_distinct`` over the concatenation [value_set
++ input] groups equal keys, and an input row whose group's first row lies
in the value-set prefix is a member; that first row IS the index of the
value's first occurrence in the set (Arrow's index_in contract). A
dictionary input probes its dictionary and maps its codes, so a
dictionary column of millions of rows sorts only its dictionary.

Null semantics (Arrow ``SetLookupOptions``):
  * ``null_matching_behavior="MATCH"`` (default): null input matches null
    in the set.
  * ``"SKIP"`` (= skip_nulls=True): null input never matches; nulls in the
    value set are ignored.
  * ``"EMIT_NULL"``: null input -> null output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array, array_from_numpy
from ..compute.registry import Kind, NullHandling, register_function
from .concat import concat_arrays
from .vector_hash import _key_lanes, sort_distinct

__all__ = ["SetLookupOptions", "is_in_array", "index_in_array"]

_I32MAX = (1 << 31) - 1


class SetLookupOptions:
    def __init__(self, value_set=None, skip_nulls: Optional[bool] = None,
                 null_matching_behavior: Optional[str] = None):
        self.value_set = value_set
        if null_matching_behavior is None:
            null_matching_behavior = "SKIP" if skip_nulls else "MATCH"
        self.null_matching_behavior = null_matching_behavior


def _value_set(vs, t: dt.DataType, device) -> Array:
    """The value set as an Array on ``device``: an Array moves there; a
    list or numpy array is staged as type ``t`` (without pyarrow unless
    it holds nulls or Python objects); a pyarrow array as it is."""
    if isinstance(vs, Array):
        return vs.to(device)
    from ..core.interop import array_from_pyarrow
    if isinstance(vs, (list, tuple, np.ndarray)):
        npv = np.asarray(vs)
        if npv.dtype != object:
            return array_from_numpy(npv, type=t, device=device)
        import pyarrow as pa
        vs = pa.array(list(vs), type=dt.to_pyarrow_type(t))
    return array_from_pyarrow(vs, device=device)


def _set_probe(a: Array, options: SetLookupOptions):
    """Returns (first_set_index int32 (cap,), matched bool, in_valid bool).

    first_set_index is the index in value_set of each row's first match
    (undefined where ~matched)."""
    if options is None or options.value_set is None:
        raise ValueError("is_in/index_in require SetLookupOptions.value_set")
    is_dict = isinstance(a.type, dt.DictionaryType)
    vs = _value_set(options.value_set,
                    a.type.value_type if is_dict else a.type, a.device)
    if is_dict and not isinstance(vs.type, dt.DictionaryType):
        # probe the dictionary values, then map through the codes
        didx, dmatched, _ = _set_probe(
            a.dictionary, SetLookupOptions(vs, null_matching_behavior=(
                options.null_matching_behavior)))
        codes = a.values.long()
        in_valid = a.validity_or_true() & a.row_mask()
        return didx[codes], in_valid & dmatched[codes], in_valid
    if vs.type != a.type:
        if vs.type.is_numeric and a.type.is_numeric:
            from ..compute.registry import call_function
            from .scalar_cast import CastOptions
            vs = call_function("cast", [vs], options=CastOptions(a.type))
        else:
            raise TypeError(
                f"value_set type {vs.type} does not match input {a.type}")

    nset = len(vs)
    skip = options.null_matching_behavior != "MATCH"
    both = concat_arrays([vs, a])
    active = both.row_mask()
    if skip:
        active = active & both.validity_or_true()
    codes, unique_rows, _ = sort_distinct(
        _key_lanes(both, include_validity=not skip), active)
    # representative row of each input row's group; in-set iff rep < nset
    rep = torch.where(codes >= 0,
                      unique_rows[codes.clamp(0, codes.shape[0] - 1).long()],
                      _I32MAX)
    # input rows occupy concat positions [nset, nset + len(a)); the slice
    # is a.capacity wide (positions past len(a) are padding, masked below)
    rep_in = rep[nset:nset + a.capacity]
    in_valid = a.validity_or_true() & a.row_mask()
    matched = rep_in < nset
    if skip:
        matched = matched & in_valid
    return rep_in.to(torch.int32), matched, in_valid


def is_in_array(a: Array, options: SetLookupOptions) -> Array:
    _, matched, in_valid = _set_probe(a, options)
    if options.null_matching_behavior == "EMIT_NULL":
        return Array(dt.bool_, matched, in_valid, length=a.length)
    return Array(dt.bool_, matched, None, length=a.length)


def index_in_array(a: Array, options: SetLookupOptions) -> Array:
    idx, matched, in_valid = _set_probe(a, options)
    validity = matched
    if options.null_matching_behavior == "EMIT_NULL":
        validity = matched & in_valid
    return Array(dt.int32, torch.where(matched, idx, 0), validity,
                 length=a.length)


@register_function("is_in", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SetLookupOptions)
def _is_in(args, options):
    return is_in_array(args[0], options)


@register_function("index_in", Kind.SCALAR, 1,
                   null_handling=NullHandling.COMPUTED,
                   options_class=SetLookupOptions)
def _index_in(args, options):
    return index_in_array(args[0], options)


@register_function("is_in_meta_binary", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _is_in_meta_binary(args, options):
    """Binary (2-arg) convenience variant of is_in: the value set rides
    as the second argument instead of options (api_scalar.cc IsIn meta)."""
    return is_in_array(args[0], SetLookupOptions(value_set=args[1],
                                                 skip_nulls=False))


@register_function("index_in_meta_binary", Kind.SCALAR, 2,
                   null_handling=NullHandling.COMPUTED)
def _index_in_meta_binary(args, options):
    return index_in_array(args[0], SetLookupOptions(value_set=args[1],
                                                    skip_nulls=False))
