"""Shared helpers for kernel implementations: type promotion, scalar
broadcasting, output construction (the JAX package's
``ops/kernel_utils.py``).

Type promotion matches Arrow's CommonNumeric resolution
(``cpp/src/arrow/compute/kernels/codegen_internal.cc`` CommonNumeric):
  * any float present -> widest float among the floats
  * all ints, same signedness -> max width
  * mixed signedness -> signed of width max(signed_w, 2*unsigned_w), cap 64
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import datatype as dt
from ..core.array import Array
from ..compute.scalar import Scalar
from .bits import SIGNED_OF, unsigned_to_int64

__all__ = [
    "common_numeric_type", "promote_args", "values_of", "output_like",
    "capacity_of", "length_of", "device_of", "torch_dtype", "to_storage",
    "host_to_device",
]


def torch_dtype(t: dt.DataType) -> torch.dtype:
    """The torch dtype of a logical type's storage (``t.storage_np``)."""
    return torch.from_numpy(np.empty(0, dtype=t.storage_np)).dtype


def common_numeric_type(types: Sequence[dt.DataType]) -> dt.DataType:
    floats = [t for t in types if t.is_floating]
    if floats:
        bits = max(t.bits for t in floats)
        return dt.FloatType(bits)
    ints = [t for t in types if t.is_integer]
    if len(ints) != len(types):
        bad = [t for t in types if not t.is_numeric]
        raise TypeError(f"non-numeric types in arithmetic: {bad}")
    signed = [t for t in ints if t.signed]
    unsigned = [t for t in ints if not t.signed]
    if not unsigned:
        return dt.IntegerType(max(t.bits for t in signed), True)
    if not signed:
        return dt.IntegerType(max(t.bits for t in unsigned), False)
    width = max(max(t.bits for t in signed),
                min(64, 2 * max(t.bits for t in unsigned)))
    return dt.IntegerType(min(width, 64), True)


def capacity_of(args: Sequence[Union[Array, Scalar]]) -> int:
    caps = {a.capacity for a in args if isinstance(a, Array)}
    if not caps:
        raise ValueError("at least one Array argument required")
    if len(caps) > 1:
        raise ValueError(f"mismatched array capacities: {caps}")
    return caps.pop()


def length_of(args: Sequence[Union[Array, Scalar]]):
    for a in args:
        if isinstance(a, Array):
            return a.length
    raise ValueError("at least one Array argument required")


def device_of(args: Sequence[Union[Array, Scalar]]) -> torch.device:
    for a in args:
        if isinstance(a, Array):
            return a.device
    raise ValueError("at least one Array argument required")


def values_of(a: Union[Array, Scalar],
              out_type: Optional[dt.DataType] = None) -> torch.Tensor:
    """The values (a column, or a 0-d CPU tensor for a scalar, which torch
    broadcasts against a column on any device), cast to out_type storage
    if given."""
    if isinstance(a, Array):
        v = a.values
    else:
        v = torch.from_numpy(np.asarray(a.storage_value()))
    if out_type is not None:
        want = torch_dtype(out_type)
        if v.dtype == want:
            return v
        # the card converts no uint16 / uint32 / uint64: by value through
        # int64 (uint64: its bits, read as unsigned by a float target),
        # into one by the low bits of the signed type of its width
        if v.dtype in SIGNED_OF:
            wide = v.dtype == torch.uint64
            v = unsigned_to_int64(v)
            if wide and want.is_floating_point:
                # from 2^63 up: halve keeping the low bit sticky, convert,
                # double (one rounding, as a direct conversion rounds)
                half = ((v >> 1) & ((1 << 63) - 1)) | (v & 1)
                return torch.where(v < 0, half.to(want) * 2, v.to(want))
        return to_storage(v, out_type)
    return v


def host_to_device(v: torch.Tensor, device) -> torch.Tensor:
    """A small host tensor (a scalar's 0-d value) copied to ``device``.
    Inside a CUDA graph's capture the copy is taken from pinned memory kept
    with the graph (a capture takes no copy from pageable memory), so a
    replay copies the same value again."""
    device = torch.device(device)
    if device.type == "cuda" and v.device.type == "cpu" and \
            torch.cuda.is_current_stream_capturing():
        from .cuda_kernels import keep_for_capture
        return keep_for_capture(v.pin_memory()).to(device, non_blocking=True)
    return v.to(device)


def to_storage(v: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """Integer or float values -> ``t``'s storage dtype (a uint16 / uint32 /
    uint64 by the low bits of the signed type of its width: the card
    converts into none of them)."""
    d = torch_dtype(t)
    if d in SIGNED_OF:
        return v.to(SIGNED_OF[d]).view(d)
    return v.to(d)


def promote_args(args: Sequence[Union[Array, Scalar]]
                 ) -> Tuple[List[torch.Tensor], dt.DataType]:
    """Cast all numeric args to the Arrow common type; return values+type."""
    out_t = common_numeric_type([a.type for a in args])
    return [values_of(a, out_t) for a in args], out_t


def output_like(values: torch.Tensor, type: dt.DataType,
                args: Sequence[Union[Array, Scalar]],
                validity=None) -> Array:
    """Build an output Array with the shared capacity/length of the args.

    `validity` here is kernel-computed extra validity (COMPUTED kernels);
    INTERSECTION propagation happens centrally in the registry.
    """
    cap = capacity_of(args)
    if values.ndim == 0:
        values = host_to_device(values, device_of(args)).expand(cap).clone()
    return Array(type, values, validity, length=length_of(args))
