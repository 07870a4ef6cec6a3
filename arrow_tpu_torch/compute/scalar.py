"""Scalar datum — a single typed value (constant columns in kernels).

Reference: ``cpp/src/arrow/scalar.h``. On TPU a scalar is just a 0-d value
broadcast by the kernels; this class carries type + validity.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..core import datatype as dt

__all__ = ["Scalar", "scalar"]


class Scalar:
    __slots__ = ("type", "value", "is_valid")

    def __init__(self, value: Any, type: dt.DataType, is_valid: bool = True):
        self.type = type
        self.value = value
        self.is_valid = is_valid and value is not None

    def as_py(self):
        if not self.is_valid:
            return None
        v = self.value
        if isinstance(v, np.generic):
            return v.item()
        return v

    def storage_value(self):
        """Value as numpy storage dtype (0 for null — masked anyway)."""
        import datetime as _dtm
        if not self.is_valid:
            return np.zeros((), dtype=self.type.storage_np)[()]
        if self.type.is_varlen:
            return self.value
        v = self.value
        if isinstance(self.type, dt.DecimalType):
            return _decimal_storage(v, self.type)
        if isinstance(v, _dtm.datetime):
            epoch = _dtm.datetime(1970, 1, 1)
            us = int((v - epoch).total_seconds() * 1e6)
            scale = {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": 1}[
                getattr(self.type, "unit", "us")]
            v = us // scale if getattr(self.type, "unit", "us") != "ns" \
                else us * 1000
        elif isinstance(v, _dtm.date):
            days = (v - _dtm.date(1970, 1, 1)).days
            v = days * 86_400_000 if isinstance(self.type, dt.Date64Type) \
                else days
        return np.asarray(v).astype(self.type.storage_np)[()]

    def __repr__(self):
        return f"Scalar<{self.type}>({self.as_py()!r})"


def _decimal_storage(v, t) -> np.ndarray:
    """A decimal value as its column stores it: the integer of
    ``v * 10^scale`` (a ``decimal.Decimal``, int, or str, exact), one int64,
    or for a wide type the int64 limbs [low 64 bits, high signed 64]."""
    import decimal
    q = int(decimal.Decimal(v).scaleb(t.scale))
    if not t.wide:
        return np.int64(q)
    lo = q & ((1 << 64) - 1)
    return np.array([lo - (1 << 64) if lo >> 63 else lo, q >> 64],
                    dtype=np.int64)


def _infer_scalar_type(value) -> dt.DataType:
    if isinstance(value, bool) or isinstance(value, np.bool_):
        return dt.bool_
    if isinstance(value, (int, np.integer)):
        return dt.int64
    if isinstance(value, (float, np.floating)):
        return dt.float64
    if isinstance(value, (str,)):
        return dt.string
    if isinstance(value, (bytes,)):
        return dt.binary
    import datetime as _dtm
    if isinstance(value, _dtm.datetime):
        return dt.timestamp("us")
    if isinstance(value, _dtm.date):
        return dt.date32
    raise TypeError(f"cannot infer scalar type for {value!r}")


def scalar(value, type: Optional[dt.DataType] = None) -> Scalar:
    if isinstance(value, Scalar):
        return value
    if value is None:
        if type is None:
            raise TypeError("null scalar needs an explicit type")
        return Scalar(None, type, is_valid=False)
    t = type or _infer_scalar_type(value)
    return Scalar(value, t)
