"""Function registry + dispatch + centralized null propagation.

Reference model: ``cpp/src/arrow/compute/registry.h:46`` (FunctionRegistry),
``compute/function.h:142`` (Function), ``compute/kernel.h:510`` (kernel
null-handling policies), ``compute/exec.cc:1362`` (CallFunction). The
counterpart of the JAX package's ``compute/registry.py``: INTERSECTION
kernels get validity = AND of input validities computed once; kernels only
produce values.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..core.array import Array
from .scalar import Scalar, scalar as make_scalar

__all__ = [
    "NullHandling", "Kind", "Function", "FunctionRegistry",
    "registry", "call_function", "register_function", "Datum",
]

Datum = Union[Array, Scalar]


class NullHandling(enum.Enum):
    INTERSECTION = 1      # validity = AND of inputs (most scalar kernels)
    COMPUTED = 2          # kernel computes its own validity
    OUTPUT_NOT_NULL = 3   # result never null


class Kind(enum.Enum):
    SCALAR = 1            # elementwise, length-preserving
    VECTOR = 2            # whole-array semantics (filter/take/sort/unique)
    SCALAR_AGGREGATE = 3  # array -> scalar
    HASH_AGGREGATE = 4    # grouped aggregate (used via Grouper/acero)
    META = 5              # dispatches on datum kind


@dataclass
class Function:
    name: str
    kind: Kind
    arity: int                      # -1 = varargs
    exec: Callable                  # (args: List[Datum], options) -> Datum
    null_handling: NullHandling = NullHandling.INTERSECTION
    doc: str = ""
    options_class: Optional[type] = None

    def call(self, args: Sequence, options=None):
        from ..core.batch import Batch
        args = [a if isinstance(a, (Array, Scalar, Batch)) else
                make_scalar(a) for a in args]
        if self.arity >= 0 and len(args) != self.arity:
            raise ValueError(
                f"{self.name} expects {self.arity} args, got {len(args)}")
        if self.kind is Kind.SCALAR:
            caps = {a.capacity for a in args if isinstance(a, Array)}
            if len(caps) > 1:
                raise ValueError(
                    f"{self.name}: mismatched array capacities {sorted(caps)}"
                    " — repartition to a shared batch capacity first")
        if (self.kind is Kind.SCALAR
                and self.null_handling is NullHandling.INTERSECTION):
            out = self.exec(args, options)
            return _apply_intersection_validity(out, args)
        return self.exec(args, options)


def _apply_intersection_validity(out: Array, args: Sequence[Datum]) -> Array:
    validity = out.validity  # kernel may already have constrained it
    for a in args:
        if isinstance(a, Array):
            if a.validity is not None:
                validity = a.validity if validity is None \
                    else validity & a.validity
        elif isinstance(a, Scalar) and not a.is_valid:
            validity = torch.zeros((out.capacity,), dtype=torch.bool,
                                   device=out.device)
    if validity is out.validity:
        return out
    return out.with_validity(validity)


# the ported kernel modules, imported for their registrations
_KERNEL_MODULES = ["scalar_arithmetic", "scalar_compare", "scalar_cast",
                   "selection", "sorting", "aggregates", "vector_hash",
                   "set_lookup", "aggregates_order", "vector_misc",
                   "strings", "temporal", "ree", "nested", "pivot",
                   "strings_regex", "scalar_checked"]
_kernels_loaded = False


def ensure_kernels_loaded():
    """Import kernel modules for their registration side effects
    (deferred + idempotent, as in the JAX package)."""
    global _kernels_loaded
    if _kernels_loaded:
        return
    _kernels_loaded = True
    import importlib
    for m in _KERNEL_MODULES:
        importlib.import_module(f"arrow_tpu_torch.ops.{m}")


class FunctionRegistry:
    def __init__(self):
        self._functions: Dict[str, Function] = {}

    def add(self, fn: Function, allow_overwrite: bool = False):
        if fn.name in self._functions and not allow_overwrite:
            raise KeyError(f"function {fn.name} already registered")
        self._functions[fn.name] = fn

    def get(self, name: str) -> Function:
        ensure_kernels_loaded()
        try:
            return self._functions[name]
        except KeyError:
            raise KeyError(f"no compute function registered named '{name}'") \
                from None

    def __contains__(self, name: str) -> bool:
        ensure_kernels_loaded()
        return name in self._functions

    def list_functions(self) -> List[str]:
        ensure_kernels_loaded()
        return sorted(self._functions)


registry = FunctionRegistry()


def register_function(name: str, kind: Kind, arity: int,
                      null_handling: NullHandling = NullHandling.INTERSECTION,
                      doc: str = "", options_class=None,
                      allow_overwrite: bool = False):
    """Decorator: register `fn(args, options) -> Datum` under `name`."""
    def deco(fn):
        registry.add(Function(name, kind, arity, fn, null_handling, doc,
                              options_class), allow_overwrite=allow_overwrite)
        return fn
    return deco


def call_function(name: str, args: Sequence, options=None,
                  **option_kwargs):
    """The CallFunction entry point (``compute/exec.cc:1362`` analog)."""
    fn = registry.get(name)
    if options is None and option_kwargs:
        if fn.options_class is None:
            raise TypeError(f"{name} takes no options")
        options = fn.options_class(**option_kwargs)
    return fn.call(args, options)
