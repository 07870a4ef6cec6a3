"""Expression trees: literal / field_ref / call.

Reference: ``cpp/src/arrow/compute/expression.h:45`` (Expression = literal,
field_ref or call) and ``ExecuteScalarExpression`` (:247); the counterpart
of the JAX package's ``compute/expressions.py``. An expression executes
against a Batch by running registered compute functions over its tensors.
Python operator overloads mirror pyarrow.compute.Expression ergonomics.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..core.array import Array
from ..core.batch import Batch
from .registry import call_function
from .scalar import Scalar, scalar as make_scalar

__all__ = ["Expression", "literal", "field", "call",
           "execute_scalar_expression"]


class Expression:
    KIND_LITERAL = "literal"
    KIND_FIELD = "field"
    KIND_CALL = "call"

    def __init__(self, kind: str, value=None, name: Optional[str] = None,
                 function: Optional[str] = None,
                 args: Sequence["Expression"] = (), options=None):
        self.kind = kind
        self.value = value          # literal
        self.name = name            # field ref
        self.function = function    # call
        self.args = list(args)
        self.options = options

    # ---- construction sugar -------------------------------------------------
    @staticmethod
    def _wrap(x) -> "Expression":
        if isinstance(x, Expression):
            return x
        return literal(x)

    def _bin(self, fn: str, other) -> "Expression":
        return call(fn, [self, Expression._wrap(other)])

    def _rbin(self, fn: str, other) -> "Expression":
        return call(fn, [Expression._wrap(other), self])

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._rbin("add", o)
    def __sub__(self, o): return self._bin("subtract", o)
    def __rsub__(self, o): return self._rbin("subtract", o)
    def __mul__(self, o): return self._bin("multiply", o)
    def __rmul__(self, o): return self._rbin("multiply", o)
    def __truediv__(self, o): return self._bin("divide", o)
    def __rtruediv__(self, o): return self._rbin("divide", o)
    def __eq__(self, o): return self._bin("equal", o)      # type: ignore
    def __ne__(self, o): return self._bin("not_equal", o)  # type: ignore
    def __lt__(self, o): return self._bin("less", o)
    def __le__(self, o): return self._bin("less_equal", o)
    def __gt__(self, o): return self._bin("greater", o)
    def __ge__(self, o): return self._bin("greater_equal", o)
    def __and__(self, o): return self._bin("and_kleene", o)
    def __or__(self, o): return self._bin("or_kleene", o)
    def __invert__(self): return call("invert", [self])
    def __hash__(self):
        return hash(str(self))

    def is_null(self): return call("is_null", [self])
    def is_valid(self): return call("is_valid", [self])

    def cast(self, target_type):
        from ..ops.scalar_cast import CastOptions
        return call("cast", [self], options=CastOptions(target_type))

    def isin(self, values):
        from ..ops.set_lookup import SetLookupOptions
        if not isinstance(values, SetLookupOptions):
            values = SetLookupOptions(value_set=values)
        return call("is_in", [self], options=values)

    # ---- introspection --------------------------------------------------------
    def field_names(self) -> List[str]:
        if self.kind == self.KIND_FIELD:
            return [self.name]
        out: List[str] = []
        for a in self.args:
            out.extend(a.field_names())
        return out

    def __repr__(self):
        if self.kind == self.KIND_LITERAL:
            return repr(self.value.as_py() if isinstance(self.value, Scalar)
                        else self.value)
        if self.kind == self.KIND_FIELD:
            return self.name
        return f"{self.function}({', '.join(map(repr, self.args))})"


def literal(value, type=None) -> Expression:
    return Expression(Expression.KIND_LITERAL,
                      value=make_scalar(value, type))


def field(name: str) -> Expression:
    return Expression(Expression.KIND_FIELD, name=name)


def call(function: str, args: Sequence, options=None) -> Expression:
    return Expression(Expression.KIND_CALL, function=function,
                      args=[Expression._wrap(a) for a in args],
                      options=options)


def execute_scalar_expression(expr: Expression, batch: Batch
                              ) -> Union[Array, Scalar]:
    """Evaluate an expression against a Batch (ExecuteScalarExpression,
    ``expression.cc:247`` analog)."""
    if expr.kind == Expression.KIND_LITERAL:
        return expr.value
    if expr.kind == Expression.KIND_FIELD:
        return batch.column(expr.name)
    args = [execute_scalar_expression(a, batch) for a in expr.args]
    return call_function(expr.function, args, options=expr.options)
