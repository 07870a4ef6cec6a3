"""arrow_tpu_torch.compute — the function registry + kernel API surface.

Every registered function is callable as ``compute.call_function(name,
args)``. Kernel modules live in ``arrow_tpu_torch.ops`` and register on
first registry access (``registry.ensure_kernels_loaded``).
"""

from .registry import (  # noqa: F401
    Function, FunctionRegistry, Kind, NullHandling, call_function, registry,
    register_function, ensure_kernels_loaded,
)
from .scalar import Scalar, scalar  # noqa: F401
from .expressions import (  # noqa: F401
    Expression, call, execute_scalar_expression, field, literal,
)


def list_functions():
    return registry.list_functions()


def cast(arr, target_type, **kwargs):
    from ..ops.scalar_cast import CastOptions
    return call_function("cast", [arr],
                         options=CastOptions(target_type, **kwargs))

# option classes of the kernels, under the JAX package's names; resolved on
# first access, as its ``compute`` resolves them
_LAZY = {
    "ModeOptions": "arrow_tpu_torch.ops.aggregates_order",
    "QuantileOptions": "arrow_tpu_torch.ops.aggregates_order",
    "TDigestOptions": "arrow_tpu_torch.ops.aggregates_order",
    "IndexOptions": "arrow_tpu_torch.ops.aggregates_order",
    "SkewOptions": "arrow_tpu_torch.ops.aggregates_order",
    "WinsorizeOptions": "arrow_tpu_torch.ops.aggregates_order",
    "ScalarAggregateOptions": "arrow_tpu_torch.ops.agg_options",
    "CountOptions": "arrow_tpu_torch.ops.agg_options",
    "VarianceOptions": "arrow_tpu_torch.ops.agg_options",
    "CastOptions": "arrow_tpu_torch.ops.scalar_cast",
    "CumulativeOptions": "arrow_tpu_torch.ops.vector_misc",
    "PairwiseOptions": "arrow_tpu_torch.ops.vector_misc",
    "SetLookupOptions": "arrow_tpu_torch.ops.set_lookup",
    "DayOfWeekOptions": "arrow_tpu_torch.ops.temporal",
    "WeekOptions": "arrow_tpu_torch.ops.temporal",
    "RoundTemporalOptions": "arrow_tpu_torch.ops.temporal",
    "StrftimeOptions": "arrow_tpu_torch.ops.temporal",
    "StrptimeOptions": "arrow_tpu_torch.ops.temporal",
    "AssumeTimezoneOptions": "arrow_tpu_torch.ops.temporal",
    "ListSliceOptions": "arrow_tpu_torch.ops.nested",
    "MakeStructOptions": "arrow_tpu_torch.ops.nested",
    "StructFieldOptions": "arrow_tpu_torch.ops.nested",
    "MapLookupOptions": "arrow_tpu_torch.ops.nested",
    "SplitOptions": "arrow_tpu_torch.ops.strings_regex",
    "SplitPatternOptions": "arrow_tpu_torch.ops.strings_regex",
    "ExtractRegexOptions": "arrow_tpu_torch.ops.strings_regex",
    "RandomOptions": "arrow_tpu_torch.ops.ree",
    "PivotWiderOptions": "arrow_tpu_torch.ops.agg_options",
    "MatchSubstringOptions": "arrow_tpu_torch.ops.strings",
    "SliceOptions": "arrow_tpu_torch.ops.strings",
    "TrimOptions": "arrow_tpu_torch.ops.strings",
    "PadOptions": "arrow_tpu_torch.ops.strings",
    "ReplaceSubstringOptions": "arrow_tpu_torch.ops.strings",
    "JoinOptions": "arrow_tpu_torch.ops.strings",
    "FilterOptions": "arrow_tpu_torch.ops.selection",
    "TakeOptions": "arrow_tpu_torch.ops.selection",
    "filter_array": "arrow_tpu_torch.ops.selection",
    "filter_batch": "arrow_tpu_torch.ops.selection",
    "take_array": "arrow_tpu_torch.ops.selection",
    "take_batch": "arrow_tpu_torch.ops.selection",
    "get_take_indices": "arrow_tpu_torch.ops.selection",
    "SortKey": "arrow_tpu_torch.ops.sorting",
    "SortOptions": "arrow_tpu_torch.ops.sorting",
    "ArraySortOptions": "arrow_tpu_torch.ops.sorting",
    "SelectKOptions": "arrow_tpu_torch.ops.sorting",
    "RankOptions": "arrow_tpu_torch.ops.sorting",
}


def __getattr__(name):
    """An option class or selection helper of ``_LAZY``, or a registered
    function as a module-level helper: ``compute.add(a, b)``."""
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    fn = registry.get(name) if name in registry else None
    if fn is not None:
        def wrapper(*args, options=None, **kwargs):
            return call_function(name, list(args), options=options,
                                 **kwargs)
        wrapper.__name__ = name
        wrapper.__doc__ = fn.doc or f"compute function {name!r}"
        return wrapper
    raise AttributeError(
        f"module 'arrow_tpu_torch.compute' has no attribute {name!r}")
