"""arrow_tpu_torch.engine: plan serialization (Substrait consumer and
producer); the counterpart of the JAX package's ``engine``.

Reference: ``cpp/src/arrow/engine/substrait`` (serde.cc plan de/
serialization, relation_internal.cc rel <-> Declaration,
extension_set.cc UDF registration).
"""

from .substrait import (run_query, substrait_to_declaration,  # noqa: F401
                        declaration_to_substrait,
                        register_substrait_function)

__all__ = ["run_query", "substrait_to_declaration",
           "declaration_to_substrait", "register_substrait_function"]
