"""Data-dependent errors of the checked kernels; the counterpart of the JAX
package's ``utils/errors.py``.

Reference model: Arrow's ``*_checked`` kernels abort execution with
``ArrowInvalid`` when a data-dependent error (integer overflow, divide by
zero, float domain error) occurs —
``cpp/src/arrow/compute/kernels/scalar_arithmetic.cc:339``.

A kernel reduces its per-row error condition to one 0-d bool tensor and
reports it through :func:`check`. The port's plan engine is eager, so
``check`` reads the flag at once: one host read a checked call, and the
error is raised where pyarrow raises it. A caller that wants several
flags read together opens a :func:`collect` scope: the flags are recorded,
``ErrorScope.encode`` folds them into one int32 code on the device, and
:func:`raise_code` reads it once (the JAX package's deferred form, which
its jitted stages need).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import torch

__all__ = ["ArrowInvalid", "check", "check_optional", "collect",
           "ErrorScope", "raise_code"]


class ArrowInvalid(ValueError):
    """Data-dependent kernel error (the pyarrow.lib.ArrowInvalid analog)."""


_tls = threading.local()


def _current_scope() -> Optional["ErrorScope"]:
    return getattr(_tls, "scope", None)


class ErrorScope:
    """Collects (flag, message) pairs reported inside a ``collect()``."""

    def __init__(self):
        self.flags: List[Tuple[torch.Tensor, str]] = []

    def add(self, flag, message: str):
        self.flags.append((torch.as_tensor(flag), message))

    def encode(self) -> torch.Tensor:
        """int32 0-d tensor: 1-based index of the first tripped flag, 0 =
        ok."""
        code = torch.zeros((), dtype=torch.int32)
        for i, (f, _) in reversed(list(enumerate(self.flags))):
            code = torch.where(f, torch.tensor(i + 1, dtype=torch.int32,
                                               device=f.device),
                               code.to(f.device))
        return code

    def messages(self) -> List[str]:
        return [m for _, m in self.flags]


class collect:
    """Context manager installing an :class:`ErrorScope` for this thread."""

    def __enter__(self) -> ErrorScope:
        self._prev = _current_scope()
        scope = ErrorScope()
        _tls.scope = scope
        return scope

    def __exit__(self, *exc):
        _tls.scope = self._prev
        return False


def raise_code(code, messages: List[str]) -> None:
    """Raise the message selected by a nonzero encoded code (one host
    read)."""
    c = int(code)
    if c:
        raise ArrowInvalid(messages[c - 1])


def check(flag, message: str) -> None:
    """Report a 0-d bool error condition (True = error): recorded in the
    active scope, else read at once and raised."""
    scope = _current_scope()
    if scope is not None:
        scope.add(flag, message)
        return
    if bool(flag):
        raise ArrowInvalid(message)


# the JAX package skips an unscoped check inside jit; the port has no
# trace, so both forms read the flag
check_optional = check
