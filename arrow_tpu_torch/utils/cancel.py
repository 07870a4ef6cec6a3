"""Cancellation.

Reference: ``util/cancel.h`` StopToken / StopSource propagated through
plans (``ExecPlan::StopProducing``); the counterpart of the JAX package's
``utils/cancel.py``. The plan driver checks the token between batches
(``Declaration.to_batches`` / ``to_table`` / ``to_batches_prefetched``),
the points where the host hands a batch on; a node that holds disk state
(the external sort's runs, the Grace join's partitions) removes it when
the stop unwinds through it.
"""

from __future__ import annotations

import threading

__all__ = ["StopSource", "StopToken", "CancelledError"]


class CancelledError(RuntimeError):
    pass


class StopToken:
    def __init__(self, source: "StopSource"):
        self._source = source

    @property
    def stop_requested(self) -> bool:
        return self._source._stopped.is_set()

    def raise_if_stopped(self):
        if self.stop_requested:
            raise CancelledError(self._source._reason or "plan cancelled")


class StopSource:
    def __init__(self):
        self._stopped = threading.Event()
        self._reason = None

    def request_stop(self, reason: str = ""):
        self._reason = reason
        self._stopped.set()

    def token(self) -> StopToken:
        return StopToken(self)
