"""Runtime utilities of the port: cancellation, config, tracing, and the
TPC-H generator (``utils/tpch.py``)."""

from .cancel import CancelledError, StopSource, StopToken  # noqa: F401
from .config import build_info, env_settings, runtime_info  # noqa: F401
from .tracing import metrics, trace_span  # noqa: F401
