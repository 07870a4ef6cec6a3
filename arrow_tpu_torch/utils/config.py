"""Config and flags.

Reference: Arrow's three tiers (``docs/source/cpp/env_vars.rst``):
build-time options -> ``GetBuildInfo``; environment variables; per-call
options structs. The counterpart of the JAX package's ``utils/config.py``:

  1. build info: ``build_info()`` (the package, torch and CUDA versions,
     whether the native host runtime builds) and ``runtime_info()`` (the
     device type and count, device 0's name, whether the CUDA kernels are
     built);
  2. environment variables, all prefixed ARROW_TPU_ (``ENV_VARS``: the
     ones this package reads);
  3. per-call options classes next to each kernel (FunctionOptions
     analogs) and per-node ExecNodeOptions.
"""

from __future__ import annotations

import os
from typing import Dict

__all__ = ["build_info", "runtime_info", "env_settings", "ENV_VARS"]

# every ARROW_TPU_* variable a module of this package reads
ENV_VARS = (
    "ARROW_TPU_AGG_REPLAY_BYTES",   # ops/hash_aggregate: replay budget
    "ARROW_TPU_COMPACT_MIN",        # acero/nodes: compaction row floor
    "ARROW_TPU_COMPACT_MIN_BYTES",  # acero/nodes: compaction byte floor
    "ARROW_TPU_DICT_INGEST_MIN",    # core/interop: dictionary ingest rows
    "ARROW_TPU_INGEST_DICT",        # core/interop: dictionary ingest off
    "ARROW_TPU_MAX_POOL_BYTES",     # core/interop: a batch's string pool
    "ARROW_TPU_NO_COMPACT",         # acero/nodes: compaction off
    "ARROW_TPU_NO_PRUNE",           # acero/plan: projection pushdown off
    "ARROW_TPU_PLAN_CACHE",         # acero/fuse: the learned plan store file
    "ARROW_TPU_SORT_PREFIX_BYTES",  # ops/sorting: string key prefix
    "ARROW_TPU_SPILL_BYTES",        # acero/spill: the spill budget
    "ARROW_TPU_TRACE_DIR",          # utils/tracing: profiler traces
)


def build_info() -> Dict[str, str]:
    import torch
    from .. import __version__, native
    return {
        "version": __version__,
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
        "native_runtime": str(native.available()),
    }


def runtime_info() -> Dict[str, str]:
    import torch
    from ..ops import cuda_kernels
    cuda = torch.cuda.is_available()
    return {
        "device_type": "cuda" if cuda else "cpu",
        "num_devices": str(torch.cuda.device_count() if cuda else 1),
        "device0": torch.cuda.get_device_name(0) if cuda else "cpu",
        "cuda_kernels_built": str(cuda_kernels.is_built()),
    }


def env_settings() -> Dict[str, str]:
    return {k: os.environ[k] for k in ENV_VARS if k in os.environ}
