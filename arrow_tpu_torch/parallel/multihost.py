"""Multi-process SPMD: the distributed operators across processes and
hosts; the counterpart of the JAX package's ``parallel/multihost.py``.

The engine's distributed operators run over a mesh of shards
(``parallel/context.py``). This module is the thin launch layer that makes
the SAME code run across N processes: ``torch.distributed``'s process group
+ a DistContext over the global mesh. Every process passes the same number
L of local shards; process r owns the global shards [r·L, (r+1)·L), the
JAX package's process-major device order. The exchange becomes an
``all_to_all_single`` (``parallel/shuffle._exchange_group``), the host
reads and the results all-gathers (``parallel/collective.py``).

Usage (one call per process, before any distributed call)::

    from arrow_tpu_torch.parallel import multihost
    ctx = multihost.initialize(coordinator="host0:29500",
                               num_processes=N, process_id=i)
    out = ctx.group_by(batch, ["k"], [("sum", "v")])

With no arguments, ``initialize()`` reads torchrun's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, ``env://``)
and takes the card ``cuda:{LOCAL_RANK}``: ``torchrun --nproc-per-node=K
script.py`` runs one process per card.

Backends: ``"nccl"`` for card shards (one process per card: NCCL refuses
two ranks on one card), ``"gloo"`` for CPU shards, and for card shards
through pinned host buffers (``collective.py``), which two processes on one
card can use. A backend that cannot run raises; nothing changes it or
moves shards to the CPU quietly.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "global_context", "shutdown"]

_context = None


def _backend_for(devices, backend: Optional[str]) -> str:
    cards = any(d.type == "cuda" for d in devices)
    if backend is None:
        backend = "nccl" if cards else "gloo"
    if backend == "nccl":
        if not cards or any(d.type != "cuda" for d in devices):
            raise ValueError("multihost: the NCCL backend moves card "
                             f"tensors only; the shards are on {devices}")
        if not dist.is_nccl_available():
            raise RuntimeError("multihost: this torch has no NCCL backend")
    elif backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("multihost: this torch has no gloo backend")
    else:
        raise ValueError(f"multihost: backend {backend!r}: 'nccl' or 'gloo'")
    return backend


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_devices: Optional[Sequence] = None,
               backend: Optional[str] = None,
               timeout: float = 300.0):
    """Join this process to the group and return a DistContext over the
    GLOBAL mesh. Call once per process before any distributed call.

    ``coordinator`` ("host:port", process 0's) with ``num_processes`` and
    ``process_id``: ``tcp://`` rendezvous; without it, ``env://``
    (torchrun's variables; the arguments given override ``WORLD_SIZE`` /
    ``RANK``). ``local_devices``: this process's shards' devices, which
    may repeat one device (logical shards); default ``cuda:{LOCAL_RANK}``.
    ``timeout`` (seconds) bounds the rendezvous and every collective, so a
    process that fails before a collective makes the others raise, not
    hang. Raises on every process unless all pass the same number of
    local shards."""
    global _context
    if local_devices is None:
        local_devices = [torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0")))]
    devices = [torch.device(d) for d in local_devices]
    backend = _backend_for(devices, backend)
    if not dist.is_initialized():
        kwargs = {}
        if coordinator is not None:
            if num_processes is None or process_id is None:
                raise ValueError("multihost: a coordinator needs "
                                 "num_processes and process_id")
            init_method = f"tcp://{coordinator}"
        else:
            init_method = "env://"
        if num_processes is not None:
            kwargs["world_size"] = num_processes
        if process_id is not None:
            kwargs["rank"] = process_id
        if backend == "nccl":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(
            backend, init_method=init_method,
            timeout=datetime.timedelta(seconds=timeout), **kwargs)
    from . import collective
    from .context import DistContext
    counts = collective.all_gather(
        torch.tensor([len(devices)], device=devices[0]), dist.group.WORLD)
    if len(set(counts.reshape(-1).tolist())) != 1:
        raise ValueError(f"multihost: every process must pass the same "
                         f"number of local shards; per process: "
                         f"{counts.reshape(-1).tolist()}")
    _context = DistContext(devices=devices, group=dist.group.WORLD)
    return _context


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_context():
    """The DistContext over the global mesh that ``initialize`` made; before
    it, a single-process DistContext over this host's cards."""
    from .context import DistContext
    return _context if _context is not None else DistContext()


def shutdown() -> None:
    """Leave the group (``destroy_process_group``)."""
    global _context
    _context = None
    if is_initialized():
        dist.destroy_process_group()
