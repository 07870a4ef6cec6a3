"""The collectives of a ``torch.distributed`` process group that the
distributed operators use across processes: an all-gather of one tensor a
process, an all-gather of byte buffers of unequal sizes, and an
all-to-all of byte blocks of unequal sizes.

Every tensor crosses as its bytes (uint8): gloo refuses int16, uint16,
uint32 and uint64 ("Invalid scalar type"), and a byte view costs nothing.
The backend is the group's: NCCL moves card tensors; gloo moves CPU
tensors, and card tensors through pinned host buffers (the gloo group's
transport: a copy to the host before the call, one back after it). Which
of the two runs is what the group was made with (``multihost.initialize``'s
``backend=``), never a fallback.

``STATS`` counts the calls and the bytes this process sent to other
processes.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

__all__ = ["STATS", "reset_stats", "all_gather", "all_gather_bytes",
           "all_to_all_bytes", "as_bytes"]

STATS = {"calls": 0, "bytes_remote": 0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes_remote=0)


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a 1-D uint8 tensor (a view where ``t`` is
    contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _staged(group, device: torch.device) -> bool:
    """Whether ``device``'s tensors cross ``group`` through the host: a
    gloo group's card tensors."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _run(fn, remote_bytes: int) -> None:
    """Make one collective call ``fn`` and count it."""
    fn()
    STATS["calls"] += 1
    STATS["bytes_remote"] += remote_bytes


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every process's ``t`` (equal shapes and dtypes), stacked in rank
    order: a (world, *t.shape) tensor on ``t``'s device. ONE collective."""
    world = dist.get_world_size(group)
    dev = t.device
    b = as_bytes(t)
    if _staged(group, dev):
        b = _to_host(b)
    out = b.new_empty((world, b.numel()))
    _run(lambda: dist.all_gather(list(out.unbind(0)), b, group=group),
         b.numel() * (world - 1))
    return out.view(t.dtype).reshape((world,) + tuple(t.shape)).to(dev)


def all_gather_bytes(buf: torch.Tensor, sizes: Sequence[int], group
                     ) -> List[torch.Tensor]:
    """Every process's 1-D uint8 ``buf``, whose sizes all processes know
    (``sizes[r]``: process r's): the buffers padded to the largest, ONE
    collective, then each process's ``sizes[r]`` bytes, in rank order, on
    ``buf``'s device."""
    world = dist.get_world_size(group)
    dev = buf.device
    top = max(sizes)
    if top == 0:
        return [buf.new_empty((0,)) for _ in range(world)]
    padded = buf.new_zeros((top,))
    padded[:buf.numel()] = buf
    if _staged(group, dev):
        padded = _to_host(padded)
    out = padded.new_empty((world, top))
    _run(lambda: dist.all_gather(list(out.unbind(0)), padded, group=group),
         buf.numel() * (world - 1))
    out = out.to(dev)
    return [out[r, :sizes[r]] for r in range(world)]


def all_to_all_bytes(send: torch.Tensor, send_sizes: Sequence[int],
                     recv_sizes: Sequence[int], group) -> torch.Tensor:
    """The all-to-all of byte blocks: ``send`` (1-D uint8) holds, in rank
    order, ``send_sizes[r]`` bytes for process r; the result (on ``send``'s
    device) holds, in rank order, the ``recv_sizes[q]`` bytes process q
    sent here. ONE collective; the caller skips it where every process's
    blocks are empty (all processes know the sizes)."""
    rank = dist.get_rank(group)
    dev = send.device
    staged = _staged(group, dev)
    if staged:
        send = _to_host(send)
    recv = send.new_empty((sum(recv_sizes),))
    _run(lambda: dist.all_to_all_single(
        recv, send, list(map(int, recv_sizes)), list(map(int, send_sizes)),
        group=group),
        sum(int(s) for r, s in enumerate(send_sizes) if r != rank))
    return recv.to(dev, non_blocking=staged)
